"""ClearGrasp validation and test dataset (the twin of the JAX project's
`datasets/val_test_dataset.py`): paired RGB + normal map -> depth map
samples with their sample ids (the RGB file's stem up to its last `-`),
`denormalize` to metres for the metrics, and `save` of a predicted depth
map as EXR. Channels-last arrays."""

import os
from dataclasses import dataclass
from pathlib import Path
from typing import Tuple

import cv2
import numpy as np

from ganslate_tpu_torch import configs
from ganslate_tpu_torch.data.utils.normalization import min_max_denormalize
from ganslate_tpu_torch.utils.io import make_dataset_of_files

from .train_dataset import (EXTENSIONS, UPPER_DEPTH_INTENSITY_LIMIT,
                            clip_and_min_max_normalize, read_depthmap, read_normalmap,
                            read_rgb, resize)


@dataclass
class ClearGraspValTestDatasetConfig(configs.base.BaseDatasetConfig):
    """Note: the val dataset is paired and does not supply RGB in domain B."""
    load_size: Tuple[int, int] = (512, 256)
    model_is_cyclegan_balanced: bool = False


class ClearGraspValTestDataset:

    def __init__(self, conf):
        dataset_conf = conf[conf.mode].dataset
        root = Path(dataset_conf.root)
        self.image_paths = {
            'RGB': make_dataset_of_files(root / "rgb", EXTENSIONS),
            'normalmap': make_dataset_of_files(root / "normal", EXTENSIONS),
            'depthmap': make_dataset_of_files(root / "depth", EXTENSIONS),
        }
        self.dataset_size = len(self.image_paths['RGB'])
        self.sample_ids = ['-'.join(Path(p).stem.split('-')[:-1])
                           for p in self.image_paths['RGB']]

        self.load_size = tuple(dataset_conf.load_size)
        self.rgb_min, self.rgb_max = 0.0, 255.0
        self.normalmap_min, self.normalmap_max = -1.0, 1.0
        self.depthmap_min, self.depthmap_max = 0.0, UPPER_DEPTH_INTENSITY_LIMIT
        self.model_is_cyclegan_balanced = dataset_conf.model_is_cyclegan_balanced

    def __len__(self):
        return self.dataset_size

    def __getitem__(self, index):
        rgb = resize(read_rgb(self.image_paths['RGB'][index]), self.load_size)
        normalmap = resize(read_normalmap(self.image_paths['normalmap'][index]),
                           self.load_size)
        depthmap = resize(read_depthmap(self.image_paths['depthmap'][index]),
                          self.load_size)

        rgb = clip_and_min_max_normalize(rgb, self.rgb_min, self.rgb_max)
        normalmap = np.clip(normalmap, self.normalmap_min, self.normalmap_max)
        depthmap = clip_and_min_max_normalize(depthmap, self.depthmap_min,
                                              self.depthmap_max)

        A = np.concatenate([rgb, normalmap], axis=-1).astype(np.float32)
        if self.model_is_cyclegan_balanced:
            zeros_dummy = np.zeros_like(rgb)
            B = np.concatenate([zeros_dummy, depthmap], axis=-1).astype(np.float32)
        else:
            B = depthmap.astype(np.float32)

        return {'A': A, 'B': B, 'metadata': {'sample_id': self.sample_ids[index]}}

    def denormalize(self, tensor):
        """Metrics in the original depth range (metres)."""
        return min_max_denormalize(np.asarray(tensor), self.depthmap_min,
                                   self.depthmap_max)

    def save(self, tensor, save_dir, metadata):
        """Save a predicted depth map as EXR."""
        tensor = np.asarray(tensor)
        if self.model_is_cyclegan_balanced:
            tensor = tensor[..., 3]  # depth is the last channel
        else:
            tensor = tensor.squeeze()
        tensor = min_max_denormalize(tensor, self.depthmap_min, self.depthmap_max)

        os.makedirs(save_dir, exist_ok=True)
        save_path = f"{save_dir}/{metadata['sample_id']}.exr"
        cv2.imwrite(save_path, tensor.astype(np.float32))
