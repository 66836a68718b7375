"""ClearGrasp multimodal training dataset (the twin of the JAX project's
`datasets/train_dataset.py`): RGB photo and surface normal map to depth
map. cv2 reads the `.jpg` and `.exr` files, a bicubic resize brings them to
`load_size` (W, H), then clip and min-max; channels-last float32 outputs,
A = [RGB, normal map] (H, W, 6), B = depth map (H, W, 1) or, with
`require_domain_B_rgb`, [noisy RGB, depth map] (H, W, 4).

Domain B's sample is drawn with Python's `random` when unpaired, and the
RGB noise of domain B from the global `np.random`, as in the JAX
project."""

import random
from dataclasses import dataclass
from pathlib import Path
from typing import Tuple

import cv2
import numpy as np

from ganslate_tpu_torch import configs
from ganslate_tpu_torch.data.utils.normalization import clip_and_min_max_normalize
from ganslate_tpu_torch.utils.io import make_dataset_of_files

EXTENSIONS = ['.jpg', '.exr']

# Max allowed intensity of depthmap images (metres), from dataset analysis.
UPPER_DEPTH_INTENSITY_LIMIT = 8.0


@dataclass
class ClearGraspTrainDatasetConfig(configs.base.BaseDatasetConfig):
    load_size: Tuple[int, int] = (512, 256)  # (W, H)
    paired: bool = True  # `True` for paired A-B.
    require_domain_B_rgb: bool = False  # Fetch noisy RGB photo for domain B.


def read_rgb(path) -> np.ndarray:
    bgr = cv2.imread(str(path))
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB).astype(np.float32)


def read_normalmap(path) -> np.ndarray:
    img = cv2.imread(str(path), cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32)


def read_depthmap(path) -> np.ndarray:
    img = cv2.imread(str(path), cv2.IMREAD_ANYDEPTH)
    return img.astype(np.float32)[..., None]


def resize(image: np.ndarray, load_size_wh) -> np.ndarray:
    w, h = int(load_size_wh[0]), int(load_size_wh[1])
    out = cv2.resize(image, (w, h), interpolation=cv2.INTER_CUBIC)
    return out[..., None] if out.ndim == 2 else out


class ClearGraspTrainDataset:
    """RGB photos, surface normal maps and depth maps curated from the
    ClearGrasp robot-vision dataset. Translation: RGB + normal map -> depth."""

    def __init__(self, conf):
        dataset_conf = conf[conf.mode].dataset
        self.paired = dataset_conf.paired
        self.require_domain_B_rgb = dataset_conf.require_domain_B_rgb

        root = Path(dataset_conf.root)
        self.image_paths = {
            'RGB': make_dataset_of_files(root / "rgb", EXTENSIONS),
            'normalmap': make_dataset_of_files(root / "normal", EXTENSIONS),
            'depthmap': make_dataset_of_files(root / "depth", EXTENSIONS),
        }
        self.dataset_size = len(self.image_paths['RGB'])
        self.load_size = tuple(dataset_conf.load_size)

        self.rgb_min, self.rgb_max = 0.0, 255.0
        self.normalmap_min, self.normalmap_max = -1.0, 1.0
        self.depthmap_min, self.depthmap_max = 0.0, UPPER_DEPTH_INTENSITY_LIMIT

    def __len__(self):
        return self.dataset_size

    def __getitem__(self, index):
        index_A = index % self.dataset_size
        index_B = index_A if self.paired else random.randint(0, self.dataset_size - 1)

        rgb_A = resize(read_rgb(self.image_paths['RGB'][index_A]), self.load_size)
        normalmap = resize(read_normalmap(self.image_paths['normalmap'][index_A]),
                           self.load_size)
        depthmap = resize(read_depthmap(self.image_paths['depthmap'][index_B]),
                          self.load_size)

        rgb_A = clip_and_min_max_normalize(rgb_A, self.rgb_min, self.rgb_max)
        normalmap = np.clip(normalmap, self.normalmap_min, self.normalmap_max)
        depthmap = clip_and_min_max_normalize(depthmap, self.depthmap_min,
                                              self.depthmap_max)

        A = np.concatenate([rgb_A, normalmap], axis=-1).astype(np.float32)

        if self.require_domain_B_rgb:
            rgb_B = resize(read_rgb(self.image_paths['RGB'][index_B]), self.load_size)
            rgb_B = clip_and_min_max_normalize(rgb_B, self.rgb_min, self.rgb_max)
            rgb_B = rgb_B + np.random.normal(0, 0.05, rgb_B.shape).astype(np.float32)
            rgb_B = np.clip(rgb_B, -1, 1)
            B = np.concatenate([rgb_B, depthmap], axis=-1).astype(np.float32)
        else:
            B = depthmap.astype(np.float32)

        return {'A': A, 'B': B}
