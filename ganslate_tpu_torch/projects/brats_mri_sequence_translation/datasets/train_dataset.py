"""BRaTS MRI sequence-translation training dataset (the twin of the JAX
package's `projects/brats_mri_sequence_translation/datasets/
train_dataset.py`): 4-D NIfTI volumes (sequence, z, y, x), the source and
target sequences taken out of them, a stochastic-focal 3D patch pair, each
patch z-scored to [-1, 1], channels-last `(*patch_size, 1)`.

As in the JAX package, domain B's scan is drawn with Python's `random` and
the patch pair with the sampler's own generator, so `train.seed` (which
seeds `random`) fixes the scans and not the patches."""

import random
from dataclasses import dataclass
from typing import Tuple

import numpy as np

from ganslate_tpu_torch import configs
from ganslate_tpu_torch.data.utils.normalization import z_score_normalize
from ganslate_tpu_torch.data.utils.stochastic_focal_patching import StochasticFocalPatchSampler
from ganslate_tpu_torch.utils import sitk_utils
from ganslate_tpu_torch.utils.io import make_dataset_of_files


@dataclass
class BratsDatasetConfig(configs.base.BaseDatasetConfig):
    patch_size: Tuple[int, int, int] = (32, 32, 32)
    # Focal region size as a proportion of the volume size.
    focal_region_proportion: float = 0
    source_sequence: str = "flair"
    target_sequence: str = "t1w"


EXTENSIONS = ['.nii.gz']

# MRI sequence indices in the BRaTS 4D volumes.
SEQUENCE_MAP = {"flair": 0, "t1w": 1, "t1gd": 2, "t2w": 3}


def get_mri_sequence(image, sequence_name):
    """Extract one sequence from a 4D (sequence, z, y, x) volume."""
    idx = SEQUENCE_MAP[sequence_name.lower()]
    array = image.array
    if array.ndim == 4:
        array = array[idx]
    return sitk_utils.tensor_to_sitk_image(array, dtype=str(array.dtype))


class BratsDataset:

    def __init__(self, conf):
        dataset_conf = conf.train.dataset
        self.paths_brats = make_dataset_of_files(dataset_conf.root, EXTENSIONS)
        self.num_datapoints = len(self.paths_brats)

        self.patch_size = np.array(dataset_conf.patch_size)
        self.patch_sampler = StochasticFocalPatchSampler(
            self.patch_size, dataset_conf.focal_region_proportion)

        self.source_sequence = dataset_conf.source_sequence
        self.target_sequence = dataset_conf.target_sequence

    def __getitem__(self, index):
        index_A = index % self.num_datapoints
        index_B = random.randint(0, self.num_datapoints - 1)

        A = get_mri_sequence(sitk_utils.load(self.paths_brats[index_A]),
                             self.source_sequence)
        B = get_mri_sequence(sitk_utils.load(self.paths_brats[index_B]),
                             self.target_sequence)

        if (sitk_utils.is_image_smaller_than(A, self.patch_size) or
                sitk_utils.is_image_smaller_than(B, self.patch_size)):
            raise ValueError(
                f"Volume size not smaller than the defined patch size."
                f"\nA: {sitk_utils.get_torch_like_size(A)}"
                f"\nB: {sitk_utils.get_torch_like_size(B)}"
                f"\npatch_size: {self.patch_size}.")

        A = sitk_utils.get_tensor(A)
        B = sitk_utils.get_tensor(B)

        A, B = self.patch_sampler.get_patch_pair(A, B)
        A = z_score_normalize(A, scale_to_range=(-1, 1))
        B = z_score_normalize(B, scale_to_range=(-1, 1))

        # Channels-last grayscale.
        return {'A': A[..., None], 'B': B[..., None]}

    def __len__(self):
        return self.num_datapoints
