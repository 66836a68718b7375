"""BRaTS validation and test dataset (the twin of the JAX package's
`projects/brats_mri_sequence_translation/datasets/val_test_dataset.py`):
whole volumes, the source and target sequences of the same scan, each
z-scored to [-1, 1], channels-last; `denormalize` maps to [0, 1] for the
metrics."""

from dataclasses import dataclass

import numpy as np

from ganslate_tpu_torch import configs
from ganslate_tpu_torch.data.utils.normalization import z_score_normalize
from ganslate_tpu_torch.utils import sitk_utils
from ganslate_tpu_torch.utils.io import make_dataset_of_files

from .train_dataset import EXTENSIONS, get_mri_sequence


@dataclass
class BratsValTestDatasetConfig(configs.base.BaseDatasetConfig):
    source_sequence: str = "flair"
    target_sequence: str = "t1w"


class BratsValTestDataset:

    def __init__(self, conf):
        dataset_conf = conf[conf.mode].dataset
        self.paths_brats = make_dataset_of_files(dataset_conf.root, EXTENSIONS)
        self.num_datapoints = len(self.paths_brats)
        self.source_sequence = dataset_conf.source_sequence
        self.target_sequence = dataset_conf.target_sequence

    def __getitem__(self, index):
        mri = sitk_utils.load(self.paths_brats[index])
        A = sitk_utils.get_tensor(get_mri_sequence(mri, self.source_sequence))
        B = sitk_utils.get_tensor(get_mri_sequence(mri, self.target_sequence))

        A = z_score_normalize(A, scale_to_range=(-1, 1))
        B = z_score_normalize(B, scale_to_range=(-1, 1))

        return {'A': A[..., None], 'B': B[..., None]}

    def __len__(self):
        return self.num_datapoints

    def denormalize(self, tensor):
        """Metrics are computed in the [0, 1] range rather than [-1, 1]."""
        return (np.asarray(tensor) + 1) / 2
