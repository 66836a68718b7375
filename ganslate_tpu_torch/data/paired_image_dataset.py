"""Paired (aligned) 2D image dataset (the JAX package's
`data/paired_image_dataset.py`).

A[i] corresponds to B[i], and the random preprocessing draws one set of
parameters applied to both, so that crops and flips keep them aligned.
Samples are channels-last float32 arrays in [-1, 1].
"""

from dataclasses import dataclass, field
from typing import Tuple

from ganslate_tpu_torch import configs
from ganslate_tpu_torch.data.image_folder import domain_folders
from ganslate_tpu_torch.data.utils.transforms import get_paired_image_transform


@dataclass
class PairedImageDatasetConfig(configs.base.BaseDatasetConfig):
    image_channels: int = 3
    # During val/test random transforms are skipped.
    preprocess: Tuple[str] = ('resize', 'random_crop', 'random_flip')
    # Sizes in (H, W) format.
    load_size: Tuple[int, int] = field(default_factory=lambda: [286, 572])
    final_size: Tuple[int, int] = field(default_factory=lambda: [256, 512])


class PairedImageDataset:

    def __init__(self, conf):
        self.domain_A, self.domain_B = domain_folders(conf, 'A', 'B')
        self.transform = get_paired_image_transform(conf)

    def __len__(self):
        return len(self.domain_A)

    def __getitem__(self, index, rng=None):
        index = index % len(self.domain_A)
        a, b = self.domain_A.load(index), self.domain_B.load(index)
        a_t, b_t = self.transform(a, b, rng=rng)
        return {'A': a_t, 'B': b_t}
