"""Unpaired 2D image dataset (the JAX package's
`data/unpaired_image_dataset.py`).

Domain A is indexed in order, domain B is drawn uniformly at random on each
access (the CycleGAN unaligned regime), and one epoch spans the larger
domain. Samples are channels-last float32 arrays in [-1, 1].
"""

import random
from dataclasses import dataclass, field
from typing import Tuple

from ganslate_tpu_torch import configs
from ganslate_tpu_torch.data.image_folder import domain_folders
from ganslate_tpu_torch.data.utils.transforms import get_single_image_transform


@dataclass
class UnpairedImageDatasetConfig(configs.base.BaseDatasetConfig):
    image_channels: int = 3
    # Preprocessing at load time:
    #   initial resizing: 'resize', 'scale_width'
    #   random transforms: 'random_zoom', 'random_crop', 'random_flip'
    preprocess: Tuple[str] = ('resize', 'random_crop', 'random_flip')
    # Sizes in (H, W) format.
    load_size: Tuple[int, int] = field(default_factory=lambda: [286, 286])
    final_size: Tuple[int, int] = field(default_factory=lambda: [256, 256])


class UnpairedImageDataset:

    def __init__(self, conf):
        self.domain_A, self.domain_B = domain_folders(conf, 'A', 'B')
        self.transform = get_single_image_transform(conf)

    def __len__(self):
        return max(len(self.domain_A), len(self.domain_B))

    def __getitem__(self, index, rng=None):
        # `rng` (a np.random.Generator) comes from the DataLoader, seeded by
        # the sample's stream position: the B draw and both transforms'
        # draws are then deterministic. Without it, the global RNGs.
        a = self.domain_A.load(index % len(self.domain_A))
        if rng is None:
            b_index = random.randint(0, len(self.domain_B) - 1)
        else:
            b_index = int(rng.integers(0, len(self.domain_B)))
        b = self.domain_B.load(b_index)
        # A and B take independent transform draws from the same rng.
        return {'A': self.transform(a, rng=rng), 'B': self.transform(b, rng=rng)}
