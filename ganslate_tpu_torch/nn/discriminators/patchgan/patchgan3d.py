"""3D PatchGAN (the JAX package's `nn/discriminators/patchgan/patchgan3d.py`)."""

from dataclasses import dataclass
from typing import Tuple

from ganslate_tpu_torch import configs
from ganslate_tpu_torch.nn.discriminators.patchgan.patchgan import PatchGAN


@dataclass
class PatchGAN3DConfig(configs.base.BaseDiscriminatorConfig):
    ndf: int = 64
    n_layers: int = 3
    kernel_size: Tuple[int] = (4, 4, 4)


class PatchGAN3D(PatchGAN):
    kernel_size = (4, 4, 4)
