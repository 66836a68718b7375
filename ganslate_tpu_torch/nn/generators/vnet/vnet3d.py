"""3D partially-invertible V-Net (the JAX package's
`nn/generators/vnet/vnet3d.py`)."""

from dataclasses import dataclass
from typing import Tuple

from ganslate_tpu_torch import configs
from ganslate_tpu_torch.nn.generators.vnet.vnet import VnetGenerator


@dataclass
class Vnet3DConfig(configs.base.BaseGeneratorConfig):
    """Partially-invertible V-Net generator."""
    use_memory_saving: bool = False
    use_inverse: bool = False
    first_layer_channels: int = 16
    down_blocks: Tuple[int] = (1, 2, 3, 2)
    up_blocks: Tuple[int] = (2, 2, 1, 1)
    is_separable: bool = False
    # A space-to-depth execution form of the JAX package (same function, same
    # parameters); the port runs the plain computation.
    use_s2d_exec: bool = False


class Vnet3D(VnetGenerator):
    spatial_dims = 3
