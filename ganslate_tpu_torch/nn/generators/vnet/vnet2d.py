"""2D partially-invertible V-Net (the JAX package's
`nn/generators/vnet/vnet2d.py`)."""

from dataclasses import dataclass

from ganslate_tpu_torch import configs
from ganslate_tpu_torch.nn.generators.vnet.vnet import VnetGenerator


@dataclass
class Vnet2DConfig(configs.base.BaseGeneratorConfig):
    """Partially-invertible V-Net generator."""
    use_memory_saving: bool = True
    use_inverse: bool = True
    first_layer_channels: int = 16
    # A space-to-depth execution form of the JAX package (same function, same
    # parameters); the port runs the plain computation.
    use_s2d_exec: bool = False


class Vnet2D(VnetGenerator):
    spatial_dims = 2
