"""3D U-Net generator (the JAX package's `nn/generators/unet/unet3d.py`)."""

from dataclasses import dataclass

from ganslate_tpu_torch import configs
from ganslate_tpu_torch.nn.generators.unet.unet import UnetGenerator


@dataclass
class Unet3DConfig(configs.base.BaseGeneratorConfig):
    num_downs: int = 7
    ngf: int = 64
    use_dropout: bool = False
    # A space-to-depth execution form of the JAX package (same function, same
    # parameters); the port runs the plain computation.
    use_s2d_exec: bool = False


class Unet3D(UnetGenerator):
    spatial_dims = 3
