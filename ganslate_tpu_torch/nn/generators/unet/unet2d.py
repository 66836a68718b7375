"""2D U-Net generator (the JAX package's `nn/generators/unet/unet2d.py`)."""

from dataclasses import dataclass

from ganslate_tpu_torch import configs
from ganslate_tpu_torch.nn.generators.unet.unet import UnetGenerator


@dataclass
class Unet2DConfig(configs.base.BaseGeneratorConfig):
    num_downs: int = 7
    ngf: int = 64
    use_dropout: bool = False


class Unet2D(UnetGenerator):
    spatial_dims = 2
