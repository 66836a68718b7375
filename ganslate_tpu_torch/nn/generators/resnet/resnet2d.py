"""2D ResNet generator (the JAX package's `nn/generators/resnet/resnet2d.py`)."""

from dataclasses import dataclass

from ganslate_tpu_torch import configs
from ganslate_tpu_torch.nn.generators.resnet.resnet import ResnetGenerator


@dataclass
class Resnet2DConfig(configs.base.BaseGeneratorConfig):
    n_residual_blocks: int = 9
    # Base width (the reference hardcodes 64; exposed here as a knob).
    ngf: int = 64
    # A TPU execution form of the JAX package; the port runs the plain path.
    use_cells_boundary: bool = False


class Resnet2D(ResnetGenerator):
    spatial_dims = 2
    pad_mode = "reflect"
