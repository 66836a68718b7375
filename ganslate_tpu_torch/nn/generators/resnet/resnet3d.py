"""3D ResNet generator (the JAX package's `nn/generators/resnet/resnet3d.py`):
the 2D architecture with 3D convs and replication padding."""

from dataclasses import dataclass

from ganslate_tpu_torch import configs
from ganslate_tpu_torch.nn.generators.resnet.resnet import ResnetGenerator


@dataclass
class Resnet3DConfig(configs.base.BaseGeneratorConfig):
    n_residual_blocks: int = 9
    # Base width (the reference hardcodes 64; exposed here as a knob).
    ngf: int = 64
    # A TPU execution form of the JAX package; the port runs the plain path.
    use_s2d_exec: bool = False


class Resnet3D(ResnetGenerator):
    spatial_dims = 3
    pad_mode = "replicate"
