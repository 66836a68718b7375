from ganslate_tpu_torch.nn.generators.resnet.resnet2d import Resnet2D, Resnet2DConfig  # noqa: F401
from ganslate_tpu_torch.nn.generators.vnet.vnet2d import Vnet2D, Vnet2DConfig  # noqa: F401
from ganslate_tpu_torch.nn.generators.vnet.vnet3d import Vnet3D, Vnet3DConfig  # noqa: F401
