from ganslate_tpu_torch.nn.generators.resnet.piresnet3d import (  # noqa: F401
    Piresnet3D, Piresnet3DConfig)
from ganslate_tpu_torch.nn.generators.resnet.resnet2d import Resnet2D, Resnet2DConfig  # noqa: F401
from ganslate_tpu_torch.nn.generators.resnet.resnet3d import Resnet3D, Resnet3DConfig  # noqa: F401
from ganslate_tpu_torch.nn.generators.vnet.selfattention_vnet3d import (  # noqa: F401
    SelfAttentionVnet3D, SelfAttentionVnet3DConfig)
from ganslate_tpu_torch.nn.generators.vnet.vnet2d import Vnet2D, Vnet2DConfig  # noqa: F401
from ganslate_tpu_torch.nn.generators.vnet.vnet3d import Vnet3D, Vnet3DConfig  # noqa: F401
from ganslate_tpu_torch.nn.generators.unet.unet2d import Unet2D, Unet2DConfig  # noqa: F401
from ganslate_tpu_torch.nn.generators.unet.unet3d import Unet3D, Unet3DConfig  # noqa: F401
