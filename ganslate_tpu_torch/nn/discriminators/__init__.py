from ganslate_tpu_torch.nn.discriminators.patchgan.patchgan2d import (  # noqa: F401
    PatchGAN2D, PatchGAN2DConfig)
from ganslate_tpu_torch.nn.discriminators.patchgan.patchgan3d import (  # noqa: F401
    PatchGAN3D, PatchGAN3DConfig)
