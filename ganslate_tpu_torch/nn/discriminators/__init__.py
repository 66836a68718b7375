from ganslate_tpu_torch.nn.discriminators.patchgan.multiscale_patchgan3d import (  # noqa: F401
    MultiScalePatchGAN3D, MultiScalePatchGAN3DConfig)
from ganslate_tpu_torch.nn.discriminators.patchgan.patchgan2d import (  # noqa: F401
    PatchGAN2D, PatchGAN2DConfig)
from ganslate_tpu_torch.nn.discriminators.patchgan.patchgan3d import (  # noqa: F401
    PatchGAN3D, PatchGAN3DConfig)
from ganslate_tpu_torch.nn.discriminators.patchgan.selfattention_patchgan3d import (  # noqa: F401
    SelfAttentionPatchGAN3D, SelfAttentionPatchGAN3DConfig)
