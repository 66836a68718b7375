"""The 2D PatchGAN discriminator (`PatchGAN2D`)."""

from gpubench.reference.patchgan import PatchGAN, kwargs  # noqa: F401


def build(**kw):
    return PatchGAN(dims=2, **kw)
