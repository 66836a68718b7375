"""The 3D PatchGAN discriminator (`PatchGAN3D`)."""

from gpubench.reference.patchgan import PatchGAN, kwargs  # noqa: F401


def build(**kw):
    return PatchGAN(dims=3, **kw)
