"""The PatchGAN discriminator, in 2D and 3D (`networks/PatchGAN2D.py`,
`networks/PatchGAN3D.py`)."""

import torch.nn.functional as F
from torch import nn

from gpubench.reference.layers import InstanceNorm, RefConv, require_instance_norm


def kwargs(section, label, gan):
    """The arguments from the discriminator's config section, for domain
    `label` (`A`, `B`)."""
    require_instance_norm(gan)
    if any(int(k) != 4 for k in section.kernel_size):
        raise ValueError(f"the reference PatchGAN has 4-wide kernels, not {section.kernel_size}")
    cin = section.in_channels
    cin = cin[label] if hasattr(cin, "keys") else cin
    return dict(in_channels=int(cin), ndf=int(section.ndf), n_layers=int(section.n_layers))


class PatchGAN(nn.Module):
    """k4 s2 conv + LeakyReLU(0.2); `n_layers - 1` k4 s2 convs doubling the
    width (at most 8 ndf) with instance norm + LeakyReLU; a k4 s1 conv with
    norm + LeakyReLU; a k4 s1 conv to one channel of logits."""

    def __init__(self, in_channels: int, dims: int, ndf: int = 64, n_layers: int = 3):
        super().__init__()
        self.n_layers = n_layers
        self.stem = RefConv(in_channels, ndf, 4, dims, stride=2, padding=1)
        c = ndf
        for n in range(1, n_layers):
            out = ndf * min(2 ** n, 8)
            setattr(self, f"down{n}", RefConv(c, out, 4, dims, stride=2, padding=1))
            setattr(self, f"NormAct_{n - 1}", InstanceNorm("leaky_relu"))
            c = out
        out = ndf * min(2 ** n_layers, 8)
        self.penultimate = RefConv(c, out, 4, dims, stride=1, padding=1)
        setattr(self, f"NormAct_{n_layers - 1}", InstanceNorm("leaky_relu"))
        self.head = RefConv(out, 1, 4, dims, stride=1, padding=1)

    def forward(self, x):
        h = F.leaky_relu(self.stem(x), 0.2)
        for n in range(1, self.n_layers):
            h = getattr(self, f"NormAct_{n - 1}")(getattr(self, f"down{n}")(h))
        h = getattr(self, f"NormAct_{self.n_layers - 1}")(self.penultimate(h))
        return self.head(h)
