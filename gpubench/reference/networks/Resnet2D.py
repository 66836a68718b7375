"""The ResNet generator (`Resnet2D`): c7s1-ngf, two stride-2 convs,
`n_residual_blocks` blocks, two stride-2 transposed convs, c7s1-out, tanh;
instance norm + ReLU after every conv but the last. Parameters carry the
names of ganslate's checkpoints (`initial.weight`, `res0.conv1.weight`)."""

import torch
from torch import nn

from gpubench.reference.layers import InstanceNorm, RefConv, require_instance_norm


def kwargs(section, label, gan):
    """`build`'s arguments from the generator's config section, for
    direction `label` (`AB`, `BA`)."""
    require_instance_norm(gan)
    cin, cout = (int(v) for v in section.in_out_channels[label])
    return dict(in_channels=cin, out_channels=cout,
                n_residual_blocks=int(section.n_residual_blocks), ngf=int(section.ngf))


def build(**kw) -> nn.Module:
    return Resnet2D(**kw)


class ResidualBlock(nn.Module):
    def __init__(self, c: int, dims: int):
        super().__init__()
        self.conv1 = RefConv(c, c, 3, dims, padding=1, pad_mode="reflect")
        self.NormAct_0 = InstanceNorm("relu")
        self.conv2 = RefConv(c, c, 3, dims, padding=1, pad_mode="reflect")
        self.NormAct_1 = InstanceNorm()

    def forward(self, x):
        return x + self.NormAct_1(self.conv2(self.NormAct_0(self.conv1(x))))


class Resnet2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, n_residual_blocks: int = 9,
                 ngf: int = 64):
        super().__init__()
        self.n_blocks = n_residual_blocks
        self.initial = RefConv(in_channels, ngf, 7, 2, padding=3, pad_mode="reflect")
        self.norm_0 = InstanceNorm("relu")
        c = ngf
        for i in range(2):
            setattr(self, f"down{i}", RefConv(c, 2 * c, 3, 2, stride=2, padding=1))
            setattr(self, f"norm_{i + 1}", InstanceNorm("relu"))
            c *= 2
        for i in range(n_residual_blocks):
            setattr(self, f"res{i}", ResidualBlock(c, 2))
        for i in range(2):
            setattr(self, f"up{i}", RefConv(c, c // 2, 3, 2, stride=2, padding=1,
                                            transposed=True, output_padding=1))
            setattr(self, f"NormAct_{i}", InstanceNorm("relu"))
            c //= 2
        self.out = RefConv(c, out_channels, 7, 2, padding=3, pad_mode="reflect")

    def forward(self, x):
        h = self.norm_0(self.initial(x))
        for i in range(2):
            h = getattr(self, f"norm_{i + 1}")(getattr(self, f"down{i}")(h))
        for i in range(self.n_blocks):
            h = getattr(self, f"res{i}")(h)
        for i in range(2):
            h = getattr(self, f"NormAct_{i}")(getattr(self, f"up{i}")(h))
        return torch.tanh(self.out(h))
