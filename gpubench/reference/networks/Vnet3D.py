"""The V-Net generator (`Vnet3D`, without inverse, separable convs or
memory saving): input block, down blocks (k2 s2 conv + norm + PReLU, a
chain of additive couplings y1 = x1 + F(x2), y2 = x2 + G(y1), residual +
PReLU), up blocks (transposed k2 s2 conv to half width + norm + PReLU,
concatenated with the skip, couplings, residual + PReLU), output block (k5
conv + norm + PReLU, k1 conv, tanh). Parameters carry the names of
ganslate's checkpoints (`downs_0.core.blocks.1.F.conv.weight`)."""

from typing import Sequence

import torch
from torch import nn

from gpubench.reference.layers import InstanceNorm, PReLU, RefConv, require_instance_norm


def kwargs(section, label, gan):
    """`build`'s arguments from the generator's config section, for
    direction `label` (`AB`, `BA`)."""
    require_instance_norm(gan)
    if section.use_inverse or section.is_separable or section.use_s2d_exec:
        raise ValueError("the reference V-Net has no inverse, separable or s2d form")
    cin, cout = (int(v) for v in section.in_out_channels[label])
    return dict(in_channels=cin, out_channels=cout,
                first_layer_channels=int(section.first_layer_channels),
                down_blocks=tuple(section.down_blocks), up_blocks=tuple(section.up_blocks))


def build(**kw) -> nn.Module:
    return Vnet3D(**kw)


class ConvNormPReLU(nn.Module):
    """conv -> instance norm -> PReLU: a coupling half (`conv` k5), a down
    conv (k2 s2) or an up conv (transposed k2 s2)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
                 transposed: bool = False, attr: str = "conv"):
        super().__init__()
        self.attr = attr
        setattr(self, attr, RefConv(cin, cout, k, 3, stride=stride, padding=padding,
                                    transposed=transposed))
        self.norm = InstanceNorm()
        self.PReLU_0 = PReLU(cout)

    def forward(self, x):
        return self.PReLU_0(self.norm(getattr(self, self.attr)(x)))


class Coupling(nn.Module):
    def __init__(self, c: int, n_blocks: int):
        super().__init__()
        self.blocks = nn.ModuleList(
            nn.ModuleDict({"F": ConvNormPReLU(c // 2, c // 2, 5, padding=2),
                           "G": ConvNormPReLU(c // 2, c // 2, 5, padding=2)})
            for _ in range(n_blocks))

    def forward(self, x):
        x1, x2 = x.chunk(2, dim=1)
        for block in self.blocks:
            x1 = x1 + block["F"](x2)
            x2 = x2 + block["G"](x1)
        return torch.cat([x1, x2], dim=1)


class DownBlock(nn.Module):
    def __init__(self, cin: int, n_blocks: int):
        super().__init__()
        self.down_conv_ab = ConvNormPReLU(cin, 2 * cin, 2, stride=2)
        self.core = Coupling(2 * cin, n_blocks)
        self.relu = PReLU(2 * cin)

    def forward(self, x):
        down = self.down_conv_ab(x)
        return self.relu(self.core(down) + down)


class UpBlock(nn.Module):
    def __init__(self, cin: int, cout: int, n_blocks: int):
        super().__init__()
        self.up_conv_ab = ConvNormPReLU(cin, cout // 2, 2, stride=2, transposed=True,
                                        attr="convt")
        self.core = Coupling(cout, n_blocks)
        self.relu = PReLU(cout)

    def forward(self, x, skip):
        cat = torch.cat([self.up_conv_ab(x), skip], dim=1)
        return self.relu(self.core(cat) + cat)


class InputBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = RefConv(cin, cout, 5, 3, padding=2)
        self.norm = InstanceNorm()
        self.PReLU_0 = PReLU(cout)
        self.repeats = cout // cin

    def forward(self, x):
        return self.PReLU_0(self.norm(self.conv1(x)) + x.repeat(1, self.repeats, 1, 1, 1))


class OutBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = RefConv(cin, cin, 5, 3, padding=2)
        self.norm = InstanceNorm()
        self.PReLU_0 = PReLU(cin)
        self.conv2 = RefConv(cin, cout, 1, 3)

    def forward(self, x):
        return torch.tanh(self.conv2(self.PReLU_0(self.norm(self.conv1(x)))))


class Vnet3D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, first_layer_channels: int = 16,
                 down_blocks: Sequence[int] = (2, 2, 3), up_blocks: Sequence[int] = (3, 3, 3)):
        super().__init__()
        flc, n = first_layer_channels, len(down_blocks)
        self.n_levels = n
        self.in_ab = InputBlock(in_channels, flc)
        self.out_ab = OutBlock(2 * flc, out_channels)
        for i, blocks in enumerate(down_blocks):
            setattr(self, f"downs_{i}", DownBlock(flc * 2 ** i, blocks))
        widths = [flc * 2 ** (n - i) for i in range(n)]
        for i, blocks in enumerate(up_blocks):
            setattr(self, f"ups_{i}", UpBlock(widths[max(i - 1, 0)], widths[i], blocks))

    def forward(self, x):
        skips = [self.in_ab(x)]
        for i in range(self.n_levels):
            skips.append(getattr(self, f"downs_{i}")(skips[-1]))
        out = skips.pop()
        for i in range(self.n_levels):
            out = getattr(self, f"ups_{i}")(out, skips.pop())
        return self.out_ab(out)
