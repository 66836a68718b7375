"""The layers that the plain reference networks are made of, written from
ganslate's published layer equations, in plain PyTorch.

No kernel, cache or batching trick: instance norm is the textbook mean and
biased variance over the spatial dims (eps 1e-5, no affine), padding is
`F.pad`. `set_fp8` rounds every conv's input, weight and output, every
norm's and PReLU's output, and in the backward the gradients that cross
them, to float8 e4m3 with one scale per tensor: the lower precision that
the benchmark's control computes in.
"""

import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0         # largest finite float8 e4m3fn


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class _Fp8(torch.autograd.Function):
    """Rounds to float8 e4m3 under a per-tensor scale (amax to 448), in the
    forward and, on the way back, the gradient too."""

    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x)

    @staticmethod
    def backward(ctx, grad):
        return _round_fp8(grad)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)


class RefConv(nn.Module):
    """A conv or transposed conv with bias; `pad_mode` 'reflect' pads with
    `F.pad` first, as ganslate's ReflectionPad layers do."""

    def __init__(self, cin: int, cout: int, k: int, dims: int, stride: int = 1,
                 padding: int = 0, pad_mode: str = "zeros", transposed: bool = False,
                 output_padding: int = 0):
        super().__init__()
        shape = (cin, cout) if transposed else (cout, cin)
        self.weight = nn.Parameter(torch.empty(*shape, *(k,) * dims))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dims, self.stride, self.padding = dims, stride, padding
        self.pad_mode, self.transposed, self.output_padding = pad_mode, transposed, output_padding
        self.fp8 = False

    def forward(self, x):
        w = self.weight
        if self.fp8:
            x, w = fp8_round(x), fp8_round(w)
        y = self._conv(x, w)
        return fp8_round(y) if self.fp8 else y

    def _conv(self, x, w):
        if self.transposed:
            fn = F.conv_transpose2d if self.dims == 2 else F.conv_transpose3d
            return fn(x, w, self.bias, self.stride, self.padding, self.output_padding)
        padding = self.padding
        if self.pad_mode == "reflect" and padding:
            x = F.pad(x, [padding] * (2 * self.dims), mode="reflect")
            padding = 0
        fn = F.conv2d if self.dims == 2 else F.conv3d
        return fn(x, w, self.bias, self.stride, padding)


class InstanceNorm(nn.Module):
    """Instance norm over the spatial dims, then `activation`."""

    def __init__(self, activation: str = "none"):
        super().__init__()
        self.activation = activation
        self.fp8 = False

    def forward(self, x):
        axes = tuple(range(2, x.ndim))
        mean = x.mean(dim=axes, keepdim=True)
        var = (x - mean).square().mean(dim=axes, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + 1e-5)
        if self.activation == "relu":
            y = F.relu(y)
        elif self.activation == "leaky_relu":
            y = F.leaky_relu(y, 0.2)
        return fp8_round(y) if self.fp8 else y


class PReLU(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.slope = nn.Parameter(torch.full((channels,), 0.25))
        self.fp8 = False

    def forward(self, x):
        y = F.prelu(x, self.slope)
        return fp8_round(y) if self.fp8 else y


def set_fp8(net: nn.Module, on: bool):
    """Round every conv's input, weight and output, every norm's and
    PReLU's output, and the gradients that cross them, to float8."""
    for m in net.modules():
        if isinstance(m, (RefConv, InstanceNorm, PReLU)):
            m.fp8 = on


def require_instance_norm(gan):
    """The reference models instance norm only."""
    if gan.norm_type != "instance":
        raise ValueError(f"the reference models instance norm only, not {gan.norm_type!r}")
