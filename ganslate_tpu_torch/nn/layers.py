"""Conv / norm building blocks (the JAX package's `ganslate_tpu/nn/layers.py`).

PyTorch idiom: modules take and return `(N, C, *spatial)` tensors, and the
parameters are stored in torch's layout (conv `(O, I, *k)`, transposed conv
`(I, O, *k)`), registered in forward order as the original ganslate
registers them. On the GPU the generator keeps its activations in
`torch.channels_last`, so the `(N, *spatial, C)` view that the instance-norm
kernels take (the JAX package's layout) is a free permute.

One implementation serves 2D and 3D: the spatial rank is `len(kernel_size)`.
"""

import functools
import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ganslate_tpu_torch.ops.instance_norm import instance_norm

# ------------------------------------------------------------- initializers


def make_initializer(weight_init_type: str = "normal", gain: float = 0.02):
    """Kernel initializer of the JAX package's init menu.

    Returns `init(shape, generator) -> tensor` for a kernel in the JAX
    package's `(*k, I, O)` layout, with its fans (fan_in = I * prod(k),
    fan_out = O * prod(k)), so both packages draw from the same
    distributions. The layers move the result into torch's layout."""
    if weight_init_type not in ("normal", "xavier", "kaiming", "orthogonal"):
        raise NotImplementedError(
            f"initialization method `{weight_init_type}` is not implemented")

    def init(shape, generator: Optional[torch.Generator] = None):
        receptive = math.prod(shape[:-2])
        fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
        if weight_init_type == "orthogonal":
            flat = torch.empty(math.prod(shape[:-1]), shape[-1])
            nn.init.orthogonal_(flat, gain=gain, generator=generator)
            return flat.reshape(shape)
        if weight_init_type == "normal":
            std = gain
        elif weight_init_type == "xavier":
            std = gain * math.sqrt(2.0 / (fan_in + fan_out))
        else:  # kaiming_normal_(a=0, mode='fan_in')
            std = math.sqrt(2.0 / fan_in)
        return torch.empty(shape).normal_(0.0, std, generator=generator)

    return init


def conv_kernel_to_torch(kernel: torch.Tensor) -> torch.Tensor:
    """JAX `Conv` kernel `(*k, I, O)` -> torch `(O, I, *k)`."""
    n = kernel.ndim - 2
    return kernel.permute(n + 1, n, *range(n)).contiguous()


def conv_transpose_kernel_to_torch(kernel: torch.Tensor) -> torch.Tensor:
    """JAX `ConvTranspose` kernel `(*k, I, O)` -> torch `(I, O, *k)`.

    The JAX layer correlates the input-dilated signal with the kernel as
    stored; torch's `conv_transpose` correlates it with the spatially
    flipped kernel, so the flip moves into the conversion."""
    n = kernel.ndim - 2
    return kernel.flip(list(range(n))).permute(n, n + 1, *range(n)).contiguous()


# ------------------------------------------------------------------ padding


def _to_tuple(v: Union[int, Sequence[int]], n: int) -> Tuple[int, ...]:
    return (v,) * n if isinstance(v, int) else tuple(v)


_PAD_MODES = ("zeros", "reflect", "replicate", "edge")


def _source_index(size: int, p: int, mode: str) -> torch.Tensor:
    """Source position of each of the `size + 2p` padded positions."""
    i = torch.arange(-p, size + p)
    if mode == "reflect":           # excludes the edge, as jnp.pad(mode='reflect')
        return torch.where(i < 0, -i, torch.where(i >= size, 2 * (size - 1) - i, i))
    return i.clamp(0, size - 1)     # replicate / edge


@functools.lru_cache(maxsize=64)
def _gather_index(sizes: Tuple[int, ...], pad: Tuple[int, ...], mode: str,
                  device: torch.device) -> torch.Tensor:
    """Flat source row (into the prod(sizes) spatial rows) of every row of
    the padded grid. Made outside inference mode: the cached tensor also
    serves autograd, which refuses inference tensors."""
    with torch.inference_mode(False):
        flat = torch.zeros((), dtype=torch.long)
        for size, p in zip(sizes, pad):
            flat = flat[..., None] * size + _source_index(size, p, mode)
        return flat.reshape(-1).to(device)


def pad_spatial(x: torch.Tensor, pad: Sequence[int], mode: str = "zeros") -> torch.Tensor:
    """Pad the spatial dims of `(N, C, *spatial)` symmetrically, `pad[i]` on
    both sides of spatial dim i.

    Reflect and replicate padding gather whole channel rows of the
    channels-last view `(N, S, C)` in one pass, so a channels-last input
    gives a channels-last output. (`F.pad`'s CUDA reflection kernel copies
    a channels-last input to NCHW and returns NCHW, which cuDNN then copies
    back: three passes instead of one.)"""
    if mode not in _PAD_MODES:
        raise ValueError(f"pad mode must be one of {_PAD_MODES}, got {mode!r}")
    pad = tuple(pad)
    if all(p == 0 for p in pad):
        return x
    if mode == "zeros":
        flat = []
        for p in reversed(pad):     # F.pad lists the last dim first
            flat += [p, p]
        return F.pad(x, flat)
    n, c, sizes = x.shape[0], x.shape[1], tuple(x.shape[2:])
    rows = x.permute(0, *range(2, x.ndim), 1).reshape(n, -1, c)
    out = rows.index_select(1, _gather_index(sizes, pad, mode, x.device))
    out = out.reshape(n, *(s + 2 * p for s, p in zip(sizes, pad)), c)
    return out.permute(0, x.ndim - 1, *range(1, x.ndim - 1))


# ------------------------------------------------------------------- convs


def inert_bias(norm_type: Optional[str]) -> bool:
    """True when a conv bias before this norm type cancels in it: affine-less
    instance norm subtracts the per-(sample, channel) mean, bias included.
    Such a conv keeps the bias add but gives the bias no gradient
    (`bias_inert`), as the JAX package does (`layers.py:inert_bias`, with its
    `bias_inert` flag at its default)."""
    return norm_type == "instance"


def _bias(layer) -> Optional[torch.Tensor]:
    """The bias to add: detached for an inert bias, so its gradient is
    exactly zero (no gradient at all) instead of rounding noise."""
    if layer.bias is None or not layer.bias_inert:
        return layer.bias
    return layer.bias.detach()


class Conv(nn.Module):
    """Convolution with torch-style symmetric integer padding.

    `pad_mode` in {'zeros', 'reflect', 'replicate'}: a non-zero mode pads
    with `pad_spatial` first and runs the conv unpadded, as the original
    ganslate's ReflectionPad / ReplicationPad layers do. `bias_inert`: see
    `inert_bias`."""

    def __init__(self, in_features: int, features: int, kernel_size: Sequence[int],
                 strides: Union[int, Sequence[int]] = 1,
                 padding: Union[int, Sequence[int]] = 0, pad_mode: str = "zeros",
                 use_bias: bool = True, bias_inert: bool = False, kernel_init=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        k = tuple(kernel_size)
        n = len(k)
        self.strides = _to_tuple(strides, n)
        self.padding = _to_tuple(padding, n)
        self.pad_mode = pad_mode
        self._conv = {2: F.conv2d, 3: F.conv3d}[n]
        kernel_init = kernel_init or make_initializer()
        self.weight = nn.Parameter(conv_kernel_to_torch(
            kernel_init((*k, in_features, features), generator)))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.bias_inert = bias_inert

    def forward(self, x):
        if self.pad_mode == "zeros":
            padding = self.padding
        else:
            x = pad_spatial(x, self.padding, self.pad_mode)
            padding = 0
        return self._conv(x, self.weight, _bias(self), self.strides, padding)


class ConvTranspose(nn.Module):
    """Fractionally-strided conv with torch's output geometry,
    out = (in - 1) * stride - 2 * padding + kernel + output_padding.
    `bias_inert`: see `inert_bias`."""

    def __init__(self, in_features: int, features: int, kernel_size: Sequence[int],
                 strides: Union[int, Sequence[int]] = 1,
                 padding: Union[int, Sequence[int]] = 0,
                 output_padding: Union[int, Sequence[int]] = 0,
                 use_bias: bool = True, bias_inert: bool = False, kernel_init=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        k = tuple(kernel_size)
        n = len(k)
        self.strides = _to_tuple(strides, n)
        self.padding = _to_tuple(padding, n)
        self.output_padding = _to_tuple(output_padding, n)
        self._conv = {2: F.conv_transpose2d, 3: F.conv_transpose3d}[n]
        kernel_init = kernel_init or make_initializer()
        self.weight = nn.Parameter(conv_transpose_kernel_to_torch(
            kernel_init((*k, in_features, features), generator)))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.bias_inert = bias_inert

    def forward(self, x):
        return self._conv(x, self.weight, _bias(self), self.strides, self.padding,
                          self.output_padding)


# -------------------------------------------------------------------- norms


def _channels_last_view(x):
    """(N, C, *spatial) -> (N, *spatial, C). Free (no copy) for a tensor in
    channels-last memory format; copies otherwise."""
    return x.permute(0, *range(2, x.ndim), 1).contiguous()


def _channels_first_view(y):
    return y.permute(0, y.ndim - 1, *range(1, y.ndim - 1))


class NormAct(nn.Module):
    """Instance norm fused with the following activation
    (`activation` in {'none', 'relu', 'leaky_relu'}).

    Matches torch InstanceNorm2d/3d defaults (affine=False,
    track_running_stats=False, eps=1e-5); statistics are fp32 under a bf16
    compute policy. Other norm types run norm, then activation."""

    def __init__(self, norm_type: str = "instance", activation: str = "none",
                 negative_slope: float = 0.2, epsilon: float = 1e-5):
        super().__init__()
        if norm_type not in ("instance", "none", None):
            raise NotImplementedError(
                f"Normalization layer `{norm_type}` is not ported yet")
        self.norm_type = norm_type
        self.activation = activation
        self.negative_slope = negative_slope
        self.epsilon = epsilon

    def forward(self, x):
        if self.norm_type == "instance":
            y = instance_norm(_channels_last_view(x), self.epsilon, self.activation,
                              self.negative_slope)
            return _channels_first_view(y)
        if self.activation == "relu":
            return F.relu(x)
        if self.activation == "leaky_relu":
            return leaky_relu(x, self.negative_slope)
        return x


class InstanceNorm(NormAct):
    """Instance norm without activation."""

    def __init__(self, epsilon: float = 1e-5):
        super().__init__("instance", "none", epsilon=epsilon)


class IdentityNorm(NormAct):
    """`norm_type='none'`: a pass-through."""

    def __init__(self):
        super().__init__("none", "none")


def get_norm_layer(norm_type: str = "instance"):
    """Config `norm_type` -> norm module constructor."""
    if norm_type == "instance":
        return InstanceNorm
    if norm_type in ("none", None):
        return IdentityNorm
    raise NotImplementedError(f"Normalization layer `{norm_type}` is not ported yet")


def is_bias_before_norm(norm_type: str = "instance") -> bool:
    """Conv keeps its bias before InstanceNorm (no affine), drops it before
    BatchNorm (affine absorbs it)."""
    if norm_type in ("instance", "none", None):
        return True
    if norm_type == "batch":
        return False
    raise NotImplementedError(f"Normalization layer `{norm_type}` not supported")


# -------------------------------------------------------------- activations


def leaky_relu(x, negative_slope: float = 0.2):
    return F.leaky_relu(x, negative_slope)
