"""Conv / norm / activation building blocks (the JAX package's
`ganslate_tpu/nn/layers.py`).

PyTorch idiom: modules take and return `(N, C, *spatial)` tensors, and the
parameters are stored in torch's layout (conv `(O, I, *k)`, transposed conv
`(I, O, *k)`), registered in forward order as the original ganslate
registers them. On the GPU the generator keeps its activations in
`torch.channels_last`, so the `(N, *spatial, C)` view that the instance-norm
kernels take (the JAX package's layout) is a free permute.

One implementation serves 2D and 3D: the spatial rank is `len(kernel_size)`.

Inside a sharded `parallel.spatial.spatial_scope` the tensors are slabs of
the samples along one spatial dim: the convs and `pad_spatial` exchange
halo rows with the neighbouring shards, instance norm takes the whole
sample's statistics and batch norm the world's, and the dropout mask is
drawn over the whole extent and sliced (`parallel/spatial.py`).
"""

import functools
import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ganslate_tpu_torch.ops.instance_norm import instance_norm
from ganslate_tpu_torch.parallel import all_reduce_sum, batch_spans_ranks, spatial
from ganslate_tpu_torch.utils import communication

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
    back: three passes instead of one.)

    In a sharded scope the sharded dim takes the neighbours' rows on its
    interior sides and pads by `mode` only at the global edges."""
    if mode not in _PAD_MODES:
        raise ValueError(f"pad mode must be one of {_PAD_MODES}, got {mode!r}")
    pad = tuple(pad)
    if all(p == 0 for p in pad):
        return x
    scope = spatial.active()
    if scope is not None:
        d = scope.spatial_dim
        x = spatial.pad_halo(x, pad[d], pad[d], 2 + d, mode, scope)
        pad = pad[:d] + (0,) + pad[d + 1:]
        with spatial.suspended():
            return pad_spatial(x, pad, mode)
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


def _bias(layer, live: bool = False) -> Optional[torch.Tensor]:
    """The bias to add: detached for an inert bias, so its gradient is
    exactly zero (no gradient at all) instead of rounding noise. `live`
    keeps an inert bias's gradient for one call: a CUT feature tap reads a
    conv's raw output, bias included (the JAX package turns `bias_inert`
    off on its tap path)."""
    if layer.bias is None or not layer.bias_inert or live:
        return layer.bias
    return layer.bias.detach()


class Conv(nn.Module):
    """Convolution with torch-style symmetric integer padding.

    `pad_mode` in {'zeros', 'reflect', 'replicate'}: a non-zero mode pads
    with `pad_spatial` first and runs the conv unpadded, as the original
    ganslate's ReflectionPad / ReplicationPad layers do. `bias_inert`: see
    `inert_bias`; `forward(x, live_bias=True)` gives the bias its gradient
    for that call (`_bias`)."""

    spatially_sharded = True

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

    def forward(self, x, live_bias: bool = False):
        padding, pad_mode = self.padding, self.pad_mode
        scope = spatial.active()
        if scope is not None:
            d = scope.spatial_dim
            halo = spatial.conv_halo(self.weight.shape[2 + d], self.strides[d], padding[d],
                                     x.shape[2 + d])
            if halo is None:
                spatial.uneven(type(self).__name__, x.shape[2 + d], scope)
            x = spatial.pad_halo(x, *halo, 2 + d, pad_mode, scope)
            padding = padding[:d] + (0,) + padding[d + 1:]
        if pad_mode != "zeros":
            with spatial.suspended():
                x = pad_spatial(x, padding, pad_mode)
            padding = 0
        return self._conv(x, self.weight, _bias(self, live_bias), self.strides, padding)


class ConvTranspose(nn.Module):
    """Fractionally-strided conv with torch's output geometry,
    out = (in - 1) * stride - 2 * padding + kernel + output_padding.
    `bias_inert`: see `inert_bias`."""

    spatially_sharded = True

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
        scope = spatial.active()
        if scope is None:
            return self._conv(x, self.weight, _bias(self), self.strides, self.padding,
                              self.output_padding)
        # Each shard's output is its own slab of out = in * stride rows: the
        # conv runs unpadded over the shard and its halo rows, and the slab
        # is cut from the result.
        d = scope.spatial_dim
        k, s, p = self.weight.shape[2 + d], self.strides[d], self.padding[d]
        halo = spatial.conv_transpose_halo(k, s, p, self.output_padding[d])
        if halo is None:
            spatial.uneven(type(self).__name__, x.shape[2 + d], scope)
        size = x.shape[2 + d]
        x = spatial.halo_exchange(x, *halo, 2 + d, scope)
        padding = self.padding[:d] + (0,) + self.padding[d + 1:]
        output_padding = self.output_padding[:d] + (0,) + self.output_padding[d + 1:]
        y = self._conv(x, self.weight, _bias(self), self.strides, padding, output_padding)
        return y.narrow(2 + d, halo[0] * s + p, size * s)


# -------------------------------------------------------------------- norms


def _channels_last_view(x):
    """(N, C, *spatial) -> (N, *spatial, C). Free (no copy) for a tensor in
    channels-last memory format; copies otherwise."""
    return x.permute(0, *range(2, x.ndim), 1).contiguous()


def _channels_first_view(y):
    return y.permute(0, y.ndim - 1, *range(1, y.ndim - 1))


class BatchNorm(nn.Module):
    """Affine batch norm over (N, *spatial) per channel (the JAX package's
    `layers.BatchNorm`): torch's BatchNorm with `track_running_stats=False`,
    so batch statistics serve in training and in evaluation alike and a
    train step keeps no running state. Statistics are fp32; `scale` (ones)
    and `bias` (zeros) are applied in fp32 and the result is cast back to
    x's dtype. Plain PyTorch: the JAX package's version is XLA, not a
    kernel.

    Data parallel, every forward of a train step (`parallel.global_batch`,
    which `BaseGAN.optimize_parameters` opens, with or without autograd)
    takes the statistics of the global batch, as the JAX package's mean
    over a batch sharded on its `data` axis does: the per-channel sum, then
    the sum of squared deviations from the global mean, each summed over
    the ranks by a differentiable all-reduce, so that the backward's two
    reductions span the ranks too. Outside a train step (the Validator,
    `infer`) each rank keeps its own batch, since the ranks serve different
    samples. Without a process group the arithmetic is the one-process
    one. Spatially sharded, a train step's statistics span the data and
    spatial ranks (the world), a replicated leaf's the data ranks only, and
    a sharded forward outside a train step (inference) its spatial
    group."""

    spatially_sharded = True

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.epsilon = epsilon

    def forward(self, x):
        axes = (0, *range(2, x.ndim))
        x32 = x.float()
        scope = spatial.active()
        if batch_spans_ranks():
            # Every rank holds an equal share (`parallel.check_local_batch`).
            over, ranks = ("world", communication.get_world_size()) if scope is not None \
                else ("data", communication.get_data_size())
        elif scope is not None:
            over, ranks = "spatial", scope.size
        else:
            over = None
        if over is None:
            mean = x32.mean(dim=axes, keepdim=True)
            var = (x32 - mean).square().mean(dim=axes, keepdim=True)
        else:
            count = x32.numel() // x32.shape[1] * ranks
            mean = all_reduce_sum(x32.sum(dim=axes, keepdim=True), over) / count
            var = all_reduce_sum((x32 - mean).square().sum(dim=axes, keepdim=True), over) / count
        y = (x32 - mean) * torch.rsqrt(var + self.epsilon)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return (y * self.scale.view(shape) + self.bias.view(shape)).to(x.dtype)


def norm_act(x, norm_type: str, activation: str = "none", negative_slope: float = 0.2,
             epsilon: float = 1e-5, batch_norm: Optional[nn.Module] = None):
    """Norm of `norm_type`, then `activation`. Instance norm runs the norm
    kernels with the activation fused; batch norm needs the network's own
    `BatchNorm` module (`batch_norm`), which holds its parameters."""
    if norm_type == "instance":
        y = instance_norm(_channels_last_view(x), epsilon, activation, negative_slope,
                          shards=spatial.active())
        return _channels_first_view(y)
    if norm_type == "batch":
        if batch_norm is None:
            raise ValueError("batch norm holds per-channel parameters: pass the "
                             "network's `BatchNorm` module")
        x = batch_norm(x)
    elif norm_type not in ("none", None):
        raise NotImplementedError(f"Normalization layer `{norm_type}` not supported")
    if activation == "relu":
        return F.relu(x)
    if activation == "leaky_relu":
        return leaky_relu(x, negative_slope)
    return x


class NormAct(nn.Module):
    """A norm fused with the following activation
    (`activation` in {'none', 'relu', 'leaky_relu'}).

    Instance norm matches torch InstanceNorm2d/3d defaults (affine=False,
    track_running_stats=False, eps=1e-5) and runs the norm kernels;
    statistics are fp32 under a bf16 compute policy. Batch norm holds its
    per-channel parameters in a `BatchNorm_0` submodule (flax's name for it
    inside the JAX package's `NormAct`), so it needs `features`. Other norm
    types run norm, then activation. `forward(x, activation=...)` overrides
    the activation for one call (a CUT feature tap reads a norm's output
    before its ReLU)."""

    spatially_sharded = True

    def __init__(self, norm_type: str = "instance", activation: str = "none",
                 negative_slope: float = 0.2, epsilon: float = 1e-5,
                 features: Optional[int] = None):
        super().__init__()
        if norm_type not in ("instance", "batch", "none", None):
            raise NotImplementedError(f"Normalization layer `{norm_type}` not supported")
        if norm_type == "batch":
            if features is None:
                raise ValueError("batch norm holds per-channel parameters: give `features`")
            self.BatchNorm_0 = BatchNorm(features, epsilon)
        self.norm_type = norm_type
        self.activation = activation
        self.negative_slope = negative_slope
        self.epsilon = epsilon

    def forward(self, x, activation: Optional[str] = None):
        return norm_act(x, self.norm_type, activation or self.activation,
                        self.negative_slope, self.epsilon,
                        getattr(self, "BatchNorm_0", None))


def batch_norm_or_none(norm_type: Optional[str], features: int) -> Optional["BatchNorm"]:
    """The `BatchNorm` that the JAX package's bare `get_norm_layer(...)()`
    call creates in a block's scope (flax names it `BatchNorm_{k}` there),
    or None for the norms without parameters."""
    return BatchNorm(features) if norm_type == "batch" else None


class InstanceNorm(NormAct):
    """Instance norm without activation. `features` is accepted, as every
    norm constructor of `get_norm_layer` takes it, and unused: the norm has
    no parameters."""

    def __init__(self, features: Optional[int] = None, epsilon: float = 1e-5):
        super().__init__("instance", "none", epsilon=epsilon)


class IdentityNorm(NormAct):
    """`norm_type='none'`: a pass-through."""

    def __init__(self, features: Optional[int] = None):
        super().__init__("none", "none")


def get_norm_layer(norm_type: str = "instance"):
    """Config `norm_type` -> norm module constructor, called with the
    channel count: `get_norm_layer(norm_type)(features)`."""
    if norm_type == "instance":
        return InstanceNorm
    if norm_type == "batch":
        return BatchNorm
    if norm_type in ("none", None):
        return IdentityNorm
    raise NotImplementedError(f"Normalization layer `{norm_type}` not supported")


def check_s2d_norm(norm_type: str, s2d: int):
    """The JAX package's s2d execution form takes instance and no norm only;
    the same configs are refused here."""
    if s2d > 1 and norm_type not in ("instance", "none", None):
        raise ValueError(f"the s2d execution space supports instance and no norm, "
                         f"got {norm_type!r}")


def apply_norm_s2d(norm_type: str, h, channels: Optional[int] = None, s2d: int = 0,
                   norm: Optional[nn.Module] = None):
    """Norm dispatch of the s2d-capable generators (the JAX package's
    `layers.apply_norm_s2d`). There, `s2d > 1` selects the grouped norm of
    its space-to-depth execution form, which computes the same function; the
    port runs the plain computation, so every `s2d` gives the plain norm.
    `norm` is the network's own norm module, which a norm with parameters
    (batch norm) needs; as in the JAX package, the s2d form takes instance
    and no norm only."""
    check_s2d_norm(norm_type, s2d)
    if norm is None:
        return norm_act(h, norm_type)
    return norm(h)


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


class PReLU(nn.Module):
    """PReLU with a learned slope per channel (torch `nn.PReLU(features)`),
    or one shared slope when `features` is None (the JAX package's
    `layers.PReLU`).

    It computes `where(x >= 0, x, x * slope)` with the slope cast to x's
    dtype first, as the JAX package does: in bf16 the product of two bf16
    values is exact in fp32 and rounds once, there as here. `F.prelu` is that
    function in one pass. `s2d_rn` and `fused_norm` select the JAX package's
    space-to-depth forms; the port runs the plain computation and takes them
    only at their plain values."""

    spatially_sharded = True

    def __init__(self, features: Optional[int] = None, init_slope: float = 0.25,
                 s2d_rn: int = 0, fused_norm: bool = False):
        super().__init__()
        if s2d_rn > 1 or fused_norm:
            raise NotImplementedError("PReLU's space-to-depth forms (`s2d_rn > 1`, "
                                      "`fused_norm`) are not ported: the port runs the "
                                      "plain computation")
        self.slope = nn.Parameter(torch.full((features or 1,), float(init_slope)))

    def forward(self, x):
        return F.prelu(x, self.slope.to(x.dtype))


# ------------------------------------------------------------------ dropout


def dropout_mask(shape: Sequence[int], keep: float, generator: torch.Generator,
                 device: torch.device) -> torch.Tensor:
    """Boolean keep-mask of `shape` (a channels-last `(N, *spatial, C)`
    activation): each element True with probability `keep`, drawn from
    `generator` on `device`. Data parallel, the mask is drawn over the
    global batch, as the JAX package draws it, and this rank's slice of it
    kept, so that the generator stays the same on every rank; spatially
    sharded, over the whole extent of the sharded dim too, and this rank's
    slab kept."""
    n, rank = shape[0], communication.get_data_rank()
    scope = spatial.active()
    whole = list(shape)
    whole[0] = n * communication.get_data_size()
    if scope is not None:
        whole[1 + scope.spatial_dim] *= scope.size
    draw = torch.rand(whole, generator=generator, device=device)[rank * n:(rank + 1) * n]
    if scope is not None:
        d = 1 + scope.spatial_dim
        draw = draw.narrow(d, scope.index * shape[d], shape[d])
    return draw < keep


class Dropout(nn.Module):
    """Dropout with flax's formula, `where(mask, x / keep, 0)` in x's dtype,
    keep = 1 - rate. The mask comes from the generator the caller passes
    (`BaseGAN.apply`'s per-apply randomness, as the JAX package passes a key
    per apply), drawn in the channels-last order of the activation, so that
    the masked output keeps its memory format. In eval mode, and in any call
    without a generator, it is the identity."""

    spatially_sharded = True

    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if generator is None or not self.training or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.rate
        mask = dropout_mask((x.shape[0], *x.shape[2:], x.shape[1]), keep, generator, x.device)
        mask = mask.permute(0, mask.ndim - 1, *range(1, mask.ndim - 1))
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
