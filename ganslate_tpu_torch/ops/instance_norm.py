"""Fused instance norm (+ activation): CUDA forward kernels, their plain
PyTorch version, and the backward.

The counterpart of the JAX package's `ganslate_tpu/ops/instance_norm.py`,
with the same signature and layout: `instance_norm(x, eps, activation,
negative_slope)` over channels-last `(N, *spatial, C)`. Statistics are fp32
(mean and biased variance per sample and channel) whatever the input dtype;
the normalised, activated result is cast back to `x.dtype`.

Where the computation runs is decided by the tensor alone:

- a CPU tensor takes `instance_norm_reference`, the plain PyTorch version
  (it mirrors the JAX package's `_xla_forward`);
- a CUDA tensor launches one of the hand-written kernels of
  `csrc/instance_norm.cu`, or raises. There is no fallback.

Two kernel forms, chosen by `pick_kernel` from the shape alone:

- ``onepass`` (replaces `_pallas_forward`): a thread-block cluster of K
  blocks holds one sample's (S, G) channel group in shared memory, each
  block a tile of rows, so x is read from device memory once and y written
  once (the bytes bound: 2 * N*S*C*itemsize). The blocks exchange their
  partial (mean, M2) through distributed shared memory and merge them in
  rank order (Chan). `onepass_geometry` picks G (64-byte row segments,
  twice the old kernel's 32-byte columns) and K (up to 8) for 3 blocks per
  SM and, at batch 1, 64 blocks rather than 16. Taken while a sample's
  (S, 32-byte) slab is within `ONEPASS_MAX_SMEM`.
- ``split`` (replaces `_pallas_forward_tiled`): two kernels over whole-row
  tiles (R rows x all C channels of one sample, one contiguous span). The
  stats kernel brings each tile into shared memory with one bulk
  asynchronous copy and writes its (mean, M2); the last tile of each group
  of 16 to arrive merges the group in tile order (Chan), and the last group
  of a sample to arrive merges the groups in order and writes mean and
  rstd. The normalise kernel reads the tiles again, in reverse order, and
  writes y. `split_geometry` picks R and the thread count. Taken for larger
  slabs.

At CycleGAN-256 this sends the down1 and residual norms (64x64x256) to the
one-pass form and the stem, down0 and up norms (S >= 16384) to the split
form. Each wrapper counts its launches in `LAUNCHES`, so a caller can show
which kernels a run went through.

`instance_norm` is differentiable: `InstanceNormFunction` runs the forward
above, saves `(x, mean, rstd)` and computes the gradient with
`instance_norm_backward`, plain PyTorch in fp32 from the saved statistics, on
the CPU and on the card alike. It is the counterpart of the JAX package's
`_bwd`, which is XLA there too: no TPU kernel stands behind it.
"""

import ctypes
import math

import torch

ACTIVATIONS = ("none", "relu", "leaky_relu")
_ACT_CODES = {"none": 0, "relu": 1, "leaky_relu": 2}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# One row of a channel block is 32 bytes: CB = 8 float or 16 bfloat16
# channels. The kernels take a channel count that is a multiple of CB (the
# one-pass form's narrowest row segment; the split form's row segments are
# multiples of it); their wrappers pad any other C up to one.
ROW_BYTES = 32
# The one-pass/split boundary: slabs of S rows x 32 bytes up to this size
# (S <= 6400) take the one-pass form. It also caps the slab of the one-pass
# geometries `chip_smoke.py` times: a Hopper block may use 227 KB, and the
# kernel's static scratch (about 3 KB) and some headroom come off that.
ONEPASS_MAX_SMEM = 200 * 1024

# One-pass cluster geometry (`onepass_geometry`), chosen from the one-pass
# kernel timed at every (G, K) at the two main slabs on an H100
# (`chip_smoke.py`, geometry phase; PERF.md):
# - row segments of 64 bytes (32 where a row has only 32): whole sectors,
#   with half the cluster that 128-byte segments need for the same block.
#   The cluster's barrier and merge cost more than the wider segment saves.
ONEPASS_SEGMENT_BYTES = 64
# - clusters of up to 8 blocks (the portable size): 16 was slower at every
#   main slab.
ONEPASS_CLUSTER_SIZES = (1, 2, 4, 8)
# - at most 64 KB of slab per block, so that 3 blocks share an SM (227 KB)
#   and one's loads overlap another's reductions and stores;
ONEPASS_BLOCK_SMEM = 64 * 1024
# - and at least 64 blocks where a cluster of 8 allows: at batch 1, 64
#   blocks beat both 32 and 128.
ONEPASS_MIN_BLOCKS = 64

# Split geometry (`split_geometry`), chosen from the split kernels timed at
# every tile size, thread count and order at the four split slabs on an H100
# (`chip_smoke.py`, split sweep phase; PERF.md):
# - a tile's row segment is the whole row up to this width (wider rows are
#   cut into segments of at most this many bytes);
SPLIT_SEGMENT_MAX_BYTES = 512
# - tiles of 32 KB, at batch 1 too: smaller tiles give more blocks but more
#   partials to merge, and every block pays its own copy, barriers and
#   counting. 64 KB tiles were as fast at batch 16;
SPLIT_TILE_BYTES = 32 * 1024
# - 128 threads per block (or the nearest multiple of the vectors per
#   segment): 256 and 512 threads cost more in each block's reductions and
#   barriers.
SPLIT_THREADS = 128
# - and the normalise pass walks the tiles in the reverse of the stats
#   pass's order.
SPLIT_REVERSE = True

SOURCE = "instance_norm.cu"

#: Launches per kernel form since the last `reset_launches()`. The split form
#: counts one launch per call (its stats and normalise kernels run together).
LAUNCHES = {"onepass": 0, "split": 0}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ------------------------------------------------------------ plain version


def _act(y, activation: str, negative_slope: float):
    if activation == "relu":
        return torch.clamp_min(y, 0)
    if activation == "leaky_relu":
        return torch.where(y >= 0, y, y * negative_slope)
    return y


def instance_norm_reference(x, eps: float = 1e-5, activation: str = "none",
                            negative_slope: float = 0.2):
    """Plain PyTorch instance norm over `(N, *spatial, C)`; returns
    `(out, mean, rstd)` with fp32 `mean` and `rstd` of shape (N, C).
    Mirrors the JAX package's `_xla_forward`."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {ACTIVATIONS}, got {activation!r}")
    axes = tuple(range(1, x.ndim - 1))
    x32 = x.float()
    mean = x32.mean(dim=axes, keepdim=True)
    var = (x32 - mean).square().mean(dim=axes, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    out = _act((x32 - mean) * rstd, activation, negative_slope).to(x.dtype)
    n, c = x.shape[0], x.shape[-1]
    return out, mean.reshape(n, c), rstd.reshape(n, c)


# ---------------------------------------------------------------- dispatch


def channel_block(dtype: torch.dtype) -> int:
    """Channels per kernel block: one 32-byte row."""
    return ROW_BYTES // dtype.itemsize


def onepass_geometry(shape, dtype: torch.dtype):
    """`(G, K, rows_per_block, smem_bytes)` of the one-pass cluster kernel for
    a `(N, *spatial, C)` input that `pick_kernel` sends to it.

    A block owns at most `rows_per_block = ceil(S / K)` rows (rank r of the
    cluster owns rows [r*S//K, (r+1)*S//K)) x G channels of one sample, in
    `smem_bytes` of shared memory; the grid is (K * C / G, N). G * itemsize is
    `ONEPASS_SEGMENT_BYTES`, or 32 where C * itemsize is not a multiple of
    it. K is the smallest of `ONEPASS_CLUSTER_SIZES` that keeps a block
    within `ONEPASS_BLOCK_SMEM` and makes at least `ONEPASS_MIN_BLOCKS`
    blocks, else the largest; never more than S, so that no rank is empty.
    (A one-pass slab has S <= 6400 rows: 50 KB per block at K = 8.)"""
    n, c, s = shape[0], shape[-1], math.prod(shape[1:-1])
    item = dtype.itemsize
    seg = ONEPASS_SEGMENT_BYTES if (c * item) % ONEPASS_SEGMENT_BYTES == 0 else ROW_BYTES
    g = seg // item
    sizes = [k for k in ONEPASS_CLUSTER_SIZES if k <= s]
    k = next((k for k in sizes if -(-s // k) * seg <= ONEPASS_BLOCK_SMEM
              and k * (c // g) * n >= ONEPASS_MIN_BLOCKS), sizes[-1])
    rows = -(-s // k)
    return g, k, rows, rows * seg


def split_geometry(shape, dtype: torch.dtype):
    """`(tile_rows, seg_bytes, threads, blocks)` of the split kernels for a
    `(N, *spatial, C)` input.

    A block owns rows [t * tile_rows, (t + 1) * tile_rows) (the last tile of
    a sample may be shorter) x one `seg_bytes` segment of each row of one
    sample. The segment is the whole row up to `SPLIT_SEGMENT_MAX_BYTES`,
    else the widest multiple of 32 bytes up to it that divides the row, so
    that a tile is one contiguous span where it can be. `threads` is the
    multiple of lcm(vectors per segment, 32) nearest below `SPLIT_THREADS`
    (at least one), so that each thread keeps one 16-byte vector column.
    A tile is `SPLIT_TILE_BYTES` of whole segments, never more rows than S."""
    n, c, s = shape[0], shape[-1], math.prod(shape[1:-1])
    row = c * dtype.itemsize
    seg = row if row <= SPLIT_SEGMENT_MAX_BYTES else max(
        b for b in range(ROW_BYTES, SPLIT_SEGMENT_MAX_BYTES + 1, ROW_BYTES) if row % b == 0)
    unit = math.lcm(seg // 16, 32)
    threads = unit * max(1, SPLIT_THREADS // unit)
    rows = min(s, SPLIT_TILE_BYTES // seg)
    return rows, seg, threads, n * (row // seg) * -(-s // rows)


def split_stats_smem(dtype: torch.dtype, tile_rows: int, seg_bytes: int, threads: int) -> int:
    """Dynamic shared memory of one split stats block, as its launcher
    computes it: the tile, then the scratch of the column sums."""
    vecs, per_vec = seg_bytes // 16, 16 // dtype.itemsize
    sums = (threads // 32 * vecs if 32 % vecs == 0 else threads) * per_vec
    return tile_rows * seg_bytes + 4 * sums


def pick_kernel(shape, dtype: torch.dtype) -> str:
    """'onepass' when a sample's (S, CB) slab fits one block's shared
    memory, else 'split'. Any C: the kernel wrappers pad the channels up to
    a multiple of CB (`_channel_padded`). Raises for shapes and dtypes the
    kernels do not take."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"instance_norm kernels take float32 or bfloat16, got {dtype}")
    if len(shape) not in (4, 5):
        raise ValueError(f"instance_norm kernels take (N, *spatial, C) with 2 or 3 "
                         f"spatial dims, got shape {tuple(shape)}")
    s = math.prod(shape[1:-1])
    return "onepass" if s * ROW_BYTES <= ONEPASS_MAX_SMEM else "split"


def _channel_padded(launch, x, *args):
    """`launch(x, *args) -> (out, mean, rstd)`, a kernel that needs C to be a
    multiple of `channel_block`, on an `x` of any C: the channels are padded
    with zeros up to the next multiple, and the result and its statistics
    are cut back to C. Exact: each channel's statistics and output depend on
    that channel alone (a zero channel gives mean 0 and output 0)."""
    c, cb = x.shape[-1], channel_block(x.dtype)
    if c % cb == 0:
        return launch(x, *args)
    out, mean, rstd = launch(torch.nn.functional.pad(x, (0, cb - c % cb)), *args)
    return out[..., :c].contiguous(), mean[:, :c].contiguous(), rstd[:, :c].contiguous()


# ------------------------------------------------------------------ kernels


_SIGNATURES = {
    "inorm_onepass": (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
        ctypes.c_int),
    "inorm_split_stats": (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p],
        ctypes.c_int),
    "inorm_split_norm": (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p],
        ctypes.c_int),
}

# Arrival counters of the split stats kernel (per sample and segment, one
# for each group of tiles and one for the sample), one int32 buffer per
# (device, stream): zero between launches, because each block that merges
# resets its counter. Launches on one stream never overlap, so they share a
# buffer; launches on two streams never do.
_ARRIVALS = {}


def _arrivals(device, stream: int, count: int):
    key = (device.index, stream)
    buf = _ARRIVALS.get(key)
    if buf is None or buf.numel() < count:
        buf = _ARRIVALS[key] = torch.zeros(count, device=device, dtype=torch.int32)
    return buf


def library():
    """The built and loaded kernel library (built at first use)."""
    from ganslate_tpu_torch.ops import build
    return build.load(SOURCE, _SIGNATURES)


def _check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def _check_input(x):
    if x.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got one on {x.device}")
    if not x.is_contiguous():
        raise ValueError("instance_norm kernels take a contiguous (N, *spatial, C) "
                         "tensor (a channels-last activation's permuted view)")
    if x.data_ptr() % 16:
        raise ValueError("instance_norm kernels need a 16-byte aligned tensor")


def _outputs(x):
    n, c = x.shape[0], x.shape[-1]
    return (torch.empty_like(x),
            torch.empty((n, c), device=x.device, dtype=torch.float32),
            torch.empty((n, c), device=x.device, dtype=torch.float32))


def onepass(x, eps=1e-5, activation="none", negative_slope=0.2):
    """One-pass cluster kernel on a CUDA tensor, at `onepass_geometry`;
    returns `(out, mean, rstd)`."""
    _check_input(x)
    if pick_kernel(x.shape, x.dtype) != "onepass":
        raise ValueError(f"slab of {math.prod(x.shape[1:-1])} rows does not fit the "
                         f"one-pass kernel")
    result = _channel_padded(_onepass_at_geometry, x, eps, activation, negative_slope)
    LAUNCHES["onepass"] += 1
    return result


def _onepass_at_geometry(x, eps, activation, negative_slope):
    g, k, _, _ = onepass_geometry(x.shape, x.dtype)
    return _launch_onepass(x, g, k, eps, activation, negative_slope)


def _launch_onepass(x, g, k, eps, activation, negative_slope):
    """The one-pass kernel at G = g channels per block and clusters of k
    blocks, on a checked input; not counted in `LAUNCHES`."""
    n, c, s = x.shape[0], x.shape[-1], math.prod(x.shape[1:-1])
    out, mean, rstd = _outputs(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = library().inorm_onepass(
        x.data_ptr(), out.data_ptr(), mean.data_ptr(), rstd.data_ptr(), n, s, c,
        _DTYPE_CODES[x.dtype], g, k, eps, _ACT_CODES[activation], negative_slope, stream)
    _check(err, "inorm_onepass")
    return out, mean, rstd


def split(x, eps=1e-5, activation="none", negative_slope=0.2):
    """Split (stats with its fold, normalise) kernels on a CUDA tensor, at
    `split_geometry`; returns `(out, mean, rstd)`."""
    _check_input(x)
    pick_kernel(x.shape, x.dtype)
    result = _channel_padded(_split_at_geometry, x, eps, activation, negative_slope)
    LAUNCHES["split"] += 1
    return result


def _split_at_geometry(x, eps, activation, negative_slope):
    rows, seg, threads, _ = split_geometry(x.shape, x.dtype)
    return _launch_split(x, rows, seg, threads, SPLIT_REVERSE, eps, activation, negative_slope)


def _launch_split(x, tile_rows, seg_bytes, threads, reverse, eps, activation,
                  negative_slope):
    """The split kernels at the given geometry and order, on a checked
    input; not counted in `LAUNCHES`."""
    out, mean, rstd = _outputs(x)
    _split_stats(x, mean, rstd, tile_rows, seg_bytes, threads, eps)
    _split_norm(x, mean, rstd, out, tile_rows, seg_bytes, threads, reverse, activation,
                negative_slope)
    return out, mean, rstd


def _split_stats(x, mean, rstd, tile_rows, seg_bytes, threads, eps):
    """The split stats kernel, whose last block per sample folds: writes
    `mean` and `rstd`."""
    n, c, s = x.shape[0], x.shape[-1], math.prod(x.shape[1:-1])
    tiles = -(-s // min(tile_rows, s))
    partial = torch.empty((n, tiles, 2, c), device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    # At least one counter per group of tiles and one per sample, for each
    # (sample, segment).
    arrivals = _arrivals(x.device, stream, n * (c * x.element_size() // seg_bytes) * (tiles + 1))
    _check(library().inorm_split_stats(
        x.data_ptr(), partial.data_ptr(), arrivals.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), n, s, c, _DTYPE_CODES[x.dtype], seg_bytes, tile_rows, threads, eps,
        stream), "inorm_split_stats")


def _split_norm(x, mean, rstd, out, tile_rows, seg_bytes, threads, reverse, activation,
                negative_slope):
    """The split normalise kernel: writes `out` from `x`, `mean`, `rstd`."""
    n, c, s = x.shape[0], x.shape[-1], math.prod(x.shape[1:-1])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _check(library().inorm_split_norm(
        x.data_ptr(), mean.data_ptr(), rstd.data_ptr(), out.data_ptr(), n, s, c,
        _DTYPE_CODES[x.dtype], seg_bytes, tile_rows, threads, int(reverse),
        _ACT_CODES[activation], negative_slope, stream), "inorm_split_norm")


KERNELS = {"onepass": onepass, "split": split}


# ------------------------------------------------------------------- public


def instance_norm_forward(x, eps: float = 1e-5, activation: str = "none",
                          negative_slope: float = 0.2):
    """`(out, mean, rstd)`: the plain version for a CPU tensor, a kernel for
    a CUDA tensor."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {ACTIVATIONS}, got {activation!r}")
    if x.device.type == "cpu":
        return instance_norm_reference(x, eps, activation, negative_slope)
    return KERNELS[pick_kernel(x.shape, x.dtype)](x, eps, activation, negative_slope)


def _act_grad(y, activation: str, negative_slope: float):
    """d act(y) / dy as a function of the pre-activation y (fp32), for
    'relu' and 'leaky_relu'."""
    if activation == "relu":
        return (y > 0).float()
    return torch.where(y >= 0, 1.0, negative_slope)


def instance_norm_backward(x, mean, rstd, grad, activation: str = "none",
                           negative_slope: float = 0.2):
    """The gradient with respect to `x` of `instance_norm`, given the
    forward's fp32 `mean` and `rstd` (N, C) and the output's gradient `grad`
    (any layout). Computed in fp32 and returned in `x.dtype`; mirrors the
    JAX package's `_bwd`."""
    n, c = x.shape[0], x.shape[-1]
    axes = tuple(range(1, x.ndim - 1))
    stat_shape = (n,) + (1,) * (x.ndim - 2) + (c,)
    mean, rstd = mean.reshape(stat_shape), rstd.reshape(stat_shape)
    y = (x.float() - mean) * rstd                   # pre-activation output
    gy = grad.float()
    if activation != "none":
        gy = gy * _act_grad(y, activation, negative_slope)
    mean_gy = gy.mean(dim=axes, keepdim=True)
    mean_gy_y = (gy * y).mean(dim=axes, keepdim=True)
    return (rstd * (gy - mean_gy - y * mean_gy_y)).to(x.dtype)


class InstanceNormFunction(torch.autograd.Function):
    """`instance_norm` under autograd: the forward of `instance_norm_forward`
    (a kernel for a CUDA tensor), the backward of `instance_norm_backward`."""

    @staticmethod
    def forward(ctx, x, eps, activation, negative_slope):
        out, mean, rstd = instance_norm_forward(x, eps, activation, negative_slope)
        ctx.save_for_backward(x, mean, rstd)
        ctx.activation, ctx.negative_slope = activation, negative_slope
        return out

    @staticmethod
    def backward(ctx, grad):
        x, mean, rstd = ctx.saved_tensors
        dx = instance_norm_backward(x, mean, rstd, grad, ctx.activation, ctx.negative_slope)
        return dx, None, None, None


def instance_norm(x, eps: float = 1e-5, activation: str = "none",
                  negative_slope: float = 0.2):
    """Fused instance norm + optional activation over `(N, *spatial, C)`,
    differentiable with respect to `x`. Without a gradient to record (as in
    serving), the forward runs without the autograd wrapper."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return instance_norm_forward(x, eps, activation, negative_slope)[0]
    return InstanceNormFunction.apply(x, eps, activation, negative_slope)
