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
`instance_norm_grad`, which takes the tensor's device as the forward does:

- a CPU tensor takes `instance_norm_backward`, the plain version in fp32
  from the saved statistics (it mirrors the JAX package's `_bwd`);
- a CUDA tensor launches the backward kernels of `csrc/instance_norm.cu`,
  or raises. They replace no TPU kernel: `_bwd` is XLA there. Their bound
  is 3 slab-sized transfers (x and the gradient read once, dx written once,
  in x's dtype), where the plain version makes about a dozen fp32 passes.
  The one-pass backward (`backward_onepass_geometry`: the forward's cluster
  with x and the gradient both in shared memory) takes the slabs that the
  forward's one-pass form takes and moves those 3; the split pair (a sums
  kernel that folds its tiles' sums in tile order, then a dx kernel that
  walks the tiles in reverse, at `split_geometry`'s tiles) takes the rest
  and moves 5, less what L2 keeps between the two. `BACKWARD_LAUNCHES`
  counts them.

A spatially sharded tensor (`parallel/spatial.py`: each rank holds a slab of
every sample) is normalised with the statistics of the whole sample by
`instance_norm(x, ..., shards=...)`, through the split pair whatever
`pick_kernel` would choose: the stats kernel in its (mean, M2) mode gives the
slab's per-(n, c) statistics; each rank writes them into its slot of a
zeroed (shards, N, 2, C) fp32 tensor, one sum all-reduce fills every slot,
and `fold_shard_stats` merges the slots in rank order (Chan), the same on
every rank; the normalise kernel then runs on the slab with the global mean
and rstd. The backward all-reduces its two per-(n, c) sums over the shards:
on the card between the split backward's two kernels, whatever the shape.
On the CPU the plain version computes the slab's (mean, M2)
(`partial_stats_reference`) and the normalisation, with the same fold.
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
#: Backward launches, likewise (the split form's sums and dx kernels count
#: one), and the gradients that came in another layout, or unaligned, and
#: were copied before a backward launch.
BACKWARD_LAUNCHES = {"onepass": 0, "split": 0}
BACKWARD_COPIES = {"grad": 0}


def reset_launches():
    for counts in (LAUNCHES, BACKWARD_LAUNCHES, BACKWARD_COPIES):
        for name in counts:
            counts[name] = 0


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
    return _cluster_geometry(shape, dtype, 1)


def backward_onepass_geometry(shape, dtype: torch.dtype):
    """`(G, K, rows_per_block, smem_bytes)` of the one-pass backward kernel
    for a `(N, *spatial, C)` input that `pick_kernel` sends to the one-pass
    form: `onepass_geometry`'s rule, with a block's rows of x and of the
    gradient both in its `smem_bytes` (at most 100 KB at S = 6400, K = 8)."""
    return _cluster_geometry(shape, dtype, 2)


def _cluster_geometry(shape, dtype, tensors: int):
    """The one-pass rule for a block that keeps `tensors` slabs of its rows."""
    n, c, s = shape[0], shape[-1], math.prod(shape[1:-1])
    item = dtype.itemsize
    seg = ONEPASS_SEGMENT_BYTES if (c * item) % ONEPASS_SEGMENT_BYTES == 0 else ROW_BYTES
    g = seg // item
    sizes = [k for k in ONEPASS_CLUSTER_SIZES if k <= s]
    k = next((k for k in sizes if tensors * -(-s // k) * seg <= ONEPASS_BLOCK_SMEM
              and k * (c // g) * n >= ONEPASS_MIN_BLOCKS), sizes[-1])
    rows = -(-s // k)
    return g, k, rows, tensors * rows * seg


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
    return _split_smem(dtype, tile_rows, seg_bytes, threads, 1)


def backward_sums_smem(dtype: torch.dtype, tile_rows: int, seg_bytes: int,
                       threads: int) -> int:
    """Dynamic shared memory of one block of the split backward's sums
    kernel, as its launcher computes it: the tiles of x and of the
    gradient, then the scratch of the column sums."""
    return _split_smem(dtype, tile_rows, seg_bytes, threads, 2)


def _split_smem(dtype, tile_rows, seg_bytes, threads, tensors):
    vecs, per_vec = seg_bytes // 16, 16 // dtype.itemsize
    sums = (threads // 32 * vecs if 32 % vecs == 0 else threads) * per_vec
    return tensors * tile_rows * seg_bytes + 4 * sums


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
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p],
        ctypes.c_int),
    "inorm_split_norm": (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p],
        ctypes.c_int),
    "norm_bwd_onepass": (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p],
        ctypes.c_int),
    "norm_bwd_sums": (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p],
        ctypes.c_int),
    "norm_bwd_dx": (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int,
                                                      ctypes.c_float, ctypes.c_void_p],
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


def _split_stats(x, mean, rstd, tile_rows, seg_bytes, threads, eps, m2_out=False):
    """The split stats kernel, whose last block per sample folds: writes
    `mean` and `rstd` (with `m2_out`, the slab's M2 in place of rstd)."""
    n, c, s = x.shape[0], x.shape[-1], math.prod(x.shape[1:-1])
    tiles = -(-s // min(tile_rows, s))
    partial = torch.empty((n, tiles, 2, c), device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    # At least one counter per group of tiles and one per sample, for each
    # (sample, segment).
    arrivals = _arrivals(x.device, stream, n * (c * x.element_size() // seg_bytes) * (tiles + 1))
    _check(library().inorm_split_stats(
        x.data_ptr(), partial.data_ptr(), arrivals.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), n, s, c, _DTYPE_CODES[x.dtype], seg_bytes, tile_rows, threads,
        int(m2_out), eps, stream), "inorm_split_stats")


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


def split_partial_stats(x):
    """The split stats kernel in its (mean, M2) mode on a CUDA tensor, at
    `split_geometry`: the slab's fp32 mean and M2 (sum of squared deviations
    from that mean), each (N, C). Not counted in `LAUNCHES` (the sharded
    norm counts its whole pass)."""
    _check_input(x)
    pick_kernel(x.shape, x.dtype)
    c, cb = x.shape[-1], channel_block(x.dtype)
    if c % cb:
        x = torch.nn.functional.pad(x, (0, cb - c % cb))
    mean, m2 = _split_m2(x)
    return mean[:, :c].contiguous(), m2[:, :c].contiguous()


def _split_m2(x):
    """The stats kernel's (mean, M2) mode on a checked `x` whose C is a
    multiple of `channel_block`."""
    rows, seg, threads, _ = split_geometry(x.shape, x.dtype)
    mean, m2 = (torch.empty((x.shape[0], x.shape[-1]), device=x.device, dtype=torch.float32)
                for _ in range(2))
    _split_stats(x, mean, m2, rows, seg, threads, 0.0, m2_out=True)
    return mean, m2


def _sharded_split(x, eps, activation, negative_slope, shards):
    """The split pair on a checked `x` whose C is a multiple of
    `channel_block`, normalising with the whole samples' statistics
    (`_merge_shards` of the stats kernel's (mean, M2))."""
    mean, rstd = _merge_shards(*_split_m2(x), x, eps, shards)
    rows, seg, threads, _ = split_geometry(x.shape, x.dtype)
    out = torch.empty_like(x)
    _split_norm(x, mean, rstd, out, rows, seg, threads, SPLIT_REVERSE, activation,
                negative_slope)
    return out, mean, rstd


# --------------------------------------------------------- backward kernels


def _grad_operand(grad, x):
    """The output's gradient as the backward kernels take it: of x's shape,
    dtype and device, contiguous and 16-byte aligned. One that is not
    contiguous or aligned is copied (counted in `BACKWARD_COPIES`)."""
    if grad.shape != x.shape or grad.dtype != x.dtype or grad.device != x.device:
        raise ValueError(f"the gradient ({tuple(grad.shape)}, {grad.dtype}, {grad.device}) "
                         f"does not match x ({tuple(x.shape)}, {x.dtype}, {x.device})")
    if not grad.is_contiguous() or grad.data_ptr() % 16:
        BACKWARD_COPIES["grad"] += 1
        grad = grad.clone(memory_format=torch.contiguous_format)
    return grad


def _backward_channel_padded(launch, x, mean, rstd, grad, *args):
    """`launch(x, mean, rstd, grad, *args) -> dx`, a backward kernel that
    needs C to be a multiple of `channel_block`, on any C: x, the gradient
    and the statistics are padded with zeros, and dx is cut back to C.
    Exact: a zero channel (x, mean and rstd 0) has y = 0 and a zero
    gradient, so it adds nothing to the sums and gets dx = 0."""
    c, cb = x.shape[-1], channel_block(x.dtype)
    if c % cb == 0:
        return launch(x, mean, rstd, grad, *args)
    pad = (0, cb - c % cb)
    padded = (torch.nn.functional.pad(t, pad) for t in (x, mean, rstd, grad))
    return launch(*padded, *args)[..., :c].contiguous()


def backward_onepass(x, mean, rstd, grad, activation="none", negative_slope=0.2):
    """The one-pass backward kernel on CUDA tensors, at
    `backward_onepass_geometry`: dx of the forward's `x` from its fp32
    `mean` and `rstd` (N, C) and the output's gradient."""
    _check_input(x)
    if pick_kernel(x.shape, x.dtype) != "onepass":
        raise ValueError(f"slab of {math.prod(x.shape[1:-1])} rows does not fit the "
                         f"one-pass kernel")
    dx = _backward_channel_padded(_launch_backward_onepass, x, mean, rstd,
                                  _grad_operand(grad, x), activation, negative_slope)
    BACKWARD_LAUNCHES["onepass"] += 1
    return dx


def _launch_backward_onepass(x, mean, rstd, grad, activation, negative_slope):
    """The one-pass backward kernel at `backward_onepass_geometry`, on
    checked operands."""
    n, c, s = x.shape[0], x.shape[-1], math.prod(x.shape[1:-1])
    g, k, _, _ = backward_onepass_geometry(x.shape, x.dtype)
    dx = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _check(library().norm_bwd_onepass(
        x.data_ptr(), grad.data_ptr(), mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(), n, s, c,
        _DTYPE_CODES[x.dtype], g, k, _ACT_CODES[activation], negative_slope, stream),
        "norm_bwd_onepass")
    return dx


def backward_split(x, mean, rstd, grad, activation="none", negative_slope=0.2, shards=None):
    """The split backward kernels (sums with their fold, dx) on CUDA
    tensors, at `split_geometry`; returns dx. `shards`: `x` is a slab of
    spatially sharded samples; the sums are all-reduced over the shards
    between the two kernels and divided by the whole samples' count."""
    _check_input(x)
    pick_kernel(x.shape, x.dtype)
    dx = _backward_channel_padded(_launch_backward_split, x, mean, rstd,
                                  _grad_operand(grad, x), activation, negative_slope, shards)
    BACKWARD_LAUNCHES["split"] += 1
    return dx


def _launch_backward_split(x, mean, rstd, grad, activation, negative_slope, shards):
    """The split backward kernels at `split_geometry`, in `SPLIT_REVERSE`
    order, on checked operands."""
    n, c, s = x.shape[0], x.shape[-1], math.prod(x.shape[1:-1])
    tile_rows, seg_bytes, threads, _ = split_geometry(x.shape, x.dtype)
    tiles = -(-s // tile_rows)
    partial = torch.empty((n, tiles, 2, c), device=x.device, dtype=torch.float32)
    sums = torch.empty((2, n, c), device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    arrivals = _arrivals(x.device, stream, n * (c * x.element_size() // seg_bytes) * (tiles + 1))
    dtype, act = _DTYPE_CODES[x.dtype], _ACT_CODES[activation]
    _check(library().norm_bwd_sums(
        x.data_ptr(), grad.data_ptr(), mean.data_ptr(), rstd.data_ptr(), partial.data_ptr(),
        arrivals.data_ptr(), sums[0].data_ptr(), sums[1].data_ptr(), n, s, c, dtype, seg_bytes,
        tile_rows, threads, act, negative_slope, stream), "norm_bwd_sums")
    count = s
    if shards is not None:
        shards.all_reduce(sums)
        count = s * shards.size
    dx = torch.empty_like(x)
    _check(library().norm_bwd_dx(
        x.data_ptr(), grad.data_ptr(), mean.data_ptr(), rstd.data_ptr(), sums[0].data_ptr(),
        sums[1].data_ptr(), dx.data_ptr(), n, s, c, dtype, seg_bytes, tile_rows, threads,
        int(SPLIT_REVERSE), float(count), act, negative_slope, stream), "norm_bwd_dx")
    return dx


BACKWARD_KERNELS = {"onepass": backward_onepass, "split": backward_split}


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
                           negative_slope: float = 0.2, shards=None):
    """The gradient with respect to `x` of `instance_norm`, given the
    forward's fp32 `mean` and `rstd` (N, C) and the output's gradient `grad`
    (any layout). Computed in fp32 and returned in `x.dtype`; mirrors the
    JAX package's `_bwd`. `shards`: `x` is a slab of sharded samples, and
    the two means span the whole samples."""
    n, c = x.shape[0], x.shape[-1]
    axes = tuple(range(1, x.ndim - 1))
    stat_shape = (n,) + (1,) * (x.ndim - 2) + (c,)
    mean, rstd = mean.reshape(stat_shape), rstd.reshape(stat_shape)
    y = (x.float() - mean) * rstd                   # pre-activation output
    gy = grad.float()
    if activation != "none":
        gy = gy * _act_grad(y, activation, negative_slope)
    if shards is None:
        mean_gy = gy.mean(dim=axes, keepdim=True)
        mean_gy_y = (gy * y).mean(dim=axes, keepdim=True)
    else:
        sums = torch.stack([gy.sum(dim=axes, keepdim=True), (gy * y).sum(dim=axes, keepdim=True)])
        shards.all_reduce(sums)
        sums = sums / (math.prod(x.shape[1:-1]) * shards.size)
        mean_gy, mean_gy_y = sums[0], sums[1]
    return (rstd * (gy - mean_gy - y * mean_gy_y)).to(x.dtype)


def instance_norm_grad(x, mean, rstd, grad, activation: str = "none",
                       negative_slope: float = 0.2, shards=None):
    """dx of `instance_norm`: `instance_norm_backward` for a CPU tensor; for
    a CUDA tensor the backward kernels, the split pair for a sharded slab,
    else the form that `pick_kernel` picks for the forward."""
    if x.device.type == "cpu":
        return instance_norm_backward(x, mean, rstd, grad, activation, negative_slope, shards)
    x, mean, rstd = x.contiguous(), mean.contiguous(), rstd.contiguous()
    if shards is not None:
        return backward_split(x, mean, rstd, grad, activation, negative_slope, shards)
    return BACKWARD_KERNELS[pick_kernel(x.shape, x.dtype)](x, mean, rstd, grad, activation,
                                                           negative_slope)


class InstanceNormFunction(torch.autograd.Function):
    """`instance_norm` under autograd: the forward of `instance_norm_forward`
    (a kernel for a CUDA tensor), the backward of `instance_norm_grad`
    (kernels for a CUDA tensor)."""

    @staticmethod
    def forward(ctx, x, eps, activation, negative_slope):
        out, mean, rstd = instance_norm_forward(x, eps, activation, negative_slope)
        ctx.save_for_backward(x, mean, rstd)
        ctx.activation, ctx.negative_slope = activation, negative_slope
        return out

    @staticmethod
    def backward(ctx, grad):
        x, mean, rstd = ctx.saved_tensors
        dx = instance_norm_grad(x, mean, rstd, grad, ctx.activation, ctx.negative_slope)
        return dx, None, None, None


# ------------------------------------------------------- sharded statistics


def partial_stats_reference(x):
    """Plain PyTorch (mean, M2) of each (sample, channel) of an
    `(N, *spatial, C)` slab, fp32, each (N, C): what the stats kernel's
    (mean, M2) mode writes."""
    axes = tuple(range(1, x.ndim - 1))
    x32 = x.float()
    mean = x32.mean(dim=axes, keepdim=True)
    m2 = (x32 - mean).square().sum(dim=axes)
    n, c = x.shape[0], x.shape[-1]
    return mean.reshape(n, c), m2


def fold_shard_stats(slots, count: int, eps: float):
    """Chan et al.'s merge, in rank order, of the shards' (mean, M2) in
    `slots` (shards, N, 2, C) fp32, each shard over `count` rows; returns
    the global fp32 `(mean, rstd)`, each (N, C). Every rank folds the same
    slots in the same order, so every rank gets the same numbers."""
    total, mean, m2 = 0.0, torch.zeros_like(slots[0, :, 0]), torch.zeros_like(slots[0, :, 1])
    for part in slots:
        merged = total + count
        delta = part[:, 0] - mean
        mean = mean + delta * (count / merged)
        m2 = m2 + part[:, 1] + delta.square() * (total * count / merged)
        total = merged
    return mean, torch.rsqrt(m2 / total + eps)


def _merge_shards(mean, m2, x, eps, shards):
    """The whole samples' (mean, rstd) from this slab's `mean` and `m2` of
    `x`: written into this rank's slot of a zeroed (shards, N, 2, C) fp32
    tensor, summed over the shards, folded (`fold_shard_stats`)."""
    slots = torch.zeros((shards.size, mean.shape[0], 2, mean.shape[1]), dtype=torch.float32,
                        device=x.device)
    slots[shards.index, :, 0] = mean
    slots[shards.index, :, 1] = m2
    shards.all_reduce(slots)
    return fold_shard_stats(slots, math.prod(x.shape[1:-1]), eps)


def sharded_instance_norm_forward(x, eps, activation, negative_slope, shards):
    """`(out, mean, rstd)` of a spatially sharded `x` with the whole
    sample's statistics (`shards`: `.size`, `.index` and an in-place sum
    `.all_reduce(t)` over the ranks that hold the sample's slabs). A CUDA
    tensor takes the split kernel pair, counted as one split launch; a CPU
    tensor the plain version (`partial_stats_reference`, the same merge)."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {ACTIVATIONS}, got {activation!r}")
    if x.device.type == "cpu":
        mean, rstd = _merge_shards(*partial_stats_reference(x), x, eps, shards)
        stat_shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
        y = (x.float() - mean.reshape(stat_shape)) * rstd.reshape(stat_shape)
        return _act(y, activation, negative_slope).to(x.dtype), mean, rstd
    x = x.contiguous()
    _check_input(x)
    pick_kernel(x.shape, x.dtype)
    result = _channel_padded(_sharded_split, x, eps, activation, negative_slope, shards)
    LAUNCHES["split"] += 1
    return result


class ShardedInstanceNormFunction(torch.autograd.Function):
    """`instance_norm(..., shards=...)` under autograd: the backward of
    `instance_norm_grad` with its two per-(n, c) means taken over the whole
    sample (sums all-reduced over the shards, over the global count)."""

    @staticmethod
    def forward(ctx, x, eps, activation, negative_slope, shards):
        out, mean, rstd = sharded_instance_norm_forward(x, eps, activation, negative_slope,
                                                        shards)
        ctx.save_for_backward(x, mean, rstd)
        ctx.activation, ctx.negative_slope, ctx.shards = activation, negative_slope, shards
        return out

    @staticmethod
    def backward(ctx, grad):
        x, mean, rstd = ctx.saved_tensors
        dx = instance_norm_grad(x, mean, rstd, grad, ctx.activation, ctx.negative_slope,
                                shards=ctx.shards)
        return dx, None, None, None, None


def instance_norm(x, eps: float = 1e-5, activation: str = "none",
                  negative_slope: float = 0.2, shards=None):
    """Fused instance norm + optional activation over `(N, *spatial, C)`,
    differentiable with respect to `x`. Without a gradient to record (as in
    serving), the forward runs without the autograd wrapper. `shards`: `x`
    is one rank's slab of spatially sharded samples, normalised with the
    whole samples' statistics (`sharded_instance_norm_forward`)."""
    if shards is not None:
        if not (torch.is_grad_enabled() and x.requires_grad):
            return sharded_instance_norm_forward(x, eps, activation, negative_slope, shards)[0]
        return ShardedInstanceNormFunction.apply(x, eps, activation, negative_slope, shards)
    if not (torch.is_grad_enabled() and x.requires_grad):
        return instance_norm_forward(x, eps, activation, negative_slope)[0]
    return InstanceNormFunction.apply(x, eps, activation, negative_slope)
