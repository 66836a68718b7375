"""Fused instance norm (+ activation) forward: CUDA kernels and their plain
PyTorch version.

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
- ``split`` (replaces `_pallas_forward_tiled`): per-tile (mean, M2)
  partials, a Chan merge over the tiles, then a normalise pass. Taken for
  larger slabs.

At CycleGAN-256 this sends the down1 and residual norms (64x64x256) to the
one-pass form and the stem, down0 and up norms (S >= 16384) to the split
form. Each wrapper counts its launches in `LAUNCHES`, so a caller can show
which kernels a run went through.

Forward only: a CUDA tensor that needs a gradient raises (the backward is a
later port step).
"""

import ctypes
import math

import torch

ACTIVATIONS = ("none", "relu", "leaky_relu")
_ACT_CODES = {"none": 0, "relu": 1, "leaky_relu": 2}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# One row of a channel block is 32 bytes: CB = 8 float or 16 bfloat16
# channels. The channel count must be a multiple of CB (the split form's
# block width and the one-pass form's narrowest row segment).
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

SOURCE = "instance_norm.cu"

#: Launches per kernel form since the last `reset_launches()`. The split form
#: counts one launch per call (its stats, fold and normalise kernels run
#: together).
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


def pick_kernel(shape, dtype: torch.dtype) -> str:
    """'onepass' when a sample's (S, CB) slab fits one block's shared
    memory, else 'split'. Raises for shapes the kernels do not take."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"instance_norm kernels take float32 or bfloat16, got {dtype}")
    if len(shape) not in (4, 5):
        raise ValueError(f"instance_norm kernels take (N, *spatial, C) with 2 or 3 "
                         f"spatial dims, got shape {tuple(shape)}")
    c = shape[-1]
    cb = channel_block(dtype)
    if c % cb:
        raise ValueError(f"instance_norm kernels need C divisible by {cb} for {dtype}, "
                         f"got C={c}")
    s = math.prod(shape[1:-1])
    return "onepass" if s * ROW_BYTES <= ONEPASS_MAX_SMEM else "split"


# ------------------------------------------------------------------ kernels


_SIGNATURES = {
    "inorm_onepass": (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
        ctypes.c_int),
    "inorm_split_stats": (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
        ctypes.c_int),
    "inorm_split_fold": (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p],
        ctypes.c_int),
    "inorm_split_norm": (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p],
        ctypes.c_int),
    "inorm_split_tile_rows": ([], ctypes.c_int),
}


def library():
    """The built and loaded kernel library (built at first use)."""
    from ganslate_tpu_torch.ops import build
    return build.load(SOURCE, _SIGNATURES)


def _check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def _check_input(x):
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            "instance_norm on CUDA is forward only: the backward kernel comes "
            "with the training port. Run under torch.no_grad() or "
            "torch.inference_mode().")
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
    g, k, _, _ = onepass_geometry(x.shape, x.dtype)
    result = _launch_onepass(x, g, k, eps, activation, negative_slope)
    LAUNCHES["onepass"] += 1
    return result


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
    """Split (stats, fold, normalise) kernels on a CUDA tensor; returns
    `(out, mean, rstd)`."""
    _check_input(x)
    pick_kernel(x.shape, x.dtype)
    n, c, s = x.shape[0], x.shape[-1], math.prod(x.shape[1:-1])
    lib = library()
    n_tiles = -(-s // lib.inorm_split_tile_rows())
    out, mean, rstd = _outputs(x)
    partial = torch.empty((n, n_tiles, 2, c), device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    dtype = _DTYPE_CODES[x.dtype]
    _check(lib.inorm_split_stats(x.data_ptr(), partial.data_ptr(), n, s, c, dtype,
                                 stream), "inorm_split_stats")
    _check(lib.inorm_split_fold(partial.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                                n, s, c, eps, stream), "inorm_split_fold")
    _check(lib.inorm_split_norm(x.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                                out.data_ptr(), n, s, c, dtype, _ACT_CODES[activation],
                                negative_slope, stream), "inorm_split_norm")
    LAUNCHES["split"] += 1
    return out, mean, rstd


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


def instance_norm(x, eps: float = 1e-5, activation: str = "none",
                  negative_slope: float = 0.2):
    """Fused instance norm + optional activation over `(N, *spatial, C)`."""
    return instance_norm_forward(x, eps, activation, negative_slope)[0]
