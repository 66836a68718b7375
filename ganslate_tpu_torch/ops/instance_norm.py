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

- ``onepass`` (replaces `_pallas_forward`): one block holds one sample's
  (S, CB) channel block in shared memory and reads it from device memory
  once. Taken while that slab fits a block's shared memory.
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
# channels. The channel count must be a multiple of CB.
ROW_BYTES = 32
# Largest slab (S rows x 32 bytes) the one-pass kernel keeps in shared
# memory. A Hopper block may use 227 KB; the kernel's own reduction scratch
# (about 1.2 KB) and some headroom come off that.
ONEPASS_MAX_SMEM = 200 * 1024

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
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
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
    """One-pass kernel on a CUDA tensor; returns `(out, mean, rstd)`."""
    _check_input(x)
    pick_kernel(x.shape, x.dtype)
    n, c, s = x.shape[0], x.shape[-1], math.prod(x.shape[1:-1])
    if s * ROW_BYTES > ONEPASS_MAX_SMEM:
        raise ValueError(f"slab of {s} rows does not fit the one-pass kernel")
    out, mean, rstd = _outputs(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = library().inorm_onepass(
        x.data_ptr(), out.data_ptr(), mean.data_ptr(), rstd.data_ptr(), n, s, c,
        _DTYPE_CODES[x.dtype], eps, _ACT_CODES[activation], negative_slope, stream)
    _check(err, "inorm_onepass")
    LAUNCHES["onepass"] += 1
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
