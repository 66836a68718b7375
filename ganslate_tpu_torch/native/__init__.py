"""The host data ops: multithreaded C++ for the medical data path's
whole-volume normalisation, masked fill and patch copy (the JAX package's
`native/`, with the port's own copy of its source, `dataops.cpp`).

Every entry point takes and returns numpy arrays, float32. At first use the
library is compiled by the host compiler with the JAX package's flags into
`build/ganslate_tpu_torch/` (`ops/build.py:build_host`) and loaded with
`ctypes`, which releases the GIL during each call, so a loader thread's op
overlaps the training thread. A missing compiler or a failed build raises:
no entry point turns it into a numpy result. The C code's arithmetic is not
numpy's (`clip_minmax_normalize` multiplies by 2 / (hi - lo), and GCC
contracts that and the z-score's rescale into fused multiply-adds;
`mean_std` sums in float64 over threads), so the same input gives the JAX
package's native bits, not its numpy bits.

Beside each entry point is its plain numpy version (`*_plain`): the same
function without the library, which the tests and `chip_smoke.py` hold the
entry point against. The data path never calls them.

`CALLS` counts, per entry point, the calls that reached the library since
`reset_calls()`.
"""

import ctypes
import threading
from typing import Tuple

import numpy as np

from ganslate_tpu_torch.ops import build

SOURCE = "dataops.cpp"

_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_ubyte)
_F64P = ctypes.POINTER(ctypes.c_double)
_I64 = ctypes.c_int64
_F32 = ctypes.c_float
_SIGNATURES = {
    "clip_minmax_normalize_f32": ([_F32P, _F32P, _I64, _F32, _F32], None),
    "mean_std_f32": ([_F32P, _I64, _F64P, _F64P], None),
    "zscore_normalize_f32": ([_F32P, _F32P, _I64, _F32, _F32, ctypes.c_int, _F32, _F32,
                              _F32, _F32], None),
    "extract_patch_f32": ([_F32P, _F32P] + [_I64] * 9, None),
    "masked_fill_f32": ([_F32P, _U8P, _F32P, _I64, _F32], None),
}

CALLS = {"clip_minmax_normalize": 0, "mean_std": 0, "z_score_normalize": 0,
         "extract_patch": 0, "masked_fill": 0}
_calls_lock = threading.Lock()


def reset_calls():
    with _calls_lock:
        for name in CALLS:
            CALLS[name] = 0


def library() -> ctypes.CDLL:
    """The loaded library, built at first use; raises if it cannot be."""
    return build.load_host(SOURCE, _SIGNATURES)


def _counted(op: str) -> ctypes.CDLL:
    lib = library()
    with _calls_lock:
        CALLS[op] += 1
    return lib


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def _ptr(a):
    return a.ctypes.data_as(_F32P)


# ------------------------------------------------------------ the entry points


def clip_minmax_normalize(array, lo: float, hi: float) -> np.ndarray:
    """2 * (clip(x, lo, hi) - lo) / (hi - lo) - 1, multithreaded."""
    x = _f32(array)
    out = np.empty_like(x)
    _counted("clip_minmax_normalize").clip_minmax_normalize_f32(
        _ptr(x), _ptr(out), x.size, _F32(lo), _F32(hi))
    return out


def mean_std(array) -> Tuple[float, float]:
    """The population mean and standard deviation, summed in float64."""
    x = _f32(array)
    mean = ctypes.c_double()
    std = ctypes.c_double()
    _counted("mean_std").mean_std_f32(_ptr(x), x.size, ctypes.byref(mean),
                                      ctypes.byref(std))
    return mean.value, std.value


def z_score_normalize(array, scale_to_range=None) -> np.ndarray:
    """(x - mean) / std, then, given `scale_to_range`, the z-scored volume's
    [min, max] mapped onto it; multithreaded."""
    x = _f32(array)
    mean, std = mean_std(x)
    out = np.empty_like(x)
    lib = _counted("z_score_normalize")
    if scale_to_range:
        # Source scale: the z-scored volume's min and max, in double, passed
        # as float like the mean and std.
        smin = (float(x.min()) - mean) / std
        smax = (float(x.max()) - mean) / std
        lib.zscore_normalize_f32(_ptr(x), _ptr(out), x.size, _F32(mean), _F32(std), 1,
                                 _F32(smin), _F32(smax), _F32(scale_to_range[0]),
                                 _F32(scale_to_range[1]))
    else:
        lib.zscore_normalize_f32(_ptr(x), _ptr(out), x.size, _F32(mean), _F32(std), 0,
                                 0, 0, 0, 0)
    return out


def extract_patch(volume, start, size) -> np.ndarray:
    """A copy of the (dz, dy, dx) patch of a (Z, Y, X) volume at (z, y, x),
    plane by plane over threads. A volume that is not float32, C-contiguous
    and 3-D is sliced by numpy instead, as in the JAX package."""
    z, y, x = (int(v) for v in start)
    dz, dy, dx = (int(v) for v in size)
    if volume.dtype != np.float32 or not volume.flags.c_contiguous or volume.ndim != 3:
        return np.ascontiguousarray(volume[z:z + dz, y:y + dy, x:x + dx])
    if not all(0 <= o and 0 <= d and o + d <= n
               for o, d, n in zip((z, y, x), (dz, dy, dx), volume.shape)):
        raise ValueError(f"a patch of {(dz, dy, dx)} at {(z, y, x)} does not fit in a "
                         f"volume of {volume.shape}")
    out = np.empty((dz, dy, dx), np.float32)
    _counted("extract_patch").extract_patch_f32(_ptr(volume), _ptr(out), *volume.shape,
                                                z, y, x, dz, dy, dx)
    return out


def masked_fill(array, mask, fill: float) -> np.ndarray:
    """`array` (as float32) where `mask` is nonzero, `fill` elsewhere;
    multithreaded (the HX4 body mask)."""
    x = _f32(array)
    m = np.ascontiguousarray(np.asarray(mask) != 0, dtype=np.uint8)
    if m.shape != x.shape:
        raise ValueError(f"a mask of {m.shape} for an array of {x.shape}")
    out = np.empty_like(x)
    _counted("masked_fill").masked_fill_f32(_ptr(x), m.ctypes.data_as(_U8P), _ptr(out),
                                            x.size, _F32(fill))
    return out


# ------------------------------------------------------------ plain versions


def _fma(a, b, c) -> np.ndarray:
    """a * b + c for float32 operands, rounded once to float32 as a fused
    multiply-add would (the product of two float32 is exact in float64)."""
    return (np.float64(b) * a.astype(np.float64) + np.float64(c)).astype(np.float32)


def clip_minmax_normalize_plain(array, lo: float, hi: float) -> np.ndarray:
    """`clip_minmax_normalize` in numpy, in the C code's float32 order, with
    the multiply-add that GCC contracts at `-O3 -march=native` fused."""
    lo, hi = np.float32(lo), np.float32(hi)
    x = np.clip(_f32(array), lo, hi)
    return _fma(x - lo, np.float32(2) / (hi - lo), np.float32(-1))


def mean_std_plain(array) -> Tuple[float, float]:
    """`mean_std` in numpy (two passes, float64)."""
    x = _f32(array)
    return float(x.mean(dtype=np.float64)), float(x.std(dtype=np.float64))


def z_score_normalize_plain(array, scale_to_range=None) -> np.ndarray:
    """`z_score_normalize` in numpy, in the C code's float32 order, with
    the z-score's multiply and the rescale's subtraction fused as GCC
    contracts them."""
    x = _f32(array)
    mean, std = mean_std_plain(x)
    centred = x - np.float32(mean)
    inv = np.float32(1) / np.float32(std)
    if not scale_to_range:
        return centred * inv
    smin = np.float32((float(x.min()) - mean) / std)
    smax = np.float32((float(x.max()) - mean) / std)
    rmin, rmax = np.float32(scale_to_range[0]), np.float32(scale_to_range[1])
    return (rmax - rmin) * _fma(centred, inv, -smin) / (smax - smin) + rmin


def extract_patch_plain(volume, start, size) -> np.ndarray:
    """`extract_patch` by a numpy slice."""
    z, y, x = (int(v) for v in start)
    dz, dy, dx = (int(v) for v in size)
    return np.ascontiguousarray(volume[z:z + dz, y:y + dy, x:x + dx])


def masked_fill_plain(array, mask, fill: float) -> np.ndarray:
    """`masked_fill` by `np.where`."""
    return np.where(mask, _f32(array), np.float32(fill))
