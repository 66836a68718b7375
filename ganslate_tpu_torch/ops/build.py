"""Build and bind the port's CUDA kernels.

Each `csrc/*.cu` source has a plain `extern "C"` interface. At first use it
is compiled with `nvcc` into a shared library under `build/ganslate_tpu_torch/`
(beside the package, listed in `.gitignore`), named by a hash of the source
and the flags, and loaded with `ctypes`. Nothing here runs at import time, so
the package imports on machines without a GPU or `nvcc`; a missing `nvcc` or
a failed build raises.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE_DIR = _PACKAGE_DIR / "csrc"
BUILD_DIR = _PACKAGE_DIR.parent / "build" / "ganslate_tpu_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libraries = {}


def find_nvcc() -> str:
    """The CUDA compiler under PyTorch's CUDA_HOME (which reads `$CUDA_HOME`,
    `$CUDA_PATH`, the PATH and /usr/local/cuda)."""
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = Path(CUDA_HOME or "/nonexistent") / "bin" / "nvcc"
    if not nvcc.is_file():
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on the PATH): the port's "
            "CUDA kernels are compiled from csrc/ at first use")
    return str(nvcc)


def library_path(source: str) -> Path:
    """Where the library built from `csrc/<source>` lives."""
    text = (SOURCE_DIR / source).read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}_{digest}.so"


def build(source: str) -> Path:
    """Compile `csrc/<source>` unless its library exists; returns its path.

    The compiler's report (`-Xptxas -v`: registers, shared memory and
    spills of each kernel) is kept beside the library as `<name>.log`."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE_DIR / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {source}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent process never sees half a file
    return out


def load(source: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<source>`, declaring each function's
    `(argtypes, restype)` from `signatures`. Pointers and streams must be
    declared `c_void_p`, or ctypes passes them as 32-bit ints."""
    with _lock:
        lib = _libraries.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            for name, (argtypes, restype) in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _libraries[source] = lib
        return lib
