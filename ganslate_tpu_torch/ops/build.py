"""Build and bind the port's native code: the CUDA kernels and the host data ops.

Each `csrc/*.cu` source has a plain `extern "C"` interface. At first use it
is compiled with `nvcc` into a shared library under `build/ganslate_tpu_torch/`
(beside the package, listed in `.gitignore`), named by a hash of the source
and the flags, and loaded with `ctypes`. The host C++ of `native/*.cpp` takes
the same way through the host compiler (`$CXX`, else `g++`) with
`HOST_FLAGS`; since `-march=native` compiles for the CPU it runs on, its
library's name also hashes that CPU and the compiler's version, so a
`build/` carried to another machine is rebuilt, not loaded. Nothing here
runs at import time, so the package imports on machines without a GPU,
`nvcc` or `g++`; a missing compiler or a failed build raises.
"""

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

_PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE_DIR = _PACKAGE_DIR / "csrc"
HOST_SOURCE_DIR = _PACKAGE_DIR / "native"
BUILD_DIR = _PACKAGE_DIR.parent / "build" / "ganslate_tpu_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# The JAX package's flags for its host data ops, exactly: the bits of the
# expressions that the compiler contracts into FMAs depend on them.
HOST_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")

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


def find_cxx() -> str:
    """The host C++ compiler: `$CXX`, else `g++`, on the PATH."""
    name = os.environ.get("CXX") or "g++"
    cxx = shutil.which(name)
    if cxx is None:
        raise RuntimeError(
            f"host C++ compiler {name!r} not found (set CXX or install g++): the "
            "port's host data ops are compiled from native/ at first use")
    return cxx


def host_cpu() -> str:
    """What `-march=native` compiles for: the CPU's model name and flags
    (`/proc/cpuinfo`), else the platform's processor name."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return platform.machine() + " " + platform.processor()
    wanted = ("model name", "flags", "Features", "CPU part")
    seen = {}
    for line in lines:
        key, _, value = line.partition(":")
        key = key.strip()
        if key in wanted and key not in seen:
            seen[key] = value.strip()
    return platform.machine() + "".join(f"\n{k}: {seen[k]}" for k in wanted if k in seen)


def _named(source: Path, salt: str) -> Path:
    digest = hashlib.sha256(source.read_bytes() + salt.encode()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}_{digest}.so"


def library_path(source: str) -> Path:
    """Where the library built from `csrc/<source>` lives."""
    return _named(SOURCE_DIR / source, " ".join(NVCC_FLAGS))


def compiler_version(cxx: str) -> str:
    """The first line of `cxx --version`."""
    proc = subprocess.run([cxx, "--version"], capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} --version failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    return proc.stdout.partition("\n")[0]


def host_library_path(source: str, cxx: str = None) -> Path:
    """Where the library built from `native/<source>` by `cxx` (default
    `find_cxx()`) for this CPU lives: named by the source, the compiler and
    its version, the flags and the CPU."""
    cxx = cxx or find_cxx()
    salt = "\n".join((cxx, compiler_version(cxx), " ".join(HOST_FLAGS), host_cpu()))
    return _named(HOST_SOURCE_DIR / source, salt)


def _compile(source: Path, out: Path, cmd: list) -> Path:
    """Run `cmd` (which writes `-o <tmp>`) unless `out` exists; the
    compiler's output is kept beside the library as `<name>.log`."""
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [*cmd, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{Path(cmd[0]).name} failed ({proc.returncode}) on "
                           f"{source.name}:\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent process never sees half a file
    return out


def build(source: str) -> Path:
    """Compile `csrc/<source>` unless its library exists; returns its path.

    The compiler's report (`-Xptxas -v`: registers, shared memory and
    spills of each kernel) is kept beside the library as `<name>.log`."""
    out = library_path(source)
    if out.exists():
        return out
    return _compile(SOURCE_DIR / source, out, [find_nvcc(), *NVCC_FLAGS])


def build_host(source: str) -> Path:
    """Compile `native/<source>` with the host compiler unless its library
    exists; returns its path."""
    cxx = find_cxx()
    return _compile(HOST_SOURCE_DIR / source, host_library_path(source, cxx),
                    [cxx, *HOST_FLAGS])


def _load(key, path_of, signatures: dict) -> ctypes.CDLL:
    with _lock:
        lib = _libraries.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(path_of()))
            for name, (argtypes, restype) in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _libraries[key] = lib
        return lib


def load(source: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<source>`, declaring each function's
    `(argtypes, restype)` from `signatures`. Pointers and streams must be
    declared `c_void_p`, or ctypes passes them as 32-bit ints."""
    return _load(source, lambda: build(source), signatures)


def load_host(source: str, signatures: dict) -> ctypes.CDLL:
    """`load` for the host C++ of `native/<source>`."""
    return _load(("host", source), lambda: build_host(source), signatures)
