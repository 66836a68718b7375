"""The port's host data ops (`ganslate_tpu_torch/native/`) against the JAX
package's `ganslate_tpu.native` and against their plain numpy versions.

Both packages compile the same C++ with the same flags (`-O3
-march=native`) on the machine that runs the tests, so each of the five ops
must give the JAX package's bits exactly, on seeded gamma-distributed
volumes below and above `parallel_for`'s serial cutoff (2^16 elements). A
difference there means the two libraries were built differently (another
compiler or CPU), not a tolerance to widen.

Against the plain versions: `masked_fill` and `extract_patch` bit for bit;
clip and z-score within 2^-22 absolute (their outputs lie in [-1, 1]; the
plain versions fuse the multiply-adds that GCC contracts, so they differ
only where a compiler contracts otherwise); `mean_std` within 1e-6
relative (float64 sums in another order).

Both `normalization` functions against the JAX package's at 2^20 - 1
elements (numpy in both) and 2^20 (native in both), bit for bit. Then the
build: a failed or missing compiler raises, the library's name hashes the
CPU, concurrent builds and calls are safe, and the port's process maps no
shared object of the JAX package."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ganslate_tpu_torch import native
from ganslate_tpu_torch.data.utils import normalization
from ganslate_tpu_torch.ops import build
from tests.torch_port_support import jax_native

REPO = Path(__file__).resolve().parents[1]
SHAPES = ((5, 31, 37), (64, 128, 128))      # serial; threaded (2^20 elements)
ATOL = 2.0 ** -22
MEAN_STD_RTOL = 1e-6


def _volume(shape, seed=0):
    return np.random.default_rng(seed).gamma(2.0, 300.0, shape).astype(np.float32)


def _mask(shape, seed=1):
    return (np.random.default_rng(seed).random(shape) < 0.6).astype(np.float32)


def _patch_of(shape):
    return (1, 2, 3), (shape[0] - 2, shape[1] - 5, shape[2] - 7)


# Each op: call(module, x, suffix) on either package's native module, or
# with the suffix "_plain" on the port's plain versions.
OPS = {
    "clip_minmax_normalize": lambda m, x, p="": getattr(m, "clip_minmax_normalize" + p)(
        x, 0.0, 2000.0),
    "mean_std": lambda m, x, p="": np.array(getattr(m, "mean_std" + p)(x)),
    "z_score_normalize": lambda m, x, p="": getattr(m, "z_score_normalize" + p)(x),
    "z_score_normalize_to_range": lambda m, x, p="": getattr(m, "z_score_normalize" + p)(
        x, (-1, 1)),
    "extract_patch": lambda m, x, p="": getattr(m, "extract_patch" + p)(x, *_patch_of(x.shape)),
    "masked_fill": lambda m, x, p="": getattr(m, "masked_fill" + p)(x, _mask(x.shape), -1024.0),
}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("op", OPS)
def test_matches_jax_bit_for_bit(op, shape):
    x = _volume(shape)
    before = dict(native.CALLS)
    got, want = OPS[op](native, x), OPS[op](jax_native(), x)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want, err_msg=(
        "the port's native build and the JAX package's disagree: two builds of "
        "dataops.cpp with the same flags on one machine must give the same bits"))
    name = op.replace("_to_range", "")
    assert native.CALLS[name] == before[name] + 1


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("op", OPS)
def test_matches_plain(op, shape):
    x = _volume(shape, seed=2)
    got, want = OPS[op](native, x), OPS[op](native, x, "_plain")
    assert got.dtype == want.dtype and got.shape == want.shape
    if op == "mean_std":
        np.testing.assert_allclose(got, want, rtol=MEAN_STD_RTOL, atol=0)
    elif op in ("extract_patch", "masked_fill"):
        np.testing.assert_array_equal(got, want)
    else:
        if op != "z_score_normalize":       # the others lie in [-1, 1], to a rounding
            assert np.abs(got).max() <= 1 + ATOL
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL * scale)


def test_extract_patch_of_other_volumes_is_a_numpy_slice():
    """Not float32, not contiguous or not 3-D: sliced by numpy, as in the JAX
    package, and never through the library."""
    x = _volume((6, 7, 8))
    before = native.CALLS["extract_patch"]
    for volume in (x.astype(np.float64), x[:, ::2], x[None]):
        got = native.extract_patch(volume, (1, 2, 3), (3, 2, 2))
        np.testing.assert_array_equal(got, jax_native().extract_patch(volume, (1, 2, 3),
                                                                      (3, 2, 2)))
        assert got.flags.c_contiguous
    assert native.CALLS["extract_patch"] == before


def test_out_of_range_arguments_raise():
    x = _volume((6, 7, 8))
    for start, size in (((4, 0, 0), (3, 7, 8)), ((0, -1, 0), (1, 1, 1)),
                        ((0, 0, 0), (1, 1, 9))):
        with pytest.raises(ValueError, match="does not fit"):
            native.extract_patch(x, start, size)
    with pytest.raises(ValueError, match="mask of"):
        native.masked_fill(x, np.ones((6, 7)), 0.0)


@pytest.mark.parametrize("size", (2 ** 20 - 1, 2 ** 20))
@pytest.mark.parametrize("fn, args", [
    ("clip_and_min_max_normalize", (-500.0, 1500.0)),
    ("z_score_normalize", ()),
    ("z_score_normalize", ((-1, 1),)),
])
def test_normalization_matches_jax_on_both_sides_of_the_threshold(fn, args, size):
    """At 2^20 elements both packages normalise natively, below it by numpy:
    the same bits either way, and the port's native calls show the route."""
    from ganslate_tpu.data.utils import normalization as jax_normalization
    jax_native()
    x = _volume((size,), seed=3)
    before = sum(native.CALLS.values())
    got = getattr(normalization, fn)(x, *args)
    assert (sum(native.CALLS.values()) > before) == (size >= normalization._NATIVE_THRESHOLD)
    want = getattr(jax_normalization, fn)(x, *args)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------- the build


def test_failed_build_raises(monkeypatch, tmp_path):
    """A compiler that fails (`false`) raises, and no entry point turns that
    into a numpy result."""
    monkeypatch.setenv("CXX", "false")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_libraries", {})
    with pytest.raises(RuntimeError, match="false"):
        native.masked_fill(np.zeros(4, np.float32), np.ones(4), 1.0)
    assert not list(tmp_path.glob("*.so"))


def test_compiler_error_raises_with_its_output(monkeypatch, tmp_path):
    """A compiler error is raised with the compiler's output, and leaves no
    library behind."""
    cxx = tmp_path / "bin" / "g++"
    cxx.parent.mkdir()
    cxx.write_text('#!/bin/sh\n[ "$1" = --version ] && echo "g++ 0" && exit 0\n'
                   "echo 'error: no such header' >&2\nexit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "_libraries", {})
    with pytest.raises(RuntimeError, match="no such header"):
        native.z_score_normalize(np.arange(4, dtype=np.float32))
    assert not list((tmp_path / "out").glob("*.so"))


def test_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_libraries", {})
    with pytest.raises(RuntimeError, match="compiler .* not found"):
        native.clip_minmax_normalize(np.zeros(4, np.float32), 0.0, 1.0)


def test_library_name_hashes_compiler_and_cpu(monkeypatch):
    """Another compiler, compiler version or CPU names another library."""
    cxx = build.find_cxx()
    path = build.host_library_path(native.SOURCE, cxx)
    assert path.parent == build.BUILD_DIR and path.name.startswith("dataops_")
    assert build.host_library_path(native.SOURCE, "c++") != path
    names = {path}
    for name, value in (("compiler_version", lambda cxx: "g++ 99"),
                        ("host_cpu", lambda: "another CPU")):
        monkeypatch.setattr(build, name, value)
        names.add(build.host_library_path(native.SOURCE, cxx))
    assert len(names) == 3


def test_concurrent_builds_and_calls(tmp_path):
    """Two processes build into one empty directory at once (the atomic
    rename), and in each, 8 threads call at once with a short switch
    interval: every result right, every call counted."""
    code = (
        "import sys, threading\n"
        "from pathlib import Path\n"
        "import numpy as np\n"
        "from ganslate_tpu_torch import native\n"
        "from ganslate_tpu_torch.ops import build\n"
        "build.BUILD_DIR = Path(sys.argv[1])\n"
        "sys.setswitchinterval(1e-6)\n"
        "x = np.arange(70000, dtype=np.float32)\n"
        "m = x % 3 != 0\n"
        "want = np.where(m, x, np.float32(-1))\n"
        "ok = []\n"
        "def work():\n"
        "    for _ in range(25):\n"
        "        ok.append(np.array_equal(native.masked_fill(x, m, -1.0), want))\n"
        "threads = [threading.Thread(target=work) for _ in range(8)]\n"
        "[t.start() for t in threads]\n"
        "[t.join(timeout=120) for t in threads]\n"
        "print(len(ok), all(ok), native.CALLS['masked_fill'],\n"
        "      any(t.is_alive() for t in threads))\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    for proc in procs:
        out, err = proc.communicate(timeout=240)
        assert proc.returncode == 0, out + err
        assert out.split() == ["200", "True", "200", "False"], out + err
    assert len(list(tmp_path.glob("*.so"))) == 1
    assert not list(tmp_path.glob("*.tmp"))


def test_maps_no_shared_object_of_the_jax_package():
    """A process that runs the port's ops has the port's library mapped and
    nothing under `ganslate_tpu/`, and imports nothing of the JAX package."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from ganslate_tpu_torch import native\n"
        "from ganslate_tpu_torch.data.utils import normalization\n"
        "normalization.z_score_normalize(np.arange(2 ** 20, dtype=np.float32), (-1, 1))\n"
        "print(sorted(m for m in sys.modules if m == 'ganslate_tpu'\n"
        "             or m.startswith(('ganslate_tpu.', 'jax'))))\n"
        "print(open('/proc/self/maps').read())\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    first, maps = proc.stdout.split("\n", 1)
    assert first == "[]"
    paths = {line.split()[-1] for line in maps.splitlines() if "/" in line}
    jax_package = str(REPO / "ganslate_tpu") + "/"
    assert not [p for p in paths if p.startswith(jax_package)]
    assert [p for p in paths if p.startswith(str(build.BUILD_DIR) + "/dataops_")]
