"""The one-pass cluster kernel's geometry and arithmetic, on the CPU.

`onepass_geometry` (ganslate_tpu_torch/ops/instance_norm.py) is pure Python:
it is checked here at every shape `chip_smoke.py` runs on the card. The
kernel itself runs only on a GPU, so its arithmetic is emulated in numpy,
step for step in fp32: each cluster rank's local mean and its M2 around that
mean, then Chan's merge of the ranks in rank order. The emulation is held
against the JAX package's `_xla_forward` and against `_pallas_forward` in
interpret mode, including ragged rank splits (S % K != 0) and |mean| >> std,
where E[x^2] - E[x]^2 cancels."""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import ganslate_tpu.ops.instance_norm as in_mod
from ganslate_tpu_torch.ops import instance_norm as port

ACTIVATIONS = ("none", "relu", "leaky_relu")
# Largest shared memory a Hopper block may use, less the kernel's static
# scratch (reduction buffer and statistics: at most 3 KB).
BLOCK_SMEM_CAP = 227 * 1024 - 3 * 1024

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

_xla_forward = jax.jit(in_mod._xla_forward, static_argnums=(1, 2, 3))


def _rank_rows(s, k):
    """Rows [lo, hi) of each cluster rank, as the kernel's rank_row."""
    return [(r * s // k, (r + 1) * s // k) for r in range(k)]


def _block_sum(v, step):
    """Sum over axis 1 of (N, rows, C) in fp32 as a block sums: each thread
    adds every step-th row in turn, then the threads' sums are added."""
    n, r, c = v.shape
    v = np.concatenate([v, np.zeros((n, -r % step, c), np.float32)], axis=1)
    return v.reshape(n, -1, step, c).sum(axis=1, dtype=np.float32).sum(axis=1, dtype=np.float32)


def _emulate(x, dtype, eps, activation, slope):
    """The cluster kernel's arithmetic on an (N, *spatial, C) numpy array, at
    `onepass_geometry`'s (G, K) for `dtype`, in fp32: per-rank (mean, M2),
    then Chan's merge in rank order. Returns (out in fp32, mean, rstd)."""
    n, c = x.shape[0], x.shape[-1]
    g, k, _, _ = port.onepass_geometry(x.shape, dtype)
    # kOnepassThreads = 256 threads, g * itemsize / 16 of them per row.
    step = 256 // (g * dtype.itemsize // 16)
    x32 = x.reshape(n, -1, c).astype(np.float32)
    s = x32.shape[1]
    count = np.zeros((n, c), np.float32)
    mean = np.zeros((n, c), np.float32)
    m2 = np.zeros((n, c), np.float32)
    for lo, hi in _rank_rows(s, k):
        rows = x32[:, lo:hi]
        nb = np.float32(hi - lo)
        mb = _block_sum(rows, step) / nb
        m2b = _block_sum(np.square(rows - mb[:, None]), step)
        total = count + nb
        d = mb - mean
        mean = mean + d * (nb / total)
        m2 = m2 + m2b + d * d * (count * nb / total)
        count = total
    rstd = np.float32(1) / np.sqrt(m2 / np.float32(s) + np.float32(eps))
    y = (x32 - mean[:, None]) * rstd[:, None]
    if activation == "relu":
        y = np.maximum(y, 0)
    elif activation == "leaky_relu":
        y = np.where(y >= 0, y, y * np.float32(slope))
    return y.reshape(x.shape), mean, rstd


def _inputs(shape, dtype, seed, scale, shift):
    """The same values for both packages: fp32 numpy, rounded to bf16 where
    asked (both round to nearest even)."""
    x = (np.random.default_rng(seed).normal(size=shape) * scale + shift).astype(np.float32)
    if dtype == "bfloat16":
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return x


def _assert_emulation_matches(got, want, dtype, out_atol=1e-5, rstd_rtol=1e-5):
    out_e, mean_e, rstd_e = got
    out_w, mean_w, rstd_w = (np.asarray(a, np.float32) for a in want)
    # Statistics are fp32 in both; only the summation order differs.
    np.testing.assert_allclose(mean_e, mean_w, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rstd_e, rstd_w, rtol=rstd_rtol)
    if dtype == "bfloat16":
        # The kernel casts its fp32 result to bf16; it may round to the
        # neighbouring bf16 value of the reference's: one bf16 ulp is at most
        # 2**-7 of the value.
        out_e = torch.from_numpy(out_e).to(torch.bfloat16).float().numpy()
        np.testing.assert_allclose(out_e, out_w, rtol=2 ** -7, atol=1e-6)
    else:
        np.testing.assert_allclose(out_e, out_w, rtol=1e-5, atol=out_atol)


# ------------------------------------------------------------------ geometry


def _onepass_shapes():
    shapes = chip_smoke.SLABS + chip_smoke.EDGE_SHAPES
    return [s for s in shapes if port.pick_kernel(s, torch.float32) == "onepass"]


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32), ids=("bf16", "f32"))
@pytest.mark.parametrize("shape", chip_smoke.SLABS + chip_smoke.EDGE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_geometry_at_chip_smoke_shapes(shape, dtype):
    kernel = port.pick_kernel(shape, dtype)
    s, c, n = math.prod(shape[1:-1]), shape[-1], shape[0]
    if kernel == "split":
        assert s * port.ROW_BYTES > port.ONEPASS_MAX_SMEM
        assert chip_smoke.chosen_geometry(kernel, shape, dtype) == {}
        return
    g, k, rows, smem = port.onepass_geometry(shape, dtype)
    seg = g * dtype.itemsize
    assert c % g == 0
    assert seg % 16 == 0 and seg in (32, 64, 128)
    # A cluster of up to 8 is portable; 16 needs the non-portable attribute,
    # which the launcher sets. The rule takes no more than 8.
    assert k in port.ONEPASS_CLUSTER_SIZES and k <= 8
    assert smem == rows * seg <= min(port.ONEPASS_MAX_SMEM, BLOCK_SMEM_CAP)
    spans = _rank_rows(s, k)
    assert spans[0][0] == 0 and spans[-1][1] == s
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert all(1 <= hi - lo <= rows for lo, hi in spans)
    assert rows == max(hi - lo for lo, hi in spans) == -(-s // k)
    blocks = k * (c // g) * n
    assert blocks >= min(port.ONEPASS_MIN_BLOCKS, 8 * (c // g) * n)
    assert chip_smoke.chosen_geometry(kernel, shape, dtype) == {
        "G": g, "K": k, "blocks": blocks, "smem_bytes": smem}


@pytest.mark.parametrize("batch, dtype, want", [
    (16, torch.bfloat16, (32, 4, 512)),
    (16, torch.float32, (16, 4, 1024)),
    (1, torch.bfloat16, (32, 8, 64)),
    (1, torch.float32, (16, 4, 64)),
])
def test_geometry_at_the_main_slabs(batch, dtype, want):
    """The residual slab (N, 64, 64, 256): 64-byte segments, at most 64 KB a
    block (3 blocks per SM), at least 64 blocks; 16 at batch 1 before."""
    shape = (batch, 64, 64, 256)
    g, k, rows, smem = port.onepass_geometry(shape, dtype)
    assert (g, k, k * (256 // g) * batch) == want
    assert smem <= port.ONEPASS_BLOCK_SMEM
    assert g * dtype.itemsize == port.ONEPASS_SEGMENT_BYTES


def test_edge_shapes_hold_a_ragged_rank_split():
    """chip_smoke.py checks a one-pass shape whose rows do not split evenly
    over the cluster, in both dtypes."""
    ragged = [s for s in _onepass_shapes()
              for dtype in (torch.bfloat16, torch.float32)
              if math.prod(s[1:-1]) % port.onepass_geometry(s, dtype)[1]]
    assert (1, 4097, 1, 64) in ragged


@pytest.mark.parametrize("s", (1, 3, 7, 9, 1073, 4097, 6400))
def test_geometry_never_leaves_a_rank_empty(s):
    for c, dtype in ((16, torch.bfloat16), (64, torch.float32), (256, torch.bfloat16)):
        g, k, rows, _ = port.onepass_geometry((1, s, 1, c), dtype)
        assert k <= s
        assert all(hi > lo for lo, hi in _rank_rows(s, k))


# ---------------------------------------------------------------- arithmetic


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("shape", ((2, 37, 29, 16), (1, 4, 6, 6, 32)), ids=("2d", "3d"))
def test_emulation_matches_xla_forward(shape, dtype, activation):
    """Ragged 2D (S = 1073 over K = 8) and a 3D volume, at the geometry's
    (G, K)."""
    x = _inputs(shape, dtype, seed=5, scale=3.0, shift=1.5)
    xj = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    _assert_emulation_matches(_emulate(x, getattr(torch, dtype), 1e-5, activation, 0.2),
                              _xla_forward(xj, 1e-5, activation, 0.2), dtype)


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_emulation_matches_pallas_onepass_interpret(activation):
    """Against the TPU kernel itself (interpret mode), with S % K != 0."""
    shape = (2, 37, 29, 16)
    assert math.prod(shape[1:-1]) % port.onepass_geometry(shape, torch.float32)[1]
    x = _inputs(shape, "float32", seed=6, scale=2.0, shift=1.0)
    in_mod._INTERPRET = True
    try:
        want = in_mod._pallas_forward(jnp.asarray(x), 1e-5, activation, 0.2)
    finally:
        in_mod._INTERPRET = False
    _assert_emulation_matches(_emulate(x, torch.float32, 1e-5, activation, 0.2), want,
                              "float32")


@pytest.mark.parametrize("shape", ((2, 4097, 1, 16), (1, 64, 64, 256)),
                         ids=("ragged", "residual"))
def test_emulation_large_mean(shape):
    """|mean| >> std (mean 1e3, std 0.1, fp32): the ranks' M2 around their
    own means and Chan's merge keep the variance, where E[x^2] - E[x]^2
    loses it. Held against the exact statistics (float64) and `_xla_forward`."""
    x = _inputs(shape, "float32", seed=7, scale=0.1, shift=1e3)
    out, mean, rstd = _emulate(x, torch.float32, 1e-5, "none", 0.2)
    x64 = x.reshape(shape[0], -1, shape[-1]).astype(np.float64)
    mean64 = x64.mean(axis=1)
    rstd64 = 1 / np.sqrt(np.square(x64 - mean64[:, None]).mean(axis=1) + 1e-5)
    # Each rank's mean is an fp32 number near 1e3, whose ulp (6e-5) is 6e-4
    # of the std; the merge takes the ranks' differences with that error, so
    # the variance keeps about 4 digits: rstd within 2e-4. The mean is off
    # by a few such ulps. `_xla_forward`'s own fp32 mean is off by up to 7e-4
    # here, 7e-3 of the std, and the outputs differ by about that.
    np.testing.assert_allclose(mean, mean64, rtol=0, atol=4e-4)
    np.testing.assert_allclose(rstd, rstd64, rtol=2e-4)
    want = _xla_forward(jnp.asarray(x), 1e-5, "none", 0.2)
    np.testing.assert_allclose(mean, np.asarray(want[1]), rtol=0, atol=8e-4)
    np.testing.assert_allclose(rstd, np.asarray(want[2]), rtol=2e-4)
    np.testing.assert_allclose(out, np.asarray(want[0]), rtol=0, atol=1e-2)
    naive_var = np.square(x64.astype(np.float32)).mean(axis=1, dtype=np.float32) - \
        np.square(x64.astype(np.float32).mean(axis=1, dtype=np.float32))
    naive_rstd = 1 / np.sqrt(np.maximum(naive_var, 0) + np.float32(1e-5))
    assert np.abs(naive_rstd / rstd64 - 1).max() > 0.1
