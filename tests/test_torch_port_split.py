"""The split instance-norm kernels' geometry and arithmetic, on the CPU.

`split_geometry` (ganslate_tpu_torch/ops/instance_norm.py) is pure Python:
it is checked here at every split shape `chip_smoke.py` runs on the card.
The kernels run only on a GPU, so their arithmetic is emulated in numpy,
step for step in fp32: each whole-row tile's mean and its M2 around that
mean, summed as a block sums them, then Chan's merge of the tiles in tile
order in two levels (groups of 16 tiles, then the groups), as the stats
kernel's last blocks do. The emulation is
held against the JAX package's `_xla_forward` and against
`_pallas_forward_tiled` in interpret mode, including a ragged last tile and
|mean| >> std, where E[x^2] - E[x]^2 cancels."""

import importlib.util
import math
import re
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import ganslate_tpu.ops.instance_norm as in_mod
from ganslate_tpu_torch.ops import instance_norm as port

ACTIVATIONS = ("none", "relu", "leaky_relu")
# Tiles merged per group by the stats kernel's first fold level (kFoldGroup
# in csrc/instance_norm.cu).
FOLD_GROUP = 16
DTYPES = (torch.bfloat16, torch.float32)
# Largest shared memory a Hopper block may use, less the split stats
# kernel's static scratch (the tile's statistics, at most 2 x 256 floats,
# and its barrier).
BLOCK_SMEM_CAP = 227 * 1024 - (2 * 256 * 4 + 16)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

_xla_forward = jax.jit(in_mod._xla_forward, static_argnums=(1, 2, 3))

SPLIT_CASES = [(shape, dtype) for shape in chip_smoke.SLABS + chip_smoke.EDGE_SHAPES
               for dtype in DTYPES if port.pick_kernel(shape, dtype) == "split"]


def _tiles(s, rows):
    """Rows [lo, hi) of each tile of one sample."""
    return [(lo, min(lo + rows, s)) for lo in range(0, s, rows)]


def _block_sum(v, step):
    """Sum over axis 1 of (N, rows, C) in fp32 as a block sums: each thread
    adds every step-th row in turn, then the threads' sums are added."""
    n, r, c = v.shape
    v = np.concatenate([v, np.zeros((n, -r % step, c), np.float32)], axis=1)
    return v.reshape(n, -1, step, c).sum(axis=1, dtype=np.float32).sum(axis=1, dtype=np.float32)


def _chan_merge(parts, n, c):
    """Chan et al.'s merge of (count, mean, M2) partials in order, in fp32,
    as the kernel's chan_fold."""
    count = np.float32(0)
    mean = np.zeros((n, c), np.float32)
    m2 = np.zeros((n, c), np.float32)
    for nb, mb, m2b in parts:
        total = count + nb
        d = mb - mean
        mean = mean + d * (nb / total)
        m2 = m2 + (m2b + d * d * (count * nb / total))
        count = total
    return count, mean, m2


def _emulate(x, dtype, eps, activation, slope, tile_rows=None):
    """The split kernels' arithmetic on an (N, *spatial, C) numpy array at
    `split_geometry`'s tiles for `dtype` (or `tile_rows`), in fp32: per-tile
    (mean, M2), then Chan's merge in tile order, in groups of `FOLD_GROUP`
    tiles and then over the groups. Returns (out in fp32, mean, rstd)."""
    n, c = x.shape[0], x.shape[-1]
    rows, seg, threads, _ = port.split_geometry(x.shape, dtype)
    rows = tile_rows or rows
    # threads / (seg / 16) rows are read in one step of a block.
    step = threads // (seg // 16)
    x32 = x.reshape(n, -1, c).astype(np.float32)
    s = x32.shape[1]
    tiles = []
    for lo, hi in _tiles(s, rows):
        tile = x32[:, lo:hi]
        nb = np.float32(hi - lo)
        mb = _block_sum(tile, step) / nb
        tiles.append((nb, mb, _block_sum(np.square(tile - mb[:, None]), step)))
    # Two levels, each in order: the tiles of each group of FOLD_GROUP, then
    # the groups.
    groups = [_chan_merge(tiles[g:g + FOLD_GROUP], n, c)
              for g in range(0, len(tiles), FOLD_GROUP)]
    count, mean, m2 = _chan_merge(groups, n, c)
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


def _assert_emulation_matches(got, want, dtype):
    out_e, mean_e, rstd_e = got
    out_w, mean_w, rstd_w = (np.asarray(a, np.float32) for a in want)
    # Statistics are fp32 in both; only the summation order differs.
    np.testing.assert_allclose(mean_e, mean_w, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rstd_e, rstd_w, rtol=1e-5)
    if dtype == "bfloat16":
        # The kernel casts its fp32 result to bf16; it may round to the
        # neighbouring bf16 value of the reference's: one bf16 ulp is at most
        # 2**-7 of the value.
        out_e = torch.from_numpy(out_e).to(torch.bfloat16).float().numpy()
        np.testing.assert_allclose(out_e, out_w, rtol=2 ** -7, atol=1e-6)
    else:
        np.testing.assert_allclose(out_e, out_w, rtol=1e-5, atol=1e-5)


def _stats64(x):
    """Mean and rstd in float64: the exact statistics of an fp32 input."""
    x64 = x.reshape(x.shape[0], -1, x.shape[-1]).astype(np.float64)
    mean = x64.mean(axis=1)
    return mean, 1 / np.sqrt(np.square(x64 - mean[:, None]).mean(axis=1) + 1e-5)


# ------------------------------------------------------------------ geometry


@pytest.mark.parametrize("shape, dtype", SPLIT_CASES,
                         ids=[f"{'x'.join(map(str, s))}-{str(d)[6:]}" for s, d in SPLIT_CASES])
def test_geometry_at_chip_smoke_shapes(shape, dtype):
    n, c, s = shape[0], shape[-1], math.prod(shape[1:-1])
    rows, seg, threads, blocks = port.split_geometry(shape, dtype)
    row = c * dtype.itemsize
    # Segments of whole 16-byte vectors tile the row, at most 512 bytes; a
    # row up to that width is one segment, so a tile is one contiguous span.
    assert seg % 16 == 0 and row % seg == 0 and seg <= port.SPLIT_SEGMENT_MAX_BYTES
    assert seg == row or row > port.SPLIT_SEGMENT_MAX_BYTES
    # Each thread keeps one vector column, which holds whole channels.
    vecs = seg // 16
    assert 16 % dtype.itemsize == 0 and threads % vecs == 0
    assert threads % 32 == 0 and 32 <= threads <= 512
    # Tiles cover [0, S) without gaps; the last may be short, never empty.
    tiles = _tiles(s, rows)
    assert 1 <= rows <= s
    assert tiles[0][0] == 0 and tiles[-1][1] == s
    assert all(a[1] == b[0] for a, b in zip(tiles, tiles[1:]))
    assert all(hi - lo == rows for lo, hi in tiles[:-1]) and 1 <= tiles[-1][1] - tiles[-1][0]
    assert blocks == n * (row // seg) * len(tiles)
    # The stats block's tile and scratch fit a Hopper block beside its
    # static scratch.
    smem = port.split_stats_smem(dtype, rows, seg, threads)
    assert rows * seg <= port.SPLIT_TILE_BYTES
    assert smem <= BLOCK_SMEM_CAP
    assert chip_smoke.geometry_record("split", shape, dtype) == {
        "tile_rows": rows, "seg_bytes": seg, "threads": threads, "blocks": blocks,
        "smem_bytes": smem, "reverse": port.SPLIT_REVERSE}


@pytest.mark.parametrize("shape, dtype, want", [
    ((16, 256, 256, 64), torch.bfloat16, (256, 128, 128, 4096)),
    ((16, 128, 128, 128), torch.bfloat16, (128, 256, 128, 2048)),
    ((1, 256, 256, 64), torch.bfloat16, (256, 128, 128, 256)),
    ((1, 128, 128, 128), torch.bfloat16, (128, 256, 128, 128)),
    ((16, 256, 256, 64), torch.float32, (128, 256, 128, 8192)),
    ((1, 128, 128, 128), torch.float32, (64, 512, 128, 256)),
])
def test_geometry_at_the_split_slabs(shape, dtype, want):
    """The four split slabs of CycleGAN-256: whole rows, 32 KB tiles and
    128 threads at both batches."""
    assert port.split_geometry(shape, dtype) == want


@pytest.mark.parametrize("shape, dtype, seg, threads", [
    ((2, 9000, 1, 48), torch.bfloat16, 96, 96),      # 6 vectors: lcm(6, 32) = 96
    ((2, 9000, 1, 48), torch.float32, 192, 96),      # 12 vectors: lcm(12, 32) = 96
    ((1, 7000, 1, 256), torch.float32, 512, 128),    # a 1 KB row: two segments
    ((1, 7000, 1, 256), torch.bfloat16, 512, 128),
    ((1, 7000, 1, 320), torch.float32, 320, 160),    # 1280 bytes: four of 320
])
def test_geometry_segments_and_threads(shape, dtype, seg, threads):
    rows, got_seg, got_threads, blocks = port.split_geometry(shape, dtype)
    assert (got_seg, got_threads) == (seg, threads)
    nseg = shape[-1] * dtype.itemsize // seg
    assert blocks == shape[0] * nseg * -(-math.prod(shape[1:-1]) // rows)


def test_edge_shapes_hold_the_split_cases():
    """chip_smoke.py checks, in both dtypes: a ragged last tile, a 3D split
    volume, a row whose vectors do not divide a warp, and a row cut into
    segments."""
    ragged = {s for s, d in SPLIT_CASES
              if math.prod(s[1:-1]) % port.split_geometry(s, d)[0]}
    assert {(1, 6401, 1, 16), (2, 70000, 1, 32), (2, 9000, 1, 48)} <= ragged
    assert ((1, 32, 32, 32, 16), torch.bfloat16) in SPLIT_CASES
    assert any(32 % (port.split_geometry(s, d)[1] // 16) for s, d in SPLIT_CASES)
    assert any(s[-1] * d.itemsize > port.split_geometry(s, d)[1] for s, d in SPLIT_CASES)


def test_launcher_signatures_match_the_source():
    """Each `extern "C"` launcher in the CUDA source takes as many arguments
    as its ctypes declaration says (ctypes cannot check it), the split form
    has no fold launcher any more, and the emulation's fold groups are the
    kernel's."""
    source = (Path(port.__file__).resolve().parents[1] / "csrc" / port.SOURCE).read_text()
    body = source[source.index('extern "C" {'):]
    found = {name: len(args.split(","))
             for name, args in re.findall(r"^int (\w+)\(([^)]*)\)", body, re.M)}
    assert found == {name: len(argtypes) for name, (argtypes, _) in port._SIGNATURES.items()}
    assert "inorm_split_fold" not in source and "inorm_split_tile_rows" not in source
    assert re.search(r"constexpr int kFoldGroup = (\d+);", source).group(1) == str(FOLD_GROUP)


def test_arrival_counters_are_kept_per_stream():
    """One zeroed buffer per (device, stream), grown when a launch needs
    more counters."""
    port._ARRIVALS.clear()
    cpu = torch.device("cpu")
    a = port._arrivals(cpu, 1, 16)
    assert a.dtype == torch.int32 and a.numel() == 16 and not a.any()
    assert port._arrivals(cpu, 1, 8) is a
    assert port._arrivals(cpu, 2, 8) is not a
    b = port._arrivals(cpu, 1, 32)
    assert b.numel() == 32 and not b.any() and port._arrivals(cpu, 1, 16) is b
    port._ARRIVALS.clear()


# ---------------------------------------------------------------- arithmetic


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("shape", ((2, 37, 29, 16), (1, 5, 24, 24, 32)), ids=("2d", "3d"))
def test_emulation_matches_xla_forward(shape, dtype, activation):
    """At the geometry's tiles, each with a ragged last one: S = 1073 in 2
    (bf16) or 3 (f32) tiles, and a 3D volume of S = 2880 in 6 or 12."""
    tdtype = getattr(torch, dtype)
    s = math.prod(shape[1:-1])
    assert len(_tiles(s, port.split_geometry(shape, tdtype)[0])) > 1
    x = _inputs(shape, dtype, seed=15, scale=3.0, shift=1.5)
    xj = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    _assert_emulation_matches(_emulate(x, tdtype, 1e-5, activation, 0.2),
                              _xla_forward(xj, 1e-5, activation, 0.2), dtype)


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_emulation_matches_pallas_tiled_interpret(activation):
    """Against the TPU kernel itself (interpret mode; its tile must divide
    S): the TPU kernel sums [x, x^2] over 8 tiles of 64 rows, the port
    takes the (mean, M2) of 2 tiles of 256 rows and merges them."""
    shape = (2, 32, 16, 32)
    x = _inputs(shape, "float32", seed=16, scale=2.0, shift=1.0)
    in_mod._INTERPRET = True
    try:
        want = in_mod._pallas_forward_tiled(jnp.asarray(x), 1e-5, activation, 0.2, tile=64)
    finally:
        in_mod._INTERPRET = False
    out, mean, rstd = _emulate(x, torch.float32, 1e-5, activation, 0.2)
    assert port.split_geometry(shape, torch.float32)[0] == 256
    # The TPU kernel's variance is E[x^2] - E[x]^2, which loses a few more
    # fp32 digits than per-tile M2 and Chan's merge (mean 1, std 2 here).
    np.testing.assert_allclose(mean, np.asarray(want[1]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rstd, np.asarray(want[2]), rtol=1e-4)
    np.testing.assert_allclose(out, np.asarray(want[0]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tile_rows", (7, 100, 333, 1072))
def test_emulation_ragged_last_tile(tile_rows):
    """Tiles that do not divide S (1073 = 153 * 7 + 2, ...; the last of
    1072-row tiles holds one row): the merge weighs each tile by its own
    count. Held against float64 statistics and `_xla_forward`."""
    shape = (2, 37, 29, 16)
    assert 1073 % tile_rows
    x = _inputs(shape, "float32", seed=17, scale=2.0, shift=-1.0)
    out, mean, rstd = _emulate(x, torch.float32, 1e-5, "leaky_relu", 0.2, tile_rows)
    mean64, rstd64 = _stats64(x)
    # fp32 sums of ~1e3 values: a few ulps of the mean's scale (~2).
    np.testing.assert_allclose(mean, mean64, rtol=0, atol=2e-6)
    np.testing.assert_allclose(rstd, rstd64, rtol=1e-5)
    _assert_emulation_matches((out, mean, rstd),
                              _xla_forward(jnp.asarray(x), 1e-5, "leaky_relu", 0.2), "float32")


@pytest.mark.parametrize("shape", ((2, 4099, 1, 16), (1, 128, 128, 32)),
                         ids=("ragged", "down0-like"))
def test_emulation_large_mean(shape):
    """|mean| >> std (mean 1e3, std 0.1, fp32): the tiles' M2 around their
    own means and Chan's merge keep the variance, where E[x^2] - E[x]^2
    loses it. Held against the exact statistics (float64) and `_xla_forward`."""
    x = _inputs(shape, "float32", seed=18, scale=0.1, shift=1e3)
    out, mean, rstd = _emulate(x, torch.float32, 1e-5, "none", 0.2)
    mean64, rstd64 = _stats64(x)
    # Each tile's mean is an fp32 number near 1e3, whose ulp (6e-5) is 6e-4
    # of the std; the merge takes the tiles' differences with that error, so
    # the variance keeps about 4 digits: rstd within 2e-4. The merge rounds
    # the running mean once per tile and group (18 and 64 tiles here), so
    # the mean is off by a few such ulps. `_xla_forward`'s own fp32 mean is
    # off by up to 7e-4 here, 7e-3 of the std, and the outputs differ by
    # about that.
    np.testing.assert_allclose(mean, mean64, rtol=0, atol=4e-4)
    np.testing.assert_allclose(rstd, rstd64, rtol=2e-4)
    want = _xla_forward(jnp.asarray(x), 1e-5, "none", 0.2)
    np.testing.assert_allclose(mean, np.asarray(want[1]), rtol=0, atol=8e-4)
    np.testing.assert_allclose(rstd, np.asarray(want[2]), rtol=2e-4)
    np.testing.assert_allclose(out, np.asarray(want[0]), rtol=0, atol=1e-2)
    x32 = x.reshape(shape[0], -1, shape[-1])
    naive_var = np.square(x32).mean(axis=1, dtype=np.float32) - \
        np.square(x32.mean(axis=1, dtype=np.float32))
    naive_rstd = 1 / np.sqrt(np.maximum(naive_var, 0) + np.float32(1e-5))
    assert np.abs(naive_rstd / rstd64 - 1).max() > 0.1
