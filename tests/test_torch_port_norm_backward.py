"""The instance-norm backward kernels' dispatch, geometry and arithmetic, on
the CPU.

The backward kernels (`norm_bwd_*` in `ganslate_tpu_torch/csrc/instance_norm.cu`)
run only on a GPU; `chip_smoke.py` holds them against the float64 gradient
there. Here: which form each slab of the two training cells
takes and that its geometry fits the card (`backward_onepass_geometry`,
`split_geometry`, `backward_sums_smem`); that a CPU tensor keeps the plain
`instance_norm_backward` and counts no launch; the wrappers' gradient
operand and channel padding; the kernel names the benchmark reads
(`gpubench/trace.py:family` files the kernels under the norm backward, never
under the forward's `inorm` kernels); and the kernels' arithmetic, emulated
in numpy step for step in fp32 (each block's sums of g' and g' * y, the
cluster's ranks or the tiles' two-level fold added in order, then dx),
against the JAX package's `_bwd` on the same residuals."""

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
from tests.torch_port_support import one_torch_thread  # noqa: F401 (autouse)

ACTIVATIONS = ("none", "relu", "leaky_relu")
SOURCE = Path(port.__file__).resolve().parents[1] / "csrc" / port.SOURCE
# Shared memory a Hopper block may use.
HOPPER_BLOCK_SMEM = 227 * 1024
# The one-pass backward's static scratch: the column sums (8 warps x G
# floats) and two pairs of G sums, at most G = 64 channels.
ONEPASS_STATIC = (8 + 4) * 64 * 4
# The sums kernel's static scratch: the tile's two sums (2 x 256 floats)
# and the barrier.
SUMS_STATIC = 2 * 256 * 4 + 16
# Tiles added per group by the sums kernel's first fold level.
FOLD_GROUP = 16

_xla_forward = jax.jit(in_mod._xla_forward, static_argnums=(1, 2, 3))
_bwd = jax.jit(in_mod._bwd, static_argnums=(0, 1, 2))

# The norms of the benchmark's two training cells (bf16), with the form
# each takes. horse2zebra at batch 16: the ResNet generator's stem, down
# and up norms (split) and its down1 and residual norms (one-pass); the
# PatchGAN2D's three in the G step (16) and the D step (32). BRaTS at batch
# 1: the V-Net's levels 0-2 (split) and 3 (one-pass) at both channel
# counts; PatchGAN3D's two in the G step (1) and the D step (2).
CELL_SLABS = (
    [((16, 256, 256, 64), "split"), ((16, 128, 128, 128), "split"),
     ((16, 64, 64, 256), "onepass")]
    + [((n, *hw, c), "onepass") for n in (16, 32)
       for hw, c in (((64, 64), 128), ((32, 32), 256), ((31, 31), 512))]
    + [((1, 32, 176, 176, c), "split") for c in (16, 32)]
    + [((1, 16, 88, 88, c), "split") for c in (16, 32)]
    + [((1, 8, 44, 44, c), "split") for c in (32, 64)]
    + [((1, 4, 22, 22, c), "onepass") for c in (64, 128)]
    + [((n, 8, 44, 44, 128), "split") for n in (1, 2)]
    + [((n, 7, 43, 43, 256), "split") for n in (1, 2)])


def _id(shape):
    return "x".join(map(str, shape))


# ------------------------------------------------------------------ dispatch


@pytest.mark.parametrize("shape, form", CELL_SLABS, ids=[_id(s) for s, _ in CELL_SLABS])
def test_cell_slabs_take_the_forward_s_form(shape, form):
    """Each norm of the two training cells takes the backward form of its
    forward: the one-pass backward where the forward is one-pass."""
    assert port.pick_kernel(shape, torch.bfloat16) == form


def _onepass_cases():
    shapes = [s for s, f in CELL_SLABS if f == "onepass"]
    shapes += [(1, 6400, 1, 16), (1, 4097, 1, 64), (2, 37, 29, 32), (4, 8, 22, 22, 24)]
    return [(s, d) for s in shapes for d in (torch.bfloat16, torch.float32)
            if port.pick_kernel(s, d) == "onepass"]


@pytest.mark.parametrize("shape, dtype", _onepass_cases(),
                         ids=[f"{_id(s)}-{str(d)[6:]}" for s, d in _onepass_cases()])
def test_onepass_geometry_fits_the_card(shape, dtype):
    """G divides the (padded) channels in whole 32 or 64-byte segments; the
    cluster is a portable size and leaves no rank empty; the ranks' rows
    cover S; x's and the gradient's rows and the static scratch fit a
    block; the forward's rule on twice the bytes."""
    n, c, s = shape[0], shape[-1], math.prod(shape[1:-1])
    cb = port.channel_block(dtype)
    c = -(-c // cb) * cb
    g, k, rows, smem = port.backward_onepass_geometry(shape[:-1] + (c,), dtype)
    assert g * dtype.itemsize in (32, 64) and c % g == 0
    assert k in (1, 2, 4, 8) and k <= s
    assert rows == -(-s // k) and rows * k >= s and (rows - 1) * k < s
    assert smem == 2 * rows * g * dtype.itemsize
    assert smem + ONEPASS_STATIC <= HOPPER_BLOCK_SMEM
    fwd = port.onepass_geometry(shape[:-1] + (c,), dtype)
    assert g == fwd[0] and k >= fwd[1]


@pytest.mark.parametrize("batch, want", ((16, (32, 8)), (1, (32, 8))))
def test_onepass_geometry_at_the_main_slab(batch, want):
    """bf16 (N, 64, 64, 256): 64-byte segments in clusters of 8, 64 KB of x
    and gradient a block (timed against every other (G, K) on an H100)."""
    g, k, rows, smem = port.backward_onepass_geometry((batch, 64, 64, 256), torch.bfloat16)
    assert (g, k) == want and rows == 512 and smem == 64 * 1024


def _split_cases():
    shapes = [s for s, f in CELL_SLABS if f == "split"]
    shapes += [(2, 16, 64, 64, 20), (1, 6401, 1, 16), (2, 33, 33, 1024)]
    return [(s, d) for s in shapes for d in (torch.bfloat16, torch.float32)]


@pytest.mark.parametrize("shape, dtype", _split_cases(),
                         ids=[f"{_id(s)}-{str(d)[6:]}" for s, d in _split_cases()])
def test_split_backward_geometry_fits_the_card(shape, dtype):
    """The split backward runs at the forward's tiles: whole segments of the
    (padded) row, tiles that cover S exactly (the last one ragged), a
    thread count the launcher takes, and x's and the gradient's tiles with
    the scratch within a block's shared memory."""
    n, c, s = shape[0], shape[-1], math.prod(shape[1:-1])
    cb = port.channel_block(dtype)
    c = -(-c // cb) * cb
    rows, seg, threads, blocks = port.split_geometry(shape[:-1] + (c,), dtype)
    row = c * dtype.itemsize
    tiles = -(-s // rows)
    assert row % seg == 0 and seg % 16 == 0 and seg <= 512
    assert 1 <= rows <= s and (tiles - 1) * rows < s <= tiles * rows
    assert threads % 32 == 0 and threads % (seg // 16) == 0 and 32 <= threads <= 512
    assert blocks == n * (row // seg) * tiles
    assert port.backward_sums_smem(dtype, rows, seg, threads) + SUMS_STATIC <= HOPPER_BLOCK_SMEM
    assert port.backward_sums_smem(dtype, rows, seg, threads) == \
        rows * seg + port.split_stats_smem(dtype, rows, seg, threads)


def test_cpu_tensor_takes_the_plain_backward():
    """A CPU tensor's gradient is `instance_norm_backward`'s, bit for bit,
    and no backward kernel counts a launch."""
    port.reset_launches()
    rng = np.random.default_rng(0)
    for shape, act in (((2, 8, 8, 16), "relu"), ((1, 4, 6, 6, 8), "leaky_relu")):
        x = torch.from_numpy((rng.normal(size=shape) * 3 + 1.5).astype(np.float32))
        g = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        xt = x.clone().requires_grad_(True)
        port.instance_norm(xt, 1e-5, act, 0.2).backward(g)
        _, mean, rstd = port.instance_norm_reference(x, 1e-5, act, 0.2)
        want = port.instance_norm_backward(x, mean, rstd, g, act, 0.2)
        assert torch.equal(xt.grad, want)
        assert torch.equal(port.instance_norm_grad(x, mean, rstd, g, act, 0.2), want)
    assert port.BACKWARD_LAUNCHES == {"onepass": 0, "split": 0}
    assert port.BACKWARD_COPIES == {"grad": 0}
    assert port.LAUNCHES == {"onepass": 0, "split": 0}


def test_reset_launches_clears_every_counter():
    for counts in (port.LAUNCHES, port.BACKWARD_LAUNCHES, port.BACKWARD_COPIES):
        for name in counts:
            counts[name] = 3
    port.reset_launches()
    assert port.LAUNCHES == {"onepass": 0, "split": 0}
    assert port.BACKWARD_LAUNCHES == {"onepass": 0, "split": 0}
    assert port.BACKWARD_COPIES == {"grad": 0}


@pytest.mark.parametrize("kernel", ("onepass", "split"))
def test_backward_wrappers_reject_cpu_tensors(kernel):
    """A backward kernel wrapper never computes on the CPU: it raises
    before it builds or launches anything."""
    port.reset_launches()
    x = torch.zeros(1, 8, 8, 16)
    stats = torch.zeros(1, 16)
    with pytest.raises(ValueError, match="CUDA"):
        port.BACKWARD_KERNELS[kernel](x, stats, stats, x)
    assert port.BACKWARD_LAUNCHES[kernel] == 0


@pytest.mark.parametrize("shards, want", ((None, "onepass"), (object(), "split")))
def test_dispatch_picks_the_form(monkeypatch, shards, want):
    """Off the CPU (here the `meta` device), `instance_norm_grad` takes the
    form that `pick_kernel` picks, and the split pair for a sharded slab
    whatever its size."""
    seen = []
    monkeypatch.setitem(port.BACKWARD_KERNELS, "onepass",
                        lambda *a: seen.append(("onepass", a)) or "dx")
    monkeypatch.setattr(port, "backward_split",
                        lambda *a: seen.append(("split", a)) or "dx")
    monkeypatch.setitem(port.BACKWARD_KERNELS, "split", port.backward_split)
    x = torch.zeros(2, 64, 64, 256, device="meta", dtype=torch.bfloat16)
    stats = torch.zeros(2, 256, device="meta")
    assert port.instance_norm_grad(x, stats, stats, x, "relu", 0.2, shards=shards) == "dx"
    assert [form for form, _ in seen] == [want]
    assert seen[0][1][4:6] == ("relu", 0.2)


def test_grad_operand_copies_only_what_it_must():
    """A contiguous gradient passes as it is; a permuted view is copied into
    x's layout and counted; one of another dtype or shape raises."""
    port.reset_launches()
    x = torch.zeros(2, 8, 8, 16)
    g = torch.randn(2, 8, 8, 16)
    assert port._grad_operand(g, x) is g
    permuted = torch.randn(2, 16, 8, 8).permute(0, 2, 3, 1)
    got = port._grad_operand(permuted, x)
    assert got.is_contiguous() and torch.equal(got, permuted)
    assert port.BACKWARD_COPIES == {"grad": 1}
    with pytest.raises(ValueError, match="does not match"):
        port._grad_operand(g.to(torch.bfloat16), x)
    with pytest.raises(ValueError, match="does not match"):
        port._grad_operand(g[:1], x)
    port.reset_launches()


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("shape", ((2, 6, 6, 20), (1, 3, 4, 4, 12)), ids=("2d", "3d"))
def test_backward_channel_padding_is_exact(shape, activation):
    """The padded channels (x, mean and rstd zero) add nothing to the sums
    and are cut away: the launch on the padded operands gives the plain
    gradient of the unpadded ones, bit for bit."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.normal(size=shape) * 3 + 1.5).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    _, mean, rstd = port.instance_norm_reference(x, 1e-5, activation, 0.2)
    seen = []

    def launch(xp, mp, rp, gp, act, slope):
        seen.append(xp.shape)
        dx = port.instance_norm_backward(xp, mp, rp, gp, act, slope)
        assert not dx[..., shape[-1]:].any()
        return dx

    got = port._backward_channel_padded(launch, x, mean, rstd, g, activation, 0.2)
    cb = port.channel_block(x.dtype)
    assert seen == [shape[:-1] + (-(-shape[-1] // cb) * cb,)]
    assert got.is_contiguous()
    assert torch.equal(got, port.instance_norm_backward(x, mean, rstd, g, activation, 0.2))


# ------------------------------------------------------------ kernel names


def _backward_names():
    """The backward's kernels and exported launchers, read from the source."""
    source = SOURCE.read_text()
    kernels = re.findall(r"^(\w+_kernel)\(", source, re.M)
    body = source[source.index('extern "C" {'):]
    exported = re.findall(r"^int (\w+)\(", body, re.M)
    return ([k for k in kernels if "bwd" in k], [e for e in exported if "bwd" in e],
            kernels, exported)


def test_backward_kernel_names_leave_out_inorm():
    """The benchmark counts every kernel whose name holds `inorm` as the
    forward's (`inorm_fwd_roofline`, `trace.family`'s `norm_kernels`): no
    backward kernel or launcher may be named so, and the forward's keep it."""
    kernels, exported, all_kernels, all_exported = _backward_names()
    assert kernels == ["norm_bwd_onepass_kernel", "norm_bwd_sums_kernel", "norm_bwd_dx_kernel"]
    assert exported == ["norm_bwd_onepass", "norm_bwd_sums", "norm_bwd_dx"]
    assert not any("inorm" in name.lower() for name in kernels + exported)
    forward = [k for k in all_kernels + all_exported if k not in kernels + exported]
    assert forward and all(name.startswith("inorm_") for name in forward)
    assert set(all_exported) == set(port._SIGNATURES)


@pytest.mark.parametrize("kernel", _backward_names()[0])
def test_trace_files_backward_kernels_under_the_norm_backward(kernel):
    """A device op of a backward kernel, as the profiler names a templated
    kernel, under the autograd node of `InstanceNormFunction`, is filed
    under the norm backward's family; its name does not match the forward's
    metric."""
    from gpubench.trace import DeviceOp, family
    name = f"void (anonymous namespace)::{kernel}<__nv_bfloat16>(__nv_bfloat16 const*, float)"
    chain = ("cudaLaunchKernelExC",
             "autograd::engine::evaluate_function: InstanceNormFunctionBackward")
    op = DeviceOp(name, 0.0, 1.0, chain)
    assert family(op) == "norm_backward_plain"
    assert "inorm" not in op.name.lower()
    assert family(DeviceOp(name.replace("norm_bwd", "inorm_bwd"), 0.0, 1.0, chain)) \
        == "norm_kernels"


# ---------------------------------------------------------------- arithmetic


def _block_sum(v, step):
    """Sum over axis 1 of (N, rows, C) in fp32 as a block sums: each thread
    adds every step-th row in turn, then the threads' sums are added."""
    n, r, c = v.shape
    v = np.concatenate([v, np.zeros((n, -r % step, c), np.float32)], axis=1)
    return v.reshape(n, -1, step, c).sum(axis=1, dtype=np.float32).sum(axis=1, dtype=np.float32)


def _gp_y(x32, g32, mean, rstd, activation, slope):
    """y and g' of (N, S, C) fp32 arrays, as the kernels compute them."""
    y = (x32 - mean[:, None]) * rstd[:, None]
    if activation == "relu":
        gp = g32 * (y > 0).astype(np.float32)
    elif activation == "leaky_relu":
        gp = g32 * np.where(y >= 0, np.float32(1), np.float32(slope))
    else:
        gp = g32
    return y, gp


def _dx(y, gp, rstd, a, b, shape):
    return (rstd[:, None] * (gp - a[:, None] - y * b[:, None])).reshape(shape)


def _emulate_onepass(x, g, mean, rstd, dtype, activation, slope):
    """The one-pass backward: each cluster rank's block sums over its rows,
    the ranks added in rank order, divided by S."""
    n, c = x.shape[0], x.shape[-1]
    gch, k, _, _ = port.backward_onepass_geometry(x.shape, dtype)
    step = 256 // (gch * dtype.itemsize // 16)
    x32, g32 = (a.reshape(n, -1, c).astype(np.float32) for a in (x, g))
    s = x32.shape[1]
    y, gp = _gp_y(x32, g32, mean, rstd, activation, slope)
    a = np.zeros((n, c), np.float32)
    b = np.zeros((n, c), np.float32)
    for r in range(k):
        lo, hi = r * s // k, (r + 1) * s // k
        a = a + _block_sum(gp[:, lo:hi], step)
        b = b + _block_sum(gp[:, lo:hi] * y[:, lo:hi], step)
    return _dx(y, gp, rstd, a / np.float32(s), b / np.float32(s), x.shape)


def _emulate_split(x, g, mean, rstd, dtype, activation, slope, tile_rows):
    """The split backward: each tile's block sums, added in tile order in
    groups of `FOLD_GROUP`, then the groups in order, divided by S."""
    n, c = x.shape[0], x.shape[-1]
    _, seg, threads, _ = port.split_geometry(x.shape, dtype)
    step = threads // (seg // 16)
    x32, g32 = (a.reshape(n, -1, c).astype(np.float32) for a in (x, g))
    s = x32.shape[1]
    y, gp = _gp_y(x32, g32, mean, rstd, activation, slope)
    tiles = [(_block_sum(gp[:, lo:lo + tile_rows], step),
              _block_sum(gp[:, lo:lo + tile_rows] * y[:, lo:lo + tile_rows], step))
             for lo in range(0, s, tile_rows)]

    def added(parts):
        a = np.zeros((n, c), np.float32)
        b = np.zeros((n, c), np.float32)
        for pa, pb in parts:
            a, b = a + pa, b + pb
        return a, b

    groups = [added(tiles[i:i + FOLD_GROUP]) for i in range(0, len(tiles), FOLD_GROUP)]
    a, b = added(groups)
    return _dx(y, gp, rstd, a / np.float32(s), b / np.float32(s), x.shape)


def _residuals(shape, dtype, activation, seed, scale=3.0, shift=1.5):
    """x and g (fp32 numpy, bf16-rounded where asked) and the JAX forward's
    statistics."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * scale + shift).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    if dtype == torch.bfloat16:
        x, g = (torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in (x, g))
    _, mean, rstd = _xla_forward(jnp.asarray(x), 1e-5, activation, 0.2)
    return x, g, np.asarray(mean), np.asarray(rstd)


def _assert_matches_bwd(got, x, g, mean, rstd, dtype, activation):
    want = np.array(_bwd(1e-5, activation, 0.2, (jnp.asarray(x), jnp.asarray(mean),
                                                   jnp.asarray(rstd)), jnp.asarray(g))[0])
    scale = float(np.abs(want).max())
    if dtype == torch.bfloat16:
        # The kernels round their fp32 dx to bf16; the reference's fp32 dx,
        # rounded alike, may land on the neighbouring bf16 value.
        got = torch.from_numpy(got).to(torch.bfloat16).float().numpy()
        want = torch.from_numpy(want).to(torch.bfloat16).float().numpy()
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6 * scale)
    else:
        # The same residuals: only the order of the two sums differs.
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=("f32", "bf16"))
@pytest.mark.parametrize("shape", ((2, 37, 29, 32), (1, 5, 24, 24, 32)), ids=("2d", "3d"))
def test_onepass_emulation_matches_bwd(shape, dtype, activation):
    """At the geometry's clusters, with ragged rank splits (S = 1073 and
    2880 over K ranks)."""
    x, g, mean, rstd = _residuals(shape, dtype, activation, seed=2)
    got = _emulate_onepass(x, g, mean, rstd, dtype, activation, 0.2)
    _assert_matches_bwd(got, x, g, mean, rstd, dtype, activation)


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=("f32", "bf16"))
@pytest.mark.parametrize("shape, tile_rows", (((2, 37, 29, 16), 16), ((1, 9, 24, 24, 32), 40)),
                         ids=("2d", "3d"))
def test_split_emulation_matches_bwd(shape, tile_rows, dtype, activation):
    """Small tiles, so that the fold has several groups and a ragged last
    tile: S = 1073 in 68 tiles (5 groups), S = 5184 in 130 (9 groups)."""
    x, g, mean, rstd = _residuals(shape, dtype, activation, seed=3)
    got = _emulate_split(x, g, mean, rstd, dtype, activation, 0.2, tile_rows)
    _assert_matches_bwd(got, x, g, mean, rstd, dtype, activation)


@pytest.mark.parametrize("form", ("onepass", "split"))
def test_emulation_large_mean(form):
    """Post-conv activations with |mean| 1e3 and std 0.1: y is recomputed
    from the forward's statistics in fp32, as `_bwd` does."""
    shape = (2, 16, 16, 16)
    x, g, mean, rstd = _residuals(shape, torch.float32, "none", seed=4, scale=0.1, shift=1e3)
    if form == "onepass":
        got = _emulate_onepass(x, g, mean, rstd, torch.float32, "none", 0.2)
    else:
        got = _emulate_split(x, g, mean, rstd, torch.float32, "none", 0.2, tile_rows=24)
    _assert_matches_bwd(got, x, g, mean, rstd, torch.float32, "none")
