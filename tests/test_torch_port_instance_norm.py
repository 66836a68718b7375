"""The port's instance norm (`ganslate_tpu_torch/ops/instance_norm.py`)
against the JAX package's: the plain version against `_xla_forward` and
against both Pallas kernels run in interpret mode (on 4-D and on the V-Net's
5-D slabs), the kernel dispatch rule at the CycleGAN-256 shapes, the
wrappers' channel padding for any C, and the CPU path's launch counters.

The CUDA kernels themselves run only on a GPU; `chip_smoke.py` holds them
against the plain version there."""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import ganslate_tpu.ops.instance_norm as in_mod
from ganslate_tpu_torch.ops import instance_norm as port
from tests.torch_port_support import one_torch_thread  # noqa: F401 (autouse)

ACTIVATIONS = ("none", "relu", "leaky_relu")
SHAPES = ((2, 8, 8, 16), (1, 4, 6, 6, 8))

_xla_forward = jax.jit(in_mod._xla_forward, static_argnums=(1, 2, 3))


def _inputs(shape, dtype, seed=0, scale=1.0, shift=0.0):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32) * scale + shift
    xj = jnp.asarray(x)
    xt = torch.from_numpy(x)
    if dtype == "bfloat16":
        # Both round to nearest even, so the two inputs are bit-identical.
        xj, xt = xj.astype(jnp.bfloat16), xt.to(torch.bfloat16)
    return xj, xt


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _assert_matches(got, want, dtype):
    out_t, mean_t, rstd_t = got
    out_j, mean_j, rstd_j = want
    assert out_t.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    assert tuple(mean_t.shape) == tuple(mean_j.shape) == tuple(rstd_t.shape)
    # Statistics are fp32 in both: only the summation order differs.
    np.testing.assert_allclose(_f32(mean_t), _f32(mean_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_f32(rstd_t), _f32(rstd_j), rtol=1e-5)
    if dtype == "bfloat16":
        # The fp32 result may round to the neighbouring bf16 value: one bf16
        # ulp is at most 2**-7 of the value.
        np.testing.assert_allclose(_f32(out_t), _f32(out_j), rtol=2 ** -7, atol=1e-6)
    else:
        np.testing.assert_allclose(_f32(out_t), _f32(out_j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("shape", SHAPES, ids=("2d", "3d"))
def test_reference_matches_xla_forward(shape, dtype, activation):
    xj, xt = _inputs(shape, dtype)
    got = port.instance_norm_reference(xt, 1e-5, activation, 0.2)
    want = _xla_forward(xj, 1e-5, activation, 0.2)
    _assert_matches(got, want, dtype)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_reference_large_mean(dtype):
    """Post-conv activations with |mean| >> std: the two-pass variance keeps
    its precision in both packages."""
    xj, xt = _inputs((2, 16, 16, 16), dtype, seed=1, scale=3.0, shift=50.0)
    got = port.instance_norm_reference(xt, 1e-5, "relu", 0.2)
    want = _xla_forward(xj, 1e-5, "relu", 0.2)
    _assert_matches(got, want, dtype)


def test_public_function_matches_forward():
    _, xt = _inputs((2, 8, 8, 16), "float32", seed=2)
    out, _, _ = port.instance_norm_forward(xt, 1e-5, "leaky_relu", 0.1)
    torch.testing.assert_close(port.instance_norm(xt, 1e-5, "leaky_relu", 0.1), out,
                               rtol=0, atol=0)


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_reference_matches_pallas_onepass_interpret(activation):
    xj, xt = _inputs((2, 16, 128, 8), "float32", seed=3, scale=2.0, shift=1.0)
    in_mod._INTERPRET = True
    try:
        want = in_mod._pallas_forward(xj, 1e-5, activation, 0.2)
    finally:
        in_mod._INTERPRET = False
    _assert_matches(port.instance_norm_reference(xt, 1e-5, activation, 0.2), want,
                    "float32")


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_reference_matches_pallas_onepass_interpret_on_a_slab(dtype):
    """A 5-D (N, D, H, W, C) slab, as the V-Net's norms take: the one-pass
    kernel sees it as (N, S, C) with S = D * H * W."""
    xj, xt = _inputs((2, 4, 6, 6, 16), dtype, seed=5, scale=2.0, shift=1.0)
    in_mod._INTERPRET = True
    try:
        want = in_mod._pallas_forward(xj, 1e-5, "none", 0.2)
    finally:
        in_mod._INTERPRET = False
    _assert_matches(port.instance_norm_reference(xt, 1e-5, "none", 0.2), want, dtype)


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_reference_matches_pallas_tiled_interpret_on_a_slab(activation):
    """A 5-D slab through the tiled kernel, 4 tiles of 64 rows per sample."""
    xj, xt = _inputs((2, 4, 8, 8, 16), "float32", seed=6, scale=3.0, shift=2.0)
    in_mod._INTERPRET = True
    try:
        want = in_mod._pallas_forward_tiled(xj, 1e-5, activation, 0.2, tile=64)
    finally:
        in_mod._INTERPRET = False
    out_t, mean_t, rstd_t = port.instance_norm_reference(xt, 1e-5, activation, 0.2)
    assert out_t.shape == want[0].shape
    # As in the 4-D case below: the tiled kernel's E[x^2] - E[x]^2.
    np.testing.assert_allclose(_f32(mean_t), np.asarray(want[1]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_f32(rstd_t), np.asarray(want[2]), rtol=1e-4)
    np.testing.assert_allclose(_f32(out_t), np.asarray(want[0]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_reference_matches_pallas_tiled_interpret(activation):
    xj, xt = _inputs((2, 32, 16, 24), "float32", seed=4, scale=3.0, shift=2.0)
    in_mod._INTERPRET = True
    try:
        want = in_mod._pallas_forward_tiled(xj, 1e-5, activation, 0.2, tile=64)
    finally:
        in_mod._INTERPRET = False
    # The tiled kernel's variance is E[x^2] - E[x]^2, which loses a few more
    # fp32 digits than the two-pass form (mean 2, std 3 here).
    out_t, mean_t, rstd_t = port.instance_norm_reference(xt, 1e-5, activation, 0.2)
    np.testing.assert_allclose(_f32(mean_t), np.asarray(want[1]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_f32(rstd_t), np.asarray(want[2]), rtol=1e-4)
    np.testing.assert_allclose(_f32(out_t), np.asarray(want[0]), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------------ dispatch


def _cyclegan_norm_shapes(batch, size=256, ngf=64, n_blocks=9):
    """(N, H, W, C) of the 23 norms of one Resnet2D forward, in order."""
    shapes = [(batch, size, size, ngf)]
    shapes += [(batch, size // 2, size // 2, ngf * 2), (batch, size // 4, size // 4, ngf * 4)]
    shapes += [(batch, size // 4, size // 4, ngf * 4)] * (2 * n_blocks)
    shapes += [(batch, size // 2, size // 2, ngf * 2), (batch, size, size, ngf)]
    return shapes


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("batch", (1, 16))
def test_dispatch_at_cyclegan_256(batch, dtype):
    shapes = _cyclegan_norm_shapes(batch)
    assert len(shapes) == 23
    picks = [port.pick_kernel(s, dtype) for s in shapes]
    # Residual and down1 slabs (64x64x256) fit one block: one-pass.
    assert picks.count("onepass") == 19
    # Stem, down0, up0, up1 (S = 65536 or 16384) take the split form.
    assert [i for i, p in enumerate(picks) if p == "split"] == [0, 1, 21, 22]
    for s, p in zip(shapes, picks):
        rows = math.prod(s[1:-1])
        assert (p == "onepass") == (rows * port.ROW_BYTES <= port.ONEPASS_MAX_SMEM)


def test_dispatch_limits():
    # The largest one-pass slab still fits a Hopper block (227 KB).
    assert port.ONEPASS_MAX_SMEM <= 227 * 1024
    rows = port.ONEPASS_MAX_SMEM // port.ROW_BYTES
    assert port.pick_kernel((1, rows, 1, 16), torch.bfloat16) == "onepass"
    assert port.pick_kernel((1, rows + 1, 1, 16), torch.bfloat16) == "split"
    assert port.pick_kernel((2, 8, 8, 8, 32), torch.float32) == "onepass"
    assert port.channel_block(torch.float32) == 8
    assert port.channel_block(torch.bfloat16) == 16


@pytest.mark.parametrize("shape, dtype, error", [
    ((2, 4, 4, 4, 4, 16), torch.bfloat16, ValueError),  # four spatial dims
    ((2, 16), torch.float32, ValueError),               # none
    ((2, 64, 16), torch.float32, ValueError),           # one spatial dim
    ((2, 8, 8, 16), torch.float16, TypeError),
])
def test_dispatch_rejects(shape, dtype, error):
    with pytest.raises(error):
        port.pick_kernel(shape, dtype)


@pytest.mark.parametrize("shape, dtype", [
    ((2, 8, 8, 24), torch.bfloat16),    # C not a multiple of 16
    ((2, 8, 8, 12), torch.float32),     # C not a multiple of 8
    ((1, 4, 8, 8, 20), torch.bfloat16),
    ((1, 200, 200, 3), torch.float32),
])
def test_dispatch_takes_any_channel_count(shape, dtype):
    """The JAX package takes any C; so do the kernels' wrappers, which pad
    the channels to a multiple of the channel block."""
    assert port.pick_kernel(shape, dtype) == (
        "onepass" if math.prod(shape[1:-1]) * port.ROW_BYTES <= port.ONEPASS_MAX_SMEM
        else "split")


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("shape", ((2, 6, 7, 20), (1, 3, 4, 5, 20), (2, 9, 9, 3)))
def test_channel_padding_is_exact(shape, dtype, activation):
    """`_channel_padded` with the kernel replaced by the plain version:
    the kernel gets C padded with zeros to a multiple of the channel
    block, and the result and statistics cut back to C equal the plain
    version on the unpadded input. Only the summation order of the
    statistics may differ with the padded width (a few fp32 ulps), and a
    bf16 output may then round to the neighbouring value."""
    _, xt = _inputs(shape, dtype, seed=7, scale=2.0, shift=-1.0)
    seen = []

    def launch(x, eps, act, slope):
        assert x.shape[-1] % port.channel_block(x.dtype) == 0 and x.is_contiguous()
        seen.append(tuple(x.shape))
        return port.instance_norm_reference(x, eps, act, slope)

    got = port._channel_padded(launch, xt, 1e-5, activation, 0.2)
    want = port.instance_norm_reference(xt, 1e-5, activation, 0.2)
    cb = port.channel_block(xt.dtype)
    assert seen == [shape[:-1] + (-(-shape[-1] // cb) * cb,)]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype and g.is_contiguous()
    _assert_matches(got, want, dtype)


def test_channel_padding_leaves_a_multiple_alone():
    _, xt = _inputs((2, 4, 4, 16), "bfloat16")
    seen = []
    port._channel_padded(lambda x, *a: seen.append(x) or port.instance_norm_reference(x), xt)
    assert seen[0] is xt


def test_cpu_tensor_leaves_counters_at_zero():
    port.reset_launches()
    for shape in SHAPES:
        for dtype in ("float32", "bfloat16"):
            port.instance_norm(_inputs(shape, dtype)[1], 1e-5, "relu")
    assert port.LAUNCHES == {"onepass": 0, "split": 0}


@pytest.mark.parametrize("kernel", ("onepass", "split"))
def test_kernel_wrappers_reject_cpu_tensors(kernel):
    """A kernel wrapper never computes on the CPU: it raises before it
    builds or launches anything."""
    port.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        port.KERNELS[kernel](torch.zeros(1, 8, 8, 16))
    assert port.LAUNCHES[kernel] == 0


@pytest.mark.parametrize("kernel", ("onepass", "split"))
def test_kernel_wrappers_are_forward_only(kernel):
    """The kernel wrappers compute the forward only, for a tensor that needs
    a gradient too (they refuse it for lying on the CPU, not for its
    gradient); the gradient comes from `InstanceNormFunction`, around the
    same forward."""
    x = torch.zeros(1, 8, 8, 16, requires_grad=True)
    with pytest.raises(ValueError, match="CUDA"):
        port.KERNELS[kernel](x)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        port.KERNELS[kernel](x)
    out = port.instance_norm(x)
    assert out.requires_grad
    assert type(out.grad_fn).__name__ == "InstanceNormFunctionBackward"


def test_rejects_unknown_activation():
    with pytest.raises(ValueError):
        port.instance_norm(torch.zeros(1, 4, 4, 8), activation="gelu")


# --------------------------------------------------------------------- build


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as cpp_extension
    from ganslate_tpu_torch.ops import build
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(port.SOURCE)


def test_failed_build_raises(monkeypatch, tmp_path):
    """A compiler error is raised with the compiler's output, and leaves no
    library behind."""
    import torch.utils.cpp_extension as cpp_extension
    from ganslate_tpu_torch.ops import build
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("#!/bin/sh\necho 'error: no such card' >&2\nexit 2\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="no such card"):
        build.build(port.SOURCE)
    assert not list((tmp_path / "out").glob("*.so"))
