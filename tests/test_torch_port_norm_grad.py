"""The port's instance-norm gradient (`ops/instance_norm.py`:
`InstanceNormFunction`, whose backward is `instance_norm_backward`) against
the JAX package's custom_vjp backward `_bwd`.

- End to end: the vector-Jacobian product of the port's `instance_norm`
  (torch autograd) against `jax.vjp` of the JAX `instance_norm`, with the
  same input and the same output cotangent, both made with numpy. On the
  CPU the JAX function takes `_xla_forward` (its Pallas paths need a TPU).
- `_bwd` itself, called with the `(x, mean, rstd)` that `_pallas_forward`
  and `_pallas_forward_tiled` give in interpret mode, against
  `instance_norm_backward` on the same residuals.

Tolerances. fp32: the two forwards' statistics differ by the summation order
(a few fp32 ulps), and dx = rstd * (gy - mean(gy) - y * mean(gy * y)) sums
again; 1e-5 relative to the gradient's scale covers it. With |mean| = 1e3
and std 0.1, x itself carries only ~6e-5 of absolute precision, and a mean
that differs by one fp32 ulp moves y by ~6e-4: that slab takes 1e-3. On the
same residuals only the reductions of the backward differ: 1e-6. bf16: dx is
computed in fp32 and rounded to bf16, and may round to the neighbouring
value (2**-7 relative)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import ganslate_tpu.ops.instance_norm as in_mod
from ganslate_tpu_torch.ops import instance_norm as port
from tests.torch_port_support import one_torch_thread  # noqa: F401 (autouse)

ACTIVATIONS = ("none", "relu", "leaky_relu")
SHAPES = {"2d": (2, 8, 8, 16), "3d": (1, 4, 6, 6, 8)}


def _arrays(shape, seed, scale=3.0, shift=1.5):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * scale + shift).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    return x, g


def _cast(x, dtype):
    """numpy fp32 -> the (jax, torch) pair in `dtype`, bit-identical."""
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bfloat16":
        xj, xt = xj.astype(jnp.bfloat16), xt.to(torch.bfloat16)
    return xj, xt


def _jax_vjp(xj, gj, activation, slope=0.2):
    fn = jax.jit(lambda v, c: jax.vjp(
        lambda u: in_mod.instance_norm(u, 1e-5, activation, slope), v)[1](c)[0])
    return np.asarray(fn(xj, gj).astype(jnp.float32))


def _port_vjp(xt, gt, activation, slope=0.2):
    xt = xt.clone().requires_grad_(True)
    port.instance_norm(xt, 1e-5, activation, slope).backward(gt)
    assert xt.grad.dtype == xt.dtype
    return xt.grad.float().numpy()


def _assert_close(got, want, dtype, rtol):
    scale = float(np.abs(want).max())
    if dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6 * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("rank", SHAPES)
def test_gradient_matches_jax(rank, dtype, activation):
    x, g = _arrays(SHAPES[rank], seed=0)
    (xj, xt), (gj, gt) = _cast(x, dtype), _cast(g, dtype)
    _assert_close(_port_vjp(xt, gt, activation), _jax_vjp(xj, gj, activation), dtype,
                  rtol=1e-5)


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_gradient_large_mean(activation):
    """Post-conv activations with |mean| 1e3 and std 0.1. The activation's
    derivative jumps at y = 0, and there the two forwards' y (which differ by
    up to ~1e-3 on this slab) may fall on either side: elements with |y| <
    1e-2 are left out of the comparison for relu and leaky_relu (a few in a
    thousand)."""
    x, g = _arrays((2, 16, 16, 16), seed=1, scale=0.1, shift=1e3)
    (xj, xt), (gj, gt) = _cast(x, "float32"), _cast(g, "float32")
    got, want = _port_vjp(xt, gt, activation), _jax_vjp(xj, gj, activation)
    y = np.asarray(in_mod._xla_forward(xj, 1e-5, "none", 0.2)[0])
    keep = np.abs(y) >= 1e-2 if activation != "none" else np.ones(y.shape, bool)
    assert keep.mean() > 0.99
    _assert_close(got[keep], want[keep], "float32", rtol=1e-3)


def test_gradient_of_a_permuted_cotangent():
    """The cotangent of a channels-last activation's permuted view is not
    contiguous; the backward takes any layout."""
    x, g = _arrays((2, 8, 8, 16), seed=2)
    gt = torch.from_numpy(np.ascontiguousarray(np.moveaxis(g, -1, 1))).permute(0, 2, 3, 1)
    assert not gt.is_contiguous()
    want = _jax_vjp(jnp.asarray(x), jnp.asarray(g), "relu")
    _assert_close(_port_vjp(torch.from_numpy(x), gt, "relu"), want, "float32", rtol=1e-5)


def _pallas_residuals(form, xj, activation):
    in_mod._INTERPRET = True
    try:
        if form == "onepass":
            return in_mod._pallas_forward(xj, 1e-5, activation, 0.2)
        return in_mod._pallas_forward_tiled(xj, 1e-5, activation, 0.2, tile=64)
    finally:
        in_mod._INTERPRET = False


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("form", ("onepass", "tiled"))
def test_backward_matches_bwd_on_pallas_residuals(form, activation):
    shape = (2, 16, 128, 8) if form == "onepass" else (2, 32, 16, 24)
    x, g = _arrays(shape, seed=3)
    xj = jnp.asarray(x)
    _, mean, rstd = _pallas_residuals(form, xj, activation)
    bwd = jax.jit(in_mod._bwd, static_argnums=(0, 1, 2))
    want = np.asarray(bwd(1e-5, activation, 0.2, (xj, mean, rstd), jnp.asarray(g))[0])
    got = port.instance_norm_backward(
        torch.from_numpy(x), torch.tensor(np.asarray(mean)), torch.tensor(np.asarray(rstd)),
        torch.from_numpy(g), activation, 0.2)
    assert got.dtype == torch.float32
    _assert_close(got.numpy(), want, "float32", rtol=1e-6)


def test_function_saves_the_forward_statistics():
    """The backward reads the statistics the forward computed: with the
    reference's own statistics it gives the same gradient."""
    x, g = _arrays((2, 8, 8, 16), seed=4)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    _, mean, rstd = port.instance_norm_reference(xt, 1e-5, "leaky_relu", 0.2)
    want = port.instance_norm_backward(xt, mean, rstd, gt, "leaky_relu", 0.2)
    torch.testing.assert_close(torch.from_numpy(_port_vjp(xt, gt, "leaky_relu")), want,
                               rtol=0, atol=0)


def test_gradient_matches_autograd_of_the_plain_version():
    """The hand-written backward against torch autograd through the plain
    forward (what `chip_smoke.py` holds the kernel path against on the card)."""
    x, g = _arrays((2, 8, 8, 16), seed=5)
    xt = torch.from_numpy(x).requires_grad_(True)
    port.instance_norm_reference(xt, 1e-5, "relu", 0.2)[0].backward(torch.from_numpy(g))
    _assert_close(_port_vjp(torch.from_numpy(x), torch.from_numpy(g), "relu"),
                  xt.grad.numpy(), "float32", rtol=1e-5)
