"""The port's conv layers (`ganslate_tpu_torch/nn/layers.py`) against the
JAX package's, with the JAX parameters carried across.

Tolerance: fp32 on the CPU, both sides sum the same products in another
order, so results agree to a few fp32 ulps of the sums (atol 1e-5 on
outputs of order 0.1-1)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ganslate_tpu.nn import layers as jl
from ganslate_tpu_torch.nn import layers as tl
from tests.torch_port_support import one_torch_thread, seeded_params  # noqa: F401


def _nhwc_to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _nchw_to_nhwc(y):
    return np.moveaxis(y.detach().numpy(), 1, -1)


def _jax_layer(module, x, seed=0):
    params = seeded_params(module, jnp.asarray(x), seed=seed)
    # Non-zero biases, so the test sees where they are added.
    params = jax.tree_util.tree_map(np.array, params)
    params["bias"] = np.random.default_rng(seed).normal(size=params["bias"].shape) \
        .astype(np.float32)
    out = jax.jit(module.apply)({"params": params}, jnp.asarray(x))
    return params, np.asarray(out)


CONV_CASES = {
    "zeros_k3": dict(kernel_size=(3, 3), padding=1, pad_mode="zeros"),
    "reflect_k3": dict(kernel_size=(3, 3), padding=1, pad_mode="reflect"),
    "replicate_k3": dict(kernel_size=(3, 3), padding=1, pad_mode="replicate"),
    "zeros_k3_stride2": dict(kernel_size=(3, 3), strides=2, padding=1, pad_mode="zeros"),
    "reflect_k7": dict(kernel_size=(7, 7), padding=3, pad_mode="reflect"),
    "replicate_3d": dict(kernel_size=(3, 3, 3), padding=1, pad_mode="replicate"),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_matches_jax(case):
    kw = CONV_CASES[case]
    spatial = (10, 12) if len(kw["kernel_size"]) == 2 else (6, 7, 8)
    x = np.random.default_rng(1).normal(size=(2, *spatial, 5)).astype(np.float32)
    params, want = _jax_layer(jl.Conv(features=6, **kw), x)

    conv = tl.Conv(5, 6, kw["kernel_size"], strides=kw.get("strides", 1),
                   padding=kw["padding"], pad_mode=kw["pad_mode"])
    with torch.no_grad():
        conv.weight.copy_(tl.conv_kernel_to_torch(torch.from_numpy(params["kernel"])))
        conv.bias.copy_(torch.from_numpy(params["bias"]))
        got = _nchw_to_nhwc(conv(_nhwc_to_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("spatial", [(5, 7), (4, 5, 6)], ids=("2d", "3d"))
def test_conv_transpose_matches_jax(spatial):
    """k3, s2, p1, op1: the CycleGAN up conv. The JAX kernel is flipped and
    transposed on the way in."""
    n = len(spatial)
    x = np.random.default_rng(2).normal(size=(2, *spatial, 6)).astype(np.float32)
    params, want = _jax_layer(jl.ConvTranspose(features=4, kernel_size=(3,) * n, strides=2,
                                               padding=1, output_padding=1), x, seed=1)
    assert want.shape == (2, *(2 * d for d in spatial), 4)

    up = tl.ConvTranspose(6, 4, (3,) * n, strides=2, padding=1, output_padding=1)
    with torch.no_grad():
        up.weight.copy_(tl.conv_transpose_kernel_to_torch(torch.from_numpy(params["kernel"])))
        up.bias.copy_(torch.from_numpy(params["bias"]))
        got = _nchw_to_nhwc(up(_nhwc_to_nchw(x)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", ("zeros", "reflect", "replicate"))
def test_pad_spatial_matches_jnp_pad(mode):
    x = np.random.default_rng(3).normal(size=(1, 6, 7, 2)).astype(np.float32)
    want = np.asarray(jl.pad_spatial(jnp.asarray(x), (3, 2), mode))
    got = _nchw_to_nhwc(tl.pad_spatial(_nhwc_to_nchw(x), (3, 2), mode))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("init_type, std", [
    ("normal", 0.02),
    ("kaiming", np.sqrt(2.0 / (3 * 3 * 64))),
    ("xavier", 0.02 * np.sqrt(2.0 / (3 * 3 * 64 + 3 * 3 * 32))),
])
def test_initializer_scale(init_type, std):
    """Same distributions as the JAX package's init menu, with its fans
    (fan_in = I * prod(k) for a (*k, I, O) kernel). 18432 draws: the sample
    std is within 3% of the true one."""
    w = tl.make_initializer(init_type, 0.02)((3, 3, 64, 32), torch.Generator().manual_seed(0))
    assert abs(float(w.std()) / std - 1) < 0.03
    assert abs(float(w.mean())) < 3 * std / np.sqrt(w.numel())


def test_orthogonal_initializer():
    w = tl.make_initializer("orthogonal", 1.0)((3, 3, 8, 16), torch.Generator().manual_seed(0))
    flat = w.reshape(-1, 16)
    torch.testing.assert_close(flat.T @ flat, torch.eye(16), atol=1e-5, rtol=0)


def test_initializer_is_seeded():
    init = tl.make_initializer("normal", 0.02)
    a = init((3, 3, 4, 4), torch.Generator().manual_seed(5))
    b = init((3, 3, 4, 4), torch.Generator().manual_seed(5))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_norm_act_keeps_layout_and_matches_reference():
    """NormAct on (N, C, H, W) is the instance norm of the (N, H, W, C)
    view, and its output has the input's shape."""
    from ganslate_tpu_torch.ops.instance_norm import instance_norm_reference
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 8, 5, 6)).astype(np.float32))
    got = tl.NormAct("instance", "relu")(x)
    want = instance_norm_reference(x.permute(0, 2, 3, 1).contiguous(), 1e-5, "relu")[0]
    want = want.permute(0, 3, 1, 2)
    assert got.shape == x.shape
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(tl.IdentityNorm()(x), x)
    with pytest.raises(NotImplementedError):
        tl.get_norm_layer("group")


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("features", (6, None), ids=("per-channel", "shared"))
def test_prelu_matches_jax(features, dtype):
    """PReLU over (N, C, D, H, W) against the JAX PReLU over (N, D, H, W, C),
    with the same slopes: equal bit for bit, in bf16 too, since both cast
    the slope to x's dtype and round the product once."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 3, 4, 5, 6)).astype(np.float32)
    slope = (0.25 + 0.2 * rng.normal(size=(features or 1,))).astype(np.float32)
    jdtype, tdtype = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" \
        else (jnp.float32, torch.float32)
    module = jl.PReLU(features)
    want = jax.jit(module.apply)({"params": {"slope": slope}}, jnp.asarray(x).astype(jdtype))
    prelu = tl.PReLU(features)
    assert tuple(prelu.slope.shape) == slope.shape
    with torch.no_grad():
        prelu.slope.copy_(torch.from_numpy(slope))
        got = prelu(_nhwc_to_nchw(x).to(tdtype))
    assert got.dtype == tdtype
    np.testing.assert_array_equal(_nchw_to_nhwc(got.float()),
                                  np.asarray(want.astype(jnp.float32)))


def test_prelu_takes_only_the_plain_form():
    assert torch.equal(tl.PReLU(4).slope.detach(), torch.full((4,), 0.25))
    tl.PReLU(4, s2d_rn=0)
    tl.PReLU(4, s2d_rn=1)
    for kw in (dict(s2d_rn=8), dict(fused_norm=True)):
        with pytest.raises(NotImplementedError, match="plain computation"):
            tl.PReLU(4, **kw)


@pytest.mark.parametrize("s2d", (0, 2))
def test_apply_norm_s2d_is_the_plain_norm(s2d):
    """The JAX package's grouped s2d norm computes the instance norm of the
    unfolded tensor; the port runs that norm for every `s2d`."""
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 4, 6, 6, 6))
                         .astype(np.float32))
    torch.testing.assert_close(tl.apply_norm_s2d("instance", x, 4, s2d),
                               tl.InstanceNorm()(x), rtol=0, atol=0)
    assert tl.apply_norm_s2d("none", x, 4, s2d) is x
