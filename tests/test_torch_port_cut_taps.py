"""The generators' CUT encoder taps against the JAX package's
`extract_features` (Resnet2D at every index, Vnet3D), Resnet3D, and what a
tap call changes: live raw-conv biases, no work past the last tap.

Random parameters of the JAX modules' shapes (kernels N(0, 0.05), biases
N(0, 0.1), PReLU slopes 0.25 + N(0, 0.05)), carried into the port by
`utils/flax_weights.load_flax_params`; fp32 on the CPU. Tolerance: 1e-5
absolute (a few convs and norms that each sum in another order than XLA,
on values of order 1)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ganslate_tpu_torch.nn.generators import Resnet2D, Resnet3D, Vnet3D
from ganslate_tpu_torch.utils.flax_weights import load_flax_params
from tests.torch_port_support import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-5


def _input(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def _random_params(module, x, seed=0):
    """Random parameters of `module`'s shapes, from `jax.eval_shape` (no
    compile of its init)."""
    shapes = jax.eval_shape(module.init, jax.random.key(0), jnp.asarray(x))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        scale, offset = {"kernel": (0.05, 0.0), "bias": (0.1, 0.0)}.get(name, (0.05, 0.25))
        return (offset + scale * rng.normal(size=leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _channels_first(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _channels_last(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def test_resnet2d_taps_match_jax():
    """Every tap index of the ResNet encoder against the JAX package's
    `extract_features`, with random biases: the raw conv taps (1, 4, 7)
    carry theirs."""
    from ganslate_tpu.nn.generators.resnet.resnet2d import Resnet2D as JaxResnet2D
    module = JaxResnet2D(in_channels=1, out_channels=1, n_residual_blocks=1, ngf=8)
    x = _input((2, 32, 32, 1), seed=9)
    params = _random_params(module, x)
    levels = list(range(11))
    want = jax.jit(lambda p, x: module.apply({"params": p}, x, extract_features=levels))(
        params, jnp.asarray(x))
    net = load_flax_params(Resnet2D(1, 1, n_residual_blocks=1, ngf=8), params)
    assert net.num_feature_levels == module.num_feature_levels == 11
    with torch.no_grad():
        got = net(_channels_first(x), extract_features=levels)
    for i, (g, w) in enumerate(zip(got, want)):
        assert _channels_last(g).shape == np.shape(w), i
        np.testing.assert_allclose(_channels_last(g), np.asarray(w), atol=ATOL, rtol=0,
                                   err_msg=f"tap {i}")


def test_tap_call_gives_the_raw_conv_biases_a_gradient():
    """The normal forward leaves the biases before a norm without a gradient;
    a tap call of a raw conv output gives that conv's bias one."""
    net = Resnet2D(1, 1, n_residual_blocks=1, ngf=4)
    x = torch.randn(1, 1, 16, 16)
    net(x).sum().backward()
    assert net.down0.bias.grad is None and net.initial.bias.grad is None
    net.zero_grad()
    net(x, extract_features=[4])[0].sum().backward()
    assert torch.equal(net.down0.bias.grad, torch.full((8,), 64.0))
    assert net.res0.conv1.bias.grad is None


def test_taps_stop_at_the_last_requested():
    net = Resnet2D(1, 1, n_residual_blocks=2, ngf=4)
    calls = []
    net.res1.register_forward_hook(lambda *a: calls.append("res1"))
    net.up0.register_forward_hook(lambda *a: calls.append("up0"))
    x = torch.randn(1, 1, 16, 16)
    assert [tuple(f.shape) for f in net(x, extract_features=[8, 0, 10])] == [
        (1, 16, 4, 4), (1, 1, 22, 22), (1, 16, 4, 4)]
    assert calls == []
    with pytest.raises(ValueError, match="out of range"):
        net(x, extract_features=[12])


def test_vnet3d_taps_match_jax():
    from ganslate_tpu.nn.generators.vnet.vnet3d import Vnet3D as JaxVnet3D
    kw = dict(first_layer_channels=4, down_blocks=(1, 1), up_blocks=(1, 1),
              use_memory_saving=False, use_inverse=False)
    module = JaxVnet3D(in_channels=1, out_channels=1, **kw)
    x = _input((2, 8, 16, 16, 1), seed=11)
    params = _random_params(module, x, seed=2)
    want = jax.jit(lambda p, x: module.apply({"params": p}, x, extract_features=[2, 0, 1]))(
        params, jnp.asarray(x))
    net = load_flax_params(Vnet3D(1, 1, **kw), params)
    assert net.num_feature_levels == module.num_feature_levels == 3
    calls = []
    net.ups_0.register_forward_hook(lambda *a: calls.append("ups_0"))
    with torch.no_grad():
        got = net(_channels_first(x), extract_features=[2, 0, 1])
    assert calls == []
    for g, w, c in zip(got, want, (16, 4, 8)):
        assert g.shape[1] == c
        np.testing.assert_allclose(_channels_last(g), np.asarray(w), atol=ATOL, rtol=0)


def test_resnet3d_matches_jax():
    from ganslate_tpu.nn.generators.resnet.resnet3d import Resnet3D as JaxResnet3D
    module = JaxResnet3D(in_channels=1, out_channels=1, n_residual_blocks=1, ngf=4)
    x = _input((1, 8, 12, 16, 1), seed=12)
    params = _random_params(module, x, seed=3)
    want = np.asarray(jax.jit(lambda p, x: module.apply({"params": p}, x))(
        params, jnp.asarray(x)))
    taps = jax.jit(lambda p, x: module.apply({"params": p}, x, extract_features=[0, 7, 10]))(
        params, jnp.asarray(x))
    net = load_flax_params(Resnet3D(1, 1, n_residual_blocks=1, ngf=4), params)
    with torch.no_grad():
        got = _channels_last(net(_channels_first(x)))
        got_taps = net(_channels_first(x), extract_features=[0, 7, 10])
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    for g, w in zip(got_taps, taps):
        np.testing.assert_allclose(_channels_last(g), np.asarray(w), atol=ATOL, rtol=0)


def test_resnet3d_s2d_switch_refuses_what_jax_refuses():
    net = Resnet3D(1, 1, n_residual_blocks=1, ngf=4, use_s2d_exec=True)
    assert net(torch.zeros(1, 1, 8, 8, 8)).shape == (1, 1, 8, 8, 8)
    with pytest.raises(ValueError, match="divisible by 8"):
        net(torch.zeros(1, 1, 8, 8, 12))
    with pytest.raises(ValueError, match="CUT feature taps"):
        net(torch.zeros(1, 1, 8, 8, 8), extract_features=[0])

