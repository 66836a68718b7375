"""The port's Resnet2D generator against the JAX package's, with the JAX
parameters carried across by `utils/flax_weights.load_flax_params`.

Tolerance 1e-4 (fp32, CPU): 10 convs and 6 instance norms in a chain, each
summing in another order than XLA does, and the norms rescale each layer's
rounding noise by 1/std. The few-ulp differences of single layers grow to
about 2e-6 at the tanh output; 1e-4 leaves room for other conv backends."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ganslate_tpu.nn.generators.resnet.resnet2d import Resnet2D as JaxResnet2D
from ganslate_tpu_torch.nn.generators import Resnet2D
from ganslate_tpu_torch.utils.flax_weights import load_flax_params

N_BLOCKS, NGF, SIZE = 2, 8, 32


def _jax_params(module, x, seed=0):
    params = jax.jit(module.init)(jax.random.key(seed), jnp.asarray(x))["params"]
    rng = np.random.default_rng(seed)
    # Non-zero biases (the JAX init gives zeros) so the test sees them.
    return jax.tree_util.tree_map(
        lambda a: np.array(a) if a.ndim > 1
        else (0.1 * rng.normal(size=a.shape)).astype(np.float32), params)


def _port_forward(net, x):
    with torch.no_grad():
        y = net(torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))))
    return np.moveaxis(y.numpy(), 1, -1)


@pytest.fixture(scope="module")
def case():
    x = np.random.default_rng(1).uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    module = JaxResnet2D(in_channels=3, out_channels=3, n_residual_blocks=N_BLOCKS, ngf=NGF)
    params = _jax_params(module, x)
    net = load_flax_params(Resnet2D(3, 3, n_residual_blocks=N_BLOCKS, ngf=NGF), params)
    return x, params, net


def test_resnet2d_matches_jax(case):
    x, params, net = case
    module = JaxResnet2D(in_channels=3, out_channels=3, n_residual_blocks=N_BLOCKS, ngf=NGF)
    want = np.asarray(jax.jit(module.apply)({"params": params}, jnp.asarray(x)))
    got = _port_forward(net, x)
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_resnet2d_matches_jax_cells_boundary(case):
    """The JAX cells-boundary execution form computes the same function with
    the same parameters; the port runs its plain path for it."""
    x, params, net = case
    module = JaxResnet2D(in_channels=3, out_channels=3, n_residual_blocks=N_BLOCKS, ngf=NGF,
                         use_cells_boundary=True)
    want = np.asarray(jax.jit(module.apply)({"params": params}, jnp.asarray(x)))
    port = Resnet2D(3, 3, n_residual_blocks=N_BLOCKS, ngf=NGF, use_cells_boundary=True)
    port.load_state_dict(net.state_dict())
    np.testing.assert_allclose(_port_forward(port, x), want, atol=1e-4, rtol=0)


def test_parameters_registered_in_forward_order():
    net = Resnet2D(3, 3, n_residual_blocks=N_BLOCKS, ngf=NGF)
    layers = [name.rsplit(".", 1)[0] for name, _ in net.named_parameters()][::2]
    assert layers == ["initial", "down0", "down1", "res0.conv1", "res0.conv2",
                      "res1.conv1", "res1.conv2", "up0", "up1", "out"]
    shapes = {name: tuple(p.shape) for name, p in net.named_parameters()}
    assert shapes["initial.weight"] == (NGF, 3, 7, 7)
    assert shapes["up0.weight"] == (4 * NGF, 2 * NGF, 3, 3)     # (I, O, k, k)
    assert shapes["out.weight"] == (3, NGF, 7, 7)


def test_parameter_count_matches_jax(case):
    _, params, net = case
    n_jax = sum(a.size for a in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in net.parameters()) == n_jax


def test_full_width_parameter_count():
    """The horse2zebra G (9 blocks, ngf 64): 11.38 M parameters."""
    with torch.device("meta"):
        net = Resnet2D(3, 3)
    assert sum(p.numel() for p in net.parameters()) == 11_378_179


def test_init_is_seeded():
    a = Resnet2D(3, 3, n_residual_blocks=1, ngf=8, generator=torch.Generator().manual_seed(3))
    b = Resnet2D(3, 3, n_residual_blocks=1, ngf=8, generator=torch.Generator().manual_seed(3))
    for (_, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)


def test_load_flax_params_rejects_leftover_key(case):
    _, params, _ = case
    bad = dict(params)
    bad["extra"] = {"kernel": np.zeros((3, 3, 8, 8), np.float32)}
    with pytest.raises(KeyError, match="extra"):
        load_flax_params(Resnet2D(3, 3, n_residual_blocks=N_BLOCKS, ngf=NGF), bad)


def test_load_flax_params_rejects_missing_key(case):
    _, params, _ = case
    bad = {k: v for k, v in params.items() if k != "up1"}
    with pytest.raises(KeyError, match="up1"):
        load_flax_params(Resnet2D(3, 3, n_residual_blocks=N_BLOCKS, ngf=NGF), bad)


def test_load_flax_params_rejects_wrong_shape(case):
    _, params, _ = case
    bad = dict(params)
    bad["out"] = {"kernel": np.zeros((7, 7, NGF, 4), np.float32),
                  "bias": np.zeros((4,), np.float32)}
    with pytest.raises(ValueError, match="out"):
        load_flax_params(Resnet2D(3, 3, n_residual_blocks=N_BLOCKS, ngf=NGF), bad)
