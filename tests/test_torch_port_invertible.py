"""The port's `InvertibleSequence` (`nn/invertible.py`) against the JAX
package's, over the V-Net's coupling block (k5 conv + instance norm +
PReLU), with the stacked JAX block parameters unstacked into the port's
per-block modules by `utils/flax_weights.load_flax_params`.

A (2, 16, 8, 8, 8) input split into halves of 8 channels, 3 blocks, fp32
on the CPU. Tolerance 1e-5 absolute against JAX: 6 convs and norms in a
chain, each summing in another order than XLA (below 1e-6 measured).
Inverse after forward gives the input back to fp32 rounding: each block
adds and then subtracts the same F and G outputs (of order 1), which loses
at most a few ulps of them, so 1e-5 absolute."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ganslate_tpu.nn.generators.vnet.vnet import VnetInvBlock as JaxVnetInvBlock
from ganslate_tpu.nn.invertible import InvertibleSequence as JaxInvertibleSequence
from ganslate_tpu.nn.layers import make_initializer as jax_initializer
from ganslate_tpu_torch.nn.generators.vnet.vnet import VnetInvBlock
from ganslate_tpu_torch.nn.invertible import InvertibleSequence
from ganslate_tpu_torch.nn.layers import make_initializer
from ganslate_tpu_torch.utils.flax_weights import load_flax_params

CHANNELS, N_BLOCKS = 16, 3
ATOL = 1e-5


def _jax_sequence(use_memory_saving):
    init = jax_initializer("normal", 0.02)
    return JaxInvertibleSequence(
        channels=CHANNELS, n_blocks=N_BLOCKS, norm_type="instance", spatial_dims=3,
        use_memory_saving=use_memory_saving, kernel_init=init,
        block_template=JaxVnetInvBlock(CHANNELS // 2, "instance", 3, False, init))


def _port_sequence(use_memory_saving=False, generator=None):
    return InvertibleSequence(
        N_BLOCKS, lambda: VnetInvBlock(CHANNELS // 2, "instance", 3, make_initializer(),
                                       generator),
        use_memory_saving)


@pytest.fixture(scope="module")
def case():
    x = np.random.default_rng(1).normal(size=(2, 8, 8, 8, CHANNELS)).astype(np.float32)
    params = jax.jit(_jax_sequence(False).init)(jax.random.key(0), jnp.asarray(x))["params"]
    rng = np.random.default_rng(0)
    # Non-zero biases and slopes away from 0.25, per block.
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: np.array(a) if path[-1].key == "kernel"
        else (0.1 * rng.normal(size=a.shape) + (0.25 if path[-1].key == "slope" else 0)
              ).astype(np.float32), params)
    return x, params


def _port_apply(seq, x, inverse=False):
    with torch.no_grad():
        y = seq(torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))), inverse)
    return np.moveaxis(y.numpy(), 1, -1)


@pytest.mark.parametrize("inverse", (False, True), ids=("forward", "inverse"))
@pytest.mark.parametrize("use_memory_saving", (False, True))
def test_matches_jax(case, use_memory_saving, inverse):
    x, params = case
    module = _jax_sequence(use_memory_saving)
    want = np.asarray(jax.jit(lambda p, x: module.apply({"params": p}, x, inverse=inverse))(
        params, jnp.asarray(x)))
    seq = load_flax_params(_port_sequence(use_memory_saving), params).eval()
    got = _port_apply(seq, x, inverse)
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_inverse_undoes_forward(case):
    x, params = case
    seq = load_flax_params(_port_sequence(), params)
    y = _port_apply(seq, x)
    assert np.abs(y - x).max() > 0.1
    np.testing.assert_allclose(_port_apply(seq, y, inverse=True), x, atol=ATOL, rtol=0)
    np.testing.assert_allclose(_port_apply(seq, _port_apply(seq, x, inverse=True)), x,
                               atol=ATOL, rtol=0)


def test_blocks_are_registered_block_by_block():
    """Block i's F, then its G (conv weight, conv bias, PReLU slope each),
    as the original ganslate's couplings register them."""
    names = [n for n, _ in _port_sequence().named_parameters()]
    assert names == [f"blocks.{i}.{f}.{leaf}" for i in range(N_BLOCKS) for f in "FG"
                     for leaf in ("conv.weight", "conv.bias", "PReLU_0.slope")]


def test_blocks_are_independent():
    seq = _port_sequence(generator=torch.Generator().manual_seed(0))
    weights = [b[f].conv.weight for b in seq.blocks for f in "FG"]
    assert all(not torch.equal(a, b) for i, a in enumerate(weights) for b in weights[i + 1:])


def test_memory_saving_training_raises():
    """The recompute-by-inverse backward is not ported: a sequence that
    would record a gradient through it raises; without a gradient it runs."""
    x = torch.randn(1, CHANNELS, 4, 4, 4)
    seq = _port_sequence(use_memory_saving=True)
    with pytest.raises(NotImplementedError, match="recompute-by-inverse"):
        seq(x)
    with torch.no_grad():
        assert seq(x).shape == x.shape
    assert seq.eval()(x).shape == x.shape


def test_stored_activations_train():
    x = torch.randn(1, CHANNELS, 4, 4, 4, requires_grad=True)
    seq = _port_sequence(use_memory_saving=False)
    seq(x).square().sum().backward()
    assert x.grad is not None and x.grad.abs().sum() > 0
    assert all(p.grad is not None for n, p in seq.named_parameters() if "bias" not in n)


def test_loader_rejects_a_stack_of_the_wrong_length(case):
    _, params = case
    blocks = jax.tree_util.tree_map(lambda a: a[:2], params["blocks"])
    with pytest.raises(ValueError, match=f"stack {N_BLOCKS} blocks"):
        load_flax_params(_port_sequence(), {"blocks": blocks})
