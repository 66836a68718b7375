"""The port's `InvertibleSequence` (`nn/invertible.py`) against the JAX
package's, over the V-Net's coupling block (k5 conv + instance norm +
PReLU), with the stacked JAX block parameters unstacked into the port's
per-block modules by `utils/flax_weights.load_flax_params`.

A (2, 16, 8, 8, 8) input split into halves of 8 channels, 3 blocks, fp32
on the CPU. Tolerance 1e-5 absolute against JAX: 6 convs and norms in a
chain, each summing in another order than XLA (below 1e-6 measured).
Inverse after forward gives the input back to fp32 rounding: each block
adds and then subtracts the same F and G outputs (of order 1), which loses
at most a few ulps of them, so 1e-5 absolute.

The memory-saving backward (recompute-by-inverse) is held against the
stored-activation gradients (float64: exact to rounding), against
`jax.grad` through the JAX custom VJP (fp32, 1e-5 relative L2), through the
compute-dtype cast of the fp32 masters under `functional_call`, and over a
small V-Net CycleGAN train step."""

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
from tests.torch_port_support import one_torch_thread, seeded_params  # noqa: F401

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
    params = seeded_params(_jax_sequence(False), jnp.asarray(x))
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


def _grads(seq, x, weight, inverse=False):
    """Gradients of `(seq(x) * weight).sum()` with respect to `x` and to
    every parameter (None where it gets none)."""
    x = x.clone().requires_grad_(True)
    seq.zero_grad(set_to_none=True)
    (seq(x, inverse) * weight).sum().backward()
    return {"x": x.grad, **{k: p.grad for k, p in seq.named_parameters()}}


def _assert_same_grads(got, want, rtol):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if w is None:
            assert got[k] is None, k
            continue
        rel = float((got[k] - w).norm() / w.norm())
        assert rel <= rtol, f"{k}: relative L2 {rel:.2e}"


@pytest.mark.parametrize("inverse", (False, True), ids=("forward", "inverse"))
def test_memory_saving_matches_stored_activations(case, inverse):
    """float64: the recompute-by-inverse gradients equal the stored-activation
    ones to float64 rounding (the rebuilt inputs differ from the first
    pass's by a float64 ulp; the norms compute in fp32 from them, which
    rounds both to the same values). Inert biases get no gradient in
    either."""
    x, params = case
    x = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))).double()
    weight = torch.randn(x.shape, generator=torch.Generator().manual_seed(5),
                         dtype=torch.float64)
    saving = load_flax_params(_port_sequence(True), params).double()
    stored = load_flax_params(_port_sequence(False), params).double()
    got, want = _grads(saving, x, weight, inverse), _grads(stored, x, weight, inverse)
    assert sum(g is None for g in want.values()) == 2 * N_BLOCKS
    _assert_same_grads(got, want, rtol=1e-12)


@pytest.mark.parametrize("inverse", (False, True), ids=("forward", "inverse"))
def test_memory_saving_matches_jax_custom_vjp(case, inverse):
    """The gradients of the port's recompute-by-inverse backward against
    `jax.grad` through the JAX package's `_make_sequence` custom VJP, fp32,
    1e-5 relative L2 per tensor (the same rounding as the forward, run
    backwards). JAX's inert biases get an exact zero, the port's none."""
    x, params = case
    weight = np.random.default_rng(6).normal(size=x.shape).astype(np.float32)
    module = _jax_sequence(True)

    def loss(p, x):
        return (module.apply({"params": p}, x, inverse=inverse) * weight).sum()

    jax_gp, jax_gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    seq = load_flax_params(_port_sequence(True), params)
    got = _grads(seq, torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))),
                 torch.from_numpy(np.ascontiguousarray(np.moveaxis(weight, -1, 1))), inverse)
    jax_grads = dict(load_flax_params(_port_sequence(), jax.device_get(jax_gp))
                     .named_parameters())
    for k, v in jax_grads.items():
        if got[k] is None:
            assert k.endswith("conv.bias") and not v.any(), k
    want = {"x": torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(jax_gx), -1, 1))),
            **{k: None if got[k] is None else v.detach() for k, v in jax_grads.items()}}
    _assert_same_grads(got, want, rtol=1e-5)


class _Wrapped(torch.nn.Module):
    def __init__(self, seq):
        super().__init__()
        self.core = seq

    def forward(self, x, inverse=False):
        return self.core(x, inverse)


def _master_grads(params, x, weight, use_memory_saving, dtype):
    """The fp32 masters' gradients of `(y * weight).sum()`, where the
    sequence runs under `functional_call` on the masters cast to `dtype`, as
    `BaseGAN.compute_params` casts them."""
    from torch.func import functional_call
    net = _Wrapped(load_flax_params(_port_sequence(use_memory_saving), params))
    cast = {k: p.to(dtype) for k, p in net.named_parameters()}
    y = functional_call(net, cast, (x.to(dtype),))
    assert y.dtype == dtype
    (y.float() * weight).sum().backward()
    grads = {k: p.grad for k, p in net.named_parameters()}
    assert all(g is None or g.dtype == torch.float32 for g in grads.values())
    return grads


def _channels_first_case(case, seed):
    x, params = case
    x = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))
    return x, params, torch.randn(x.shape, generator=torch.Generator().manual_seed(seed))


def test_gradients_reach_the_fp32_masters_through_the_cast(case):
    """Under `functional_call` on cast masters, the memory-saving sequence
    computes with the casts, and their gradients reach the fp32 masters
    through the cast: the stored-activation gradients, to float64 rounding
    (a float64 compute dtype, so that the comparison is exact). With the
    masters frozen (`BaseGAN.frozen`), none gets a gradient, and the input
    still does."""
    from torch.func import functional_call
    x, params, weight = _channels_first_case(case, 7)
    got = _master_grads(params, x, weight, True, torch.float64)
    want = _master_grads(params, x, weight, False, torch.float64)
    assert sum(g is not None for g in got.values()) == 2 * 2 * N_BLOCKS
    _assert_same_grads(got, want, rtol=1e-12)

    net = _Wrapped(load_flax_params(_port_sequence(True), params))
    for p in net.parameters():
        p.requires_grad_(False)
    xg = x.clone().requires_grad_(True)
    cast = {k: p.to(torch.float64) for k, p in net.named_parameters()}
    functional_call(net, cast, (xg.double(),)).sum().backward()
    assert xg.grad is not None and all(p.grad is None for p in net.parameters())


def test_bf16_cast_gradients_are_as_close_to_fp32_as_stored(case):
    """Through the bf16 cast: in bf16 the rebuilt inputs differ from the
    first pass's by a bf16 ulp here and there, so the memory-saving and the
    stored-activation gradients differ by as much as bf16 compute moves
    either from the fp32 gradient (about 5e-2 relative L2 here). So each is
    held against the fp32 stored-activation gradient: the memory-saving run
    may be no farther from it than 1.5 times the stored run, at the median
    tensor and at the worst (as `chip_smoke.py` holds bf16 train steps)."""
    x, params, weight = _channels_first_case(case, 7)
    ref = _master_grads(params, x, weight, False, torch.float32)
    saving = _master_grads(params, x, weight, True, torch.bfloat16)
    stored = _master_grads(params, x, weight, False, torch.bfloat16)
    keys = [k for k, g in ref.items() if g is not None]
    assert [k for k, g in saving.items() if g is not None] == keys

    def dist(grads):
        return {k: float((grads[k] - ref[k]).norm() / ref[k].norm()) for k in keys}

    d_saving, d_stored = dist(saving), dist(stored)
    assert max(d_saving.values()) <= 1.5 * max(d_stored.values())
    assert float(np.median([d_saving[k] / d_stored[k] for k in keys])) <= 1.5


def test_memory_saving_gives_inert_biases_no_gradient(case):
    """The convs' biases before a norm are inert: the backward hands them
    None, not zeros (Adam would move a bias with a zero gradient)."""
    x, params = case
    seq = load_flax_params(_port_sequence(True), params)
    grads = _grads(seq, torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))), 1.0)
    assert [k for k, g in grads.items() if g is None] == \
        [f"blocks.{i}.{f}.conv.bias" for i in range(N_BLOCKS) for f in "FG"]
    assert all(g.abs().sum() > 0 for g in grads.values() if g is not None)


def test_memory_saving_saves_only_its_output():
    """The chain's node saves its output and the blocks' parameters, and no
    other activation: the inputs of the blocks are rebuilt in the
    backward. The stored-activation chain's graph holds many."""
    x = torch.randn(1, CHANNELS, 4, 4, 4, requires_grad=True)
    seq = _port_sequence(use_memory_saving=True)
    y = seq(x)
    node = y.grad_fn
    assert type(node).__name__ == "MemorySavingSequenceBackward"
    saved = node.saved_tensors
    assert torch.equal(saved[0], y) and saved[0].data_ptr() == y.data_ptr()
    params = list(seq.parameters())
    assert len(saved) == 1 + len(params)
    assert all(s is p for s, p in zip(saved[1:], params))
    # Without a gradient to record, the plain chain runs.
    with torch.no_grad():
        assert torch.equal(seq(x), y.detach())
    assert seq.eval()(x.detach()).shape == x.shape


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


def _vnet_cyclegan(out_dir, use_memory_saving):
    from ganslate_tpu_torch.configs.config import Config
    from ganslate_tpu_torch.configs.omega import Conf
    from ganslate_tpu_torch.configs.utils import init_config
    from ganslate_tpu_torch.utils.builders import build_gan
    generator = {"_target_": "ganslate.nn.generators.Vnet3D", "first_layer_channels": 8,
                 "down_blocks": [1, 1], "up_blocks": [1, 1], "use_inverse": False,
                 "in_out_channels": {"AB": [1, 1]}}
    if use_memory_saving is not None:
        generator["use_memory_saving"] = use_memory_saving
    raw = {"train": {
        "output_dir": str(out_dir), "batch_size": 1, "cuda": False, "mixed_precision": False,
        "n_iters": 10, "n_iters_decay": 10, "seed": 2,
        "gan": {"_target_": "ganslate.nn.gans.unpaired.CycleGAN", "pool_size": 0,
                "generator": generator,
                "discriminator": {"_target_": "ganslate.nn.discriminators.PatchGAN3D",
                                  "ndf": 8, "n_layers": 1, "in_channels": {"B": 1}},
                "optimizer": {"lambda_AB": 5.0, "lambda_BA": 5.0, "lambda_identity": 0,
                              "proportion_ssim": 0}}}}
    model = build_gan(init_config(Conf.create(raw), Config))
    return model


def test_vnet_with_memory_saving_trains_a_cyclegan_step(tmp_path):
    """A small Vnet3D built with the V-Net's own default, `use_memory_saving`
    true, takes a CycleGAN train step on the CPU (fp32) and matches the same
    step with stored activations: losses to 1e-5 relative, every gradient to
    1e-4 relative L2 (the rebuilt inputs differ from the first pass's by
    fp32 rounding)."""
    from ganslate_tpu_torch.nn.generators.vnet.vnet import VnetGenerator
    import inspect
    assert inspect.signature(VnetGenerator).parameters["use_memory_saving"].default is True
    rng = np.random.default_rng(3)
    batch = {k: rng.uniform(-1, 1, (1, 16, 16, 16, 1)).astype(np.float32) for k in "AB"}
    runs = {}
    for use_memory_saving in (True, False):
        model = _vnet_cyclegan(tmp_path / str(use_memory_saving), use_memory_saving)
        model.setup(batch)
        assert all(m.use_memory_saving is use_memory_saving
                   for m in model.networks["G_AB"].modules()
                   if isinstance(m, InvertibleSequence))
        model.set_input(batch)
        model.optimize_parameters()
        runs[use_memory_saving] = model
    saving, stored = runs[True], runs[False]
    for k, v in stored.losses.items():
        np.testing.assert_allclose(float(saving.losses[k]), float(v), rtol=1e-5, err_msg=k)
    n_grads = 0
    for name, net in stored.networks.items():
        for (k, p), q in zip(net.named_parameters(), saving.networks[name].parameters()):
            if p.grad is None:
                assert q.grad is None, f"{name}.{k}"
                continue
            n_grads += 1
            rel = float((q.grad - p.grad).norm() / p.grad.norm())
            assert rel <= 1e-4, f"{name}.{k}: relative L2 {rel:.2e}"
    assert n_grads > 20
