"""The port's RevGAN slice against the JAX package's: Piresnet3D
(`nn/generators/resnet/piresnet3d.py`), PatchGAN3D, and the RevGAN train
step (`nn/gans/unpaired/revgan.py`) with the shared invertible core trained
by recompute-by-inverse on both sides (`use_memory_saving: true`).

Small sizes, as the JAX package's `tests/test_revgan.py`: Piresnet3D of
depth 2 with 4 first-layer channels, PatchGAN3D with ndf 8 and 1 layer, (8,
16, 16) patches of 1 channel, batch 2, fp32 on the CPU, pool 0 (the pools'
draws cannot match). One JAX RevGAN is built for the whole file (one
train-step compile), its parameters the port's seeded ones carried by the
JAX package's `torch_import` (`tests/torch_port_support.py:jax_params_from`:
nothing of the JAX init compiles) and loaded back into the port by
`utils/flax_weights.load_flax_params`.

Tolerances, as the CycleGAN lockstep (`test_torch_port_train_step.py`):
- forwards with carried weights (non-zero biases): 1e-5 absolute on tanh
  outputs and on logits of order 1, through 10 convs and norms that each
  sum in another order than XLA;
- losses and metrics per step, rtol 1e-4 (atol 1e-6 for the SSIM metrics);
- every gradient after step 1, 1e-4 relative L2 per tensor (JAX's read
  from Adam's first moment, an exact halving);
- every parameter after step 3, 1e-5 absolute (5% of one Adam step at
  lr_G 4e-4 / lr_D 2e-4 is 1e-5 and 2e-5)."""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ganslate_tpu_torch.engines.utils import init_engine
from ganslate_tpu_torch.nn.discriminators import PatchGAN3D
from ganslate_tpu_torch.nn.generators import Piresnet3D
from ganslate_tpu_torch.utils.builders import build_gan
from ganslate_tpu_torch.utils.flax_weights import load_flax_params
from ganslate_tpu_torch.utils.testing import make_revgan_conf
from tests.torch_port_support import (jax_params_from, one_torch_thread,  # noqa: F401
                                      seeded_states)

SMALL = dict(depth=2, first_layer_channels=4, ndf=8, n_layers_D=1, patch=(8, 16, 16))
BATCH = 2
NETWORKS = ("G", "D_B", "D_A")
LOSSES = ["G_AB", "G_BA", "cycle_A", "cycle_B", "D_B", "D_A"]
METRICS = ["ssim_A", "ssim_B", "D_B_real", "D_B_fake", "D_A_real", "D_A_fake"]
ATOL = 1e-5


def _batches(n, seed=7):
    rng = np.random.default_rng(seed)
    return [{k: rng.uniform(-1, 1, (BATCH, *SMALL["patch"], 1)).astype(np.float32)
             for k in ("A", "B")} for _ in range(n)]


def _metrics_on(conf):
    conf.train.metrics.discriminator_evolution = True
    conf.train.metrics.ssim = True
    return conf


def _port_conf(out_dir, **kw):
    conf = make_revgan_conf(str(out_dir), cuda=False, mixed_precision=False, pool_size=0,
                            batch_size=BATCH, **{**SMALL, **kw})
    return _metrics_on(conf)


def _jax_model(out_dir, batch):
    """The JAX RevGAN of the port's config (the same raw tree, without the
    port's infer section)."""
    from ganslate_tpu.configs.config import Config as JaxConfig
    from ganslate_tpu.configs.omega import Conf as JaxConf
    from ganslate_tpu.configs.utils import init_config as jax_init_config
    from ganslate_tpu.utils.builders import build_gan as jax_build_gan
    raw = {"train": _port_conf(out_dir).to_container(resolve=False)["train"]}
    for key in ("dataset", "logging", "checkpointing"):
        raw["train"].pop(key, None)
    conf = _metrics_on(jax_init_config(JaxConf.create(raw), JaxConfig))
    model = jax_build_gan(conf)
    with jax_params_from(seeded_states(_port_conf(out_dir).to_container(resolve=False))):
        model.setup(example_batch=batch)
    return model


def _as_port(net, tree):
    """A JAX tree (parameters, or gradients) in the port's names and layout."""
    return dict(load_flax_params(copy.deepcopy(net), tree).named_parameters())


def _floats(d):
    return {k: float(v) for k, v in d.items()}


@pytest.fixture(scope="module")
def lockstep(tmp_path_factory):
    out = tmp_path_factory.mktemp("revgan")
    batches = _batches(3)
    jax_model = _jax_model(out, batches[0])
    init = jax.device_get(jax_model.state.params)

    jax_logs, jax_grads = [], None
    for i, batch in enumerate(batches):
        jax_model.set_input(batch)
        jax_model.optimize_parameters()
        jax_logs.append({**_floats(jax.device_get(jax_model.losses)),
                         **_floats(jax.device_get(jax_model.metrics))})
        if i == 0:
            jax_grads = {}
            for group in ("G", "D"):
                mu = jax.device_get(jax_model.state.opt_state[group].inner_state[0].mu)
                jax_grads.update({name: jax.tree_util.tree_map(lambda m: 2 * np.asarray(m), t)
                                  for name, t in mu.items()})

    model = build_gan(_port_conf(out))
    model.setup(batches[0])
    for name in NETWORKS:
        load_flax_params(model.networks[name], init[name])
    initial = {name: {k: p.detach().clone() for k, p in net.named_parameters()}
               for name, net in model.networks.items()}
    port_logs, port_grads = [], None
    for i, batch in enumerate(batches):
        model.set_input(batch)
        model.optimize_parameters()
        _, losses, _, metrics = model.get_loggable_data()
        port_logs.append({**_floats(losses), **_floats(metrics)})
        if i == 0:
            port_grads = {name: {k: None if p.grad is None else p.grad.clone()
                                 for k, p in net.named_parameters()}
                          for name, net in model.networks.items()}
    return dict(out=out, jax_model=jax_model, init=init, model=model, initial=initial,
                batches=batches, jax_logs=jax_logs, port_logs=port_logs,
                jax_grads=jax_grads, port_grads=port_grads,
                jax_params=jax.device_get(jax_model.state.params))


def _with_random_biases(tree, seed=0):
    """`tree` with every bias drawn around 0 (the initial ones are zero)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (0.1 * rng.normal(size=a.shape)).astype(np.float32)
        if path[-1].key == "bias" else np.array(a), tree)


def _channels_first(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


# ---------------------------------------------------------------- networks


@pytest.mark.parametrize("inverse", (False, True), ids=("AB", "BA"))
def test_piresnet3d_matches_jax(lockstep, inverse):
    module = lockstep["jax_model"].networks["G"]
    params = _with_random_biases(lockstep["init"]["G"])
    x = _batches(1, seed=9)[0]["A"]
    want = np.asarray(jax.jit(lambda p, x: module.apply({"params": p}, x, inverse=inverse))(
        params, jnp.asarray(x)))
    net = load_flax_params(Piresnet3D(1, 1, depth=2, first_layer_channels=4), params)
    with torch.no_grad():
        got = np.moveaxis(net(_channels_first(x), inverse=inverse).numpy(), 1, -1)
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_piresnet3d_features_match_jax(lockstep):
    """`extract_features`: the down path's output (0) and the core's (1)."""
    module = lockstep["jax_model"].networks["G"]
    params = _with_random_biases(lockstep["init"]["G"])
    x = _batches(1, seed=9)[0]["A"]
    want = jax.jit(lambda p, x: module.apply({"params": p}, x, extract_features=(0, 1)))(
        params, jnp.asarray(x))
    net = load_flax_params(Piresnet3D(1, 1, depth=2, first_layer_channels=4), params)
    with torch.no_grad():
        got = net(_channels_first(x), extract_features=(0, 1))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert tuple(g.shape) == (BATCH, 8, 4, 8, 8)
        np.testing.assert_allclose(np.moveaxis(g.numpy(), 1, -1), np.asarray(w), atol=ATOL,
                                   rtol=0)


def test_patchgan3d_matches_jax(lockstep):
    module = lockstep["jax_model"].networks["D_B"]
    params = _with_random_biases(lockstep["init"]["D_B"], seed=1)
    x = _batches(1, seed=10)[0]["B"]
    want = np.asarray(jax.jit(lambda p, x: module.apply({"params": p}, x))(
        params, jnp.asarray(x)))
    net = load_flax_params(PatchGAN3D(1, ndf=8, n_layers=1), params)
    with torch.no_grad():
        got = np.moveaxis(net(_channels_first(x)).numpy(), 1, -1)
    assert got.shape == want.shape == (BATCH, 2, 6, 6, 1)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_inverse_needs_use_inverse():
    net = Piresnet3D(1, 1, depth=1, first_layer_channels=4, use_inverse=False)
    assert not any(n.startswith(("down_ba", "up_ba")) for n, _ in net.named_parameters())
    x = torch.zeros(1, 1, 8, 8, 8)
    assert net(x).shape == x.shape
    with pytest.raises(ValueError, match="use_inverse"):
        net(x, inverse=True)


def test_s2d_exec_refuses_the_extents_jax_refuses():
    net = Piresnet3D(1, 1, depth=1, first_layer_channels=4, use_s2d_exec=True)
    assert net(torch.zeros(1, 1, 8, 8, 8)).shape == (1, 1, 8, 8, 8)
    with pytest.raises(ValueError, match="divisible by 4"):
        net(torch.zeros(1, 1, 8, 8, 6))


def test_parameters_registered_in_the_original_order(lockstep):
    """The port's state dict, read in registration order by the JAX
    package's importer of original ganslate checkpoints (`flax_param_spec`,
    sorted by Piresnet3D's `torch_param_order_rank`: down_ab, up_ab,
    down_ba, up_ba, core), gives back the JAX parameters."""
    from ganslate_tpu.utils.torch_import import convert_state_dict, flax_param_spec
    module = lockstep["jax_model"].networks["G"]
    params = _with_random_biases(lockstep["init"]["G"])
    net = load_flax_params(Piresnet3D(1, 1, depth=2, first_layer_channels=4), params)
    assert [n.split(".")[0] for n, _ in net.named_parameters()][::4] == \
        ["down_ab", "up_ab", "down_ba", "up_ba", "core", "core"]
    imported = convert_state_dict(net.state_dict(), flax_param_spec(
        module, jnp.zeros((1, *SMALL["patch"], 1))))
    flat_want = jax.tree_util.tree_leaves_with_path(params)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(imported))
    assert len(flat_got) == len(flat_want)
    for path, want in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[path]), want,
                                      err_msg=jax.tree_util.keystr(path))


# ------------------------------------------------------------------ train


def test_losses_and_metrics_match_jax_each_step(lockstep):
    for step, (got, want) in enumerate(zip(lockstep["port_logs"], lockstep["jax_logs"])):
        assert sorted(got) == sorted(want) == sorted(LOSSES + METRICS)
        for key in want:
            atol = 1e-6 if key.startswith("ssim") else 0
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=atol,
                                       err_msg=f"step {step + 1}, {key}")


def test_gradients_after_step_1_match_jax(lockstep):
    model = lockstep["model"]
    n_inert = 0
    for name in NETWORKS:
        want = _as_port(model.networks[name], lockstep["jax_grads"][name])
        for k, got in lockstep["port_grads"][name].items():
            w = want[k].detach()
            if got is None:         # an inert bias: no gradient, exactly zero in JAX
                assert k.endswith(".bias") and not w.any(), f"{name}.{k}"
                n_inert += 1
                continue
            rel = float((got - w).norm() / w.norm())
            assert rel <= 1e-4, f"{name}.{k}: relative L2 {rel:.2e}"
    # G: conv1 and conv2 of both down paths, convt of both up paths, the
    # convs of the core's 2 blocks (F and G); each D (1 layer): penultimate.
    assert n_inert == 2 * 2 + 2 + 2 * 2 + 2 * 1


def test_parameters_after_step_3_match_jax(lockstep):
    model = lockstep["model"]
    for name in NETWORKS:
        want = _as_port(model.networks[name], lockstep["jax_params"][name])
        for k, p in model.networks[name].named_parameters():
            torch.testing.assert_close(p.detach(), want[k].detach(), rtol=0, atol=1e-5,
                                       msg=f"{name}.{k}")
            if lockstep["port_grads"][name][k] is None:
                assert torch.equal(p.detach(), lockstep["initial"][name][k])


def test_shared_core_takes_both_cycles_gradients(lockstep):
    """The core's step-1 gradient is the sum of what each of the G losses
    sends it through the four uses of the core (fake_B and rec_B forward,
    rec_A and fake_A inverted): both cycles' terms reach it, and the sum
    matches the step's gradient (which matched JAX)."""
    model = build_gan(_port_conf(lockstep["out"] / "terms"))
    batch = lockstep["batches"][0]
    model.setup(batch)
    for name in NETWORKS:
        load_flax_params(model.networks[name], lockstep["init"][name])
    model.set_input(batch)
    real_A, real_B = model._batch["A"], model._batch["B"]
    core = [p for k, p in model.networks["G"].named_parameters()
            if k.startswith("core") and k.endswith("weight")]
    with model.frozen(["D_B", "D_A"]):
        fake_B = model.apply("G", real_A)
        rec_A = model.apply("G", fake_B, inverse=True)
        fake_A = model.apply("G", real_B, inverse=True)
        rec_B = model.apply("G", fake_A)
        adv = model.criterion_adv
        terms = {"G_AB": adv(model.apply("D_B", fake_B), True),
                 "G_BA": adv(model.apply("D_A", fake_A), True),
                 **model.criterion_G({"real_A": real_A, "fake_B": fake_B, "rec_A": rec_A,
                                      "real_B": real_B, "fake_A": fake_A, "rec_B": rec_B})}
        grads = {k: torch.autograd.grad(v, core, retain_graph=True) for k, v in terms.items()}
    assert sorted(terms) == ["G_AB", "G_BA", "cycle_A", "cycle_B"]
    for k in ("cycle_A", "cycle_B"):
        assert all(float(g.norm()) > 0 for g in grads[k]), k
    step = [g for k, g in lockstep["port_grads"]["G"].items()
            if k.startswith("core") and k.endswith("weight")]
    for i, want in enumerate(step):
        got = sum(grads[k][i] for k in terms)
        assert float((got - want).norm() / want.norm()) <= 1e-5


# ------------------------------------------------------------------ serve


def test_infer_ba_runs_the_inverted_generator(lockstep):
    model = lockstep["model"]
    x = torch.from_numpy(_batches(1, seed=12)[0]["B"])
    net = model.networks["G"]
    with torch.no_grad():
        want_ab = net(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
        want_ba = net(x.permute(0, 4, 1, 2, 3), inverse=True).permute(0, 2, 3, 4, 1)
    got_ab, got_ba = model.infer(x), model.infer(x, direction="BA")
    assert got_ba.dtype == torch.float32 and got_ba.shape == x.shape
    torch.testing.assert_close(got_ab, want_ab, rtol=0, atol=0)
    torch.testing.assert_close(got_ba, want_ba, rtol=0, atol=0)
    assert float((got_ab - got_ba).abs().max()) > 1e-3
    assert list(model._serving) == ["G"]
    with pytest.raises(ValueError, match="direction"):
        model.infer(x, direction="AA")


def test_checkpoint_serves_both_directions_through_init_engine(lockstep, tmp_path):
    """save_checkpoint -> `init_engine("infer")` from a YAML of the config
    (deployment, fp32 wire, a sliding window of the patch size) serves
    what `model.infer` gives, in both directions."""
    model = lockstep["model"]
    model.save_checkpoint(3)
    checkpoint = torch.load(lockstep["out"] / "checkpoints" / "3.pth", weights_only=True)
    assert sorted(checkpoint) == sorted([*NETWORKS, "optimizer_G", "optimizer_D"])
    conf = _port_conf(lockstep["out"], load_iter=3)
    conf.infer.wire_dtype = "float32"
    path = tmp_path / "revgan.yaml"
    path.write_text(conf.to_yaml())
    engine = init_engine("infer", [f"config={path}"])
    assert list(engine.model.networks) == ["G"]
    x = _batches(1, seed=13)[0]["A"]
    for direction in ("AB", "BA"):
        got = engine.infer(x, direction=direction)
        want = model.infer(torch.from_numpy(x), direction=direction)
        assert got.dtype == torch.float32 and got.shape == x.shape
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
