"""The port's CUT slice against the JAX package's: `PatchNCELoss`,
`FeaturePatchMLP`, and the CUT / FastCUT train step
(`nn/gans/unpaired/cut.py`). The generators' taps are held against the JAX
package's in `test_torch_port_cut_taps.py`.

Small sizes, as the JAX package's `tests/test_cut.py`: Resnet2D with 1
residual block and ngf 8, PatchGAN2D with ndf 8 and 1 layer, 32x32 inputs of
1 channel, batch 2, `nce_layers` [0, 4, 8, 10], `mlp_nc` 16, `num_patches`
16, identity NCE on, fp32 on the CPU. One JAX CUT (and one JAX FastCUT) is
built for the file, its parameters the port's seeded ones carried by the
JAX package's `torch_import` (`tests/torch_port_support.py:jax_params_from`:
nothing of the JAX init compiles) and loaded back into the port by
`utils/flax_weights.load_flax_params`. The JAX step draws its patch ids and
flip from threefry keys, the port from its generator: the test computes
JAX's draws from the JAX state's key and hands them to the port through
`cut.draw_patch_ids` and `cut.draw_flip`, monkeypatched here only.

Tolerances:
- PatchNCE, 1e-5 absolute on per-patch losses of order 1-5 (fp32; one
  batched product and a log-softmax over 17 logits scaled by 1/0.07);
- the MLP, and the trained G's forward and taps, 1e-5 absolute (a few
  convs and norms that each sum in another order than XLA);
- losses per step, rtol 1e-4; every gradient after step 1, 1e-4 relative
  L2 per tensor (JAX's read from Adam's first moment, an exact halving);
  every parameter after step 3, 1e-5 absolute (5% of one Adam step at
  lr_G 4e-4).
- Except: the stem's and down1's conv biases. Their convs feed an instance
  norm, which cancels a bias, so the normal forward leaves them without a
  gradient (`bias_inert`); the tap call gives them one, as the JAX package
  does, but with these `nce_layers` they reach a tap only through a norm
  (taps 4, 8 and 10), and their gradient is rounding noise in both packages,
  which Adam turns into different steps of up to lr_G each. The outputs and
  taps depend on them only through rounding: those are compared after step
  3 instead. down0's bias reaches tap 4 directly and trains for real: it is
  held to the bounds above."""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ganslate_tpu_torch.engines.utils import init_engine
from ganslate_tpu_torch.nn.gans.unpaired import cut
from ganslate_tpu_torch.nn.losses.cut_losses import PatchNCELoss
from ganslate_tpu_torch.utils.builders import build_gan
from ganslate_tpu_torch.utils.flax_weights import load_flax_params
from ganslate_tpu_torch.utils.testing import make_cut_conf
from tests.torch_port_support import (jax_params_from, one_torch_thread,  # noqa: F401
                                      seeded_states)

BATCH = 2
SIZE = 32
NCE_LAYERS = (0, 4, 8, 10)
NETWORKS = ("G", "D", "mlp")
NOISE_BIASES = {"G.initial.bias", "G.down1.bias"}
ATOL = 1e-5
RESNET = {"_target_": "ganslate.nn.generators.Resnet2D", "n_residual_blocks": 1, "ngf": 8,
          "in_out_channels": {"AB": [1, 1]}}
PATCHGAN = {"_target_": "ganslate.nn.discriminators.PatchGAN2D", "ndf": 8, "n_layers": 1,
            "in_channels": {"B": 1}}


def _port_conf(out_dir, **kw):
    kw = {"generator": RESNET, "discriminator": PATCHGAN, "patch": (SIZE, SIZE),
          "nce_layers": NCE_LAYERS, "mlp_nc": 16, "num_patches": 16, "cuda": False,
          "mixed_precision": False, "batch_size": BATCH, **kw}
    conf = make_cut_conf(str(out_dir), **kw)
    conf.train.metrics.discriminator_evolution = True
    return conf


def _jax_model(conf, batch):
    """The JAX CUT of the port's config (its train section)."""
    from ganslate_tpu.configs.config import Config as JaxConfig
    from ganslate_tpu.configs.omega import Conf as JaxConf
    from ganslate_tpu.configs.utils import init_config as jax_init_config
    from ganslate_tpu.utils.builders import build_gan as jax_build_gan
    raw = {"train": conf.to_container(resolve=False)["train"]}
    for key in ("dataset", "logging", "checkpointing"):
        raw["train"].pop(key, None)
    model = jax_build_gan(jax_init_config(JaxConf.create(raw), JaxConfig))
    with jax_params_from(seeded_states(conf.to_container(resolve=False))):
        model.setup(example_batch=batch)
    return model


def _batches(n, seed=7, shape=(BATCH, SIZE, SIZE, 1)):
    rng = np.random.default_rng(seed)
    return [{k: rng.uniform(-1, 1, shape).astype(np.float32) for k in ("A", "B")}
            for _ in range(n)]


def _jax_draws(jax_model, batch):
    """The flip and the patch ids (NCE, then identity NCE) that the JAX
    train step draws from its state's key for `batch`: the keys of its
    `split(rng, 7)`, one permutation per level of the taps' positions."""
    module = jax_model.networks["G"]
    params = jax_model.state.params["G"]
    feats = jax.eval_shape(lambda p, x: module.apply({"params": p}, x,
                                                     extract_features=list(NCE_LAYERS)),
                           params, jnp.asarray(batch["A"]))
    _, k_flip, k_patch, k_idt, *_ = jax.random.split(jax_model.state.rng, 7)

    def ids(key):
        out = []
        for k, f in zip(jax.random.split(key, len(feats)), feats):
            positions = int(np.prod(f.shape[1:-1]))
            out.append(np.asarray(jax.random.permutation(k, positions)[:min(16, positions)]))
        return out

    return bool(jax.random.bernoulli(k_flip)), ids(k_patch) + ids(k_idt)


def _share_draws(monkeypatch, flip, patch_ids):
    """The port's next step draws `flip` and then `patch_ids`, in order."""
    ids = iter(patch_ids)

    def draw_patch_ids(generator, positions, num_patches):
        out = torch.from_numpy(next(ids).astype(np.int64))
        assert len(out) == min(positions, num_patches) and int(out.max()) < positions
        return out

    monkeypatch.setattr(cut, "draw_patch_ids", draw_patch_ids)
    monkeypatch.setattr(cut, "draw_flip", lambda generator: torch.tensor(flip))


def _as_port(net, tree):
    """A JAX tree (parameters, or gradients) in the port's names and layout."""
    return dict(load_flax_params(copy.deepcopy(net), tree).named_parameters())


def _floats(d):
    return {k: float(v) for k, v in d.items()}


def _jax_grads(jax_model):
    """Every gradient of the last (first) step, from Adam's first moment
    (beta1 = 0.5)."""
    grads = {}
    for group in NETWORKS:
        mu = jax.device_get(jax_model.state.opt_state[group].inner_state[0].mu)
        grads.update({name: jax.tree_util.tree_map(lambda m: 2 * np.asarray(m), t)
                      for name, t in mu.items()})
    return grads


def _lockstep(out, batches, monkeypatch, **kw):
    conf = _port_conf(out, **kw)
    jax_model = _jax_model(conf, batches[0])
    init = jax.device_get(jax_model.state.params)
    model = build_gan(conf)
    model.setup(batches[0])
    for name in NETWORKS:
        load_flax_params(model.networks[name], init[name])
    jax_logs, port_logs, draws = [], [], []
    jax_grads = port_grads = None
    for i, batch in enumerate(batches):
        draws.append(_jax_draws(jax_model, batch))
        jax_model.set_input(batch)
        jax_model.optimize_parameters()
        jax_logs.append({**_floats(jax.device_get(jax_model.losses)),
                         **_floats(jax.device_get(jax_model.metrics))})
        with monkeypatch.context() as m:
            _share_draws(m, *draws[-1])
            model.set_input(batch)
            model.optimize_parameters()
        _, losses, _, metrics = model.get_loggable_data()
        port_logs.append({**_floats(losses), **_floats(metrics)})
        if i == 0:
            jax_grads = _jax_grads(jax_model)
            port_grads = {name: {k: None if p.grad is None else p.grad.clone()
                                 for k, p in net.named_parameters()}
                          for name, net in model.networks.items()}
    return dict(conf=conf, jax_model=jax_model, init=init, model=model, jax_logs=jax_logs,
                port_logs=port_logs, jax_grads=jax_grads, port_grads=port_grads,
                draws=draws, jax_params=jax.device_get(jax_model.state.params))


@pytest.fixture(scope="module")
def lockstep(tmp_path_factory):
    with pytest.MonkeyPatch.context() as monkeypatch:
        return _lockstep(tmp_path_factory.mktemp("cut"), _batches(3), monkeypatch)


def _random_params(tree, seed=0):
    """Random parameters of `tree`'s shapes: kernels N(0, 0.05), biases
    N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: ((0.1 if path[-1].key == "bias" else 0.05)
                         * rng.normal(size=a.shape)).astype(np.float32), tree)


def _channels_first(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _channels_last(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


# ------------------------------------------------------------------- loss


def test_patchnce_matches_jax_and_the_numpy_golden():
    """The JAX package's golden (`tests/test_cut.py`): a numpy transcription
    of the original's formula."""
    from ganslate_tpu.configs.omega import Conf as JaxConf
    from ganslate_tpu.nn.losses.cut_losses import PatchNCELoss as JaxPatchNCELoss
    rng = np.random.default_rng(0)
    b, p, c = 2, 4, 8
    q = rng.normal(size=(b * p, c)).astype(np.float32)
    k = rng.normal(size=(b * p, c)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    k /= np.linalg.norm(k, axis=1, keepdims=True)
    raw = {"mode": "train", "train": {"batch_size": b, "gan": {"optimizer": {"nce_T": 0.07}}}}

    got = PatchNCELoss(JaxConf.create(raw))(torch.from_numpy(q), torch.from_numpy(k))
    want = np.asarray(jax.jit(JaxPatchNCELoss(JaxConf.create(raw)).__call__)(q, k))
    l_pos = np.sum(q * k, axis=1, keepdims=True)
    l_neg = np.einsum("bpc,bqc->bpq", q.reshape(b, p, c), k.reshape(b, p, c))
    for i in range(p):
        l_neg[:, i, i] = -10.0
    logits = np.concatenate([l_pos, l_neg.reshape(-1, p)], axis=1) / 0.07
    ex = np.exp(logits - logits.max(axis=1, keepdims=True))
    golden = -np.log(ex[:, 0] / ex.sum(axis=1))
    assert got.shape == (b * p,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), golden, atol=ATOL, rtol=0)


def test_patchnce_detaches_the_keys():
    raw = {"train": {"batch_size": 1, "gan": {"optimizer": {"nce_T": 0.07}}}}
    from ganslate_tpu_torch.configs.omega import Conf
    q = torch.randn(4, 8, requires_grad=True)
    k = torch.randn(4, 8, requires_grad=True)
    PatchNCELoss(Conf.create(raw))(q, k).sum().backward()
    assert q.grad is not None and k.grad is None


def test_feature_patch_mlp_matches_jax():
    from ganslate_tpu.nn.gans.unpaired.cut import FeaturePatchMLP as JaxMLP
    channels = (1, 16, 32)
    rng = np.random.default_rng(3)
    feats = [rng.normal(size=(10, c)).astype(np.float32) for c in channels]
    module = JaxMLP(channels_per_feature=channels, nc=16)
    params = _random_params(jax.eval_shape(module.init, jax.random.key(0), feats)["params"])
    want = jax.jit(lambda p, f: module.apply({"params": p}, f))(params, feats)
    net = load_flax_params(cut.FeaturePatchMLP(channels, nc=16), params)
    with torch.no_grad():
        got = net([torch.from_numpy(f) for f in feats])
    for g, w in zip(got, want):
        assert g.shape == (10, 16)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)
        np.testing.assert_allclose(g.norm(dim=1).numpy(), 1, atol=1e-5)


def test_feature_patch_mlp_init():
    net = cut.FeaturePatchMLP((3, 5), nc=256, generator=torch.Generator().manual_seed(0))
    assert [n for n, _ in net.named_parameters()] == [
        f"mlp{i}_fc{j}.{leaf}" for i in (0, 1) for j in (1, 2) for leaf in ("weight", "bias")]
    weights = torch.cat([p.detach().flatten() for n, p in net.named_parameters()
                         if "weight" in n])
    assert abs(float(weights.std()) - 0.02) < 1e-3
    assert all(not p.any() for n, p in net.named_parameters() if "bias" in n)


# ------------------------------------------------------------------ train


def test_mlp_is_built_for_the_taps(lockstep):
    model = lockstep["model"]
    assert model.nce_layers == NCE_LAYERS and model.feature_channels() == (1, 16, 32, 32)
    assert sorted(model.networks) == sorted(NETWORKS)
    assert sorted(model.optimizers) == sorted(NETWORKS)
    assert model.optimizers["mlp"].param_groups[0]["lr"] == pytest.approx(4e-4)


def test_losses_and_metrics_match_jax_each_step(lockstep):
    for step, (got, want) in enumerate(zip(lockstep["port_logs"], lockstep["jax_logs"])):
        assert sorted(got) == sorted(want) == ["D", "D_fake", "D_real", "G", "NCE", "NCE_idt"]
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                       err_msg=f"step {step + 1}, {key}")


def test_gradients_after_step_1_match_jax(lockstep):
    model = lockstep["model"]
    checked = []
    for name in NETWORKS:
        want = _as_port(model.networks[name], lockstep["jax_grads"][name])
        for k, got in lockstep["port_grads"][name].items():
            w = want[k].detach()
            if f"{name}.{k}" in NOISE_BIASES:
                assert got is not None          # live on the tap path, but noise
                continue
            if got is None:         # an inert bias: no gradient, exactly zero in JAX
                assert k.endswith(".bias") and not w.any(), f"{name}.{k}"
                continue
            err = float((got - w).norm() / w.norm())
            assert err < 1e-4, f"{name}.{k}: relative L2 {err:.2e}"
            checked.append(f"{name}.{k}")
    assert "G.down0.bias" in checked and "mlp.mlp3_fc2.weight" in checked


def test_parameters_after_3_steps_match_jax(lockstep):
    model = lockstep["model"]
    for name in NETWORKS:
        want = _as_port(model.networks[name], lockstep["jax_params"][name])
        for k, p in model.networks[name].named_parameters():
            if f"{name}.{k}" in NOISE_BIASES:
                continue
            np.testing.assert_allclose(p.detach().numpy(), want[k].detach().numpy(),
                                       atol=ATOL, rtol=0, err_msg=f"{name}.{k}")


def test_outputs_and_taps_after_3_steps_match_jax(lockstep):
    """The noise-driven biases cancel in their norms: the trained G's
    output and taps agree all the same."""
    module = lockstep["jax_model"].networks["G"]
    params = lockstep["jax_params"]["G"]
    x = _batches(1, seed=13)[0]["A"]
    out, taps = jax.jit(lambda p, x: (module.apply({"params": p}, x),
                                      module.apply({"params": p}, x,
                                                   extract_features=list(NCE_LAYERS))))(
        params, jnp.asarray(x))
    net = lockstep["model"].networks["G"]
    with torch.no_grad():
        got = net(_channels_first(x))
        got_taps = net(_channels_first(x), extract_features=list(NCE_LAYERS))
    np.testing.assert_allclose(_channels_last(got), np.asarray(out), atol=ATOL, rtol=0)
    for level, g, w in zip(NCE_LAYERS, got_taps, taps):
        np.testing.assert_allclose(_channels_last(g), np.asarray(w), atol=ATOL, rtol=0,
                                   err_msg=f"tap {level}")


def test_fastcut_step_with_a_shared_flip_matches_jax(tmp_path):
    """FastCUT (flip on, lambda_nce 10, no identity NCE) one step in
    lockstep, with the flip taken: both sides flip real_A and read the
    target's taps mirrored."""
    batches = _batches(1, seed=21)
    with pytest.MonkeyPatch.context() as monkeypatch:
        conf = _port_conf(tmp_path, use_equivariance_flip=True, lambda_nce=10.0,
                          lambda_nce_idt=0.0)
        jax_model = _jax_model(conf, batches[0])
        # A state key whose draw takes the flip.
        key = next(k for k in (jax.random.key(s) for s in range(100))
                   if bool(jax.random.bernoulli(jax.random.split(k, 7)[1])))
        jax_model.state = jax_model.state.replace(rng=key)
        flip, ids = _jax_draws(jax_model, batches[0])
        assert flip
        init = jax.device_get(jax_model.state.params)
        jax_model.set_input(batches[0])
        jax_model.optimize_parameters()
        want = _floats(jax.device_get(jax_model.losses))
        model = build_gan(conf)
        model.setup(batches[0])
        for name in NETWORKS:
            load_flax_params(model.networks[name], init[name])
        _share_draws(monkeypatch, flip, ids[:len(NCE_LAYERS)])
        model.set_input(batches[0])
        model.optimize_parameters()
    got = _floats(model.losses)
    assert sorted(got) == sorted(want) == ["D", "G", "NCE"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    np.testing.assert_array_equal(model.visuals["real_A"].numpy(), batches[0]["A"][:, :, ::-1])
    params = jax.device_get(jax_model.state.params)
    for name in NETWORKS:
        want_p = _as_port(model.networks[name], params[name])
        for k, p in model.networks[name].named_parameters():
            if f"{name}.{k}" not in NOISE_BIASES:
                np.testing.assert_allclose(p.detach().numpy(), want_p[k].detach().numpy(),
                                           atol=ATOL, rtol=0, err_msg=f"{name}.{k}")


def test_mirror_w_reads_the_flipped_taps():
    f = torch.randn(2, 3, 5, 7, 4)
    ids = torch.randperm(3 * 5 * 7)[:20]
    got = cut.select_patches([f], [cut.mirror_w(ids, 7)])[0]
    want = cut.select_patches([f.flip(-2)], [ids])[0]
    assert torch.equal(got, want)


def test_vnet3d_cut_step(tmp_path):
    """One step of a tiny BRaTS CUT (Vnet3D taps 0-2; the YAML's layer 3 is
    beyond its 3 taps and is dropped with a warning), in bf16: finite
    losses, every network updated, the MLP at the taps' widths."""
    conf = make_cut_conf(str(tmp_path), first_layer_channels=4, down_blocks=(1, 1),
                         up_blocks=(1, 1), ndf=8, n_layers_D=1, patch=(8, 16, 16), mlp_nc=16,
                         num_patches=16, cuda=False, batch_size=1)
    batch = _batches(1, seed=14, shape=(1, 8, 16, 16, 1))[0]
    model = build_gan(conf)
    model.setup(batch)
    assert model.nce_layers == (0, 1, 2) and model.feature_channels() == (4, 8, 16)
    before = {name: [p.detach().clone() for p in net.parameters()]
              for name, net in model.networks.items()}
    model.set_input(batch)
    model.optimize_parameters()
    assert sorted(model.losses) == ["D", "G", "NCE", "NCE_idt"]
    assert all(np.isfinite(float(v)) for v in model.losses.values())
    assert model.visuals["idt_B"].shape == (1, 8, 16, 16, 1)
    assert model.visuals["fake_B"].dtype == torch.bfloat16
    for name, net in model.networks.items():
        assert any(not torch.equal(a, b) for a, b in zip(before[name], net.parameters())), name


def test_checkpoint_serves_ab_only(lockstep, tmp_path):
    """The trained model's checkpoint holds G, D, mlp and the generator
    state; `init_engine("infer")` builds G alone from it and serves A->B as
    the trained G does; B->A raises."""
    model = lockstep["model"]
    out = tmp_path / "out"
    model.output_dir = str(out)
    model.save_checkpoint(3)
    checkpoint = torch.load(out / "checkpoints" / "3.pth", weights_only=True)
    assert {"G", "D", "mlp", "optimizer_G", "optimizer_D", "optimizer_mlp",
            "rng"} <= set(checkpoint)
    raw = _port_conf(out, load_iter=3).to_container(resolve=False)
    raw["infer"]["sliding_window"] = None
    import yaml
    path = tmp_path / "infer.yaml"
    path.write_text(yaml.safe_dump(raw))
    inferer = init_engine("infer", [f"config={path}"])
    assert list(inferer.model.networks) == ["G"]
    x = _batches(1, seed=15)[0]["A"]
    y = inferer.infer(x)                 # the deployment's bf16 wire
    want = model.infer(torch.from_numpy(x).to(torch.bfloat16)).to(torch.bfloat16)
    assert y.dtype == torch.bfloat16 and torch.equal(y, want)
    with pytest.raises(ValueError, match="A->B"):
        inferer.model.infer(torch.from_numpy(x), direction="BA")
