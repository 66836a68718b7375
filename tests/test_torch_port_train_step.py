"""The port's CycleGAN train step (`nn/gans/unpaired/cyclegan.py`,
`nn/gans/base.py`) held step for step against the JAX package's, and the
loop from training to serving.

Both packages build the same config (`utils/testing.py:make_cyclegan_conf`
in each: Resnet2D with 1 residual block, ngf 8; PatchGAN2D, ndf 8, 2
layers; 32x32 images, batch 2; lsgan; pool_size 0, because the pools' draws
cannot match; metrics on). The JAX initial parameters are carried into the
port (`utils/flax_weights.load_flax_params`), and both run the same numpy
batches through the models' own entry points.

Tolerances, fp32 on the CPU:
- losses and metrics per step, rtol 1e-4 (atol 1e-6 for the SSIM metrics,
  1 - a distance near 1): every conv and norm sums in another order than
  XLA, by a few fp32 ulps per layer, through 4 G and 4 D passes;
- every gradient after step 1, relative L2 1e-4 per tensor: the same
  rounding, run backwards. JAX's gradient is read from Adam's first moment
  after step 1, (1 - beta1) * g: an exact halving;
- every parameter after step 3, max abs 1e-5: Adam moves each weight by at
  most lr = 2e-4 per step, in the direction of m / (sqrt(v) + eps), which a
  gradient differing by 1e-4 relative moves by ~1e-4 of a step (2e-8) and a
  gradient near zero by at most its ratio to eps; 1e-5 is 5% of one step;
- the inert biases (convs before an instance norm) stay exactly at their
  initial values on both sides.
In bf16 mixed precision every conv output and norm output rounds to bf16
(2**-8 relative) in another place than XLA's; means over the batch average
most of it out. One step's losses agree to 2e-3 relative (5e-4 seen). The
D-evolution metrics are bf16 means (as in JAX), within a bf16 ulp; the SSIM
metrics lie near 0: both within 1e-3 absolute."""

import copy

import numpy as np
import pytest

import jax
import torch

from ganslate_tpu_torch.configs.config import Config
from ganslate_tpu_torch.configs.omega import Conf
from ganslate_tpu_torch.configs.utils import init_config
from ganslate_tpu_torch.engines.inferer import Inferer
from ganslate_tpu_torch.utils.builders import build_gan
from ganslate_tpu_torch.utils.flax_weights import load_flax_params
from ganslate_tpu_torch.utils.testing import make_cyclegan_conf
from ganslate_tpu_torch.utils.trackers.utils import to_numpy

BATCH, SIZE = 2, 32
SMALL = dict(n_residual_blocks=1, ngf=8, ndf=8, n_layers_D=2, pool_size=0, seed=3)
NETWORKS = ("G_AB", "G_BA", "D_B", "D_A")


def _batches(n, seed=7):
    rng = np.random.default_rng(seed)
    return [{k: rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
             for k in ("A", "B")} for _ in range(n)]


def _set_options(conf, lambda_identity, proportion_ssim):
    conf.train.metrics.discriminator_evolution = True
    conf.train.metrics.ssim = True
    conf.train.gan.optimizer.lambda_identity = lambda_identity
    conf.train.gan.optimizer.proportion_ssim = proportion_ssim
    return conf


def _jax_model(out_dir, batch, mixed_precision, lambda_identity=0, proportion_ssim=0):
    from ganslate_tpu.utils.builders import build_gan as jax_build_gan
    from ganslate_tpu.utils.testing import make_cyclegan_conf as jax_conf
    conf = _set_options(jax_conf(str(out_dir), batch_size=BATCH, image_size=SIZE,
                                 mixed_precision=mixed_precision, **SMALL),
                        lambda_identity, proportion_ssim)
    model = jax_build_gan(conf)
    model.setup(example_batch=batch)
    return model


def _port_conf(out_dir, mixed_precision, lambda_identity=0, proportion_ssim=0, **kw):
    conf = make_cyclegan_conf(str(out_dir), batch_size=BATCH, mixed_precision=mixed_precision,
                              cuda=False, **{**SMALL, **kw})
    return _set_options(conf, lambda_identity, proportion_ssim)


def _port_model(conf, batch, jax_params=None):
    model = build_gan(conf)
    model.setup(batch)
    if jax_params is not None:
        for name in NETWORKS:
            load_flax_params(model.networks[name], jax_params[name])
    return model


def _floats(d):
    return {k: float(v) for k, v in d.items()}


def _as_port(net, tree):
    """A JAX tree (parameters, or gradients) in the port's names and layout."""
    return dict(load_flax_params(copy.deepcopy(net), tree).named_parameters())


def _run_jax(model, batches):
    logs, grads = [], None
    for i, batch in enumerate(batches):
        model.set_input(batch)
        model.optimize_parameters()
        logs.append({**_floats(jax.device_get(model.losses)),
                     **_floats(jax.device_get(model.metrics))})
        if i == 0:
            grads = {}
            for group in ("G", "D"):
                mu = jax.device_get(model.state.opt_state[group].inner_state[0].mu)
                grads.update({name: jax.tree_util.tree_map(lambda m: 2 * np.asarray(m), tree)
                              for name, tree in mu.items()})
    return logs, grads, jax.device_get(model.state.params), model.get_learning_rates()


def _run_port(model, batches):
    logs, grads = [], None
    for i, batch in enumerate(batches):
        model.set_input(batch)
        model.optimize_parameters()
        lrs, losses, _, metrics = model.get_loggable_data()
        logs.append({**_floats(losses), **_floats(metrics)})
        if i == 0:
            grads = {name: {k: None if p.grad is None else p.grad.clone()
                            for k, p in model.networks[name].named_parameters()}
                     for name in NETWORKS}
    return logs, grads, lrs


@pytest.fixture(scope="module")
def lockstep(tmp_path_factory):
    out = tmp_path_factory.mktemp("lockstep")
    batches = _batches(3)
    jax_model = _jax_model(out, batches[0], mixed_precision=False)
    init = jax.device_get(jax_model.state.params)
    port_model = _port_model(_port_conf(out, False), batches[0], init)
    initial = {name: {k: p.detach().clone()
                      for k, p in port_model.networks[name].named_parameters()}
               for name in NETWORKS}
    jax_logs, jax_grads, jax_params, jax_lrs = _run_jax(jax_model, batches)
    port_logs, port_grads, port_lrs = _run_port(port_model, batches)
    return dict(model=port_model, initial=initial, jax_logs=jax_logs, port_logs=port_logs,
                jax_grads=jax_grads, port_grads=port_grads, jax_params=jax_params,
                jax_lrs=jax_lrs, port_lrs=port_lrs)


def test_losses_and_metrics_match_jax_each_step(lockstep):
    for step, (got, want) in enumerate(zip(lockstep["port_logs"], lockstep["jax_logs"])):
        assert sorted(got) == sorted(want) == sorted(
            ["G_AB", "G_BA", "cycle_A", "cycle_B", "D_B", "D_A", "ssim_A", "ssim_B",
             "D_B_real", "D_B_fake", "D_A_real", "D_A_fake"])
        for key in want:
            atol = 1e-6 if key.startswith("ssim") else 0
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=atol,
                                       err_msg=f"step {step + 1}, {key}")


def test_gradients_after_step_1_match_jax(lockstep):
    model = lockstep["model"]
    for name in NETWORKS:
        want = _as_port(model.networks[name], lockstep["jax_grads"][name])
        for k, got in lockstep["port_grads"][name].items():
            w = want[k].detach()
            if got is None:         # an inert bias: no gradient, exactly zero in JAX
                assert k.endswith(".bias") and not w.any(), f"{name}.{k}"
                continue
            rel = float((got - w).norm() / w.norm())
            assert rel <= 1e-4, f"{name}.{k}: relative L2 {rel:.2e}"


def test_parameters_after_step_3_match_jax(lockstep):
    model = lockstep["model"]
    n_inert = 0
    for name in NETWORKS:
        want = _as_port(model.networks[name], lockstep["jax_params"][name])
        for k, p in model.networks[name].named_parameters():
            torch.testing.assert_close(p.detach(), want[k].detach(), rtol=0, atol=1e-5,
                                       msg=f"{name}.{k}")
            if lockstep["port_grads"][name][k] is None:
                n_inert += 1
                assert torch.equal(p.detach(), lockstep["initial"][name][k])
                assert torch.equal(want[k].detach(), lockstep["initial"][name][k])
    # G: initial, down0, down1, res0 conv1/conv2, up0, up1; D: down1, penultimate.
    assert n_inert == 2 * 7 + 2 * 2


def test_learning_rates_match_jax(lockstep):
    assert sorted(lockstep["port_lrs"]) == sorted(lockstep["jax_lrs"]) == ["lr_D", "lr_G"]
    for k, v in lockstep["jax_lrs"].items():
        np.testing.assert_allclose(lockstep["port_lrs"][k], v, rtol=1e-6)


def test_bf16_step_with_identity_and_ssim_matches_jax(tmp_path):
    """One step in bf16 mixed precision, with the identity pair
    (lambda_identity 0.5) and the SSIM cycle mix (proportion_ssim 0.84)."""
    batch = _batches(1, seed=11)[0]
    jax_model = _jax_model(tmp_path, batch, True, lambda_identity=0.5, proportion_ssim=0.84)
    port_model = _port_model(_port_conf(tmp_path, True, 0.5, 0.84), batch,
                             jax.device_get(jax_model.state.params))
    want = _run_jax(jax_model, [batch])[0][0]
    got = _run_port(port_model, [batch])[0][0]
    assert sorted(got) == sorted(want)
    assert {"idt_A", "idt_B"} <= set(got)
    for key in want:
        if key in port_model.losses:
            np.testing.assert_allclose(got[key], want[key], rtol=2e-3, err_msg=key)
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=2 ** -7, atol=1e-3,
                                       err_msg=key)
    # fp32 masters, bf16 compute.
    for net in port_model.networks.values():
        assert all(p.dtype == torch.float32 for p in net.parameters())
    assert port_model.visuals["fake_B"].dtype == torch.bfloat16
    # The loggable visuals stay bf16 on the device; the tracker reads them
    # to the host as fp32.
    visual = port_model.get_loggable_data()[2]["fake_B"]
    assert visual.dtype == torch.bfloat16
    assert to_numpy(visual).dtype == np.float32


# ------------------------------------------------------------ port only


def test_discriminators_take_no_gradient_in_the_G_step(tmp_path):
    """Between the G update and the D update (when the pools are queried),
    no D parameter holds a gradient, and every G parameter but the inert
    biases does."""
    batch = _batches(1)[0]
    model = _port_model(_port_conf(tmp_path, False), batch)
    seen = {}
    query = model.pools["fake_B"].query

    def spy(images, draws=None):
        seen["D"] = [p.grad for n in ("D_B", "D_A") for p in model.networks[n].parameters()]
        seen["G"] = {f"{n}.{k}": p.grad is not None for n in ("G_AB", "G_BA")
                     for k, p in model.networks[n].named_parameters()}
        seen["D_requires_grad"] = all(p.requires_grad for n in ("D_B", "D_A")
                                      for p in model.networks[n].parameters())
        return query(images, draws)

    model.pools["fake_B"].query = spy
    model.set_input(batch)
    model.optimize_parameters()
    assert seen["D"] and all(g is None for g in seen["D"])
    assert seen["D_requires_grad"]
    assert all(has for k, has in seen["G"].items() if not k.endswith(".bias")) \
        and any(seen["G"].values())
    assert all(p.grad is not None for p in model.networks["D_B"].head.parameters())


def test_checkpoint_serves_the_trained_generator(tmp_path):
    """save_checkpoint -> the deployment Inferer serves what `model.infer`
    gives on the trained G_AB; `infer` before the steps does not leave a
    stale serving copy behind."""
    batches = _batches(2)
    conf = _port_conf(tmp_path, True)
    conf.infer = {"is_deployment": True, "wire_dtype": "float32",
                  "checkpointing": {"load_iter": 2}}
    model = _port_model(conf, batches[0])
    x = torch.from_numpy(batches[1]["A"])
    before = model.infer(x)
    for batch in batches:
        model.set_input(batch)
        model.optimize_parameters()
    after = model.infer(x)
    assert not torch.equal(before, after)
    model.save_checkpoint(2)
    checkpoint = torch.load(tmp_path / "checkpoints" / "2.pth", weights_only=True)
    assert sorted(checkpoint) == sorted([*NETWORKS, "optimizer_G", "optimizer_D"])

    served = Inferer(init_config(Conf.create(conf.to_container(resolve=False)), Config))
    got = served.infer(x.numpy())
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, after, rtol=0, atol=0)


def test_resume_from_a_checkpoint_continues_the_run(tmp_path):
    """Steps 2-3 after loading step 1's checkpoint (networks and optimizers)
    equal steps 2-3 of the uninterrupted run."""
    batches = _batches(3)
    straight = _port_model(_port_conf(tmp_path / "a", False), batches[0])
    _run_port(straight, batches)

    first = _port_model(_port_conf(tmp_path / "b", False), batches[0])
    _run_port(first, batches[:1])
    first.save_checkpoint(1)
    conf = _port_conf(tmp_path / "b", False)
    conf.train.checkpointing.load_iter = 1
    resumed = _port_model(conf, batches[0])
    logs, _, lrs = _run_port(resumed, batches[1:])
    assert lrs == straight.get_learning_rates()
    for name in NETWORKS:
        for (k, p), q in zip(resumed.networks[name].named_parameters(),
                             straight.networks[name].parameters()):
            torch.testing.assert_close(p, q, rtol=0, atol=1e-7, msg=f"{name}.{k}")
    np.testing.assert_allclose(list(logs[-1].values()),
                               list(_floats(straight.losses).values()) +
                               list(_floats(straight.metrics).values()), rtol=1e-6)


def test_lr_follows_the_schedule_per_update(tmp_path):
    """The rate of update k (0-based) is base * lambda(k): 1 for n_iters
    updates, then a linear decay."""
    batches = _batches(4)
    model = _port_model(_port_conf(tmp_path, False, n_iters=2), batches[0])
    seen = []
    for batch in batches:
        model.set_input(batch)
        model.optimize_parameters()
        seen.append(model.get_learning_rates()["lr_G"])
    lam = [1.0, 1.0, 2 / 3, 1 / 3]            # n_iters = n_iters_decay = 2
    np.testing.assert_allclose(seen, [2e-4 * v for v in lam], rtol=1e-12)


def test_cuda_setup_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: cuda=true is satisfied here")
    conf = make_cyclegan_conf(str(tmp_path), **SMALL)
    assert conf.train.cuda is True
    with pytest.raises(RuntimeError, match="CUDA"):
        build_gan(conf)


def test_serving_before_training_leaves_autograd_usable():
    """The reflect pad's cached gather index, first made while serving
    (inference mode), is then used by a train step's autograd."""
    from ganslate_tpu_torch.nn.layers import pad_spatial
    x = torch.randn(1, 3, 9, 11)
    with torch.inference_mode():
        pad_spatial(x, (3, 3), "reflect")
    y = x.clone().requires_grad_(True)
    pad_spatial(y, (3, 3), "reflect").sum().backward()
    assert y.grad is not None and y.grad.shape == y.shape


def _pool_conf(out_dir, **kw):
    return _port_conf(out_dir, False, **{**dict(pool_size=50), **kw})


def test_resume_restores_the_image_pools(tmp_path, caplog):
    """With pool 50: 2 steps + save + load into a fresh model + 2 steps give
    the losses and parameters of 4 uninterrupted steps, bit for bit: the
    checkpoint holds each pool's images, count and generator state."""
    batches = _batches(4)
    straight = _port_model(_pool_conf(tmp_path / "a"), batches[0])
    straight_logs = _run_port(straight, batches)[0]

    first = _port_model(_pool_conf(tmp_path / "b"), batches[0])
    _run_port(first, batches[:2])
    first.save_checkpoint(2)
    checkpoint = torch.load(tmp_path / "b" / "checkpoints" / "2.pth", weights_only=True)
    assert {"pool_fake_A", "pool_fake_B"} <= set(checkpoint)
    assert checkpoint["pool_fake_B"]["count"] == 2 * BATCH
    conf = _pool_conf(tmp_path / "b")
    conf.train.checkpointing.load_iter = 2
    with caplog.at_level("INFO"):
        resumed = _port_model(conf, batches[0])
    assert "pools start fresh" not in caplog.text
    logs = _run_port(resumed, batches[2:])[0]
    assert logs == straight_logs[2:]
    for name in NETWORKS:
        for (k, p), q in zip(resumed.networks[name].named_parameters(),
                             straight.networks[name].parameters()):
            assert torch.equal(p, q), f"{name}.{k}"


def test_checkpoint_without_pools_starts_them_fresh(tmp_path, caplog):
    """A checkpoint of the original ganslate's layout (networks and
    optimizers only) still loads; the pools start empty, and say so."""
    batches = _batches(1)
    first = _port_model(_pool_conf(tmp_path), batches[0])
    _run_port(first, batches)
    first.save_checkpoint(1)
    path = tmp_path / "checkpoints" / "1.pth"
    checkpoint = torch.load(path, weights_only=True)
    torch.save({k: v for k, v in checkpoint.items() if not k.startswith("pool_")}, path)
    conf = _pool_conf(tmp_path)
    conf.train.checkpointing.load_iter = 1
    with caplog.at_level("INFO"):
        resumed = _port_model(conf, batches[0])
    assert "pools start fresh" in caplog.text
    assert all(pool.count == 0 for pool in resumed.pools.values())


def test_unset_seed_is_drawn_once_and_logged(tmp_path, caplog):
    """`train.seed: null`: each model draws its own seed and logs it; a model
    built with the logged seed starts from the same weights and pool
    draws."""
    batch = _batches(1)[0]
    with caplog.at_level("INFO", logger="ganslate_tpu_torch.nn.gans.base"):
        a = _port_model(_pool_conf(tmp_path / "a", seed=None), batch)
        b = _port_model(_pool_conf(tmp_path / "b", seed=None), batch)
    drawn = [int(r.getMessage().rsplit(" ", 1)[1]) for r in caplog.records
             if "drew seed" in r.getMessage()]
    assert len(drawn) == 2 and drawn[0] != drawn[1]
    assert a._seed() == drawn[0] and b._seed() == drawn[1]
    assert not torch.equal(a.networks["G_AB"].initial.weight, b.networks["G_AB"].initial.weight)

    again = _port_model(_pool_conf(tmp_path / "c", seed=drawn[0]), batch)
    for name in NETWORKS:
        for (k, p), q in zip(again.networks[name].named_parameters(),
                             a.networks[name].parameters()):
            assert torch.equal(p, q), f"{name}.{k}"
    for name, pool in again.pools.items():
        assert torch.equal(pool.generator.get_state(), a.pools[name].generator.get_state())
