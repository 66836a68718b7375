"""The port's Pix2Pix slice against the JAX package's: the conditional GAN
(`nn/gans/paired/pix2pix.py`) with its U-Net G and conditional PatchGAN2D
D, the per-apply randomness of dropout (`BaseGAN.apply`'s generator and
its checkpoint), and the engines on a paired one-generator model.

Small sizes, as the JAX package's `tests/test_unet_pix2pix.py`: Unet2D with
5 levels and ngf 8, PatchGAN2D with ndf 8 and 1 layer, 3-channel (32, 32)
images, batch 2, fp32 on the CPU. One JAX Pix2Pix is built for the
lockstep (one train-step compile), its parameters the port's seeded ones
carried by the JAX package's `torch_import`
(`tests/torch_port_support.py:jax_params_from`: nothing of the JAX init
compiles) and loaded back into the port by
`utils/flax_weights.load_flax_params`.

Dropout: flax draws threefry masks, which no torch generator reproduces,
so the lockstep runs with dropout off (5 levels have no dropout level
anyway) and one step with dropout on (6 levels: dropout at level 4, on
(64, 64) images) takes its masks, on both sides, from one numpy stream in
call order: `flax.linen.Dropout.__call__` and the port's
`layers.dropout_mask` are monkeypatched in this test process only.

Tolerances, as the CycleGAN and RevGAN lockstep tests:
- losses and metrics per step, rtol 1e-4; the D metrics (means of logits
  of order 0.1 that cancel to near 0) also atol 1e-6;
- every gradient after step 1, 1e-4 relative L2 per tensor (JAX's read
  from Adam's first moment, an exact halving);
- every parameter after step 3, 1e-5 absolute.
The U-Net's convs before an instance norm keep their bias, whose gradient
is zero in exact arithmetic. The port keeps it inert (no gradient, as in
every port network); the JAX U-Net does not mark it, so JAX's gradient
there is rounding noise (checked to be below 1e-5 of the largest gradient
of its network) and Adam moves the bias on it: those biases are held to
their initial values in the port, and G's output after 3 steps against
JAX's G shows that they cancel."""

import copy
from pathlib import Path

import numpy as np
import pytest
import yaml
from PIL import Image

import jax
import jax.numpy as jnp
import torch

from ganslate_tpu_torch.configs.config import Config
from ganslate_tpu_torch.configs.utils import init_config
from ganslate_tpu_torch.engines.utils import init_engine
from ganslate_tpu_torch.nn import layers
from ganslate_tpu_torch.nn.discriminators import PatchGAN2D
from ganslate_tpu_torch.nn.gans.paired import Pix2PixConditionalGAN
from ganslate_tpu_torch.nn.generators import Unet2D
from ganslate_tpu_torch.utils.builders import build_gan
from ganslate_tpu_torch.utils.flax_weights import load_flax_params
from ganslate_tpu_torch.utils.io import import_attr
from ganslate_tpu_torch.utils.testing import make_pix2pix_conf
from tests.torch_port_support import (jax_params_from, one_torch_thread,  # noqa: F401
                                      seeded_states)

SMALL = dict(num_downs=5, ngf=8, ndf=8, n_layers_D=1, use_dropout=False)
DROPOUT = dict(num_downs=6, ngf=8, ndf=8, n_layers_D=1, use_dropout=True)
BATCH = 2
SIZE = 32
NETWORKS = ("G", "D")
LOSSES = ["G", "pix2pix", "D"]
METRICS = ["D_real", "D_fake"]


def _batches(n, size=SIZE, seed=7):
    rng = np.random.default_rng(seed)
    return [{k: rng.uniform(-1, 1, (BATCH, size, size, 3)).astype(np.float32)
             for k in ("A", "B")} for _ in range(n)]


def _port_conf(out_dir, nets=SMALL, **kw):
    return make_pix2pix_conf(str(out_dir), cuda=False, mixed_precision=False,
                             batch_size=BATCH, **{**nets, **kw})


def _jax_model(out_dir, batch, nets=SMALL):
    """The JAX Pix2Pix of the port's config (the same raw tree)."""
    from ganslate_tpu.configs.config import Config as JaxConfig
    from ganslate_tpu.configs.omega import Conf as JaxConf
    from ganslate_tpu.configs.utils import init_config as jax_init_config
    from ganslate_tpu.utils.builders import build_gan as jax_build_gan
    raw = {"train": _port_conf(out_dir, nets).to_container(resolve=False)["train"]}
    for key in ("dataset", "logging", "checkpointing"):
        raw["train"].pop(key, None)
    model = jax_build_gan(jax_init_config(JaxConf.create(raw), JaxConfig))
    with jax_params_from(seeded_states(_port_conf(out_dir, nets).to_container(resolve=False))):
        model.setup(example_batch=batch)
    return model


def _jax_grads(jax_model):
    """Step 1's gradients: 2 x Adam's first moment after one update."""
    grads = {}
    for group in ("G", "D"):
        mu = jax.device_get(jax_model.state.opt_state[group].inner_state[0].mu)
        grads.update({name: jax.tree_util.tree_map(lambda m: 2 * np.asarray(m), t)
                      for name, t in mu.items()})
    return grads


def _as_port(net, tree):
    """A JAX tree (parameters, or gradients) in the port's names and layout."""
    return dict(load_flax_params(copy.deepcopy(net), tree).named_parameters())


def _floats(d):
    return {k: float(v) for k, v in d.items()}


def _port_model(conf, batch, init=None):
    model = build_gan(conf)
    model.setup(batch)
    for name in NETWORKS if init is not None else ():
        load_flax_params(model.networks[name], init[name])
    return model


def _step(model, batch):
    model.set_input(batch)
    model.optimize_parameters()
    _, losses, _, metrics = model.get_loggable_data()
    return {**_floats(losses), **_floats(metrics)}


def _grads(model):
    return {name: {k: None if p.grad is None else p.grad.clone()
                   for k, p in net.named_parameters()} for name, net in model.networks.items()}


@pytest.fixture(scope="module")
def lockstep(tmp_path_factory):
    out = tmp_path_factory.mktemp("pix2pix")
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
            jax_grads = _jax_grads(jax_model)

    model = _port_model(_port_conf(out), batches[0], init)
    initial = {name: {k: p.detach().clone() for k, p in net.named_parameters()}
               for name, net in model.networks.items()}
    port_logs, port_grads = [], None
    for i, batch in enumerate(batches):
        port_logs.append(_step(model, batch))
        if i == 0:
            port_grads = _grads(model)
    return dict(out=out, jax_model=jax_model, init=init, model=model, initial=initial,
                batches=batches, jax_logs=jax_logs, port_logs=port_logs,
                jax_grads=jax_grads, port_grads=port_grads,
                jax_params=jax.device_get(jax_model.state.params))


def _check_grads(model, jax_grads, port_grads):
    """Every gradient within 1e-4 relative L2 of JAX's; an inert bias has
    none in the port and noise in JAX. Returns the inert biases."""
    inert = []
    for name in NETWORKS:
        want = _as_port(model.networks[name], jax_grads[name])
        scale = max(float(w.detach().abs().max()) for w in want.values())
        for k, got in port_grads[name].items():
            w = want[k].detach()
            if got is None:
                assert k.endswith(".bias") and float(w.abs().max()) <= 1e-5 * scale, \
                    f"{name}.{k}"
                inert.append(f"{name}.{k}")
                continue
            rel = float((got - w).norm() / w.norm())
            assert rel <= 1e-4, f"{name}.{k}: relative L2 {rel:.2e}"
    return inert


# ------------------------------------------------------------------ train


def test_losses_and_metrics_match_jax_each_step(lockstep):
    for step, (got, want) in enumerate(zip(lockstep["port_logs"], lockstep["jax_logs"])):
        assert sorted(got) == sorted(want) == sorted(LOSSES + METRICS)
        for key in want:
            atol = 1e-6 if key in METRICS else 0
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=atol,
                                       err_msg=f"step {step + 1}, {key}")


def test_gradients_after_step_1_match_jax(lockstep):
    inert = _check_grads(lockstep["model"], lockstep["jax_grads"], lockstep["port_grads"])
    # G: the convs before a norm (downs 1-3, ups 4-1); D (1 layer): the
    # penultimate conv.
    assert sorted(inert) == sorted([f"G.down{i}.bias" for i in (1, 2, 3)]
                                   + [f"G.up{i}.bias" for i in (4, 3, 2, 1)]
                                   + ["D.penultimate.bias"])


def test_parameters_after_step_3_match_jax(lockstep):
    model = lockstep["model"]
    for name in NETWORKS:
        want = _as_port(model.networks[name], lockstep["jax_params"][name])
        for k, p in model.networks[name].named_parameters():
            if lockstep["port_grads"][name][k] is None:
                assert torch.equal(p.detach(), lockstep["initial"][name][k])
                continue
            torch.testing.assert_close(p.detach(), want[k].detach(), rtol=0, atol=1e-5,
                                       msg=f"{name}.{k}")


def test_trained_generator_matches_jax(lockstep):
    """G after 3 steps against JAX's G after 3 steps (whose inert biases
    moved on noise, and cancel in the norms)."""
    module = lockstep["jax_model"].networks["G"]
    x = _batches(1, seed=9)[0]["A"]
    want = np.asarray(jax.jit(lambda p, x: module.apply({"params": p}, x))(
        lockstep["jax_params"]["G"], jnp.asarray(x)))
    got = lockstep["model"].infer(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_discriminator_sees_a_and_b(lockstep):
    """The conditional D takes cat([A, B]) (6 channels); G and D are the
    only networks, with no pools."""
    model = lockstep["model"]
    assert list(model.networks) == ["G", "D"] and model.pools == {}
    assert model.networks["D"].stem.weight.shape[1] == 6
    assert model._batch_fusable(model.networks["D"])


def test_infer_translates_a_to_b_only(lockstep):
    model = lockstep["model"]
    x = torch.from_numpy(_batches(1, seed=12)[0]["A"])
    assert model.infer(x).shape == x.shape
    with pytest.raises(ValueError, match="A->B"):
        model.infer(x, direction="BA")


# ---------------------------------------------------------------- dropout


@pytest.fixture
def shared_masks(monkeypatch):
    """Both packages' dropout masks from one numpy stream each, of one seed,
    in call order: the same masks when the calls come in the same order."""
    import flax.linen as fnn
    streams = {"jax": np.random.default_rng(21), "port": np.random.default_rng(21)}
    drawn = {"jax": [], "port": []}

    def jax_dropout(self, inputs, deterministic=None, rng=None):
        deterministic = fnn.merge_param("deterministic", self.deterministic, deterministic)
        if self.rate == 0.0 or deterministic:
            return inputs
        keep = 1.0 - self.rate
        mask = streams["jax"].random(inputs.shape) < keep
        drawn["jax"].append(mask)
        return jax.lax.select(jnp.asarray(mask), inputs / keep, jnp.zeros_like(inputs))

    def port_mask(shape, keep, generator, device):
        mask = streams["port"].random(tuple(shape)) < keep
        drawn["port"].append(mask)
        return torch.from_numpy(mask).to(device)

    monkeypatch.setattr(fnn.Dropout, "__call__", jax_dropout)
    monkeypatch.setattr(layers, "dropout_mask", port_mask)
    return drawn


def test_one_step_with_dropout_matches_jax(tmp_path, shared_masks):
    batch = _batches(1, size=64, seed=15)[0]
    jax_model = _jax_model(tmp_path, batch, DROPOUT)
    init = jax.device_get(jax_model.state.params)
    jax_model.set_input(batch)
    jax_model.optimize_parameters()
    want = {**_floats(jax.device_get(jax_model.losses)),
            **_floats(jax.device_get(jax_model.metrics))}
    model = _port_model(_port_conf(tmp_path, DROPOUT), batch, init)
    got = _step(model, batch)
    # One dropout level (4), applied once, in the G step.
    assert len(shared_masks["jax"]) == len(shared_masks["port"]) == 1
    np.testing.assert_array_equal(shared_masks["jax"][0], shared_masks["port"][0])
    assert shared_masks["port"][0].shape == (BATCH, 4, 4, 64)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   atol=1e-6 if key in METRICS else 0, err_msg=key)
    _check_grads(model, _jax_grads(jax_model), _grads(model))


def test_dropout_draws_from_the_model_generator(tmp_path):
    """A train step's G forward draws its masks from `model.rng`: the same
    state gives the same fake_B bit for bit, another state another one;
    `infer` draws none."""
    batch = _batches(1, size=64, seed=16)[0]
    model = _port_model(_port_conf(tmp_path, DROPOUT), batch)
    assert model.rng.device == torch.device("cpu")
    x = torch.from_numpy(batch["A"])
    state = model.rng.get_state()
    a = model.apply("G", x, generator=model.rng)
    model.rng.set_state(state)
    b = model.apply("G", x, generator=model.rng)
    c = model.apply("G", x, generator=model.rng)
    assert torch.equal(a, b) and not torch.equal(a, c)
    before = model.rng.get_state()
    served = model.infer(x)
    assert torch.equal(model.rng.get_state(), before)
    torch.testing.assert_close(served, model.apply("G", x).float(), rtol=0, atol=0)
    assert not torch.equal(served, a.float())


def test_resume_with_dropout_continues_the_run(tmp_path, caplog):
    """2 steps + checkpoint + resume + 2 steps give the losses and
    parameters of 4 uninterrupted steps, bit for bit, with dropout on: the
    checkpoint holds the generator's state. Without it, the masks differ."""
    batches = _batches(4, size=64, seed=17)
    straight = _port_model(_port_conf(tmp_path / "a", DROPOUT), batches[0])
    straight_logs = [_step(straight, b) for b in batches]

    first = _port_model(_port_conf(tmp_path / "b", DROPOUT), batches[0])
    for b in batches[:2]:
        _step(first, b)
    first.save_checkpoint(2)
    path = tmp_path / "b" / "checkpoints" / "2.pth"
    checkpoint = torch.load(path, weights_only=True)
    assert sorted(checkpoint) == ["D", "G", "optimizer_D", "optimizer_G", "rng"]
    conf = _port_conf(tmp_path / "b", DROPOUT)
    conf.train.checkpointing.load_iter = 2
    resumed = _port_model(conf, batches[0])
    assert [_step(resumed, b) for b in batches[2:]] == straight_logs[2:]
    for name in NETWORKS:
        for (k, p), q in zip(resumed.networks[name].named_parameters(),
                             straight.networks[name].parameters()):
            assert torch.equal(p, q), f"{name}.{k}"

    torch.save({k: v for k, v in checkpoint.items() if k != "rng"}, path)
    with caplog.at_level("INFO"):
        fresh = _port_model(conf, batches[0])
    assert "no generator state" in caplog.text
    assert _step(fresh, batches[2]) != straight_logs[2]


def test_models_without_dropout_save_no_generator(lockstep, tmp_path):
    model = copy.deepcopy(lockstep["model"])
    model.output_dir = str(tmp_path)
    model.save_checkpoint(1)
    checkpoint = torch.load(tmp_path / "checkpoints" / "1.pth", weights_only=True)
    assert sorted(checkpoint) == ["D", "G", "optimizer_D", "optimizer_G"]


# ---------------------------------------------------------------- engines


def _write_pairs(root, n):
    rng = np.random.default_rng(42)
    for domain in ("A", "B"):
        (root / domain).mkdir(parents=True)
        for i in range(n):
            arr = rng.integers(0, 256, (SIZE, 2 * SIZE, 3), dtype=np.uint8)
            Image.fromarray(arr).save(root / domain / f"{i}.png")


def _dataset(root, preprocess):
    return {"_target_": "ganslate.data.PairedImageDataset", "root": str(root),
            "num_workers": 2, "image_channels": 3, "preprocess": preprocess,
            "load_size": [SIZE + 4, 2 * SIZE + 8] if "random_crop" in preprocess
            else [SIZE, 2 * SIZE], "final_size": [SIZE, 2 * SIZE]}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """`init_engine("train", ["config=<yaml>"]).run()` of a Pix2Pix YAML with
    the Cityscapes one's layout (paired folders, random crop and flip,
    validation without cycle metrics) over (32, 64) PNGs: 2 + 2
    iterations, logged every one, validation at 2 and 4, a checkpoint at
    4; then its test and infer sections."""
    root = tmp_path_factory.mktemp("p2p_e2e")
    _write_pairs(root / "train", 6)
    _write_pairs(root / "val", 3)
    conf = _port_conf(root / "out", DROPOUT | dict(num_downs=5), n_iters=2, n_iters_decay=2,
                      seed=3)
    raw = conf.to_container(resolve=False)
    raw["train"].update(logging={"freq": 1}, checkpointing={"freq": 4},
                        dataset=_dataset(root / "train",
                                         ["resize", "random_crop", "random_flip"]))
    val = _dataset(root / "val", ["resize"])
    raw["val"] = {"freq": 2, "dataset": val, "metrics": {"cycle_metrics": False}}
    raw["test"] = {"checkpointing": {"load_iter": 4}, "dataset": dict(val),
                   "metrics": {"save_to_csv": True}}
    raw["infer"] = {"checkpointing": {"load_iter": 4}, "dataset": dict(val),
                    "wire_dtype": "float32"}
    path = root / "pix2pix.yaml"
    path.write_text(yaml.safe_dump(raw))
    trainer = init_engine("train", [f"config={path}"])
    losses = {}
    log_iter = trainer.tracker.log_iter

    def record(learning_rates, step_losses, visuals, metrics):
        losses[trainer.iter_idx] = _floats(step_losses)
        return log_iter(learning_rates, step_losses, visuals, metrics)

    trainer.tracker.log_iter = record
    trainer.run()
    return trainer, losses, root / "out", path


def test_trainer_runs_a_pix2pix_yaml(trained):
    trainer, losses, out, _ = trained
    assert isinstance(trainer.model, Pix2PixConditionalGAN)
    assert sorted(losses) == [1, 2, 3, 4]
    assert all(sorted(v) == sorted(LOSSES) and all(np.isfinite(list(v.values())))
               for v in losses.values())
    assert sorted(torch.load(out / "checkpoints" / "4.pth", weights_only=True)) == \
        ["D", "G", "optimizer_D", "optimizer_G", "rng"]
    log = (out / "train_log.txt").read_text()
    assert "(Val at iter 2)" in log and "(Val at iter 4)" in log
    assert "cycle_SSIM" not in log
    assert len(list((out / "val" / "images").rglob("*.png"))) == 2 * 3
    path = sorted((out / "train" / "images").glob("4_*.png"))[0]
    assert path.name == "4_real_A-fake_B-real_B.png"
    with Image.open(path) as img:
        assert img.size == (3 * 2 * SIZE, SIZE)


def test_tester_and_inferer_run_from_the_checkpoint(trained):
    _, _, out, path = trained
    init_engine("test", [f"config={path}"]).run()
    rows = (out / "test" / "metrics.csv").read_text().splitlines()
    assert len(rows) == 4
    assert all(np.isfinite(float(x)) for row in rows[1:] for x in row.split(",")[1:])
    inferer = init_engine("infer", [f"config={path}"])
    outputs = []
    inferer.save_generated_tensor = lambda generated_tensor, **kw: outputs.append(
        generated_tensor)
    inferer.run()
    assert sum(len(o) for o in outputs) == 3
    for o in outputs:
        assert o.dtype == np.float32 and o.shape[1:] == (SIZE, 2 * SIZE, 3)
        assert np.isfinite(o).all() and np.abs(o).max() <= 1


# ----------------------------------------------------------- project file


def test_cityscapes_project_file_loads(monkeypatch):
    """`projects/cityscapes_label2photo/experiments/pix2pix.yaml` loads in the
    port: its `_target_`s resolve to the port's classes, with its sizes.
    Its validation `load_size` (286, 572) is one that 7 levels cannot take
    (`test_torch_port_unet.py`)."""
    from ganslate_tpu_torch.data import PairedImageDataset
    from ganslate_tpu_torch.nn.discriminators import PatchGAN2D as PortPatchGAN2D
    monkeypatch.chdir(Path(__file__).resolve().parents[1])
    conf = init_config("projects/cityscapes_label2photo/experiments/pix2pix.yaml", Config)
    gan = conf.train.gan
    assert import_attr(gan._target_) is Pix2PixConditionalGAN
    assert import_attr(gan.generator._target_) is Unet2D
    assert import_attr(gan.discriminator._target_) is PortPatchGAN2D is PatchGAN2D
    assert import_attr(conf.train.dataset._target_) is PairedImageDataset
    assert (gan.generator.num_downs, gan.generator.ngf, gan.generator.use_dropout) == \
        (7, 128, True)
    assert gan.discriminator.n_layers == 4 and gan.discriminator.in_channels.B == 6
    assert gan.optimizer.lambda_pix2pix == 30.0
    assert list(conf.val.dataset.load_size) == [286, 572]
    assert conf.val.metrics.cycle_metrics is False
