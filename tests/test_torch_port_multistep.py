"""Multi-step dispatch (`train.steps_per_dispatch`: `BaseGAN.set_input_multi`,
`optimize_parameters` over a chunk, the Trainer's chunked loop and
`chunk_gate_warnings`) and the multi-scale discriminator's random crops
(`MultiScalePatchGAN3D`, drawn from the model's `host_rng`), against the
port itself and against the JAX package.

- k = 2 against k = 1 over 4 batches: parameters bit for bit (the same steps
  in the same order), and each chunk's logged losses and metrics equal to
  the mean of the sequential steps'.
- The port's chunk means against the JAX package's k = 2 chunk means, on
  the conf of the JAX package's `tests/test_multistep.py` with pool 0 (the
  pools' draws cannot match), from the same parameters, within that test's
  1e-3.
- A tail chunk of length 1 steps; the gate warnings read as JAX's.
- The Trainer from a YAML at k = 2: logs and checkpoints at chunk
  boundaries only; a preemption saves at the chunk's end.
- Crops in range, fresh per call, repeated from the seed and resumed from a
  checkpoint; D losses move with the crop generator's seed under the
  multi-scale D and not under PatchGAN3D (the JAX package's
  `tests/test_stochastic_training.py`).

The JAX models are set up as `BaseGAN.setup` does, but with parameters
drawn over `jax.eval_shape` shapes (`jax_model_from_shapes`): a jitted init
of each network costs ~15 s on a CPU.
"""

import signal

import numpy as np
import pytest
import yaml

import jax
import jax.numpy as jnp
import torch

from ganslate_tpu_torch.nn.discriminators.patchgan.multiscale_patchgan3d import crop_starts
from ganslate_tpu_torch.utils.builders import build_gan
from ganslate_tpu_torch.utils.flax_weights import load_flax_params
from ganslate_tpu_torch.utils.testing import make_cyclegan_conf
from tests.torch_port_support import one_torch_thread  # noqa: F401 (autouse)


def jax_model_from_shapes(conf, batch, gamma=0.0, seed=0):
    """A JAX GAN of `conf` set up as `BaseGAN.setup` does, with parameters
    drawn with numpy over the shapes of `jax.eval_shape(module.init)` in
    place of a compiled init: kernels from N(0, 0.02) (the init's
    distribution), zero biases, unit batch-norm scales, PReLU slopes 0.25
    and attention gammas `gamma`."""
    from ganslate_tpu.nn.gans.base import GANState
    from ganslate_tpu.parallel import replicate_to_mesh
    from ganslate_tpu.utils.builders import build_gan as jax_build_gan
    model = jax_build_gan(conf)
    model.init_networks()
    model.init_criterions()
    model.init_optimizers()
    model.init_metrics()
    spec = {k: jax.ShapeDtypeStruct(np.shape(v), jnp.float32) for k, v in batch.items()}
    rng = np.random.default_rng(seed)
    fill = {"scale": 1.0, "slope": 0.25, "gamma": gamma}

    def draw(path, a):
        name = path[-1].key
        if name == "kernel":
            return (0.02 * rng.normal(size=a.shape)).astype(np.float32)
        return np.full(a.shape, fill.get(name, 0.0), np.float32)

    params = {}
    for name, module in sorted(model.networks.items()):
        shapes = jax.eval_shape(module.init, jax.random.key(0),
                                model._dummy_input(name, spec))["params"]
        params[name] = jax.tree_util.tree_map_with_path(draw, shapes)
    opt_state = {g: jax.jit(model.optimizers[g].init)(model.group_params(params, g))
                 for g in model.optimizers}
    state = GANState(step=jnp.zeros((), jnp.int32), params=params, opt_state=opt_state,
                     pools=model.init_state_pools(spec), rng=jax.random.key(seed))
    model.state = replicate_to_mesh(state, model.mesh)
    k = int(conf.train.steps_per_dispatch or 1)
    model._train_step_fn = jax.jit(model.make_multi_step(k) if k > 1
                                   else model.make_train_step(), donate_argnums=0)
    return model


# ------------------------------------------------------------------ chunks


def _conf(out_dir, steps_per_dispatch=1, pool_size=4):
    """The conf of the JAX package's `tests/test_multistep.py`."""
    conf = make_cyclegan_conf(str(out_dir), batch_size=2, n_residual_blocks=1, ngf=8, ndf=8,
                              pool_size=pool_size, mixed_precision=False, seed=3, cuda=False)
    conf.train.steps_per_dispatch = steps_per_dispatch
    conf.train.metrics.discriminator_evolution = True
    return conf


def _batches(n, batch_size=2, image_size=32):
    rng = np.random.default_rng(7)
    return [{k: rng.uniform(-1, 1, (batch_size, image_size, image_size, 3))
             .astype(np.float32) for k in ("A", "B")} for _ in range(n)]


def _run(conf, batches, k, params=None):
    model = build_gan(conf)
    model.setup(batches[0])
    if params is not None:
        for name, net in model.networks.items():
            load_flax_params(net, params[name])
    logs = []
    for i in range(0, len(batches), k):
        chunk = batches[i:i + k]
        if k > 1:
            model.set_input_multi(chunk)
        else:
            model.set_input(chunk[0])
        model.optimize_parameters()
        _, losses, _, metrics = model.get_loggable_data()
        logs.append({**losses, **metrics})
    return model, logs


def test_chunks_match_sequential_steps(tmp_path):
    batches = _batches(4)
    seq, logs1 = _run(_conf(tmp_path / "1"), batches, 1)
    chunked, logs2 = _run(_conf(tmp_path / "2", 2), batches, 2)
    for name, net in seq.networks.items():
        for (key, p), (_, q) in zip(net.named_parameters(),
                                    chunked.networks[name].named_parameters()):
            assert torch.equal(p, q), f"{name}.{key}"
    for group, optimizer in seq.optimizers.items():
        assert seq._update_count(optimizer) == chunked._update_count(
            chunked.optimizers[group]) == 4
    assert len(logs2) == 2 and sorted(logs2[0]) == sorted(logs1[0])
    for chunk in range(2):
        for name in logs1[0]:
            want = (logs1[2 * chunk][name] + logs1[2 * chunk + 1][name]) / 2
            assert torch.equal(logs2[chunk][name], want), (chunk, name)
    # Visuals are the chunk's last step's.
    for k, v in seq.visuals.items():
        assert torch.equal(v, chunked.visuals[k]), k


def test_chunk_means_match_jax(tmp_path):
    from ganslate_tpu.configs.config import Config as JaxConfig
    from ganslate_tpu.configs.omega import Conf as JaxConf
    from ganslate_tpu.configs.utils import init_config as jax_init_config
    batches = _batches(4)
    conf = _conf(tmp_path, 2, pool_size=0)
    raw = {"train": conf.to_container(resolve=False)["train"]}
    for key in ("dataset", "logging", "checkpointing"):
        raw["train"].pop(key, None)
    jax_model = jax_model_from_shapes(jax_init_config(JaxConf.create(raw), JaxConfig),
                                      batches[0])
    params = jax.device_get(jax_model.state.params)
    jax_logs = []
    for i in (0, 2):
        jax_model.set_input_multi(batches[i:i + 2])
        jax_model.optimize_parameters()
        jax_logs.append({k: float(v) for k, v in {**jax.device_get(jax_model.losses),
                                                   **jax.device_get(jax_model.metrics)}.items()})
    _, logs = _run(conf, batches, 2, params)
    for got, want in zip(logs, jax_logs):
        assert sorted(got) == sorted(want)
        for name in want:
            assert abs(float(got[name]) - want[name]) < 1e-3, (name, float(got[name]),
                                                               want[name])


def test_tail_chunk_steps(tmp_path):
    """A chunk shorter than k (even of length 1) steps, and logs that step's
    own losses."""
    batches = _batches(3)
    model = build_gan(_conf(tmp_path, 2))
    model.setup(batches[0])
    model.set_input_multi(batches[:2])
    model.optimize_parameters()
    model.set_input_multi(batches[2:])
    model.optimize_parameters()
    assert all(model._update_count(o) == 3 for o in model.optimizers.values())
    assert model._batch["A"].shape == (2, 32, 32, 3)
    assert all(v.shape == () for v in model.losses.values())


def test_chunk_gate_warnings_match_jax():
    from ganslate_tpu.configs.omega import Conf as JaxConf
    from ganslate_tpu.engines.trainer import chunk_gate_warnings as jax_warnings
    from ganslate_tpu_torch.configs.omega import Conf
    from ganslate_tpu_torch.engines.trainer import chunk_gate_warnings
    for raw, k, n in (({"train": {"logging": {"freq": 8}, "checkpointing": {"freq": 16}},
                        "val": {"freq": 25}}, 8, 1),
                      ({"train": {"logging": {"freq": 5}, "checkpointing": {"freq": 6}}}, 4, 2),
                      ({"train": {"logging": {"freq": 4}, "checkpointing": {"freq": 8}}}, 2, 0)):
        got = chunk_gate_warnings(Conf.create(raw), k)
        assert got == jax_warnings(JaxConf.create(raw), k) and len(got) == n, got


def _trainer_yaml(tmp_path, **train):
    from PIL import Image
    data = tmp_path / "data"
    rng = np.random.default_rng(42)
    for domain in ("A", "B"):
        d = data / domain
        d.mkdir(parents=True, exist_ok=True)
        for i in range(8):
            Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)).save(
                d / f"{i}.png")
    raw = {"train": {
        "output_dir": str(tmp_path / "out"), "batch_size": 4, "cuda": False,
        "n_iters": 2, "n_iters_decay": 2, "steps_per_dispatch": 2,
        "logging": {"freq": 2}, "checkpointing": {"freq": 4},
        "dataset": {"_target_": "ganslate.data.UnpairedImageDataset", "root": str(data),
                    "num_workers": 0, "image_channels": 3, "preprocess": ["resize"],
                    "load_size": [32, 32], "final_size": [32, 32]},
        "gan": {"_target_": "ganslate.nn.gans.unpaired.CycleGAN", "pool_size": 4,
                "generator": {"_target_": "ganslate.nn.generators.Resnet2D",
                              "n_residual_blocks": 1, "ngf": 8,
                              "in_out_channels": {"AB": [3, 3]}},
                "discriminator": {"_target_": "ganslate.nn.discriminators.PatchGAN2D",
                                  "ndf": 8, "n_layers": 1, "in_channels": {"B": 3}},
                "optimizer": {"lambda_AB": 10.0, "lambda_BA": 10.0, "lambda_identity": 0,
                              "proportion_ssim": 0}},
        "seed": 0, **train}}
    path = tmp_path / "chunked.yaml"
    path.write_text(yaml.safe_dump(raw))
    return path


def _trainer(path, *overrides):
    from ganslate_tpu_torch.engines.utils import init_engine
    trainer = init_engine("train", [f"config={path}", *overrides])
    logged, steps = [], []
    log_iter = trainer.tracker.log_iter

    def log(*args):
        logged.append(trainer.iter_idx)
        return log_iter(*args)

    trainer.tracker.log_iter = log
    optimize = trainer.model.optimize_parameters

    def step(*args, **kwargs):
        steps.append(len(trainer.model._chunk or [None]))
        return optimize(*args, **kwargs)

    trainer.model.optimize_parameters = step
    warnings = []
    warn = trainer.logger.warning
    trainer.logger.warning = lambda msg, *a, **kw: (warnings.append(msg), warn(msg, *a, **kw))
    return trainer, logged, steps, warnings


def test_trainer_chunked_dispatch(tmp_path):
    """As the JAX package's `test_trainer_chunked_dispatch`: 4 iterations in
    chunks of 2, logs at 2 and 4, the checkpoint of 4 and its visuals."""
    trainer, logged, steps, warnings = _trainer(_trainer_yaml(tmp_path))
    trainer.run()
    model = trainer.model
    assert steps == [2, 2] and logged == [2, 4]
    assert all(model._update_count(o) == 4 for o in model.optimizers.values())
    assert sorted(p.name for p in (tmp_path / "out" / "checkpoints").glob("*.pth")) == ["4.pth"]
    assert list((tmp_path / "out" / "train" / "images").glob("*.png"))
    assert not warnings


def test_trainer_chunk_warnings_and_tail_chunk(tmp_path):
    """5 iterations at k = 2: chunks of 2, 2 and 1; logging.freq 3 is not a
    multiple of 2 and warns, in the JAX package's words."""
    trainer, logged, steps, warnings = _trainer(_trainer_yaml(tmp_path), "train.n_iters=3",
                                                "train.logging.freq=3")
    trainer.run()
    assert steps == [2, 2, 1] and logged == [2, 4, 5]
    assert all(trainer.model._update_count(o) == 5 for o in trainer.model.optimizers.values())
    assert sorted(p.name for p in (tmp_path / "out" / "checkpoints").glob("*.pth")) == ["4.pth"]
    assert warnings == ["train.logging.freq=3 is not a multiple of steps_per_dispatch=2; it will fire "
            "only when a chunk boundary lands on it."]


def test_trainer_chunked_preemption_saves_at_the_chunk_end(tmp_path):
    trainer, logged, steps, _ = _trainer(_trainer_yaml(tmp_path), "train.checkpointing.freq=100")
    optimize = trainer.model.optimize_parameters

    def preempted(*args, **kwargs):
        signal.raise_signal(signal.SIGTERM)
        return optimize(*args, **kwargs)

    trainer.model.optimize_parameters = preempted
    trainer.run()
    assert steps == [2]
    assert sorted(p.name for p in (tmp_path / "out" / "checkpoints").glob("*.pth")) == ["2.pth"]


# ------------------------------------------------------------------ crops


def test_crop_starts_in_range_fresh_and_seeded():
    spatial, crop = (16, 32, 32), (8, 16, 16)
    g = torch.Generator().manual_seed(5)
    draws = [tuple(crop_starts(spatial, crop, g)) for _ in range(20)]
    assert all(0 <= a <= s - c for d in draws for a, s, c in zip(d, spatial, crop))
    assert len(set(draws)) > 10
    g.manual_seed(5)
    assert [tuple(crop_starts(spatial, crop, g)) for _ in range(20)] == draws
    assert crop_starts(spatial, crop, None) == [4, 8, 8]


def _cyclegan3d_conf(out_dir, multiscale):
    """The JAX package's `_cyclegan3d_conf` (`tests/test_stochastic_training.py`),
    at batch 1."""
    from ganslate_tpu_torch.configs.config import Config
    from ganslate_tpu_torch.configs.omega import Conf
    from ganslate_tpu_torch.configs.utils import init_config
    d_target = ("ganslate.nn.discriminators.MultiScalePatchGAN3D" if multiscale
                else "ganslate.nn.discriminators.PatchGAN3D")
    raw = {"train": {
        "output_dir": str(out_dir), "batch_size": 1, "cuda": False, "n_iters": 4,
        "n_iters_decay": 4, "seed": 0,
        "gan": {"_target_": "ganslate.nn.gans.unpaired.CycleGAN", "pool_size": 0,
                "generator": {"_target_": "ganslate.nn.generators.Resnet3D",
                              "n_residual_blocks": 1, "ngf": 4,
                              "in_out_channels": {"AB": [1, 1]}},
                "discriminator": {"_target_": d_target, "ndf": 4, "n_layers": 1,
                                  "kernel_size": [3, 3, 3], "in_channels": {"B": 1},
                                  **({"scales": 2} if multiscale else {})},
                "optimizer": {"lambda_AB": 10.0, "lambda_BA": 10.0, "lambda_identity": 0,
                              "proportion_ssim": 0}}}}
    return init_config(Conf.create(raw), Config)


def _batch3d(seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(-1, 1, (1, 16, 16, 16, 1)).astype(np.float32) for k in "AB"}


def _losses_for_crop_seed(out_dir, multiscale, seed):
    model = build_gan(_cyclegan3d_conf(out_dir, multiscale))
    model.setup(_batch3d())
    model.host_rng.manual_seed(seed)
    model.set_input(_batch3d())
    model.optimize_parameters()
    return {k: float(v) for k, v in model.losses.items()}


@pytest.mark.parametrize("multiscale", (True, False), ids=("multiscale", "patchgan3d"))
def test_d_losses_move_with_the_crop_seed_only_under_multiscale(tmp_path, multiscale):
    l1 = _losses_for_crop_seed(tmp_path, multiscale, 1)
    l2 = _losses_for_crop_seed(tmp_path, multiscale, 2)
    if multiscale:
        assert l1["D_B"] != l2["D_B"] or l1["D_A"] != l2["D_A"], (l1, l2)
    else:
        assert l1 == l2, (l1, l2)


def test_crops_resume_from_a_checkpoint(tmp_path):
    """Train 2 steps; a model loaded from the checkpoint of step 1 takes step
    2 with the same crops: the same losses bit for bit."""
    conf = _cyclegan3d_conf(tmp_path, True)
    batches = [_batch3d(s) for s in (1, 2)]
    model = build_gan(conf)
    model.setup(batches[0])
    assert model._stochastic()
    model.set_input(batches[0])
    model.optimize_parameters()
    model.save_checkpoint(1)
    model.set_input(batches[1])
    model.optimize_parameters()
    want = {k: float(v) for k, v in model.losses.items()}
    state = torch.load(tmp_path / "checkpoints" / "1.pth", weights_only=True)
    assert "host_rng" in state and "rng" in state

    conf.train.checkpointing.load_iter = 1
    resumed = build_gan(conf)
    resumed.setup(batches[0])
    resumed.set_input(batches[1])
    resumed.optimize_parameters()
    assert {k: float(v) for k, v in resumed.losses.items()} == want
