"""The port's `Trainer`, `Validator`, `Tester` and `Inferer.run()` on the CPU,
driven from experiment YAMLs through `init_engine`, as the JAX package's
`tests/test_e2e_train.py` drives its engines; held against the JAX
package's `Trainer` iteration for iteration; resumed after a SIGTERM.

Small nets (Resnet2D with 1 residual block, ngf 8; PatchGAN2D, ndf 8),
32x32 PNG folders written here, fp32, `train.cuda=false`.

Tolerances: the lockstep's losses per iteration, rtol 1e-4, the bound of
the model-level lockstep (`test_torch_port_train_step.py`): every conv and
norm sums in another order than XLA, by a few fp32 ulps per layer. The
batches each Trainer is fed are equal bit for bit: the same Pillow decode
and the same per-sample random draws. A resumed run repeats the
uninterrupted one exactly: the same operations on the same CPU, from a
checkpoint that holds every parameter, optimizer moment, pool and the
sampler's position."""

import copy
import signal

import numpy as np
import pytest
import yaml
from PIL import Image

import jax
import torch

from ganslate_tpu_torch.configs.config import Config
from ganslate_tpu_torch.configs.omega import Conf
from ganslate_tpu_torch.configs.utils import init_config
from ganslate_tpu_torch.engines.trainer import Trainer
from ganslate_tpu_torch.engines.utils import init_engine
from ganslate_tpu_torch.utils.builders import build_conf, build_loader
from ganslate_tpu_torch.utils.flax_weights import load_flax_params

SIZE = 32
NETWORKS = ("G_AB", "G_BA", "D_B", "D_A")


def _write_pngs(root, n=6):
    rng = np.random.default_rng(42)
    for domain in ("A", "B"):
        (root / domain).mkdir(parents=True)
        for i in range(n):
            arr = rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
            Image.fromarray(arr).save(root / domain / f"{domain.lower()}{i}.png")


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("pngs")
    _write_pngs(root)
    return root


def _dataset(root, target="ganslate.data.UnpairedImageDataset", random=False):
    preprocess = ["resize", "random_crop", "random_flip"] if random else ["resize"]
    return {"_target_": target, "root": str(root), "num_workers": 2, "image_channels": 3,
            "preprocess": preprocess, "load_size": [36, 36] if random else [SIZE, SIZE],
            "final_size": [SIZE, SIZE]}


def _raw(out_dir, data_root, n_iters=2, n_iters_decay=2, pool_size=4, seed=5, **train):
    return {"train": {
        "output_dir": str(out_dir), "batch_size": 2, "cuda": False, "mixed_precision": False,
        "n_iters": n_iters, "n_iters_decay": n_iters_decay, "seed": seed,
        "logging": {"freq": 1}, "checkpointing": {"freq": 100000},
        "dataset": _dataset(data_root, random=True),
        "gan": {"_target_": "ganslate.nn.gans.unpaired.CycleGAN", "pool_size": pool_size,
                "generator": {"_target_": "ganslate.nn.generators.Resnet2D",
                              "n_residual_blocks": 1, "ngf": 8,
                              "in_out_channels": {"AB": [3, 3]}},
                "discriminator": {"_target_": "ganslate.nn.discriminators.PatchGAN2D",
                                  "ndf": 8, "n_layers": 2, "in_channels": {"B": 3}},
                "optimizer": {"lambda_AB": 10.0, "lambda_BA": 10.0, "lambda_identity": 0,
                              "proportion_ssim": 0}},
        **train}}


def _write_yaml(path, raw):
    path.write_text(yaml.safe_dump(raw))
    return str(path)


class Recorder:
    """Wraps a Trainer's `model.set_input` and `tracker.log_iter`: the batch
    fed and the losses logged at each iteration."""

    def __init__(self, trainer):
        self.batches, self.losses = {}, {}
        set_input, log_iter = trainer.model.set_input, trainer.tracker.log_iter

        def record_input(batch):
            self.batches[trainer.iter_idx] = {k: np.array(v) for k, v in batch.items()}
            return set_input(batch)

        def record_log(learning_rates, losses, visuals, metrics):
            self.losses[trainer.iter_idx] = {k: float(v) for k, v in losses.items()}
            return log_iter(learning_rates, losses, visuals, metrics)

        trainer.model.set_input = record_input
        trainer.tracker.log_iter = record_log


# ------------------------------------------------------------ end to end


@pytest.fixture(scope="module")
def trained(tmp_path_factory, data_root):
    """`init_engine("train", ["config=<yaml>"]).run()`: 2 + 2 iterations,
    logged every one, a checkpoint at 4, validation at 2 and 4 with the
    cycle metrics, NMI and the histogram distance."""
    root = tmp_path_factory.mktemp("e2e")
    raw = _raw(root / "out", data_root, checkpointing={"freq": 4})
    raw["train"]["dataset"] = _dataset(data_root)
    paired = _dataset(data_root, "ganslate.data.PairedImageDataset")
    raw["val"] = {"freq": 2, "dataset": paired,
                  "metrics": {"cycle_metrics": True, "nmi": True, "histogram_chi2": True}}
    raw["test"] = {"checkpointing": {"load_iter": 4}, "dataset": dict(paired),
                   "metrics": {"nmi": True, "save_to_csv": True}}
    raw["infer"] = {"checkpointing": {"load_iter": 4}, "dataset": _dataset(data_root),
                    "wire_dtype": "float32"}
    config = _write_yaml(root / "exp.yaml", raw)
    trainer = init_engine("train", [f"config={config}"])
    recorder = Recorder(trainer)
    trainer.run()
    return trainer, recorder, root / "out", config


def test_training_runs_end_to_end(trained):
    trainer, recorder, out, _ = trained
    assert sorted(recorder.losses) == [1, 2, 3, 4]
    assert all(np.isfinite(v) for losses in recorder.losses.values() for v in losses.values())
    assert (out / "checkpoints" / "4.pth").is_file()
    state = yaml.safe_load((out / "checkpoints" / "data_state_4.json").read_text())
    assert state["position"] == 4 * 2 and state["world_size"] == 1
    assert state["sampler_seed"] == trainer.data_loader.sampler.seed
    assert "Training started." in (out / "train_log.txt").read_text()
    assert len(list((out / "train" / "images").glob("*.png"))) == 4
    val_log = (out / "train_log.txt").read_text()
    assert "(Val at iter 2)" in val_log and "cycle_SSIM" in val_log and "nmi" in val_log
    assert len(list((out / "val" / "images").rglob("*.png"))) == 2 * 6


def test_config_dump_reads_back(trained):
    """`train/train_config.yaml` comes from the port's own YAML emitter."""
    trainer, _, out, _ = trained
    dumped = yaml.safe_load((out / "train" / "train_config.yaml").read_text())
    assert dumped == trainer.conf.to_container(resolve=False)


def test_logged_visuals_are_pngs_of_the_grid(trained):
    _, _, out, _ = trained
    path = sorted((out / "train" / "images").glob("4_*.png"))[0]
    assert path.name == "4_real_A-fake_B-rec_A-real_B-fake_A-rec_B.png"
    with Image.open(path) as img:
        assert img.mode == "RGB" and img.size == (6 * SIZE, SIZE)


def test_inferer_run_from_the_checkpoint(trained):
    _, _, out, config = trained
    inferer = init_engine("infer", [f"config={config}"])
    outputs = []
    inferer.save_generated_tensor = lambda generated_tensor, **kw: outputs.append(
        generated_tensor)
    inferer.run()
    assert sum(len(o) for o in outputs) == 6
    for o in outputs:
        assert o.dtype == np.float32 and o.shape[1:] == (SIZE, SIZE, 3)
        assert np.isfinite(o).all() and np.abs(o).max() <= 1
    assert len(list((out / "infer" / "images").glob("*_input-output.png"))) == 6


def test_tester_run_from_the_checkpoint(trained):
    _, _, out, config = trained
    init_engine("test", [f"config={config}"]).run()
    rows = (out / "test" / "metrics.csv").read_text().splitlines()
    assert rows[0] == ",ssim,mse,nmse,psnr,mae,nmi" and len(rows) == 7
    assert all(np.isfinite(float(x)) for row in rows[1:] for x in row.split(",")[1:])
    assert "(Test) " in (out / "test_log.txt").read_text()


@pytest.mark.parametrize("mode", ("train", "test", "infer"))
def test_cuda_true_without_gpu_raises(trained, mode):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: cuda=true is satisfied here")
    _, _, _, config = trained
    with pytest.raises(RuntimeError, match="CUDA"):
        init_engine(mode, [f"config={config}", "train.cuda=true"])


def test_fid_waits_for_its_slice(trained):
    """FID is ported: `test.metrics.fid=true` without `fid_weights` raises
    with the JAX package's message."""
    _, _, _, config = trained
    with pytest.raises(ValueError, match="metrics.fid requires metrics.fid_weights"):
        init_engine("test", [f"config={config}", "test.metrics.fid=true"])


def test_horse2zebra_project_file_loads(tmp_path, monkeypatch):
    """`projects/horse2zebra/experiments/default.yaml` loads in the port (FID
    off) and builds its loader over a folder of images."""
    from pathlib import Path
    repo = Path(__file__).resolve().parents[1]
    monkeypatch.chdir(repo)
    _write_pngs(tmp_path, n=3)
    conf = build_conf(["config=projects/horse2zebra/experiments/default.yaml",
                       "val.metrics.fid=false", f"train.dataset.root={tmp_path}"])
    assert conf.train.gan.generator.n_residual_blocks == 9
    assert conf.train.gan.discriminator.n_layers == 3
    assert conf.val.dataset._target_ == "ganslate.data.PairedImageDataset"
    loader = build_loader(conf)
    assert type(loader.dataset).__module__ == "ganslate_tpu_torch.data.unpaired_image_dataset"
    assert loader.num_workers == 16
    batch = next(iter(loader))
    assert batch["A"].shape == (1, 256, 256, 3) and batch["B"].dtype == np.float32


# --------------------------------------------------- lockstep with JAX


@pytest.fixture(scope="module")
def lockstep(tmp_path_factory, data_root):
    """One raw config (pool 0: the pools' draws cannot match; seed 5; 3
    iterations) through the JAX package's Trainer and the port's, the
    port's networks starting from the JAX initial parameters."""
    from ganslate_tpu.configs.config import Config as JaxConfig
    from ganslate_tpu.configs.omega import Conf as JaxConf
    from ganslate_tpu.configs.utils import init_config as jax_init_config
    from ganslate_tpu.engines.trainer import Trainer as JaxTrainer

    root = tmp_path_factory.mktemp("lockstep")
    raws = {pkg: _raw(root / pkg, data_root, n_iters=2, n_iters_decay=1, pool_size=0)
            for pkg in ("jax", "port")}
    jax_trainer = JaxTrainer(jax_init_config(JaxConf.create(raws["jax"]), JaxConfig))
    init = jax.device_get(jax_trainer.model.state.params)
    jax_record = Recorder(jax_trainer)
    jax_trainer.run()

    trainer = Trainer(init_config(Conf.create(raws["port"]), Config))
    for name in NETWORKS:
        load_flax_params(trainer.model.networks[name], init[name])
    record = Recorder(trainer)
    trainer.run()
    return record, jax_record


def test_trainer_feeds_the_same_batches_as_jax(lockstep):
    record, jax_record = lockstep
    assert sorted(record.batches) == sorted(jax_record.batches) == [1, 2, 3]
    for i, want in jax_record.batches.items():
        got = record.batches[i]
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key])


def test_trainer_losses_match_jax(lockstep):
    record, jax_record = lockstep
    assert sorted(record.losses) == sorted(jax_record.losses) == [1, 2, 3]
    for i, want in jax_record.losses.items():
        got = record.losses[i]
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                       err_msg=f"iteration {i}, {key}")


# ---------------------------------------------------------------- resume


def _sigterm_at(trainer, iteration):
    """Raise SIGTERM in this process during `iteration`'s step, once the
    Trainer's handler is installed."""
    optimize = trainer.model.optimize_parameters

    def step(*args, **kwargs):
        out = optimize(*args, **kwargs)
        if trainer.iter_idx == iteration:
            handler = signal.getsignal(signal.SIGTERM)
            assert getattr(handler, "__qualname__", "").startswith(
                "Trainer._install_preemption_handler"), handler
            signal.raise_signal(signal.SIGTERM)
        return out

    trainer.model.optimize_parameters = step


def test_sigterm_resume_reproduces_the_uninterrupted_run(tmp_path, data_root):
    before = signal.getsignal(signal.SIGTERM)
    uninterrupted = Trainer(init_config(Conf.create(_raw(tmp_path / "u", data_root)), Config))
    whole = Recorder(uninterrupted)
    uninterrupted.run()
    assert sorted(whole.losses) == [1, 2, 3, 4]

    raw = _raw(tmp_path / "p", data_root)
    stopped = Trainer(init_config(Conf.create(raw), Config))
    first = Recorder(stopped)
    _sigterm_at(stopped, 2)
    stopped.run()
    assert sorted(first.losses) == [1, 2]
    assert signal.getsignal(signal.SIGTERM) is before      # the handler is restored
    checkpoints = tmp_path / "p" / "checkpoints"
    assert (checkpoints / "2.pth").is_file() and (checkpoints / "data_state_2.json").is_file()
    assert "pool_fake_B" in torch.load(checkpoints / "2.pth", weights_only=True)

    raw = copy.deepcopy(raw)
    raw["train"]["checkpointing"]["load_iter"] = 2
    resumed = Trainer(init_config(Conf.create(raw), Config))
    rest = Recorder(resumed)
    resumed.run()
    assert sorted(rest.losses) == [3, 4]
    for i in (3, 4):
        for key, want in whole.batches[i].items():
            assert np.array_equal(rest.batches[i][key], want), (i, key)
        assert rest.losses[i] == whole.losses[i], i
