"""The ClearGrasp project twin (`ganslate_tpu_torch/projects/
cleargrasp_depth_estimation/`) against the JAX package's project: its
datasets, the multimodal CycleGAN (`CycleGANMultiModalV3`) in lockstep, and
the project's YAMLs loaded and trained through the port's engines.

Image folders of synthetic samples (`utils/synthetic_data.
write_cleargrasp_root`: 3 for training, 2 for validation, 80x48) hold JPEG
photos and JPEG normal and depth maps: this sandbox's cv2 has no EXR codec
(`cv2.haveImageWriter("x.exr")` is False), so both packages' EXR `save`
fails alike here. Both packages' datasets read the folders; before each
call both sides are seeded alike (Python's `random` for domain B's sample,
the global `np.random` for domain B's RGB noise), and the samples must be
equal bit for bit (the arrays are under 2^20 elements, where both
packages normalise in numpy).

The model: Resnet2D with 1 residual block and ngf 8 (6 -> 1 and 4 -> 3
channels) and PatchGAN2D with 1 layer and ndf 8 (1 and 3 channels), at
32x64, batch 2, fp32, pool 0; the JAX initial parameters carried into the
port. Tolerances as the CycleGAN lockstep test: losses and metrics per
step rtol 1e-4 (the D metrics also atol 1e-6), every gradient after step 1
within 1e-4 relative L2, every parameter after step 3 within 1e-5; the
inert biases (convs before an instance norm) exactly zero in JAX and
without a gradient in the port. The lockstep's batches are seed 8's: with
seed 7's, step 3 puts one pre-activation of G_BA's last norm 3e-8 from
its ReLU's kink (in a float64 replay of the port's step), where fp32
rounding picks the side; JAX's run and the port's land on opposite sides,
G's step-3 gradient moves by 2% and its parameters by up to 2.4e-4. JAX's
step 3 there agrees with the port's float64 replay to 1e-6."""

import copy
import importlib.util
import random
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import yaml

import jax
import jax.numpy as jnp
import torch

from ganslate_tpu_torch.configs.config import Config
from ganslate_tpu_torch.configs.omega import Conf
from ganslate_tpu_torch.configs.utils import init_config
from ganslate_tpu_torch.engines.utils import init_engine
from ganslate_tpu_torch.projects.cleargrasp_depth_estimation import datasets
from ganslate_tpu_torch.utils.builders import build_gan
from ganslate_tpu_torch.utils.flax_weights import load_flax_params
from ganslate_tpu_torch.utils.synthetic_data import write_cleargrasp_root
from tests.torch_port_support import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
CLEARGRASP = REPO / "projects" / "cleargrasp_depth_estimation"
YAMLS = ("pix2pix_new", "cyclegan_balanced", "cyclegan_naive")
SOURCE_WH = (80, 48)
LOAD_WH = [64, 32]
MODULE = "modules.CycleGANMultiModalV3"
NETWORKS = ("G_AB", "G_BA", "D_B", "D_A")
BATCH = 2
LOSSES = ["G_AB", "G_BA", "cycle_A", "cycle_B", "D_B", "D_A"]
METRICS = ["D_B_real", "D_B_fake", "D_A_real", "D_A_fake"]


def _jax_project():
    """The JAX package's ClearGrasp project under a name of its own (the name
    `project` is the port's in this process)."""
    name = "jax_cleargrasp_project"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, CLEARGRASP / "__init__.py", submodule_search_locations=[str(CLEARGRASP)])
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
        for sub in ("datasets", "modules"):
            importlib.import_module(f"{name}.{sub}")
    return sys.modules[name]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("cleargrasp")
    write_cleargrasp_root(root, SOURCE_WH, 3, 2, exr=False, seed=4)
    return root


def _conf(root, mode, **dataset):
    dataset = {"root": str(root / ("train" if mode == "train" else "val")),
               "load_size": LOAD_WH, **dataset}
    return Conf.create({"mode": mode, mode: {"dataset": dataset}})


def _seeded(dataset, index, seed):
    random.seed(seed)
    np.random.seed(seed)
    return dataset[index]


# ------------------------------------------------------------- datasets


@pytest.mark.parametrize("paired, rgb_b", [(True, False), (False, True), (False, False)])
def test_train_dataset_matches_jax_bit_for_bit(root, paired, rgb_b):
    conf = _conf(root, "train", paired=paired, require_domain_B_rgb=rgb_b)
    port = datasets.ClearGraspTrainDataset(conf)
    jax_ds = _jax_project().datasets.ClearGraspTrainDataset(conf)
    assert len(port) == len(jax_ds) == 3
    for index, seed in [(0, 11), (1, 12), (2, 13), (4, 14)]:
        got, want = _seeded(port, index, seed), _seeded(jax_ds, index, seed)
        assert sorted(got) == sorted(want) == ["A", "B"]
        assert got["A"].shape == (*LOAD_WH[::-1], 6)
        assert got["B"].shape == (*LOAD_WH[::-1], 4 if rgb_b else 1)
        for key in ("A", "B"):
            assert got[key].dtype == want[key].dtype == np.float32
            np.testing.assert_array_equal(got[key], want[key])
            assert got[key].min() >= -1 and got[key].max() <= 1


def test_domain_b_rgb_noise_comes_from_global_numpy_random(root):
    conf = _conf(root, "train", paired=True, require_domain_B_rgb=True)
    port = datasets.ClearGraspTrainDataset(conf)
    a, b, c = _seeded(port, 0, 3), _seeded(port, 0, 3), _seeded(port, 0, 4)
    np.testing.assert_array_equal(a["B"], b["B"])
    assert not np.array_equal(a["B"][..., :3], c["B"][..., :3])
    np.testing.assert_array_equal(a["B"][..., 3:], c["B"][..., 3:])
    np.testing.assert_array_equal(a["A"], c["A"])


@pytest.mark.parametrize("balanced", (True, False))
def test_val_dataset_matches_jax_bit_for_bit(root, balanced):
    conf = _conf(root, "val", model_is_cyclegan_balanced=balanced)
    port = datasets.ClearGraspValTestDataset(conf)
    jax_ds = _jax_project().datasets.ClearGraspValTestDataset(conf)
    assert port.sample_ids == jax_ds.sample_ids == ["000000003", "000000004"]
    for index in (0, 1):
        got, want = port[index], jax_ds[index]
        assert sorted(got) == sorted(want) == ["A", "B", "metadata"]
        assert got["metadata"] == want["metadata"] == {"sample_id": port.sample_ids[index]}
        for key in ("A", "B"):
            np.testing.assert_array_equal(got[key], want[key])
        assert got["B"].shape == (*LOAD_WH[::-1], 4 if balanced else 1)
        if balanced:
            assert not got["B"][..., :3].any()
    np.testing.assert_array_equal(port.denormalize(got["B"]), jax_ds.denormalize(want["B"]))


@pytest.mark.parametrize("balanced", (True, False))
def test_exr_save_fails_alike_without_an_exr_codec(root, tmp_path, balanced):
    """`save` writes the depth map (the last channel when balanced) as EXR;
    with a cv2 that has no EXR codec, both packages raise the same error."""
    assert not cv2.haveImageWriter(str(tmp_path / "x.exr"))
    conf = _conf(root, "val", model_is_cyclegan_balanced=balanced)
    errors = []
    for cls in (datasets.ClearGraspValTestDataset,
                _jax_project().datasets.ClearGraspValTestDataset):
        dataset = cls(conf)
        sample = dataset[0]
        with pytest.raises(cv2.error) as info:
            dataset.save(sample["B"], tmp_path / cls.__module__, sample["metadata"])
        errors.append(str(info.value))
    assert errors[0] == errors[1]


# ------------------------------------------------------------ the model


def _raw(out_dir, target):
    return {"train": {
        "output_dir": str(out_dir), "batch_size": BATCH, "cuda": False,
        "mixed_precision": False, "n_iters": 10, "n_iters_decay": 10, "seed": 3,
        "gan": {"_target_": target, "pool_size": 0,
                "generator": {"_target_": "ganslate.nn.generators.Resnet2D",
                              "n_residual_blocks": 1, "ngf": 8,
                              "in_out_channels": {"AB": [6, 1], "BA": [4, 3]}},
                "discriminator": {"_target_": "ganslate.nn.discriminators.PatchGAN2D",
                                  "n_layers": 1, "ndf": 8, "in_channels": {"B": 1, "A": 3}},
                "optimizer": {"lr_D": 0.0002, "lr_G": 0.0002, "lambda_AB": 10.0,
                              "lambda_BA": 10.0, "lambda_identity": 0,
                              "proportion_ssim": 0}},
        "metrics": {"discriminator_evolution": True}}}


def _batches(n, seed=7):
    rng = np.random.default_rng(seed)
    shape = (BATCH, *LOAD_WH[::-1])
    return [{"A": rng.uniform(-1, 1, (*shape, 6)).astype(np.float32),
             "B": rng.uniform(-1, 1, (*shape, 4)).astype(np.float32)} for _ in range(n)]


def _floats(d):
    return {k: float(v) for k, v in d.items()}


def _as_port(net, tree):
    return dict(load_flax_params(copy.deepcopy(net), tree).named_parameters())


@pytest.fixture(scope="module")
def lockstep(tmp_path_factory):
    from ganslate_tpu.configs.config import Config as JaxConfig
    from ganslate_tpu.configs.omega import Conf as JaxConf
    from ganslate_tpu.configs.utils import init_config as jax_init_config
    from ganslate_tpu.utils.builders import build_gan as jax_build_gan
    out = tmp_path_factory.mktemp("cleargrasp_lockstep")
    batches = _batches(3, seed=8)
    _jax_project()
    jax_model = jax_build_gan(jax_init_config(
        JaxConf.create(_raw(out, f"jax_cleargrasp_project.{MODULE}")), JaxConfig))
    jax_model.setup(example_batch=batches[0])
    init = jax.device_get(jax_model.state.params)

    target = f"ganslate_tpu_torch.projects.cleargrasp_depth_estimation.{MODULE}"
    model = build_gan(init_config(Conf.create(_raw(out, target)), Config))
    model.setup(batches[0])
    for name in NETWORKS:
        load_flax_params(model.networks[name], init[name])
    initial = {name: {k: p.detach().clone() for k, p in net.named_parameters()}
               for name, net in model.networks.items()}

    jax_logs, port_logs, jax_grads, port_grads = [], [], {}, None
    for i, batch in enumerate(batches):
        jax_model.set_input(batch)
        jax_model.optimize_parameters()
        jax_logs.append({**_floats(jax.device_get(jax_model.losses)),
                         **_floats(jax.device_get(jax_model.metrics))})
        model.set_input(batch)
        model.optimize_parameters()
        _, losses, _, metrics = model.get_loggable_data()
        port_logs.append({**_floats(losses), **_floats(metrics)})
        if i == 0:
            for group in ("G", "D"):
                mu = jax.device_get(jax_model.state.opt_state[group].inner_state[0].mu)
                jax_grads.update({name: jax.tree_util.tree_map(lambda m: 2 * np.asarray(m), t)
                                  for name, t in mu.items()})
            port_grads = {name: {k: None if p.grad is None else p.grad.clone()
                                 for k, p in net.named_parameters()}
                          for name, net in model.networks.items()}
    return dict(jax_model=jax_model, model=model, initial=initial, jax_logs=jax_logs,
                port_logs=port_logs, jax_grads=jax_grads, port_grads=port_grads,
                jax_params=jax.device_get(jax_model.state.params))


def test_losses_and_metrics_match_jax_each_step(lockstep):
    for step, (got, want) in enumerate(zip(lockstep["port_logs"], lockstep["jax_logs"])):
        assert sorted(got) == sorted(want) == sorted(LOSSES + METRICS)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                       atol=1e-6 if key in METRICS else 0,
                                       err_msg=f"step {step + 1}, {key}")


def test_gradients_after_step_1_match_jax(lockstep):
    model = lockstep["model"]
    inert = []
    for name in NETWORKS:
        want = _as_port(model.networks[name], lockstep["jax_grads"][name])
        for k, got in lockstep["port_grads"][name].items():
            w = want[k].detach()
            if got is None:         # an inert bias: no gradient, exactly zero in JAX
                assert k.endswith(".bias") and not w.any(), f"{name}.{k}"
                inert.append(name)
                continue
            rel = float((got - w).norm() / w.norm())
            assert rel <= 1e-4, f"{name}.{k}: relative L2 {rel:.2e}"
    # Each G: initial, down0, down1, res0 conv1 and conv2, up0, up1; each D:
    # the penultimate conv.
    assert {name: inert.count(name) for name in NETWORKS} == \
        {"G_AB": 7, "G_BA": 7, "D_B": 1, "D_A": 1}


def test_parameters_after_step_3_match_jax(lockstep):
    model = lockstep["model"]
    for name in NETWORKS:
        want = _as_port(model.networks[name], lockstep["jax_params"][name])
        for k, p in model.networks[name].named_parameters():
            torch.testing.assert_close(p.detach(), want[k].detach(), rtol=0, atol=1e-5,
                                       msg=f"{name}.{k}")
            if lockstep["port_grads"][name][k] is None:
                assert torch.equal(p.detach(), lockstep["initial"][name][k])


def test_visuals_have_zero_rgb_channels_and_pools_hold_geometry(lockstep):
    model = lockstep["model"]
    for key, channels in (("fake_B", 4), ("rec_B", 4), ("fake_A", 6), ("rec_A", 6)):
        v = model.visuals[key]
        assert v.shape == (BATCH, *LOAD_WH[::-1], channels)
        assert not v[..., :3].any() and v[..., 3:].any()
    assert model.pools["fake_B"].images.shape[1:] == (*LOAD_WH[::-1], 1)
    assert model.pools["fake_A"].images.shape[1:] == (*LOAD_WH[::-1], 3)
    assert model.networks["D_B"].stem.weight.shape[1] == 1
    assert model.networks["D_A"].stem.weight.shape[1] == 3


@pytest.mark.parametrize("direction, key, channels", [("AB", "A", 4), ("BA", "B", 6)])
def test_infer_matches_jax_infer(lockstep, direction, key, channels):
    """`infer` after 3 steps prepends 3 zero RGB channels to the
    generator's geometry (a depth map A->B, a normal map B->A), as JAX's
    `infer`."""
    x = _batches(1, seed=9)[0][key]
    want = np.asarray(lockstep["jax_model"].infer(jnp.asarray(x), direction=direction))
    got = lockstep["model"].infer(torch.from_numpy(x), direction=direction)
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (*x.shape[:-1], channels)
    assert not got[..., :3].any()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


# -------------------------------------------------------------- the YAMLs


def test_cleargrasp_yamls_load_without_jax():
    """The three ClearGrasp experiments load through the port's
    `init_config`; their datasets and the multimodal module resolve to the
    twin; nothing of JAX is imported."""
    code = (
        "import sys\n"
        "from ganslate_tpu_torch.configs.config import Config\n"
        "from ganslate_tpu_torch.configs.utils import init_config\n"
        "from ganslate_tpu_torch.utils.io import import_attr\n"
        f"for name in {YAMLS!r}:\n"
        "    conf = init_config(f'projects/cleargrasp_depth_estimation/experiments/"
        "{name}.yaml', Config)\n"
        "    for node in (conf.train.dataset, conf.val.dataset, conf.train.gan):\n"
        "        cls = import_attr(node._target_)\n"
        "        print(name, cls.__module__, cls.__name__,\n"
        "              sys.modules[cls.__module__].__file__)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'flax', 'ganslate_tpu'))\n"
        "print('bad', bad)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[-1] == "bad []"
    rows = [line.split() for line in lines[:-1]]
    assert len(rows) == 3 * len(YAMLS)
    for _, _, _, path in rows:
        assert Path(path).is_relative_to(REPO / "ganslate_tpu_torch")
    classes = {(name, cls) for name, _, cls, _ in rows}
    assert {("cyclegan_balanced", "CycleGANMultiModalV3"),
            ("pix2pix_new", "Pix2PixConditionalGAN"), ("cyclegan_naive", "CycleGAN")} <= classes
    assert {cls for _, module, cls, _ in rows if module.startswith("project.datasets")} == \
        {"ClearGraspTrainDataset", "ClearGraspValTestDataset"}


def _yaml_args(name, root, out):
    return [f"config={CLEARGRASP / 'experiments' / f'{name}.yaml'}", f"train.output_dir={out}",
            f"train.dataset.root={root / 'train'}", f"val.dataset.root={root / 'val'}",
            "train.cuda=false", "train.n_iters=1", "train.n_iters_decay=1",
            "train.logging.freq=1", "train.checkpointing.freq=2", "val.freq=4",
            "train.seed=3", "train.dataset.num_workers=2", "val.dataset.num_workers=2",
            f"train.dataset.load_size={LOAD_WH}".replace(" ", ""),
            f"val.dataset.load_size={LOAD_WH}".replace(" ", ""),
            "train.gan.discriminator.n_layers=1", "train.gan.discriminator.ndf=8"]


def test_balanced_cyclegan_trains_from_its_yaml(root, tmp_path, monkeypatch):
    """`cyclegan_balanced.yaml` through `init_engine("train")` on the image
    folders, small nets, bf16 as the YAML: 2 iterations and a checkpoint
    (validation is left out here: its `save` writes EXR, which this cv2
    cannot); then the Tester from the checkpoint, with the dataset's `save`
    replaced by a recorder in this test only."""
    monkeypatch.chdir(REPO)
    out = tmp_path / "out"
    args = _yaml_args("cyclegan_balanced", root, out) + [
        "train.gan.generator.n_residual_blocks=1", "train.gan.generator.ngf=8"]
    trainer = init_engine("train", args)
    assert type(trainer.model).__module__ == "project.modules.cyclegan_multimodal_v3"
    losses = {}
    log_iter = trainer.tracker.log_iter

    def record(learning_rates, step_losses, visuals, metrics):
        losses[trainer.iter_idx] = _floats(step_losses)
        return log_iter(learning_rates, step_losses, visuals, metrics)

    trainer.tracker.log_iter = record
    trainer.run()
    assert sorted(losses) == [1, 2]
    assert all(sorted(v) == sorted(LOSSES) and np.isfinite(list(v.values())).all()
               for v in losses.values())
    assert (out / "checkpoints" / "2.pth").is_file()
    assert "(Val at iter" not in (out / "train_log.txt").read_text()

    raw = trainer.conf.to_container(resolve=False)
    raw["test"] = {"dataset": raw["val"]["dataset"], "checkpointing": {"load_iter": 2}}
    path = tmp_path / "balanced.yaml"
    path.write_text(yaml.safe_dump({k: v for k, v in raw.items() if k != "mode"}))
    tester = init_engine("test", [f"config={path}"])
    saved = []
    dataset = tester.data_loaders[None].dataset
    dataset.save = lambda tensor, save_dir, metadata: saved.append((tensor, metadata))
    tester.run()
    assert [m["sample_id"] for _, m in saved] == ["000000003", "000000004"]
    for tensor, _ in saved:
        assert tensor.shape == (*LOAD_WH[::-1], 4) and not tensor[..., :3].any()
    rows = (out / "test" / "metrics.csv").read_text().splitlines()
    assert len(rows) == 3


def test_pix2pix_new_trains_from_its_yaml(root, tmp_path, monkeypatch):
    """`pix2pix_new.yaml` (Unet2D, 7 levels; the conditional PatchGAN2D on 7
    channels): 2 iterations and a checkpoint, small nets at (128, 128)."""
    monkeypatch.chdir(REPO)
    out = tmp_path / "out"
    args = [a for a in _yaml_args("pix2pix_new", root, out) if "load_size" not in a] + [
        "train.dataset.load_size=[128,128]", "val.dataset.load_size=[128,128]",
        "train.gan.generator.ngf=4"]
    trainer = init_engine("train", args)
    assert trainer.model.networks["D"].stem.weight.shape[1] == 7
    trainer.run()
    assert (out / "checkpoints" / "2.pth").is_file()
    log = (out / "train_log.txt").read_text()
    assert "pix2pix:" in log and "nan" not in log.lower()
