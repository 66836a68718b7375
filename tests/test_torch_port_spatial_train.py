"""Spatially sharded training of the port (`train.spatial_mesh`) on the CPU,
under one torchrun launch of 4 gloo ranks (data 2 x spatial 2): one
CycleGAN step against the JAX package's step, and the Trainer: the BRaTS
`cyclegan.yaml` (3D) on NIfTI scans, and a 2D CycleGAN on PNG folders with
a checkpoint written once by rank 0 and resumed (the BRaTS dataset draws
domain B's scan from Python's `random`, as the JAX package's does, so a
resumed BRaTS run draws other scans).

The ranks are `tests/torch_distributed_child.py` under `python -m
torch.distributed.run --standalone --nproc_per_node 4`; they import the
port only. The JAX step runs here, on the CPU mesh of `tests/conftest.py`,
while they run. The CycleGAN is the JAX package's spatial test's
(`utils/testing.py:make_cyclegan_conf`: 2D, 32x32, 1 channel, 1 residual
block, ngf 8, ndf 8, 1 D layer, no pool, fp32, batch 2, so one sample a
data rank, each spatial rank a 16-row slab of it; the CycleGAN's default
SSIM share of the cycle loss, 0.84, takes its halo of 10 rows), from the
JAX initial weights (`utils/flax_weights.load_flax_params`).

Tolerances:
- the losses against the JAX step: rtol 2e-4, atol 1e-5 (the JAX spatial
  test's bounds);
- every parameter after the step against JAX's: max abs 1e-5, the bound
  of the one-process lockstep (`test_torch_port_train_step.py`);
- the 2D Trainer resumed from its checkpoint of iteration 1: iteration 2's
  losses and the last checkpoint's tensors bit for bit."""

import copy
import fcntl
import os
import pickle

import numpy as np
import pytest

import jax
import torch

from ganslate_tpu_torch.utils import medio
from ganslate_tpu_torch.utils.flax_weights import load_flax_params

from tests import torch_distributed_child as child

SIZE, GLOBAL = 32, 2
CONF = dict(batch_size=GLOBAL, channels=1, n_residual_blocks=1, ngf=8, ndf=8, n_layers_D=1,
            pool_size=0, mixed_precision=False, seed=3, cuda=False)
NETWORKS = ("G_AB", "G_BA", "D_B", "D_A")
BRATS = child.REPO / "projects" / "brats_mri_sequence_translation"
SCAN = (4, 20, 24, 24)


def cyclegan_batch():
    rng = np.random.default_rng(0)
    return {k: rng.uniform(-1, 1, (GLOBAL, SIZE, SIZE, 1)).astype(np.float32)
            for k in ("A", "B")}


def _jax_cyclegan_reference(out_dir):
    from ganslate_tpu.utils.builders import build_gan as jax_build_gan
    from ganslate_tpu.utils.testing import make_cyclegan_conf as jax_conf
    conf = jax_conf(str(out_dir), batch_size=GLOBAL, image_size=SIZE, channels=1,
                    n_residual_blocks=1, ngf=8, ndf=8, n_layers_D=1, pool_size=0,
                    mixed_precision=False, seed=3)
    model = jax_build_gan(conf)
    batch = cyclegan_batch()
    model.setup(example_batch=batch)
    init = jax.device_get(model.state.params)
    model.set_input(batch)
    model.optimize_parameters(sync=True)
    return {"init": init,
            "losses": {k: float(v) for k, v in jax.device_get(model.losses).items()},
            "params": jax.device_get(model.state.params)}


def jax_cyclegan_reference(tmp_path_factory):
    """The JAX CycleGAN's initial parameters and, after one step on
    `cyclegan_batch()`, its losses and parameters. Its setup compiles some
    36 programs, so a test run builds it once: under xdist the first worker
    to ask builds it and the others read it from the run's shared temporary
    directory."""
    run_id = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if run_id is None:
        return _jax_cyclegan_reference(tmp_path_factory.mktemp("jax_cyclegan"))
    shared = tmp_path_factory.getbasetemp().parent
    path = shared / f"jax_cyclegan_{run_id}.pkl"
    with open(shared / f"jax_cyclegan_{run_id}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            ref = _jax_cyclegan_reference(shared / f"jax_cyclegan_{run_id}")
            partial = path.with_suffix(".partial")
            partial.write_bytes(pickle.dumps(ref))
            partial.replace(path)
    return pickle.loads(path.read_bytes())


def _port_states(params):
    """The JAX tree of each network as the port's state dict."""
    from ganslate_tpu_torch.utils.builders import build_gan
    from ganslate_tpu_torch.utils.testing import make_cyclegan_conf
    conf = make_cyclegan_conf("unused", **CONF)
    model = build_gan(conf)
    model.init_networks()
    return {name: load_flax_params(model.networks[name], params[name]).state_dict()
            for name in NETWORKS}


def _scan(seed):
    rng = np.random.default_rng(seed)
    grid = np.ogrid[tuple(slice(0, d) for d in SCAN[1:])]
    head = sum(((g - d / 2) / (0.45 * d)) ** 2 for g, d in zip(grid, SCAN[1:])) <= 1
    return (np.maximum(rng.normal(300, 100, SCAN), 0) * head).astype(np.float32)


def _brats_root(root):
    for split, seeds in (("train", (0, 1, 2)), ("val", (3,))):
        for seed in seeds:
            medio.write(medio.MedicalImage(_scan(seed)), root / split / f"BRATS_{seed:03d}.nii.gz")
    return root


def _png_root(root):
    from PIL import Image
    rng = np.random.default_rng(42)
    for domain in ("A", "B"):
        (root / domain).mkdir(parents=True)
        for i in range(4):
            Image.fromarray(rng.integers(0, 256, (36, 36, 3), dtype=np.uint8)).save(
                root / domain / f"{domain.lower()}{i}.png")
    return root


def _png_args(out_dir, config):
    """A tiny 2D CycleGAN on PNG folders (random crops and flips from the
    sampler's stream), global batch 2, 2 iterations, a checkpoint at each,
    `train.spatial_mesh=2`."""
    return [f"config={config}", f"train.output_dir={out_dir}", "train.spatial_mesh=2"]


def _png_config(path, data_root):
    import yaml
    raw = {"train": {
        "output_dir": "unset", "batch_size": 2, "cuda": False, "mixed_precision": False,
        "n_iters": 1, "n_iters_decay": 1, "seed": 5, "logging": {"freq": 1},
        "checkpointing": {"freq": 1},
        "dataset": {"_target_": "ganslate.data.UnpairedImageDataset", "root": str(data_root),
                    "num_workers": 1, "image_channels": 3,
                    "preprocess": ["resize", "random_crop", "random_flip"],
                    "load_size": [36, 36], "final_size": [SIZE, SIZE]},
        "gan": {"_target_": "ganslate.nn.gans.unpaired.CycleGAN", "pool_size": 2,
                "generator": {"_target_": "ganslate.nn.generators.Resnet2D",
                              "n_residual_blocks": 1, "ngf": 4,
                              "in_out_channels": {"AB": [3, 3]}},
                "discriminator": {"_target_": "ganslate.nn.discriminators.PatchGAN2D",
                                  "ndf": 4, "n_layers": 1, "in_channels": {"B": 3}}}}}
    path.write_text(yaml.safe_dump(raw))
    return path


def _trainer_args(out_dir, data_root):
    """`cyclegan.yaml` with small nets at a global batch of 2 (one sample a
    data rank), 2 iterations, a checkpoint at each, `train.spatial_mesh=2`."""
    return [f"config={BRATS / 'experiments' / 'cyclegan.yaml'}",
            f"train.output_dir={out_dir}", f"train.dataset.root={data_root / 'train'}",
            f"val.dataset.root={data_root / 'val'}", "train.cuda=false",
            "train.mixed_precision=false", "train.batch_size=2", "train.n_iters=1",
            "train.n_iters_decay=1", "train.logging.freq=1", "train.checkpointing.freq=1",
            "val.freq=100", "train.seed=3", "train.dataset.num_workers=1",
            "train.dataset.patch_size=[16,16,16]", "train.gan.generator.first_layer_channels=4",
            "train.gan.generator.down_blocks=[1,1]", "train.gan.generator.up_blocks=[1,1]",
            "train.gan.discriminator.n_layers=1", "train.gan.discriminator.ndf=4",
            "train.gan.pool_size=2", "train.spatial_mesh=2"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("spatial_train")
    batch = cyclegan_batch()
    ref = jax_cyclegan_reference(tmp_path_factory)
    data_root = _brats_root(out / "brats")
    job = {"checks": ["spatial_cyclegan", "spatial_trainer"], "threads": 1,
           "spatial_cyclegan": {"conf": CONF, "spatial_mesh": 2, "batch": batch,
                                "state": _port_states(ref["init"])},
           "spatial_trainer": {
               "brats": _trainer_args(out / "brats_run", data_root),
               "resumable": _png_args(out / "trainer", _png_config(
                   out / "png.yaml", _png_root(out / "png")))}}
    ranks = child.Ranks(job, out / "ranks", world=4, timeout=240, torchrun=True)
    return {"ranks": ranks.results(), "jax": ref, "out": out}


def test_cyclegan_step_on_data_2_by_spatial_2_matches_jax(run):
    ranks = [r["spatial_cyclegan"] for r in run["ranks"]]
    assert [r["ranks"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    check_step(ranks, run["jax"])


def check_step(ranks, want):
    """Each rank's step against the JAX step `want` (losses, parameters)."""
    assert all(r["sharded"] for r in ranks)
    # Only the discriminators' stride-1 tails gather: D_B and D_A in the G
    # step, and each once more in the D step (real and fake as one forward).
    assert all(r["counts"]["gather"] == 4 for r in ranks)
    for r in ranks:
        assert r["losses"].keys() == want["losses"].keys()
        for k, v in want["losses"].items():
            np.testing.assert_allclose(r["losses"][k], v, rtol=2e-4, atol=1e-5, err_msg=k)
    from ganslate_tpu_torch.utils.builders import build_gan
    from ganslate_tpu_torch.utils.testing import make_cyclegan_conf
    model = build_gan(make_cyclegan_conf("unused", **CONF))
    model.init_networks()
    for name in NETWORKS:
        expected = dict(load_flax_params(copy.deepcopy(model.networks[name]),
                                         want["params"][name]).named_parameters())
        for k, p in expected.items():
            for r in ranks:
                np.testing.assert_allclose(r["params"][f"{name}.{k}"].numpy(),
                                           p.detach().numpy(), rtol=0, atol=1e-5,
                                           err_msg=f"{name}.{k}")


def test_brats_yaml_trains_spatially_sharded(run):
    """`cyclegan.yaml` (Vnet3D, PatchGAN3D, pool 2) for 2 iterations: finite
    losses, the same on the two ranks of a spatial group, whole patches in
    the checkpointed pools."""
    ranks = [r["spatial_trainer"] for r in run["ranks"]]
    assert [r["ranks"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks:
        assert sorted(r["brats"]["losses"]) == [1, 2]
        assert all(np.isfinite(v) for losses in r["brats"]["losses"].values()
                   for v in losses.values())
    assert ranks[0]["brats"]["losses"] == ranks[1]["brats"]["losses"]
    ckpt = torch.load(run["out"] / "brats_run" / "checkpoints" / "2.pth", weights_only=True)
    assert tuple(ckpt["pool_fake_B"]["images"].shape) == (2, 16, 16, 16, 1)


def test_trainer_resumes_bit_for_bit(run):
    ranks = [r["spatial_trainer"]["resumable"] for r in run["ranks"]]
    for r in ranks:
        assert sorted(r["losses"]) == [1, 2] and sorted(r["resumed_losses"]) == [2]
        assert r["resumed_losses"][2] == r["losses"][2]
        assert all(np.isfinite(v) for v in r["losses"][2].values())
    # The ranks of a spatial group log the same (whole-sample) losses.
    assert ranks[0]["losses"] == ranks[1]["losses"]
    whole = run["out"] / "trainer" / "checkpoints"
    resumed = run["out"] / "trainer_resumed" / "checkpoints"
    assert sorted(p.name for p in whole.iterdir()) == [
        "1.pth", "2.pth", "data_state_1.json", "data_state_2.json"]
    a = torch.load(whole / "2.pth", weights_only=True)
    b = torch.load(resumed / "2.pth", weights_only=True)
    assert a.keys() == b.keys()
    for name in ("G_AB", "G_BA", "D_B", "D_A", "pool_fake_B", "pool_fake_A"):
        for k, v in a[name].items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(b[name][k])), f"{name}.{k}"
    # The pools' checkpointed images are whole images, not slabs.
    assert tuple(a["pool_fake_B"]["images"].shape) == (2, SIZE, SIZE, 3)
