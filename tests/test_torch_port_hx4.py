"""The HX4 PET project twin (`ganslate_tpu_torch/projects/
maastro_hx4_pet_translation/`) against the JAX package's project: its
datasets, the shared body mask, the balanced CycleGAN in lockstep, and the
project's YAMLs loaded and trained through the port's engines.

Synthetic patients of (12, 40, 40) voxels (`utils/synthetic_data.
write_hx4_root`: 3 for training, 2 for validation, the second without a
body mask) are written once as NRRD files; both packages' datasets read
them. Before each call both sides are seeded alike (Python's `random` for
domain B's patient, the global `np.random` for the patches), and the
samples must be equal bit for bit: the same reads, draws and float32
arithmetic. That holds for the padded (64, 512, 512) validation volumes
too, past the 2^20 voxels from which both packages' `clip_and_min_max_
normalize` run their host data ops (`native/`, which computes
`(v - lo) * (2 / (hi - lo)) - 1` and not numpy's `2 * ((v - lo) / (hi -
lo)) - 1`), and for every body mask, which both apply with the native
masked fill.

The balanced CycleGAN: Unet3D with 3 levels and ngf 8 (2 -> 1 channels,
both directions) and PatchGAN3D with 1 layer and ndf 8 (1 channel), at
(8, 16, 16), batch 2, fp32, pool 0, dropout off; the JAX model starts from
the port's seeded parameters (`tests/torch_port_support.py:
jax_params_from`), loaded back into the port
(`utils/flax_weights.load_flax_params`).
Tolerances as the Pix2Pix and CycleGAN lockstep tests: losses and metrics
per step rtol 1e-4 (the D metrics also atol 1e-6); every gradient after
step 1 within 1e-4 relative L2 (JAX's read from Adam's first moment); every
parameter after step 3 within 1e-5. The U-Net's convs before a norm keep
a bias whose gradient is zero in exact arithmetic: inert in the port,
rounding noise in JAX (below 1e-5 of the network's largest gradient),
which Adam moves; they are held to their initial values in the port, and
the trained generators' outputs against JAX's show that they cancel. One
step with dropout (6 levels at (64, 64, 64), the least extent that 6
levels take: dropout at level 4; ngf and ndf 2, since XLA's 3D convs on
the CPU take seconds at that extent) draws
both sides' masks from one numpy stream in call order
(`flax.linen.Dropout.__call__` and the port's `layers.dropout_mask`
monkeypatched in this test only)."""

import copy
import importlib.util
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

import jax
import jax.numpy as jnp
import torch

from ganslate_tpu_torch.configs.config import Config
from ganslate_tpu_torch.configs.omega import Conf
from ganslate_tpu_torch.configs.utils import init_config
from ganslate_tpu_torch.data.utils import body_mask
from ganslate_tpu_torch.engines.utils import init_engine
from ganslate_tpu_torch.nn import layers
from ganslate_tpu_torch.projects.maastro_hx4_pet_translation import datasets
from ganslate_tpu_torch.utils import medio
from ganslate_tpu_torch.utils.builders import build_gan
from ganslate_tpu_torch.utils.flax_weights import load_flax_params
from ganslate_tpu_torch.utils.synthetic_data import HX4_FILES, hx4_patient, write_hx4_root
from tests.torch_port_support import (jax_native, jax_params_from,  # noqa: F401
                                      one_torch_thread, seeded_states)

REPO = Path(__file__).resolve().parents[1]
HX4 = REPO / "projects" / "maastro_hx4_pet_translation"
YAMLS = ("pix2pix", "cyclegan_balanced", "cyclegan_naive")
SHAPE = (12, 40, 40)
PATCH = [8, 16, 16]
MODULE = "modules.HX4CycleGANBalanced"
NETWORKS = ("G_AB", "G_BA", "D_B", "D_A")
SMALL = dict(num_downs=3, ngf=8, use_dropout=False)
DROPOUT = dict(num_downs=6, ngf=2, use_dropout=True)
BATCH = 2
LOSSES = ["G_AB", "G_BA", "cycle_A", "cycle_B", "D_B", "D_A"]
METRICS = ["D_B_real", "D_B_fake", "D_A_real", "D_A_fake"]


def _jax_project():
    """The JAX package's HX4 project, imported under a name of its own (the
    name `project` is the port's in this process)."""
    name = "jax_hx4_project"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, HX4 / "__init__.py", submodule_search_locations=[str(HX4)])
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
        for sub in ("datasets", "modules"):
            importlib.import_module(f"{name}.{sub}")
    return sys.modules[name]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("hx4")
    write_hx4_root(root, SHAPE, 3, 2, seed=5)
    (root / "val" / "HX4-004" / "pct_body.nrrd").unlink()
    return root


def _train_conf(root, paired, ldct, sampling):
    dataset = {"root": str(root / "train"), "paired": paired,
               "require_ldct_for_training": ldct, "hu_range": [-1000, 2000],
               "fdg_suv_range": [0.0, 15.0], "hx4_tbr_range": [0.0, 3.0],
               "patch_size": PATCH, "patch_sampling": sampling,
               "focal_region_proportion": [0.6, 0.35, 0.35]}
    return Conf.create({"mode": "train", "train": {"dataset": dataset}})


def _val_conf(root, patch_based, masks, balanced):
    dataset = {"root": str(root / "val"), "hu_range": [-1000, 2000],
               "fdg_suv_range": [0.0, 15.0], "hx4_tbr_range": [0.0, 3.0],
               "use_patch_based_inference": patch_based, "supply_masks": masks,
               "model_is_hx4_cyclegan_balanced": balanced}
    return Conf.create({"mode": "val", "val": {"dataset": dataset}})


def _seeded(dataset, index, seed):
    random.seed(seed)
    np.random.seed(seed)
    return dataset[index]


# ------------------------------------------------------------- datasets


@pytest.mark.parametrize("paired, ldct, sampling", [
    (True, False, "uniform-random-within-body"), (True, False, "fdg-pet-weighted"),
    (False, True, "uniform-random-within-body-sf"), (False, False, "fdg-pet-weighted-sf")])
def test_train_dataset_matches_jax_bit_for_bit(root, paired, ldct, sampling):
    conf = _train_conf(root, paired, ldct, sampling)
    port = datasets.HX4PETTranslationTrainDataset(conf)
    jax_ds = _jax_project().datasets.HX4PETTranslationTrainDataset(conf)
    assert len(port) == len(jax_ds) == 3
    for index, seed in [(0, 11), (1, 12), (2, 13), (4, 14)]:
        got, want = _seeded(port, index, seed), _seeded(jax_ds, index, seed)
        assert sorted(got) == sorted(want) == ["A", "B"]
        assert got["A"].shape == (*PATCH, 2) and got["B"].shape == (*PATCH, 2 if ldct else 1)
        for key in ("A", "B"):
            assert got[key].dtype == want[key].dtype == np.float32
            np.testing.assert_array_equal(got[key], want[key])
            assert got[key].min() >= -1 and got[key].max() <= 1


def test_domain_b_patient_is_drawn_with_python_random(root):
    port = datasets.HX4PETTranslationTrainDataset(
        _train_conf(root, False, True, "uniform-random-within-body-sf"))
    loaded = []
    module = datasets.train_dataset.sitk_utils
    load = module.load
    module.load = lambda path: loaded.append(path) or load(path)
    try:
        _seeded(port, 0, 5)
    finally:
        module.load = load
    random.seed(5)
    b = random.randint(0, 2)
    assert loaded[3:] == [port.image_paths[k][b] for k in ("HX4-PET", "body-mask-B", "ldCT")]
    assert loaded[3].endswith(f"{port.patient_ids[b]}/hx4_pet.nrrd")


def test_patches_are_drawn_from_global_numpy_random(root):
    port = datasets.HX4PETTranslationTrainDataset(
        _train_conf(root, True, False, "uniform-random-within-body"))
    a, b, c = _seeded(port, 0, 21), _seeded(port, 0, 21), _seeded(port, 0, 22)
    np.testing.assert_array_equal(a["A"], b["A"])
    assert not np.array_equal(a["A"], c["A"])


def test_unknown_sampling_raises_as_jax(root):
    errors = []
    for cls in (datasets.HX4PETTranslationTrainDataset,
                _jax_project().datasets.HX4PETTranslationTrainDataset):
        with pytest.raises(ValueError, match="not a valid") as info:
            cls(_train_conf(root, True, False, "uniform-random-within-body-sf"))
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def _assert_same_sample(got, want):
    assert sorted(got) == sorted(want)
    for key in ("A", "B"):
        assert got[key].dtype == want[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], want[key])
    if "masks" in want:
        for label in ("BODY", "GTV"):
            np.testing.assert_array_equal(got["masks"][label], want["masks"][label])
    assert got["metadata"] == want["metadata"]


@pytest.mark.parametrize("balanced", (True, False))
def test_val_dataset_matches_jax_bit_for_bit(root, balanced):
    """Patch-based inference (whole volumes) with masks; the second patient's
    body mask is made from its CT (`get_body_mask`)."""
    conf = _val_conf(root, patch_based=True, masks=True, balanced=balanced)
    port = datasets.HX4PETTranslationValTestDataset(conf)
    jax_ds = _jax_project().datasets.HX4PETTranslationValTestDataset(conf)
    assert len(port) == len(jax_ds) == 2
    for index in (0, 1):
        got, want = port[index], jax_ds[index]
        _assert_same_sample(got, want)
        assert got["A"].shape == (*SHAPE, 2) and got["B"].shape == (*SHAPE, 2 if balanced else 1)
        assert got["masks"]["BODY"].shape == (*SHAPE, 1)
        if balanced:
            assert not got["B"][..., 1].any()
        assert got["metadata"]["patient_id"] == f"HX4-00{3 + index}"
        assert got["metadata"]["size"] == SHAPE[::-1]
    np.testing.assert_array_equal(port.denormalize(got["B"]), jax_ds.denormalize(want["B"]))


def test_padded_val_volume_matches_jax_bit_for_bit(root):
    """Without patch-based inference the volume is padded to (64, 512, 512),
    past the size at which both packages normalise natively."""
    jax_native()
    conf = _val_conf(root, patch_based=False, masks=True, balanced=False)
    got = datasets.HX4PETTranslationValTestDataset(conf)[0]
    want = _jax_project().datasets.HX4PETTranslationValTestDataset(conf)[0]
    assert got["A"].shape == (64, 512, 512, 2) and got["A"].size >= 2 ** 20
    _assert_same_sample(got, want)


@pytest.mark.parametrize("balanced", (True, False))
def test_save_writes_what_jax_writes(root, tmp_path, balanced):
    """`save` of a prediction: TBR -> SUV in the first channel (balanced) or
    the one channel, as NRRD with the patient's geometry."""
    conf = _val_conf(root, patch_based=True, masks=False, balanced=balanced)
    port = datasets.HX4PETTranslationValTestDataset(conf)
    jax_ds = _jax_project().datasets.HX4PETTranslationValTestDataset(conf)
    sample = port[0]
    pred = np.random.default_rng(3).uniform(-1, 1, sample["B"].shape).astype(np.float32)
    port.save(pred, tmp_path / "port", sample["metadata"])
    jax_ds.save(pred, tmp_path / "jax", sample["metadata"])
    got, want = (medio.load(tmp_path / side / "HX4-003.nrrd") for side in ("port", "jax"))
    np.testing.assert_array_equal(got.array, want.array)
    assert (got.origin, got.spacing, got.direction) == (want.origin, want.spacing,
                                                        want.direction)
    assert got.array.shape == SHAPE and got.array.dtype == np.float32
    tbr = (pred[..., 0] + 1) / 2 * 3
    np.testing.assert_allclose(got.array, tbr * 1.15, rtol=1e-6)


def test_body_mask_matches_jax_bit_for_bit():
    """`get_body_mask` and `apply_body_mask` on a synthetic CT (air, soft
    tissue and lungs) and on a CT of air only. (Under cv2 5, whose
    `GaussianBlur` returns a 1-D input as one row, both packages'
    contour smoothing yields one point pair and the filled mask is far
    smaller than the body: the same bits in both.)"""
    from ganslate_tpu.data.utils import body_mask as jax_body_mask
    ct = hx4_patient((6, 64, 64), seed=9)["pct"]
    for image in (ct, np.full((2, 16, 16), -1000, np.float32)):
        got = body_mask.get_body_mask(image, -300)
        np.testing.assert_array_equal(got, jax_body_mask.get_body_mask(image, -300))
        np.testing.assert_array_equal(body_mask.apply_body_mask(image),
                                      jax_body_mask.apply_body_mask(image))
    mask = body_mask.get_body_mask(ct, -300)
    assert mask.dtype == np.float64 and set(np.unique(mask)) <= {0.0, 1.0} and mask.any()


def test_synthetic_patients_have_every_file(root):
    patients = sorted(p.name for p in (root / "train").iterdir())
    assert patients == ["HX4-000", "HX4-001", "HX4-002"]
    for name in HX4_FILES:
        image = medio.load(root / "train" / "HX4-000" / f"{name}.nrrd")
        assert image.array.shape == SHAPE
        assert image.array.dtype == (np.uint8 if name.endswith(("body", "gtv")) else np.float32)
    assert (root / "SUVmean_aorta_HX4.csv").read_text().splitlines()[1] == "HX4-000,1.0"


def test_decollate_gives_each_sample_its_geometry():
    """The loader keeps a volume's size, origin, spacing and direction as a
    list of per-sample tuples; the port's `decollate` gives each sample its
    own (the JAX package's raises, so its HX4 validation cannot reach
    `save`)."""
    from ganslate_tpu.utils.io import decollate as jax_decollate
    from ganslate_tpu_torch.data.loaders import collate
    from ganslate_tpu_torch.utils.io import decollate
    samples = [{"A": np.zeros((2, 2)), "metadata": {"patient_id": p, "size": (i, 2, 3),
                                                    "dtype": "float32"}}
               for i, p in enumerate(("a", "b"))]
    metadata = collate(samples)["metadata"]
    assert decollate(metadata, batch_size=2) == [s["metadata"] for s in samples]
    with pytest.raises(TypeError, match="tuple"):
        jax_decollate(metadata, batch_size=2)


def test_masked_metrics_of_the_balanced_layout_fail_in_both():
    """`supply_masks` with `model_is_hx4_cyclegan_balanced`: the 1-channel
    masks do not cover the 2-channel B, in either package (the balanced
    YAML leaves `supply_masks` off)."""
    from ganslate_tpu.utils.metrics.val_test_metrics import create_masked_array as jax_masked
    from ganslate_tpu_torch.utils.metrics.val_test_metrics import create_masked_array
    x, mask = np.zeros((4, 4, 4, 2), np.float32), np.ones((4, 4, 4, 1), np.float32)
    for fn in (create_masked_array, jax_masked):
        with pytest.raises(np.ma.MaskError):
            fn(x, mask)


# ------------------------------------------------------------ the model


def _raw(out_dir, target, nets, batch_size=BATCH, ndf=8):
    return {"train": {
        "output_dir": str(out_dir), "batch_size": batch_size, "cuda": False,
        "mixed_precision": False, "n_iters": 10, "n_iters_decay": 10, "seed": 3,
        "gan": {"_target_": target, "pool_size": 0,
                "generator": {"_target_": "ganslate.nn.generators.Unet3D",
                              "in_out_channels": {"AB": [2, 1], "BA": [2, 1]}, **nets},
                "discriminator": {"_target_": "ganslate.nn.discriminators.PatchGAN3D",
                                  "in_channels": {"B": 1, "A": 1}, "n_layers": 1,
                                  "kernel_size": [4, 4, 4], "ndf": ndf},
                "optimizer": {"lr_D": 0.0001, "lr_G": 0.0002, "lambda_AB": 10.0,
                              "lambda_BA": 10.0, "lambda_identity": 0,
                              "proportion_ssim": 0}},
        "metrics": {"discriminator_evolution": True, "ssim": False}}}


def _jax_model(out_dir, batch, nets=SMALL, ndf=8):
    from ganslate_tpu.configs.config import Config as JaxConfig
    from ganslate_tpu.configs.omega import Conf as JaxConf
    from ganslate_tpu.configs.utils import init_config as jax_init_config
    from ganslate_tpu.utils.builders import build_gan as jax_build_gan
    _jax_project()
    raw = _raw(out_dir, f"jax_hx4_project.{MODULE}", nets, len(batch["A"]), ndf)
    model = jax_build_gan(jax_init_config(JaxConf.create(raw), JaxConfig))
    port_raw = _raw(out_dir, f"ganslate_tpu_torch.projects.maastro_hx4_pet_translation.{MODULE}",
                    nets, len(batch["A"]), ndf)
    with jax_params_from(seeded_states(port_raw)):
        model.setup(example_batch=batch)
    return model


def _port_model(out_dir, batch, init=None, nets=SMALL, ndf=8):
    target = f"ganslate_tpu_torch.projects.maastro_hx4_pet_translation.{MODULE}"
    conf = init_config(Conf.create(_raw(out_dir, target, nets, len(batch["A"]), ndf)), Config)
    model = build_gan(conf)
    model.setup(batch)
    for name in NETWORKS if init is not None else ():
        load_flax_params(model.networks[name], init[name])
    return model


def _batches(n, spatial=tuple(PATCH), batch=BATCH, seed=7):
    rng = np.random.default_rng(seed)
    return [{k: rng.uniform(-1, 1, (batch, *spatial, 2)).astype(np.float32)
             for k in ("A", "B")} for _ in range(n)]


def _floats(d):
    return {k: float(v) for k, v in d.items()}


def _as_port(net, tree):
    return dict(load_flax_params(copy.deepcopy(net), tree).named_parameters())


def _jax_grads(jax_model):
    """Step 1's gradients: 2 x Adam's first moment after one update."""
    grads = {}
    for group in ("G", "D"):
        mu = jax.device_get(jax_model.state.opt_state[group].inner_state[0].mu)
        grads.update({name: jax.tree_util.tree_map(lambda m: 2 * np.asarray(m), t)
                      for name, t in mu.items()})
    return grads


def _port_grads(model):
    return {name: {k: None if p.grad is None else p.grad.clone()
                   for k, p in net.named_parameters()} for name, net in model.networks.items()}


def _jax_step(model, batch):
    model.set_input(batch)
    model.optimize_parameters()
    return {**_floats(jax.device_get(model.losses)), **_floats(jax.device_get(model.metrics))}


def _port_step(model, batch):
    model.set_input(batch)
    model.optimize_parameters()
    _, losses, _, metrics = model.get_loggable_data()
    return {**_floats(losses), **_floats(metrics)}


def _check_logs(got, want):
    assert sorted(got) == sorted(want) == sorted(LOSSES + METRICS)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   atol=1e-6 if key in METRICS else 0, err_msg=key)


def _check_grads(model, jax_grads, port_grads):
    """Every gradient within 1e-4 relative L2 of JAX's; an inert bias has
    none in the port and rounding noise in JAX. Returns the inert biases."""
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


@pytest.fixture(scope="module")
def lockstep(tmp_path_factory):
    out = tmp_path_factory.mktemp("hx4_lockstep")
    batches = _batches(3)
    jax_model = _jax_model(out, batches[0])
    init = jax.device_get(jax_model.state.params)
    jax_logs, jax_grads = [], None
    for i, batch in enumerate(batches):
        jax_logs.append(_jax_step(jax_model, batch))
        if i == 0:
            jax_grads = _jax_grads(jax_model)
    model = _port_model(out, batches[0], init)
    initial = {name: {k: p.detach().clone() for k, p in net.named_parameters()}
               for name, net in model.networks.items()}
    port_logs, port_grads = [], None
    for i, batch in enumerate(batches):
        port_logs.append(_port_step(model, batch))
        if i == 0:
            port_grads = _port_grads(model)
    return dict(jax_model=jax_model, model=model, initial=initial, jax_logs=jax_logs,
                port_logs=port_logs, jax_grads=jax_grads, port_grads=port_grads,
                jax_params=jax.device_get(jax_model.state.params))


def test_losses_and_metrics_match_jax_each_step(lockstep):
    for got, want in zip(lockstep["port_logs"], lockstep["jax_logs"]):
        _check_logs(got, want)


def test_gradients_after_step_1_match_jax(lockstep):
    inert = _check_grads(lockstep["model"], lockstep["jax_grads"], lockstep["port_grads"])
    # Each G: the level-1 down conv and the level-1 and -2 up convs; each D:
    # the penultimate conv.
    assert sorted(inert) == sorted([f"{g}.{c}.bias" for g in ("G_AB", "G_BA")
                                    for c in ("down1", "up1", "up2")]
                                   + ["D_A.penultimate.bias", "D_B.penultimate.bias"])


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


def test_visuals_are_padded_with_a_zero_ct_channel(lockstep):
    visuals = lockstep["model"].visuals
    for key in ("fake_B", "rec_A", "fake_A", "rec_B"):
        assert visuals[key].shape == (BATCH, *PATCH, 2)
        assert not visuals[key][..., 1].any() and visuals[key][..., 0].any()
    pools = lockstep["model"].pools
    assert pools["fake_B"].images.shape[1:] == pools["fake_A"].images.shape[1:] == (*PATCH, 1)


@pytest.mark.parametrize("direction", ("AB", "BA"))
def test_infer_matches_jax_infer(lockstep, direction):
    """`infer` after 3 steps: the generator's PET and a zero CT channel, as
    JAX's `infer` (whose inert biases moved on noise, and cancel)."""
    x = _batches(1, seed=9)[0]["A"]
    want = np.asarray(lockstep["jax_model"].infer(jnp.asarray(x), direction=direction))
    got = lockstep["model"].infer(torch.from_numpy(x), direction=direction)
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert not got[..., 1].any()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_stock_cyclegan_pools_keep_the_batch_shape(tmp_path):
    """The naive YAML's stock CycleGAN keeps pools shaped like the batch;
    the balanced module's hold 1 channel."""
    from ganslate_tpu_torch.nn.gans.unpaired import CycleGAN
    batch = _batches(1, batch=1)[0]
    raw = _raw(tmp_path, "ganslate.nn.gans.unpaired.CycleGAN", SMALL, 1)
    raw["train"]["gan"]["generator"]["in_out_channels"] = {"AB": [2, 2], "BA": [2, 2]}
    raw["train"]["gan"]["discriminator"]["in_channels"] = {"B": 2, "A": 2}
    model = build_gan(init_config(Conf.create(raw), Config))
    assert type(model) is CycleGAN
    model.setup(batch)
    assert model.pools["fake_B"].images.shape[1:] == (*PATCH, 2)


@pytest.fixture
def shared_masks(monkeypatch):
    """Both packages' dropout masks from one numpy stream each, of one seed,
    in call order."""
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
    """The four generator passes each draw one mask at level 4, in the JAX
    graph's order: G_AB(A), G_BA([fake_B, pCT]), G_BA(B), G_AB([fake_A,
    ldCT])."""
    batch = _batches(1, spatial=(64, 64, 64), batch=1, seed=15)[0]
    jax_model = _jax_model(tmp_path, batch, DROPOUT, ndf=2)
    model = _port_model(tmp_path, batch, jax.device_get(jax_model.state.params), DROPOUT, ndf=2)
    want = _jax_step(jax_model, batch)
    got = _port_step(model, batch)
    assert len(shared_masks["jax"]) == len(shared_masks["port"]) == 4
    for a, b in zip(shared_masks["jax"], shared_masks["port"]):
        np.testing.assert_array_equal(a, b)
    assert shared_masks["port"][0].shape == (1, 4, 4, 4, 16)
    _check_logs(got, want)
    _check_grads(model, _jax_grads(jax_model), _port_grads(model))


# -------------------------------------------------------------- the YAMLs


def test_hx4_yamls_load_without_jax():
    """The three HX4 experiments load through the port's `init_config`; their
    datasets and the balanced module resolve to the twin; nothing of JAX is
    imported."""
    code = (
        "import sys\n"
        "from ganslate_tpu_torch.configs.config import Config\n"
        "from ganslate_tpu_torch.configs.utils import init_config\n"
        "from ganslate_tpu_torch.utils.io import import_attr\n"
        f"for name in {YAMLS!r}:\n"
        "    conf = init_config(f'projects/maastro_hx4_pet_translation/experiments/"
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
    for name, module, cls, path in rows:
        assert Path(path).is_relative_to(REPO / "ganslate_tpu_torch")
    classes = {(name, cls) for name, _, cls, _ in rows}
    assert ("cyclegan_balanced", "HX4CycleGANBalanced") in classes
    assert ("pix2pix", "Pix2PixConditionalGAN") in classes
    assert ("cyclegan_naive", "CycleGAN") in classes
    assert {cls for _, module, cls, _ in rows if module.startswith("project.datasets")} == \
        {"HX4PETTranslationTrainDataset", "HX4PETTranslationValTestDataset"}


SMALL_NETS = ["train.gan.generator.num_downs=3", "train.gan.generator.ngf=8",
              "train.gan.discriminator.n_layers=1", "train.gan.discriminator.ndf=8"]


def _yaml_args(name, root, out):
    return [f"config={HX4 / 'experiments' / f'{name}.yaml'}", f"train.output_dir={out}",
            f"train.dataset.root={root / 'train'}", f"val.dataset.root={root / 'val'}",
            "train.cuda=false", "train.n_iters=1", "train.n_iters_decay=1",
            "train.logging.freq=1", "train.checkpointing.freq=2", "val.freq=2",
            "train.seed=3", "train.logging.wandb=null", "train.dataset.num_workers=2",
            "val.dataset.num_workers=2", f"train.dataset.patch_size={PATCH}".replace(" ", ""),
            *SMALL_NETS]


def test_balanced_cyclegan_trains_from_its_yaml(root, tmp_path, monkeypatch):
    """`cyclegan_balanced.yaml` through `init_engine("train")` on the NRRD
    patients, small nets, bf16 as the YAML: 2 iterations, a checkpoint and a
    validation through the sliding window (windows of the patch size), whose
    `save` writes NRRD with each patient's geometry (the metadata's tuples
    through `decollate`); then the Tester from the checkpoint."""
    monkeypatch.chdir(REPO)
    out = tmp_path / "out"
    args = _yaml_args("cyclegan_balanced", root, out)
    trainer = init_engine("train", args)
    assert type(trainer.model).__name__ == "HX4CycleGANBalanced"
    assert type(trainer.model).__module__ == "project.modules.hx4_cyclegan_balanced"
    trainer.run()
    assert (out / "checkpoints" / "2.pth").is_file()
    log = (out / "train_log.txt").read_text()
    assert "(Val at iter 2)" in log and "nan" not in log.lower()
    assert sorted(p.name for p in (out / "val" / "saved").rglob("*.nrrd")) == \
        ["HX4-003.nrrd", "HX4-004.nrrd"]
    # The YAML has no test section: the Tester's is the validation's, with
    # the checkpoint to load.
    raw = trainer.conf.to_container(resolve=False)
    raw["test"] = {"dataset": raw["val"]["dataset"], "sliding_window": raw["val"]["sliding_window"],
                   "checkpointing": {"load_iter": 2}}
    path = tmp_path / "balanced.yaml"
    path.write_text(yaml.safe_dump({k: v for k, v in raw.items() if k != "mode"}))
    init_engine("test", [f"config={path}"]).run()
    saved = sorted((out / "test" / "saved").rglob("*.nrrd"))
    assert [p.name for p in saved] == ["HX4-003.nrrd", "HX4-004.nrrd"]
    image = medio.load(saved[0])
    assert image.array.shape == SHAPE and np.isfinite(image.array).all()
    rows = (out / "test" / "metrics.csv").read_text().splitlines()
    assert len(rows) == 3


def test_pix2pix_trains_from_its_yaml_with_masked_metrics(root, tmp_path, monkeypatch):
    """`pix2pix.yaml` (paired patches; validation with `supply_masks: true`)
    through `init_engine("train")`, small nets: 2 iterations and a
    validation with the BODY and GTV metrics."""
    monkeypatch.chdir(REPO)
    out = tmp_path / "out"
    trainer = init_engine("train", _yaml_args("pix2pix", root, out))
    assert type(trainer.data_loader.dataset).__module__ == "project.datasets.train_dataset"
    trainer.run()
    log = (out / "train_log.txt").read_text()
    assert "(Val at iter 2)" in log and "mae_BODY" in log and "mae_GTV" in log
    assert "nan" not in log.lower()
