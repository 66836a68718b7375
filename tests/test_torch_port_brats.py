"""The BRaTS project twin (`ganslate_tpu_torch/projects/
brats_mri_sequence_translation/`) against the JAX package's project, the
loading of the BRaTS experiment YAMLs, and the BRaTS CycleGAN trained from
its YAML on the CPU.

Synthetic BRaTS-shaped scans, 4 sequences of (12, 24, 24), are written as
4-D `.nii.gz` files by the JAX package's `medio.write`. Both packages'
datasets read them; before each call both sides are seeded alike (Python's
`random` for domain B's scan, the patch sampler's `rng` for the patch pair),
and the patches must be equal bit for bit: the same numpy reads, the same
draws and the same float32 z-scores. The validation scan is also read at
sequences of 2^20 voxels, which both packages z-score with their host data
ops (`native/`), bit for bit too."""

import importlib.util
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ganslate_tpu_torch.configs.config import Config
from ganslate_tpu_torch.configs.omega import Conf
from ganslate_tpu_torch.configs.utils import init_config
from ganslate_tpu_torch.engines.utils import init_engine
from ganslate_tpu_torch.projects.brats_mri_sequence_translation import datasets
from tests.torch_port_support import jax_native, one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
BRATS = REPO / "projects" / "brats_mri_sequence_translation"
YAMLS = ("cyclegan", "cyclegan_s2d", "revgan", "cut")
SHAPE = (4, 12, 24, 24)
# Sequences of 2^20 voxels: the size from which both packages normalise a
# volume with their host data ops.
NATIVE_SHAPE = (4, 64, 128, 128)
PATCH = [8, 16, 16]


def _scan(seed, shape=SHAPE):
    """A head-like ellipsoid of positive intensities per sequence, zero
    outside, as a BRaTS scan is."""
    rng = np.random.default_rng(seed)
    grid = np.ogrid[tuple(slice(0, d) for d in shape[1:])]
    head = sum(((g - d / 2) / (0.45 * d)) ** 2 for g, d in zip(grid, shape[1:])) <= 1
    return (np.maximum(rng.normal(300, 100, shape), 0) * head).astype(np.float32)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """`train/` with 3 scans and `val/` with 1, written by the JAX `medio`."""
    from ganslate_tpu.utils import medio as jax_medio
    root = tmp_path_factory.mktemp("brats")
    for split, seeds in (("train", (0, 1, 2)), ("val", (3,))):
        for seed in seeds:
            jax_medio.write(jax_medio.MedicalImage(_scan(seed)),
                            root / split / f"BRATS_{seed:03d}.nii.gz")
    return root


def _jax_datasets():
    """The JAX package's BRaTS project, imported under a name of its own (the
    name `project` is the port's in this process)."""
    name = "jax_brats_project"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, BRATS / "__init__.py", submodule_search_locations=[str(BRATS)])
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return importlib.import_module(f"{name}.datasets")


def _conf(roots, patch_size=PATCH, mode="train"):
    dataset = {"root": str(roots / "train"), "patch_size": list(patch_size),
               "focal_region_proportion": 0.2, "source_sequence": "flair",
               "target_sequence": "t1w"}
    return Conf.create({"mode": mode, "train": {"dataset": dataset},
                        "val": {"dataset": {"root": str(roots / "val"),
                                            "source_sequence": "flair",
                                            "target_sequence": "t1w"}}})


def _seeded(dataset, index, seed):
    random.seed(seed)
    dataset.patch_sampler.rng = np.random.default_rng(seed)
    return dataset[index]


def test_train_dataset_matches_jax_bit_for_bit(roots):
    conf = _conf(roots)
    port = datasets.BratsDataset(conf)
    jax_ds = _jax_datasets().BratsDataset(conf)
    assert len(port) == len(jax_ds) == 3
    for index, seed in [(0, 11), (1, 12), (2, 13), (4, 14)]:
        got, want = _seeded(port, index, seed), _seeded(jax_ds, index, seed)
        assert sorted(got) == sorted(want) == ["A", "B"]
        for key in ("A", "B"):
            assert got[key].dtype == want[key].dtype == np.float32
            assert got[key].shape == (*PATCH, 1)
            np.testing.assert_array_equal(got[key], want[key])
            assert got[key].min() == -1 and got[key].max() == 1


def test_domain_b_is_drawn_with_python_random(roots):
    port = datasets.BratsDataset(_conf(roots))
    loaded = []
    load = datasets.train_dataset.sitk_utils.load
    datasets.train_dataset.sitk_utils.load = lambda path: loaded.append(path) or load(path)
    try:
        _seeded(port, 0, 5)
    finally:
        datasets.train_dataset.sitk_utils.load = load
    random.seed(5)
    assert loaded == [port.paths_brats[0], port.paths_brats[random.randint(0, 2)]]


def test_patch_larger_than_the_volume_raises_as_jax(roots):
    conf = _conf(roots, patch_size=(8, 32, 16))
    errors = []
    for ds in (datasets.BratsDataset(conf), _jax_datasets().BratsDataset(conf)):
        with pytest.raises(ValueError, match="patch size") as info:
            _seeded(ds, 0, 1)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("shape", (SHAPE, NATIVE_SHAPE), ids=("small", "native"))
def test_val_dataset_matches_jax_bit_for_bit(roots, tmp_path, shape):
    """Whole sequences z-scored to [-1, 1]: by numpy in both packages, and at
    `NATIVE_SHAPE`, 2^20 voxels a sequence, by both packages' host data
    ops."""
    if shape != SHAPE:
        from ganslate_tpu.utils import medio as jax_medio
        jax_native()
        jax_medio.write(jax_medio.MedicalImage(_scan(3, shape)),
                        tmp_path / "val" / "BRATS_003.nii.gz")
        roots = tmp_path
    conf = _conf(roots, mode="val")
    port = datasets.BratsValTestDataset(conf)
    jax_ds = _jax_datasets().BratsValTestDataset(conf)
    assert len(port) == len(jax_ds) == 1
    got, want = port[0], jax_ds[0]
    for key in ("A", "B"):
        assert got[key].shape == (*shape[1:], 1)
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(port.denormalize(got["A"]), jax_ds.denormalize(want["A"]))


# ------------------------------------------------------------ the YAMLs


def test_brats_yamls_load_without_jax():
    """All four BRaTS experiments load through the port's `init_config`, their
    datasets resolve to the twin, and nothing of JAX is imported."""
    code = (
        "import sys\n"
        "from ganslate_tpu_torch.configs.config import Config\n"
        "from ganslate_tpu_torch.configs.utils import init_config\n"
        "from ganslate_tpu_torch.utils.io import import_attr\n"
        f"for name in {YAMLS!r}:\n"
        "    conf = init_config(f'projects/brats_mri_sequence_translation/experiments/"
        "{name}.yaml', Config)\n"
        "    for mode in ('train', 'val'):\n"
        "        cls = import_attr(conf[mode].dataset._target_)\n"
        "        print(name, mode, cls.__module__, cls.__name__,\n"
        "              sys.modules[cls.__module__].__file__)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'flax', 'ganslate_tpu'))\n"
        "print('bad', bad)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[-1] == "bad []"
    assert len(lines) == 2 * len(YAMLS) + 1
    for line in lines[:-1]:
        name, mode, module, cls, path = line.split()
        assert Path(path).is_relative_to(REPO / "ganslate_tpu_torch" / "projects")
        assert module == "project.datasets." + ("train_dataset" if mode == "train"
                                                else "val_test_dataset")
        assert cls == ("BratsDataset" if mode == "train" else "BratsValTestDataset")


def test_project_without_a_twin_that_imports_jax_raises(tmp_path):
    project = tmp_path / "my_jax_project"
    (project / "datasets").mkdir(parents=True)
    (project / "__init__.py").write_text("")
    (project / "datasets" / "__init__.py").write_text(
        "import numpy as np\nfrom ganslate_tpu.data.utils import normalization\n")
    raw = {"project": str(project), "train": {"output_dir": str(tmp_path)}}
    with pytest.raises(ImportError, match="no twin") as info:
        init_config(Conf.create(raw), Config)
    assert "datasets/__init__.py:2" in str(info.value)
    assert "ganslate_tpu_torch/projects/my_jax_project/" in str(info.value)


def test_project_of_the_port_loads_as_it_is(tmp_path):
    """A project with no twin that imports only the port (as the port's
    `new-project` scaffold writes them) loads from its own directory."""
    project = tmp_path / "my_project"
    project.mkdir()
    (project / "__init__.py").write_text(
        "from ganslate_tpu_torch.data.utils.normalization import z_score_normalize\n"
        "MARK = 7\n")
    init_config(Conf.create({"project": str(project),
                             "train": {"output_dir": str(tmp_path)}}), Config)
    assert sys.modules["project"].MARK == 7


def test_hx4_project_names_its_missing_twin(monkeypatch, tmp_path):
    """Without its twin (the port's projects directory swapped for an empty
    one), the HX4 project, whose code imports the JAX package, raises and
    names the twin to add."""
    from ganslate_tpu_torch.configs import utils as config_utils
    monkeypatch.chdir(REPO)
    monkeypatch.setattr(config_utils, "PROJECT_TWINS", tmp_path)
    with pytest.raises(ImportError, match="projects/maastro_hx4_pet_translation/"):
        init_config("projects/maastro_hx4_pet_translation/experiments/pix2pix.yaml", Config)


# ------------------------------------------------ training from the YAML


def test_cyclegan_trains_from_its_yaml(roots, tmp_path, monkeypatch):
    """`cyclegan.yaml` through `init_engine("train")` on the NIfTI scans,
    small nets: 2 iterations, a validation with the cycle metrics, a
    checkpoint."""
    monkeypatch.chdir(REPO)
    out = tmp_path / "out"
    overrides = [
        f"config={BRATS / 'experiments' / 'cyclegan.yaml'}",
        f"train.output_dir={out}", f"train.dataset.root={roots / 'train'}",
        f"val.dataset.root={roots / 'val'}", "train.cuda=false",
        "train.mixed_precision=false", "train.n_iters=1", "train.n_iters_decay=1",
        "train.logging.freq=1", "train.checkpointing.freq=2", "val.freq=2", "train.seed=3",
        "train.dataset.num_workers=2", "train.dataset.patch_size=[8,16,16]",
        "train.gan.generator.first_layer_channels=4", "train.gan.generator.down_blocks=[1,1]",
        "train.gan.generator.up_blocks=[1,1]", "train.gan.discriminator.n_layers=1",
        "train.gan.discriminator.ndf=8"]
    trainer = init_engine("train", overrides)
    assert type(trainer.data_loader.dataset).__module__ == "project.datasets.train_dataset"
    trainer.run()
    assert (out / "checkpoints" / "2.pth").is_file()
    log = (out / "train_log.txt").read_text()
    assert "(Val at iter 2)" in log and "cycle_SSIM" in log
    assert "nan" not in log.lower()
