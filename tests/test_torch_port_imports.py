"""The port stands alone: `ganslate_tpu_torch` imports neither JAX nor the
JAX package, serves without PyYAML, resolves `_target_` strings to its own
classes, and never runs on the CPU when the config asks for the GPU.

The import checks run in subprocesses, because this test process has JAX
imported already (tests/conftest.py)."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from ganslate_tpu_torch.configs.config import Config
from ganslate_tpu_torch.configs.omega import Conf
from ganslate_tpu_torch.configs.utils import init_config
from ganslate_tpu_torch.utils.io import import_attr

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "ganslate_tpu_torch"


def _run(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)


def test_port_imports_no_jax_and_no_jax_package():
    proc = _run(
        "import importlib, pkgutil, sys\n"
        "import ganslate_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(ganslate_tpu_torch.__path__,\n"
        "                                                'ganslate_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'flax', 'ganslate_tpu')\n"
        "             or m.startswith(('jax.', 'flax.', 'ganslate_tpu.')))\n"
        "print(len(names), bad)\n"
        "print(*names)\n"
        "sys.exit(1 if bad else 0)\n")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 40          # the training modules included
    names = set(proc.stdout.splitlines()[1].split())
    assert {"ganslate_tpu_torch.nn.invertible", "ganslate_tpu_torch.nn.generators.vnet.vnet",
            "ganslate_tpu_torch.nn.generators.vnet.vnet2d",
            "ganslate_tpu_torch.nn.generators.vnet.vnet3d",
            "ganslate_tpu_torch.utils.sliding_window_inferer"} <= names
    # The data plane, the engines and the trackers.
    assert {f"ganslate_tpu_torch.{m}" for m in (
        "data", "data.samplers", "data.loaders", "data.image_folder",
        "data.unpaired_image_dataset", "data.paired_image_dataset",
        "data.utils.transforms", "data.utils.normalization",
        "engines.trainer", "engines.validator_tester", "engines.inferer",
        "utils.trackers.base", "utils.trackers.utils", "utils.trackers.training",
        "utils.trackers.inference", "utils.trackers.validation_testing",
        "utils.trackers.wandb", "utils.trackers.tensorboard",
        "utils.environment", "utils.summary", "utils.csv_saver",
        "utils.metrics.val_test_metrics")} <= names


_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|flax|optax|orbax|ml_dtypes|ganslate_tpu)(?:\.|\s|$)",
    re.MULTILINE)


def test_port_sources_import_nothing_of_jax():
    sources = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    scanned = {str(p.relative_to(PORT)) for p in sources if p.is_relative_to(PORT)}
    assert {"data/loaders.py", "data/image_folder.py", "data/utils/transforms.py",
            "engines/trainer.py", "engines/validator_tester.py",
            "utils/trackers/base.py", "utils/trackers/training.py",
            "utils/environment.py", "utils/summary.py"} <= scanned
    offenders = [f"{p.relative_to(REPO)}: {m.group(0).strip()}"
                 for p in sources for m in _FORBIDDEN.finditer(p.read_text())]
    assert not offenders, offenders


def test_serving_path_needs_no_pyyaml():
    """Build a config in Python, save a checkpoint and serve it, with `yaml`
    and `jax` made unimportable."""
    proc = _run(
        "import sys, tempfile, pathlib\n"
        "sys.modules['yaml'] = None\n"
        "sys.modules['jax'] = None\n"
        "import numpy as np, torch\n"
        "from ganslate_tpu_torch.configs.config import Config\n"
        "from ganslate_tpu_torch.configs.omega import Conf\n"
        "from ganslate_tpu_torch.configs.utils import init_config\n"
        "from ganslate_tpu_torch.engines.inferer import Inferer\n"
        "from ganslate_tpu_torch.utils.builders import build_G\n"
        "out = tempfile.mkdtemp()\n"
        "raw = {'train': {'output_dir': out, 'batch_size': 1, 'cuda': False,\n"
        "    'mixed_precision': True, 'n_iters': 1, 'n_iters_decay': 1,\n"
        "    'gan': {'_target_': 'ganslate.nn.gans.unpaired.CycleGAN',\n"
        "            'generator': {'_target_': 'ganslate.nn.generators.Resnet2D',\n"
        "                          'n_residual_blocks': 1, 'ngf': 8,\n"
        "                          'in_out_channels': {'AB': [3, 3]}}}},\n"
        "    'infer': {'is_deployment': True, 'checkpointing': {'load_iter': 3}}}\n"
        "conf = init_config(Conf.create(raw), Config)\n"
        "g = build_G(conf, 'AB', torch.Generator().manual_seed(0))\n"
        "pathlib.Path(out, 'checkpoints').mkdir()\n"
        "torch.save({'G_AB': g.state_dict()}, pathlib.Path(out, 'checkpoints', '3.pth'))\n"
        "y = Inferer(conf).infer(np.zeros((1, 16, 16, 3), np.float32))\n"
        "print(tuple(y.shape), y.dtype)\n")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.split("\n")[0] == "(1, 16, 16, 3) torch.bfloat16"


def _raw_conf(tmp_path, cuda):
    return {"train": {
        "output_dir": str(tmp_path), "batch_size": 1, "cuda": cuda, "n_iters": 1,
        "n_iters_decay": 1,
        "gan": {"_target_": "ganslate.nn.gans.unpaired.CycleGAN",
                "generator": {"_target_": "ganslate.nn.generators.Resnet2D",
                              "n_residual_blocks": 1, "ngf": 8,
                              "in_out_channels": {"AB": [3, 3]}}}},
        "infer": {"is_deployment": True, "checkpointing": {"load_iter": 1}}}


def test_cuda_true_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: cuda=true is satisfied here")
    from ganslate_tpu_torch.engines.inferer import Inferer
    conf = init_config(Conf.create(_raw_conf(tmp_path, cuda=True)), Config)
    assert conf.infer.cuda is True
    with pytest.raises(RuntimeError, match="CUDA"):
        Inferer(conf)


def test_cuda_false_selects_cpu(tmp_path):
    from ganslate_tpu_torch.nn.gans.base import select_device
    conf = init_config(Conf.create(_raw_conf(tmp_path, cuda=False)), Config)
    assert conf.infer.cuda is False
    assert select_device(conf.infer.cuda) == torch.device("cpu")


@pytest.mark.parametrize("prefix", ("ganslate.", "ganslate_tpu.", "ganslate_tpu_torch."))
def test_import_attr_aliases_to_the_port(prefix):
    from ganslate_tpu_torch.nn.generators import Resnet2D, Resnet2DConfig
    from ganslate_tpu_torch.nn.gans.unpaired import CycleGAN
    assert import_attr(prefix + "nn.generators.Resnet2D") is Resnet2D
    assert import_attr(prefix + "nn.generators.Resnet2DConfig") is Resnet2DConfig
    assert import_attr(prefix + "nn.gans.unpaired.CycleGAN") is CycleGAN


@pytest.mark.parametrize("target, missing", [
    ("ganslate.nn.discriminators.PatchGAN3D", "PatchGAN3D"),
    ("ganslate.nn.gans.paired.Pix2PixConditionalGAN", "ganslate_tpu_torch.nn.gans.paired"),
    ("ganslate.nn.generators.Piresnet3D", "Piresnet3D"),
])
def test_import_attr_names_what_the_port_lacks(target, missing):
    with pytest.raises(ImportError, match=re.escape(missing)):
        import_attr(target)


@pytest.mark.parametrize("name", ("Vnet3D", "Vnet3DConfig", "Vnet2D", "Vnet2DConfig"))
def test_import_attr_resolves_the_vnets(name):
    """The BRaTS experiments' `_target_: ganslate.nn.generators.Vnet3D`
    resolves to the port's V-Net."""
    from ganslate_tpu_torch.nn import generators
    assert import_attr(f"ganslate.nn.generators.{name}") is getattr(generators, name)


@pytest.mark.parametrize("name", ("UnpairedImageDataset", "UnpairedImageDatasetConfig",
                                  "PairedImageDataset", "PairedImageDatasetConfig"))
def test_import_attr_resolves_the_data_plane(name):
    """The horse2zebra experiment's `_target_: ganslate.data.*` datasets
    resolve to the port's."""
    from ganslate_tpu_torch import data
    assert import_attr(f"ganslate.data.{name}") is getattr(data, name)


def test_horse2zebra_yaml_waits_for_the_data_plane(monkeypatch):
    """The headline YAML loads in the port now that the data plane is in:
    its train, val and infer datasets resolve to the port's classes, with
    their config schemas' defaults."""
    from ganslate_tpu_torch.data import PairedImageDataset, UnpairedImageDataset
    monkeypatch.chdir(REPO)
    conf = init_config("projects/horse2zebra/experiments/default.yaml", Config)
    assert import_attr(conf.train.dataset._target_) is UnpairedImageDataset
    assert import_attr(conf.val.dataset._target_) is PairedImageDataset
    assert import_attr(conf.infer.dataset._target_) is UnpairedImageDataset
    assert conf.train.dataset.pin_memory is True and conf.val.dataset.num_workers == 16
