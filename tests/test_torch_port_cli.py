"""The port's command line (`python -m ganslate_tpu_torch`, the JAX
package's `utils/cli/interface.py`) through `click.testing.CliRunner`:
a CUT trained from a YAML with the command line's overrides, then tested
and served from its checkpoint; `new-project`; the errors and the command
list, against the JAX package's CLI.

Small nets (Resnet2D with 1 residual block, ngf 8; PatchGAN2D, ndf 8),
32x32 PNG folders written here, 2 iterations on the CPU."""

import re

import numpy as np
import pytest
import yaml
from click.testing import CliRunner
from PIL import Image

import torch

from ganslate_tpu_torch.utils.cli.interface import interface

SIZE = 32


def _write_pngs(root, n=4):
    rng = np.random.default_rng(42)
    for domain in ("A", "B"):
        (root / domain).mkdir(parents=True)
        for i in range(n):
            arr = rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
            Image.fromarray(arr).save(root / domain / f"{domain.lower()}{i}.png")


def _dataset(root, target):
    return {"_target_": target, "root": str(root), "num_workers": 0, "image_channels": 3,
            "preprocess": ["resize"], "load_size": [SIZE, SIZE], "final_size": [SIZE, SIZE]}


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """A CUT experiment YAML that asks for the GPU (`cuda: true`, as the
    BRaTS CUT's does), over PNG folders."""
    root = tmp_path_factory.mktemp("cli")
    _write_pngs(root / "data")
    unpaired = _dataset(root / "data", "ganslate.data.UnpairedImageDataset")
    paired = _dataset(root / "data", "ganslate.data.PairedImageDataset")
    raw = {
        "train": {
            "output_dir": str(root / "out"), "batch_size": 2, "cuda": True,
            "mixed_precision": False, "n_iters": 1, "n_iters_decay": 1, "seed": 3,
            "logging": {"freq": 1}, "checkpointing": {"freq": 2}, "dataset": unpaired,
            "gan": {"_target_": "ganslate.nn.gans.unpaired.CUT", "nce_layers": [0, 4, 8, 10],
                    "mlp_nc": 16, "num_patches": 16,
                    "generator": {"_target_": "ganslate.nn.generators.Resnet2D",
                                  "n_residual_blocks": 1, "ngf": 8,
                                  "in_out_channels": {"AB": [3, 3]}},
                    "discriminator": {"_target_": "ganslate.nn.discriminators.PatchGAN2D",
                                      "ndf": 8, "n_layers": 2, "in_channels": {"B": 3}},
                    "optimizer": {"lr_D": 0.0002, "lr_G": 0.0004}}},
        "val": {"freq": 2, "dataset": paired, "metrics": {"cycle_metrics": False}},
        "test": {"checkpointing": {"load_iter": 2}, "dataset": dict(paired),
                 "metrics": {"cycle_metrics": False}},
        "infer": {"checkpointing": {"load_iter": 2}, "dataset": dict(unpaired)},
    }
    path = root / "cut.yaml"
    path.write_text(yaml.safe_dump(raw))
    return path, root / "out"


@pytest.fixture(scope="module")
def trained(experiment):
    config, out = experiment
    result = CliRunner().invoke(interface, ["train", f"config={config}", "train.cuda=false"])
    return result, config, out


def _logged(log, head):
    """{iteration: {name: value}} of the lines that follow `head` lines
    (`(iter: N |` for the losses, `(Val at iter N)` for the validation
    metrics) in a training log."""
    found = re.findall(re.escape(head) + r" (\d+)\D[^\n]*\n([^\n]*)", log)
    return {int(i): {k: float(v) for k, v in re.findall(r"(\S+): (\S+)", line)}
            for i, line in found}


def test_train_from_the_command_line(trained):
    result, _, out = trained
    assert result.exit_code == 0, result.output + repr(result.exception)
    log = (out / "train_log.txt").read_text()
    losses = _logged(log, "(iter:")
    assert sorted(losses) == [1, 2]
    for logged in losses.values():
        assert sorted(logged) == ["D", "G", "NCE", "NCE_idt"]
        assert all(np.isfinite(v) for v in logged.values())
    metrics = _logged(log, "(Val at iter")
    assert sorted(metrics) == [2] and "ssim" in metrics[2]
    assert all(np.isfinite(v) for v in metrics[2].values())
    checkpoint = torch.load(out / "checkpoints" / "2.pth", weights_only=True)
    assert {"G", "D", "mlp", "optimizer_mlp", "rng"} <= set(checkpoint)


def test_test_and_infer_from_its_checkpoint(trained):
    result, config, out = trained
    assert result.exit_code == 0
    runner = CliRunner()
    tested = runner.invoke(interface, ["test", f"config={config}", "train.cuda=false"])
    assert tested.exit_code == 0, tested.output + repr(tested.exception)
    inferred = runner.invoke(interface, ["infer", f"config={config}", "train.cuda=false"])
    assert inferred.exit_code == 0, inferred.output + repr(inferred.exception)
    assert len(list((out / "infer").rglob("*.png"))) == 4


def test_cuda_true_without_gpu_raises(experiment, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: cuda=true is satisfied here")
    config, _ = experiment
    result = CliRunner().invoke(interface, ["train", f"config={config}",
                                            f"train.output_dir={tmp_path}"])
    assert result.exit_code != 0 and "CUDA" in str(result.exception)


def test_new_project_scaffold(tmp_path):
    result = CliRunner().invoke(interface, ["new-project", str(tmp_path), "--name", "myproj"])
    assert result.exit_code == 0, result.output
    project = tmp_path / "myproj"
    assert (project / "__init__.py").exists()
    datasets = (project / "datasets" / "__init__.py").read_text()
    assert "from ganslate_tpu_torch import configs" in datasets
    assert "ganslate_tpu " not in datasets and "import ganslate_tpu\n" not in datasets
    assert list(project.rglob("*.yaml")), "scaffold has no experiment YAML"


def test_train_requires_config():
    """As the JAX package's CLI (`tests/test_cli.py`)."""
    result = CliRunner().invoke(interface, ["train"])
    assert result.exit_code != 0
    assert "config" in str(result.exception)


def test_commands_registered():
    from ganslate_tpu.utils.cli.interface import interface as jax_interface
    assert sorted(interface.commands) == ["infer", "new-project", "test", "train"]
    assert set(interface.commands) < set(jax_interface.commands)
    result = CliRunner().invoke(interface, ["--help"])
    assert result.exit_code == 0
    for cmd in interface.commands:
        assert cmd in result.output
