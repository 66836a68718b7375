"""The port's command line (`python -m ganslate_tpu_torch`, the JAX
package's `utils/cli/interface.py`) through `click.testing.CliRunner`:
a CUT trained from a YAML with the command line's overrides, then tested
and served from its checkpoint; `new-project`; the errors and the command
list, against the JAX package's CLI. Then the import-and-evaluate path: an
original ganslate CycleGAN checkpoint through `import-torch-checkpoint`,
Inception weights through `convert-fid-weights`, and `test` with
`test.metrics.fid=true`; `your-first-run` and `download-dataset` only for
their offline failure (`urlretrieve` made to raise: no network call).

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
from tests.torch_port_support import one_torch_thread  # noqa: F401 (autouse)

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
    assert sorted(interface.commands) == [
        "convert-fid-weights", "download-dataset", "import-torch-checkpoint", "infer",
        "new-project", "test", "train", "your-first-run"]
    assert set(interface.commands) == set(jax_interface.commands)
    result = CliRunner().invoke(interface, ["--help"])
    assert result.exit_code == 0
    for cmd in interface.commands:
        assert cmd in result.output


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    """A CycleGAN YAML over paired PNGs, its original-layout checkpoint
    (`40.pth`, seeded) imported by the command line, and the FID weights
    (a seeded port InceptionV3 with random batch-norm statistics) converted
    to `.npz` by it."""
    from ganslate_tpu_torch.configs.config import Config
    from ganslate_tpu_torch.configs.omega import Conf
    from ganslate_tpu_torch.configs.utils import init_config
    from ganslate_tpu_torch.nn.inception import InceptionV3
    from ganslate_tpu_torch.utils.builders import build_gan
    from ganslate_tpu_torch.utils.synthetic_data import write_original_checkpoint

    root = tmp_path_factory.mktemp("import")
    _write_pngs(root / "data", n=3)
    raw = {
        "train": {
            "output_dir": str(root / "out"), "batch_size": 1, "cuda": True, "n_iters": 1,
            "n_iters_decay": 1, "mixed_precision": False,
            "gan": {"_target_": "ganslate.nn.gans.unpaired.CycleGAN",
                    "generator": {"_target_": "ganslate.nn.generators.Resnet2D",
                                  "n_residual_blocks": 1, "ngf": 8,
                                  "in_out_channels": {"AB": [3, 3]}},
                    "discriminator": {"_target_": "ganslate.nn.discriminators.PatchGAN2D",
                                      "ndf": 8, "n_layers": 2, "in_channels": {"B": 3}}}},
        "test": {"checkpointing": {"load_iter": 40},
                 "dataset": _dataset(root / "data", "ganslate.data.PairedImageDataset"),
                 "metrics": {"fid": False}},
    }
    config = root / "cyclegan.yaml"
    config.write_text(yaml.safe_dump(raw))
    conf = init_config(Conf.create({**raw, "train": {**raw["train"], "cuda": False}}), Config)
    model = build_gan(conf)
    model.init_networks()
    source = write_original_checkpoint(root / "40.pth", model.networks, seed=11)

    runner = CliRunner()
    result = runner.invoke(interface, ["import-torch-checkpoint", str(root / "40.pth"),
                                       f"config={config}", "train.cuda=false"])
    net = InceptionV3(generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, buf in net.named_buffers():
            buf.copy_(torch.randn(buf.shape, generator=g) * 0.1 if name.endswith("mean")
                      else torch.rand(buf.shape, generator=g) + 0.5)
    torch.save(net.state_dict(), root / "inception.pth")
    converted = runner.invoke(interface, ["convert-fid-weights", str(root / "inception.pth"),
                                          str(root / "inception.npz")])
    return root, config, source, result, converted, net


def test_import_torch_checkpoint(imported):
    root, _, source, result, _, _ = imported
    assert result.exit_code == 0, result.output + repr(result.exception)
    path = root / "out" / "checkpoints" / "40.pth"
    assert f"Converted checkpoint written to {path}" in result.output
    written = torch.load(path, weights_only=True)
    assert sorted(written) == ["D_A", "D_B", "G_AB", "G_BA"]
    for name, sd in written.items():
        tensors = [v for k, v in source[name].items() if k.startswith("p")]
        assert [torch.equal(a, b) for a, b in zip(sd.values(), tensors)] == [True] * len(sd)


def test_convert_fid_weights(imported):
    from ganslate_tpu_torch.nn.inception import load_inception_npz
    root, _, _, _, converted, net = imported
    assert converted.exit_code == 0, converted.output + repr(converted.exception)
    assert "Native FID weights written to" in converted.output
    loaded = load_inception_npz(root / "inception.npz")
    assert sorted(loaded) == sorted(net.state_dict())
    assert all(torch.equal(loaded[k], v) for k, v in net.state_dict().items())


def test_test_with_fid_from_the_imported_checkpoint(imported, monkeypatch):
    """Inception resizes to 75x75 here (the JAX tests' small size), in this
    test only. The Frechet solve (2048^2 `eigh` in float64) runs on one
    BLAS thread: beside the suite's other workers, BLAS threads that
    outnumber the cores slow it 40-fold."""
    from threadpoolctl import threadpool_limits
    from ganslate_tpu_torch.nn import inception
    monkeypatch.setattr(inception, "FID_IMAGE_SIZE", 75)
    root, config, _, _, _, _ = imported
    with threadpool_limits(limits=1, user_api="blas"):
        result = CliRunner().invoke(interface, [
            "test", f"config={config}", "train.cuda=false", "test.metrics.fid=true",
            f"test.metrics.fid_weights={root / 'inception.npz'}"])
    assert result.exit_code == 0, result.output + repr(result.exception)
    log = (root / "out" / "test_log.txt").read_text()
    line = re.search(r"\(Test\) -+\n([^\n]*)", log).group(1)
    metrics = {k: float(v) for k, v in re.findall(r"(\S+): (\S+)", line)}
    assert sorted(metrics) == ["fid", "mae", "mse", "nmse", "psnr", "ssim"], line
    assert np.isfinite(metrics["fid"]) and metrics["fid"] >= 0, line


def test_your_first_run_offline(tmp_path, monkeypatch):
    import urllib.request

    def offline(url, filename):
        raise OSError("network unreachable")

    monkeypatch.setattr(urllib.request, "urlretrieve", offline)
    result = CliRunner().invoke(interface, ["your-first-run", str(tmp_path)])
    assert result.exit_code == 0, result.output + repr(result.exception)
    assert "Download failed (network unreachable)" in result.output
    assert f"First run ready at {tmp_path / 'first_run'}" in result.output
    yaml_conf = yaml.safe_load((tmp_path / "first_run" / "default.yaml").read_text())
    assert yaml_conf["train"]["dataset"]["root"] == str(tmp_path / "first_run" / "facades" /
                                                        "train")


@pytest.mark.parametrize("name", ("horse2zebra", "no_such_dataset"))
def test_download_dataset_offline(name, tmp_path, monkeypatch):
    import urllib.request
    calls = []

    def offline(url, filename):
        calls.append(url)
        raise OSError("network unreachable")

    monkeypatch.setattr(urllib.request, "urlretrieve", offline)
    result = CliRunner().invoke(interface, ["download-dataset", name, str(tmp_path)])
    assert result.exit_code == 0, result.output + repr(result.exception)
    if name == "horse2zebra":
        assert calls == ["https://people.eecs.berkeley.edu/~taesung_park/CycleGAN/datasets/"
                         "horse2zebra.zip"]
        assert "fetch " + calls[0] + " manually" in result.output
    else:
        assert not calls and "Unknown dataset 'no_such_dataset'" in result.output
