"""The port's trackers and what they write (`utils/trackers/`,
`utils/csv_saver.py`, `configs/omega.py:Conf.to_yaml`) against the JAX
package's: the same PNG pixels, the same CSV bytes, YAML that reads back to
the same tree, the same log message. Then the tracker path with Pillow,
pandas and PyYAML made unimportable, as on a machine without them."""

import logging
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml
from PIL import Image

from ganslate_tpu.configs.config import Config as JaxConfig
from ganslate_tpu.configs.omega import Conf as JaxConf
from ganslate_tpu.configs.utils import init_config as jax_init_config
from ganslate_tpu.utils.csv_saver import Saver as JaxSaver
from ganslate_tpu.utils.trackers.training import TrainingTracker as JaxTrainingTracker
from ganslate_tpu.utils.trackers.utils import save_image as jax_save_image
from ganslate_tpu_torch.configs.config import Config
from ganslate_tpu_torch.configs.omega import Conf
from ganslate_tpu_torch.configs.utils import init_config
from ganslate_tpu_torch.utils.csv_saver import Saver
from ganslate_tpu_torch.utils.trackers.training import TrainingTracker
from ganslate_tpu_torch.utils.trackers.utils import save_image

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("channels", (1, 2, 3, 4))
def test_png_pixels_match_jax(tmp_path, channels):
    """The port's zlib PNG decodes to the pixels of the JAX package's
    Pillow PNG, in the same mode."""
    image = np.random.default_rng(channels).uniform(-0.1, 1.1, (17, 23, channels))
    save_image(image, tmp_path / "port.png")
    jax_save_image(image, tmp_path / "jax.png")
    with Image.open(tmp_path / "port.png") as got, Image.open(tmp_path / "jax.png") as want:
        assert got.mode == want.mode and got.size == want.size == (23, 17)
        assert np.array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("rows", [
    [{"ssim": 0.1 * i, "psnr": 20.0 + 1 / (i + 3), "mae": 1e-10 * i} for i in range(4)],
    [{"a": 1.0, "b": 2}, {"a": float("nan"), "c": "x,y"}, {"b": 3, "a": float("inf")}],
    [{"n": 3, "m": 1e20}, {"n": 4, "m": -2.5}],
])
def test_csv_bytes_match_jax(tmp_path, rows):
    port, jax_saver = Saver(), JaxSaver()
    for row in rows:
        port.add(row)
        jax_saver.add(row)
    port.write(tmp_path / "port.csv")
    jax_saver.write(tmp_path / "jax.csv")
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


EXPERIMENTS = ("projects/horse2zebra/experiments/default.yaml",
               "projects/brats_mri_sequence_translation/experiments/cyclegan.yaml")


@pytest.mark.parametrize("experiment", EXPERIMENTS)
def test_to_yaml_reads_back_as_jax(experiment, monkeypatch):
    """The full config tree (the JAX package's loader: the BRaTS project's
    datasets and PatchGAN3D are not in the port) dumped by the port's
    emitter reads back to the tree and to what the JAX package's PyYAML
    dump reads back to."""
    monkeypatch.chdir(REPO)
    jax_conf = jax_init_config(experiment, JaxConfig)
    tree = jax_conf.to_container(resolve=False)
    text = Conf.create(tree).to_yaml()
    assert yaml.safe_load(text) == tree == yaml.safe_load(jax_conf.to_yaml())
    assert '_target_: "ganslate.nn.gans.unpaired.CycleGAN"' in text


def test_to_yaml_of_the_ports_own_horse2zebra(monkeypatch):
    monkeypatch.chdir(REPO)
    conf = init_config(EXPERIMENTS[0], Config)
    text = conf.to_yaml()
    assert yaml.safe_load(text) == conf.to_container(resolve=False)
    assert yaml.safe_load(conf.to_yaml(resolve=True)) == conf.to_container(resolve=True)


def _tracker_raw(out_dir):
    return {"train": {"output_dir": str(out_dir), "batch_size": 2, "n_iters": 1,
                      "n_iters_decay": 1, "logging": {"freq": 2}}}


def test_training_message_matches_jax(tmp_path, caplog):
    raw = _tracker_raw(tmp_path / "port")
    port = TrainingTracker(init_config(Conf.create(raw), Config))
    raw = _tracker_raw(tmp_path / "jax")
    jax_tracker = JaxTrainingTracker(jax_init_config(JaxConf.create(raw), JaxConfig))
    rng = np.random.default_rng(0)
    visuals = {k: rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
               for k in ("real_A", "fake_B")}
    args = ({"lr_G": 0.0002, "lr_D": 0.0001}, {"G_AB": np.float32(0.25), "D_B": 1.5},
            visuals, {"ssim_A": 0.5})
    with caplog.at_level(logging.INFO):
        for tracker in (port, jax_tracker):
            for i in (1, 2):            # logs at iteration 2 only
                tracker.set_iter_idx(i)
                tracker.log_iter(*args)
    messages = {r.name.split(".")[0]: r.getMessage() for r in caplog.records
                if r.name.endswith("trackers.training")}
    assert len([r for r in caplog.records if r.name.endswith("trackers.training")]) == 2
    assert messages["ganslate_tpu_torch"] == messages["ganslate_tpu"]
    assert "(iter: 2 | comp: 0.000, data: 0.000 | lr_G: 0.0002000, lr_D: 0.0001000)" \
        in messages["ganslate_tpu_torch"]
    images = [sorted((tmp_path / pkg / "train" / "images").glob("*.png")) for pkg in
              ("port", "jax")]
    assert [p.name for p in images[0]] == [p.name for p in images[1]] == \
        ["2_real_A-fake_B.png"]
    with Image.open(images[0][0]) as got, Image.open(images[1][0]) as want:
        assert np.array_equal(np.asarray(got), np.asarray(want))


def test_trackers_need_no_pil_pandas_or_yaml(tmp_path):
    """A config built in Python, its dump, the training tracker's PNGs, the
    val/test tracker's CSV and the inference tracker's grids, with `PIL`,
    `pandas` and `yaml` unimportable."""
    code = f"""
import sys
for name in ("PIL", "pandas", "yaml"):
    sys.modules[name] = None
import numpy as np, torch
from ganslate_tpu_torch.configs.config import Config
from ganslate_tpu_torch.configs.omega import Conf
from ganslate_tpu_torch.configs.utils import init_config
from ganslate_tpu_torch.utils.trackers.inference import InferenceTracker
from ganslate_tpu_torch.utils.trackers.training import TrainingTracker
from ganslate_tpu_torch.utils.trackers.validation_testing import ValTestTracker
out = {str(tmp_path)!r}
raw = {{"train": {{"output_dir": out, "batch_size": 2, "n_iters": 1, "n_iters_decay": 1,
                   "logging": {{"freq": 1}}}}, "test": {{}}, "infer": {{}}}}
conf = init_config(Conf.create(raw), Config)
visuals = {{"real_A": torch.zeros(2, 8, 8, 3, dtype=torch.bfloat16), "fake_B": torch.ones(2, 8, 8, 3)}}
tracker = TrainingTracker(conf)
tracker.set_iter_idx(1)
tracker.log_iter({{"lr_G": 1e-4}}, {{"G_AB": torch.tensor(0.5)}}, visuals, {{}})
conf.mode = "test"
tracker = ValTestTracker(conf)
tracker.add_sample({{k: v.float().numpy() for k, v in visuals.items()}}, {{"ssim": [0.5, 0.25]}})
tracker.log_samples(None)
conf.mode = "infer"
tracker = InferenceTracker(conf)
tracker.set_iter_idx(1)
tracker.log_iter({{"input": np.zeros((2, 8, 8, 3)), "output": np.zeros((2, 8, 8, 3))}}, 2)
assert sys.modules["yaml"] is None and sys.modules["PIL"] is None
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stdout + proc.stderr
    assert (tmp_path / "train" / "train_config.yaml").read_text().startswith("project: null")
    assert len(list((tmp_path / "train" / "images").glob("1_*.png"))) == 1
    assert (tmp_path / "test" / "metrics.csv").read_text() == ",ssim\n0,0.5\n1,0.25\n"
    assert len(list((tmp_path / "infer" / "images").glob("*.png"))) == 2
    assert yaml.safe_load((tmp_path / "test" / "test_config.yaml").read_text())["mode"] == "test"
