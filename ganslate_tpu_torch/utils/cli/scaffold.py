"""Project scaffolding (the JAX package's `utils/cli/scaffold.py`): plain
string templates for a project package, its dataset stub and a default
experiment YAML, written by `new-project`. The templates import this
package."""

from pathlib import Path

PROJECT_INIT = '''"""Project package: classes here are importable as `project.*`
from experiment YAMLs (e.g. `_target_: project.datasets.MyDataset`)."""

from .datasets import *  # noqa: F401,F403
'''

DATASETS_INIT = '''"""Custom datasets for this project.

A dataset is any class with `__init__(self, conf)`, `__len__`, and
`__getitem__(self, idx) -> dict` returning channels-last float32 numpy arrays
under keys 'A' and 'B' (optionally 'masks' and 'metadata'). Optional hooks:
`save(tensor, save_dir, metadata=None)` and `denormalize(tensor)`.
"""

from dataclasses import dataclass, field
from typing import Tuple

from ganslate_tpu_torch import configs


@dataclass
class {name_camel}DatasetConfig(configs.base.BaseDatasetConfig):
    # Add custom dataset options here; they appear under train.dataset.* in YAML.
    patch_size: Tuple[int, int] = field(default_factory=lambda: [256, 256])


class {name_camel}Dataset:

    def __init__(self, conf):
        self.root = conf[conf.mode].dataset.root
        raise NotImplementedError("Implement your dataset loading here.")

    def __len__(self):
        return 0

    def __getitem__(self, idx):
        raise NotImplementedError
'''

DEFAULT_YAML = '''project: "{project_dir}"

train:
    output_dir: "{project_dir}/checkpoints/default"
    cuda: True
    n_iters: 10000
    n_iters_decay: 10000
    batch_size: 1

    logging:
        freq: 50

    checkpointing:
        freq: 2000

    dataset:
        _target_: project.datasets.{name_camel}Dataset
        root: "{project_dir}/data/train"
        num_workers: 4

    gan:
        _target_: ganslate.nn.gans.unpaired.CycleGAN

        generator:
            _target_: ganslate.nn.generators.Resnet2D
            n_residual_blocks: 9
            in_out_channels:
                AB: [3, 3]

        discriminator:
            _target_: ganslate.nn.discriminators.PatchGAN2D
            n_layers: 3
            in_channels:
                B: 3

        optimizer:
            lambda_AB: 10.0
            lambda_BA: 10.0
            lambda_identity: 0
            proportion_ssim: 0
            lr_D: 0.0002
            lr_G: 0.0002
'''


def _camel(name: str) -> str:
    return "".join(part.capitalize() for part in name.replace("-", "_").split("_"))


def create_project(path, name: str) -> Path:
    project_dir = (Path(path) / name).resolve()
    (project_dir / "datasets").mkdir(parents=True, exist_ok=True)
    (project_dir / "experiments").mkdir(exist_ok=True)
    (project_dir / "modules").mkdir(exist_ok=True)

    ctx = {"name_camel": _camel(name), "project_dir": str(project_dir)}
    (project_dir / "__init__.py").write_text(PROJECT_INIT)
    (project_dir / "datasets" / "__init__.py").write_text(DATASETS_INIT.format(**ctx))
    (project_dir / "modules" / "__init__.py").write_text(
        '"""Custom GAN subclasses (`_target_: project.modules.X`)."""\n')
    (project_dir / "experiments" / "default.yaml").write_text(DEFAULT_YAML.format(**ctx))
    return project_dir
