"""Programmatic experiment configs (the JAX package's `utils/testing.py`): the
horse2zebra CycleGAN (`projects/horse2zebra/experiments/default.yaml`:
Resnet2D with 9 residual blocks, 70x70 PatchGAN, lsgan, lambda 10/10),
built in Python, since a machine may lack PyYAML. It names no dataset:
the data plane is not ported."""

from ganslate_tpu_torch.configs.config import Config
from ganslate_tpu_torch.configs.omega import Conf
from ganslate_tpu_torch.configs.utils import init_config


def make_cyclegan_conf(output_dir: str,
                       batch_size: int = 1,
                       channels: int = 3,
                       n_residual_blocks: int = 9,
                       ngf: int = 64,
                       ndf: int = 64,
                       n_layers_D: int = 3,
                       pool_size: int = 50,
                       mixed_precision: bool = True,
                       n_iters: int = 100,
                       seed: int = 0,
                       cuda: bool = True):
    raw = {
        "train": {
            "output_dir": output_dir,
            "batch_size": batch_size,
            "cuda": cuda,
            "mixed_precision": mixed_precision,
            "n_iters": n_iters,
            "n_iters_decay": n_iters,
            "logging": {"freq": 1000000},
            "checkpointing": {"freq": 1000000},
            "gan": {
                "_target_": "ganslate.nn.gans.unpaired.CycleGAN",
                "pool_size": pool_size,
                "generator": {
                    "_target_": "ganslate.nn.generators.Resnet2D",
                    "n_residual_blocks": n_residual_blocks,
                    "ngf": ngf,
                    "in_out_channels": {"AB": [channels, channels]},
                },
                "discriminator": {
                    "_target_": "ganslate.nn.discriminators.PatchGAN2D",
                    "ndf": ndf,
                    "n_layers": n_layers_D,
                    "in_channels": {"B": channels},
                },
                "optimizer": {
                    "lambda_AB": 10.0, "lambda_BA": 10.0,
                    "lambda_identity": 0, "proportion_ssim": 0,
                    "lr_D": 0.0002, "lr_G": 0.0002,
                },
            },
            "seed": seed,
        },
    }
    return init_config(Conf.create(raw), config_class=Config)
