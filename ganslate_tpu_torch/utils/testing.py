"""Programmatic experiment configs (the JAX package's `utils/testing.py`),
built in Python, for driving the model's entry points without a YAML. They
name no dataset: the engines' dataset-driven runs take a YAML (or a config
built with `Conf.create` + `init_config`, as `chip_smoke.py` does).

- `make_cyclegan_conf`: training the horse2zebra CycleGAN
  (`projects/horse2zebra/experiments/default.yaml`: Resnet2D with 9
  residual blocks, 70x70 PatchGAN, lsgan, lambda 10/10).
- `make_vnet_conf`: serving the BRaTS CycleGAN's `G_AB`
  (`projects/brats_mri_sequence_translation/experiments/cyclegan.yaml`:
  Vnet3D, down blocks (2, 2, 3), up blocks (3, 3, 3), 16 first-layer
  channels, 8,070,257 parameters) through the deployment `Inferer`'s
  sliding window over (32, 176, 176) windows, 28 a batch, overlap 0.25,
  gaussian blend (`bench.py`'s `bench_vnet3d_sliding_window`)."""

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


def make_vnet_conf(output_dir: str,
                   load_iter: int = 1,
                   first_layer_channels: int = 16,
                   down_blocks=(2, 2, 3),
                   up_blocks=(3, 3, 3),
                   window_size=(32, 176, 176),
                   sw_batch_size: int = 28,
                   overlap: float = 0.25,
                   mixed_precision: bool = True,
                   wire_dtype: str = "bfloat16",
                   cuda: bool = True):
    """Infer-mode config: `Inferer(make_vnet_conf(...))` serves
    `<output_dir>/checkpoints/<load_iter>.pth`."""
    raw = {
        "train": {
            "output_dir": output_dir,
            "batch_size": 1,
            "cuda": cuda,
            "mixed_precision": mixed_precision,
            "n_iters": 20000,
            "n_iters_decay": 20000,
            "gan": {
                "_target_": "ganslate.nn.gans.unpaired.CycleGAN",
                "generator": {
                    "_target_": "ganslate.nn.generators.Vnet3D",
                    "use_memory_saving": False,
                    "use_inverse": False,
                    "first_layer_channels": first_layer_channels,
                    "down_blocks": list(down_blocks),
                    "up_blocks": list(up_blocks),
                    "in_out_channels": {"AB": [1, 1]},
                },
                "optimizer": {
                    "lambda_AB": 5.0, "lambda_BA": 5.0,
                    "lambda_identity": 0, "proportion_ssim": 0,
                    "lr_D": 0.0002, "lr_G": 0.0004,
                },
            },
            "seed": 0,
        },
        "infer": {
            "is_deployment": True,
            "wire_dtype": wire_dtype,
            "checkpointing": {"load_iter": load_iter},
            "sliding_window": {
                "window_size": list(window_size),
                "batch_size": sw_batch_size,
                "overlap": overlap,
                "mode": "gaussian",
            },
        },
    }
    return init_config(Conf.create(raw), config_class=Config)
