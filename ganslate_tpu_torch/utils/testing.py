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
  gaussian blend (`bench.py`'s `bench_vnet3d_sliding_window`).
- `make_revgan_conf`: training the BRaTS RevGAN
  (`projects/brats_mri_sequence_translation/experiments/revgan.yaml`:
  Piresnet3D of depth 5, 32 first-layer channels, memory saving on;
  PatchGAN3D with 2 layers; lambda 5/5, lr_G 4e-4, lr_D 2e-4), with an
  infer section that serves `<output_dir>/checkpoints/<load_iter>.pth`
  through a sliding window of the patch size.
- `make_pix2pix_conf`: training the Cityscapes label->photo Pix2Pix
  (`projects/cityscapes_label2photo/experiments/pix2pix.yaml`: Unet2D with
  7 levels, ngf 128 and dropout; the conditional PatchGAN2D with 4 layers
  and 6 input channels; lr_G 2e-4, lr_D 1e-4, lambda 30); `spatial_dims=3`
  with its overrides gives the HX4 PET Pix2Pix's
  networks (`projects/maastro_hx4_pet_translation/experiments/
  pix2pix.yaml`).
- `make_cut_conf`: training the BRaTS CUT
  (`projects/brats_mri_sequence_translation/experiments/cut.yaml`: the
  BRaTS Vnet3D, PatchNCE on its 4 encoder taps, PatchGAN3D with 2 layers,
  lr_G 4e-4, lr_D 2e-4), with an infer section that serves
  `<output_dir>/checkpoints/<load_iter>.pth` through a sliding window of
  the patch size; `generator` and `discriminator` replace its networks (a
  2D CUT)."""

from typing import Optional

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
                   cuda: bool = True,
                   spatial_sharding: Optional[dict] = None):
    """Infer-mode config: `Inferer(make_vnet_conf(...))` serves
    `<output_dir>/checkpoints/<load_iter>.pth`, through the sliding window,
    or, given `spatial_sharding` (the config section's fields), sharded
    over the ranks."""
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
    if spatial_sharding is not None:
        del raw["infer"]["sliding_window"]
        raw["infer"]["spatial_sharding"] = dict(spatial_sharding)
    return init_config(Conf.create(raw), config_class=Config)


def make_revgan_conf(output_dir: str,
                     depth: int = 5,
                     first_layer_channels: int = 32,
                     ndf: int = 64,
                     n_layers_D: int = 2,
                     patch=(32, 176, 176),
                     cuda: bool = True,
                     mixed_precision: bool = True,
                     use_memory_saving: bool = True,
                     batch_size: int = 1,
                     pool_size: int = 50,
                     load_iter: int = 1):
    raw = {
        "train": {
            "output_dir": output_dir,
            "batch_size": batch_size,
            "cuda": cuda,
            "mixed_precision": mixed_precision,
            "n_iters": 20000,
            "n_iters_decay": 20000,
            "logging": {"freq": 1000000},
            "checkpointing": {"freq": 1000000},
            "gan": {
                "_target_": "ganslate.nn.gans.unpaired.RevGAN",
                "pool_size": pool_size,
                "generator": {
                    "_target_": "ganslate.nn.generators.Piresnet3D",
                    "use_memory_saving": use_memory_saving,
                    "use_inverse": True,
                    "first_layer_channels": first_layer_channels,
                    "depth": depth,
                    "in_out_channels": {"AB": [1, 1]},
                },
                "discriminator": {
                    "_target_": "ganslate.nn.discriminators.PatchGAN3D",
                    "ndf": ndf,
                    "n_layers": n_layers_D,
                    "in_channels": {"B": 1},
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
            "checkpointing": {"load_iter": load_iter},
            "sliding_window": {"window_size": list(patch), "batch_size": 1},
        },
    }
    return init_config(Conf.create(raw), config_class=Config)


def make_pix2pix_conf(output_dir: str,
                      spatial_dims: int = 2,
                      num_downs: int = 7,
                      ngf: int = 128,
                      use_dropout: bool = True,
                      ndf: int = 64,
                      n_layers_D: int = 4,
                      kernel_size_D=None,
                      in_out_channels=(3, 3),
                      lambda_pix2pix: float = 30.0,
                      cuda: bool = True,
                      mixed_precision: bool = True,
                      batch_size: int = 1,
                      n_iters: int = 297500,
                      n_iters_decay: int = 5000,
                      seed: int = 0):
    """The discriminator is conditional: it sees A and B concatenated, so
    its input channels are the sum of the generator's."""
    unet, patchgan = ("Unet2D", "PatchGAN2D") if spatial_dims == 2 else ("Unet3D",
                                                                        "PatchGAN3D")
    discriminator = {
        "_target_": f"ganslate.nn.discriminators.{patchgan}",
        "ndf": ndf,
        "n_layers": n_layers_D,
        "in_channels": {"B": int(sum(in_out_channels))},
    }
    if kernel_size_D is not None:
        discriminator["kernel_size"] = list(kernel_size_D)
    raw = {
        "train": {
            "output_dir": output_dir,
            "batch_size": batch_size,
            "cuda": cuda,
            "mixed_precision": mixed_precision,
            "n_iters": n_iters,
            "n_iters_decay": n_iters_decay,
            "logging": {"freq": 1000000},
            "checkpointing": {"freq": 1000000},
            "gan": {
                "_target_": "ganslate.nn.gans.paired.Pix2PixConditionalGAN",
                "generator": {
                    "_target_": f"ganslate.nn.generators.{unet}",
                    "num_downs": num_downs,
                    "ngf": ngf,
                    "use_dropout": use_dropout,
                    "in_out_channels": {"AB": list(in_out_channels)},
                },
                "discriminator": discriminator,
                "optimizer": {"lr_D": 0.0001, "lr_G": 0.0002,
                              "lambda_pix2pix": lambda_pix2pix},
            },
            "metrics": {"discriminator_evolution": True},
            "seed": seed,
        },
    }
    return init_config(Conf.create(raw), config_class=Config)


def make_cut_conf(output_dir: str,
                  first_layer_channels: int = 16,
                  down_blocks=(2, 2, 3),
                  up_blocks=(3, 3, 3),
                  ndf: int = 64,
                  n_layers_D: int = 2,
                  generator: Optional[dict] = None,
                  discriminator: Optional[dict] = None,
                  patch=(32, 176, 176),
                  nce_layers=(0, 1, 2, 3),
                  mlp_nc: int = 256,
                  num_patches: int = 256,
                  use_equivariance_flip: bool = False,
                  lambda_adv: float = 1.0,
                  lambda_nce: float = 1.0,
                  lambda_nce_idt: float = 0.5,
                  nce_T: float = 0.07,
                  cuda: bool = True,
                  mixed_precision: bool = True,
                  batch_size: int = 1,
                  n_iters: int = 20000,
                  n_iters_decay: int = 20000,
                  seed: int = 0,
                  load_iter: int = 1):
    """`generator` / `discriminator`: a network node (`_target_` and its
    fields, `in_out_channels` / `in_channels` included) in place of the
    Vnet3D / PatchGAN3D of the given widths."""
    if generator is None:
        generator = {"_target_": "ganslate.nn.generators.Vnet3D",
                     "use_memory_saving": False,
                     "use_inverse": False,
                     "first_layer_channels": first_layer_channels,
                     "down_blocks": list(down_blocks),
                     "up_blocks": list(up_blocks),
                     "in_out_channels": {"AB": [1, 1]}}
    if discriminator is None:
        discriminator = {"_target_": "ganslate.nn.discriminators.PatchGAN3D",
                         "ndf": ndf,
                         "n_layers": n_layers_D,
                         "in_channels": {"B": 1}}
    raw = {
        "train": {
            "output_dir": output_dir,
            "batch_size": batch_size,
            "cuda": cuda,
            "mixed_precision": mixed_precision,
            "n_iters": n_iters,
            "n_iters_decay": n_iters_decay,
            "logging": {"freq": 1000000},
            "checkpointing": {"freq": 1000000},
            "gan": {
                "_target_": "ganslate.nn.gans.unpaired.CUT",
                "nce_layers": list(nce_layers),
                "mlp_nc": mlp_nc,
                "num_patches": num_patches,
                "use_equivariance_flip": use_equivariance_flip,
                "generator": generator,
                "discriminator": discriminator,
                "optimizer": {"lr_D": 0.0002, "lr_G": 0.0004, "lambda_adv": lambda_adv,
                              "lambda_nce": lambda_nce, "lambda_nce_idt": lambda_nce_idt,
                              "nce_T": nce_T},
            },
            "seed": seed,
        },
        "infer": {
            "is_deployment": True,
            "checkpointing": {"load_iter": load_iter},
            "sliding_window": {"window_size": list(patch), "batch_size": 1},
        },
    }
    return init_config(Conf.create(raw), config_class=Config)
