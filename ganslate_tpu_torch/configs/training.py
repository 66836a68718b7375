"""Training-mode config (the JAX package's `ganslate_tpu/configs/training.py`)."""

from dataclasses import dataclass, field
from typing import Optional

from ganslate_tpu_torch.configs import base
from ganslate_tpu_torch.configs.omega import MISSING


@dataclass
class TrainMetricsConfig:
    # Log mean discriminator outputs on real/fake (D evolution).
    discriminator_evolution: bool = False
    # Log cycle-consistency SSIM during training.
    ssim: bool = False


@dataclass
class TrainCheckpointingConfig(base.CheckpointingConfig):
    # How often (in iters) to save checkpoints during training.
    freq: int = 2000
    # After which iteration checkpointing begins.
    start_after: int = 0
    # If False, saved optimizer state is not loaded when continuing training.
    load_optimizers: bool = True
    # Iteration number of the checkpoint to load for continuing training.
    load_iter: Optional[int] = None


@dataclass
class PerfConfig:
    """The JAX package's perf-flag overrides (`ganslate_tpu/flags.py`).
    Accepted so that its YAMLs load unchanged; the port reads none of them,
    because those switches select XLA program forms that the PyTorch port
    does not have."""
    bias_inert: Optional[bool] = None
    pad_custom_vjp: Optional[bool] = None
    pad_fwd_onepass: Optional[bool] = None
    polyphase_2d: Optional[bool] = None
    transpose_custom_grad: Optional[bool] = None
    fused_d_forward: Optional[bool] = None
    paired_apply: Optional[bool] = None
    scan_unroll: Optional[int] = None
    plain_unroll_full: Optional[bool] = None


@dataclass
class TrainConfig(base.BaseEngineConfig):
    # -------- overriding BaseEngineConfig defaults --------
    output_dir: str = MISSING
    batch_size: int = MISSING
    cuda: bool = True
    mixed_precision: bool = False
    opt_level: str = "O1"
    checkpointing: TrainCheckpointingConfig = field(default_factory=TrainCheckpointingConfig)
    logging: base.LoggingConfig = field(default_factory=base.LoggingConfig)
    # ------------------------------------------------------

    # Iterations at full learning rate.
    n_iters: int = MISSING
    # Final iterations over which learning rates decay linearly to zero.
    n_iters_decay: int = MISSING

    gan: base.BaseGANConfig = MISSING

    seed: Optional[int] = None
    metrics: TrainMetricsConfig = field(default_factory=TrainMetricsConfig)

    # Accepted for YAML compatibility and read by nothing (see PerfConfig).
    perf: PerfConfig = field(default_factory=PerfConfig)

    # Train steps per dispatch in the JAX package (logged as chunk means).
    # The port runs one step per call: a train-mode model raises for > 1.
    steps_per_dispatch: int = 1

    # Spatially sharded training: this many ranks share each sample, each
    # holding a slab of its first spatial dim (the rest of the world splits
    # the batch), with halo exchange in the convs and whole-sample norm
    # statistics, so gradients equal the unsharded ones
    # (`ganslate_tpu_torch/parallel/spatial.py`). Launch a multiple of it
    # under torchrun. The CycleGAN family on the Vnet3D, Resnet2D/3D and
    # PatchGAN2D/3D; other families and networks raise.
    spatial_mesh: Optional[int] = None
