"""Base config schemas shared across modes.

The same YAML field surface as the JAX package (`ganslate_tpu/configs/base.py`)
and the original ganslate, so experiment files stay compatible:

- ``cuda`` -> run on ``cuda:0`` (and raise when no GPU is visible); ``false``
  runs on the CPU.
- ``mixed_precision`` -> bfloat16 compute policy: parameters and inputs are
  cast to bf16 for the forward, instance-norm statistics stay fp32.
- ``opt_level`` -> accepted for compatibility.
- ``pin_memory``/``num_workers`` -> host data-plane knobs.
"""

from dataclasses import dataclass, field
from typing import Optional, Tuple

from ganslate_tpu_torch.configs.omega import II, MISSING

# --------------------------------------------------------------------- dataset


@dataclass
class BaseDatasetConfig:
    _target_: str = MISSING
    root: str = MISSING
    # Host-side prefetch worker threads (reference: DataLoader workers).
    num_workers: int = 4
    # Kept for YAML compatibility (host->device transfer of prefetched
    # batches).
    pin_memory: bool = True


# ------------------------------------------- optimizer / generator / framework


@dataclass
class BaseOptimizerConfig:
    adversarial_loss_type: str = "lsgan"
    beta1: float = 0.5
    beta2: float = 0.999
    lr_D: float = 0.0001
    lr_G: float = 0.0002


@dataclass
class GeneratorInOutChannelsConfig:
    # (in_channels, out_channels) for each translation direction.
    AB: Tuple[int, int] = MISSING
    BA: Optional[Tuple[int, int]] = II("train.gan.generator.in_out_channels.AB")


@dataclass
class BaseGeneratorConfig:
    _target_: str = MISSING
    in_out_channels: GeneratorInOutChannelsConfig = field(
        default_factory=GeneratorInOutChannelsConfig)


@dataclass
class DiscriminatorInChannelsConfig:
    B: int = MISSING
    A: Optional[int] = II("train.gan.discriminator.in_channels.B")


@dataclass
class BaseDiscriminatorConfig:
    _target_: str = MISSING
    in_channels: DiscriminatorInChannelsConfig = field(
        default_factory=DiscriminatorInChannelsConfig)


@dataclass
class BaseGANConfig:
    """Base GAN config (reference parity: configs/base.py:51-62)."""
    _target_: str = MISSING
    norm_type: str = "instance"
    weight_init_type: str = "normal"
    weight_init_gain: float = 0.02

    optimizer: BaseOptimizerConfig = MISSING
    generator: BaseGeneratorConfig = MISSING
    # Discriminator optional as it is not used in inference.
    discriminator: Optional[BaseDiscriminatorConfig] = None


# --------------------------------------------------------------------- logging


@dataclass
class WandbConfig:
    project: str = "ganslate-project"
    entity: Optional[str] = None
    run: Optional[str] = None
    # Run id to resume a previous run.
    id: Optional[str] = None


@dataclass
class CheckpointingConfig:
    # Iteration number of the checkpoint to load (continue training / eval / infer).
    load_iter: int = MISSING


@dataclass
class MultiModalitySplitConfig:
    # Log multi-modality images by splitting channels, e.g. A: [1, 3] splits a
    # 4-channel tensor into a 1-channel and a 3-channel image.
    A: Optional[Tuple[int]] = None
    B: Optional[Tuple[int]] = None


@dataclass
class ProfilerConfig:
    """Capture a device trace (view with TensorBoard / Perfetto) over a span
    of training iterations."""
    # Trace iterations [start_iter, end_iter).
    start_iter: int = 10
    end_iter: int = 15
    # Defaults to <output_dir>/profile when null.
    output_dir: Optional[str] = None


@dataclass
class LoggingConfig:
    # How often (in iters) to log during training.
    freq: int = 50
    multi_modality_split: Optional[MultiModalitySplitConfig] = None
    tensorboard: bool = False
    wandb: Optional[WandbConfig] = None
    # Optional intensity window (min, max) applied to logged images.
    image_window: Optional[Tuple[float, float]] = None
    # Optional device profiler over a training-iteration span.
    profiler: Optional[ProfilerConfig] = None


# --------------------------------------------------------------------- engines


@dataclass
class BaseEngineConfig:
    """Params all modes share; non-train modes interpolate training's values
    (reference parity: configs/base.py:111-129)."""

    output_dir: str = II("train.output_dir")
    batch_size: int = II("train.batch_size")
    # True: run on cuda:0 (raises without a GPU); False: run on the CPU.
    cuda: bool = II("train.cuda")
    mixed_precision: bool = II("train.mixed_precision")
    opt_level: str = II("train.opt_level")

    logging: LoggingConfig = II("train.logging")

    dataset: BaseDatasetConfig = MISSING
