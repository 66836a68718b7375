"""Val/test-mode configs (the JAX package's `ganslate_tpu/configs/validation_testing.py`)."""

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from ganslate_tpu_torch.configs import base
from ganslate_tpu_torch.configs.omega import MISSING


@dataclass
class SlidingWindowConfig:
    # ROI size for patched inference over large volumes/images.
    window_size: Tuple[int] = MISSING
    # Number of windows run through the network per device step.
    batch_size: int = 1
    # Fractional overlap between adjacent windows.
    overlap: float = 0.25
    # Overlap blending: 'gaussian' (importance-weighted) or 'constant'.
    mode: str = 'gaussian'


@dataclass
class SpatialShardingConfig:
    """Full-volume inference sharded across ranks
    (`ganslate_tpu_torch/parallel/spatial.py`, the JAX package's
    `parallel/spatial.py`): under torchrun every rank holds a slab of the
    volume along `dim` and the whole output comes back on every rank. It
    applies when the spatial group has more than one rank (test and infer:
    the world; val: `train.spatial_mesh`).

    method='gspmd': exact, with halo exchange in the convs and global
    instance-norm statistics (the CycleGAN family's Vnet3D, Resnet2D/3D;
    other networks raise).
    method='halo': neighbour halo exchange of the input with per-shard
    statistics, for any generator."""
    method: str = "gspmd"
    # ('halo' only) input-slice overlap exchanged between neighboring
    # shards; must cover the network's receptive-field half-width.
    halo: int = 8
    # Spatial dimension to shard, 0-based over the spatial axes
    # (0 = depth for NDHWC volumes, 0 = height for NHWC images).
    dim: int = 0


# -------------------------------------------------------------------- metrics


@dataclass
class BaseValTestMetricsConfig:
    ssim: bool = True
    psnr: bool = True
    nmse: bool = True
    mse: bool = True
    mae: bool = True
    # Normalized Mutual Information.
    nmi: bool = False
    # Chi-squared histogram distance.
    histogram_chi2: bool = False
    # Fréchet Inception Distance over the whole val/test set; needs
    # `fid_weights` (see the JAX package's nn/inception.py).
    fid: bool = False
    fid_weights: Optional[str] = None
    # 3D volumes (N, D, H, W, C): compute FID slice-wise — every axial
    # slice is one Inception image (the standard medical workaround; there
    # are no canonical 3D Inception statistics). Off: 3D data skips FID.
    fid_3d_slicewise: bool = True


@dataclass
class ValMetricsConfig(BaseValTestMetricsConfig):
    # Log metrics between original and cycle-reconstructed image.
    cycle_metrics: bool = True


@dataclass
class TestMetricsConfig(BaseValTestMetricsConfig):
    # Also compute metrics comparing input and ground truth.
    compute_over_input: bool = False
    # Save per-image metrics to CSV.
    save_to_csv: bool = True


# -------------------------------------------------------------------- general


@dataclass
class BaseValTestConfig(base.BaseEngineConfig):
    sliding_window: Optional[SlidingWindowConfig] = None
    spatial_sharding: Optional[SpatialShardingConfig] = None
    dataset: Optional[base.BaseDatasetConfig] = None
    # Val/test can run over multiple named datasets.
    multi_dataset: Optional[Dict[str, base.BaseDatasetConfig]] = None


@dataclass
class ValidationConfig(BaseValTestConfig):
    # Validate every `freq` iters.
    freq: int = MISSING
    # After which iteration validation begins.
    start_after: int = 0
    metrics: ValMetricsConfig = field(default_factory=ValMetricsConfig)


@dataclass
class TestConfig(BaseValTestConfig):
    checkpointing: base.CheckpointingConfig = field(default_factory=base.CheckpointingConfig)
    metrics: TestMetricsConfig = field(default_factory=TestMetricsConfig)
