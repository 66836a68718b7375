"""Inference-mode config (the JAX package's `ganslate_tpu/configs/inference.py`)."""

from dataclasses import dataclass, field
from typing import Optional

from ganslate_tpu_torch.configs import base, validation_testing


@dataclass
class InferenceConfig(base.BaseEngineConfig):
    # Deployment mode: no loader/tracker; caller invokes Inferer.infer() directly.
    is_deployment: bool = False
    # Wire dtype for host<->device transfers in serving. The network
    # computes in bf16 under mixed precision, so shipping float32 inputs as
    # bf16 halves the transfer bytes and the input rounding is bit-identical
    # to the in-network cast; predictions come back as bf16.
    # Set "float32" for full-precision transfers.
    wire_dtype: str = "bfloat16"
    dataset: Optional[base.BaseDatasetConfig] = None
    sliding_window: Optional[validation_testing.SlidingWindowConfig] = None
    spatial_sharding: Optional[validation_testing.SpatialShardingConfig] = None
    checkpointing: base.CheckpointingConfig = field(default_factory=base.CheckpointingConfig)
