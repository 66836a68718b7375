"""Root config (the JAX package's `ganslate_tpu/configs/config.py`)."""

from dataclasses import dataclass, field
from typing import Any, Optional

from ganslate_tpu_torch.configs.inference import InferenceConfig
from ganslate_tpu_torch.configs.training import TrainConfig
from ganslate_tpu_torch.configs.validation_testing import TestConfig, ValidationConfig


@dataclass
class Config:
    # Path of the project dir whose classes (`project.*`) become importable.
    project: Optional[Any] = None
    # Mode handled internally: train | val | test | infer.
    mode: str = "train"

    train: TrainConfig = field(default_factory=TrainConfig)
    val: Optional[ValidationConfig] = None
    test: Optional[TestConfig] = None
    infer: Optional[InferenceConfig] = None
