from ganslate_tpu_torch.configs.base import *  # noqa: F401,F403
from ganslate_tpu_torch.configs.config import Config  # noqa: F401
from ganslate_tpu_torch.configs.inference import InferenceConfig  # noqa: F401
from ganslate_tpu_torch.configs.omega import II, MISSING, Conf  # noqa: F401
from ganslate_tpu_torch.configs.training import (TrainCheckpointingConfig,  # noqa: F401
                                                 TrainConfig, TrainMetricsConfig)
from ganslate_tpu_torch.configs.validation_testing import (SlidingWindowConfig,  # noqa: F401
                                                           TestConfig, ValidationConfig)
