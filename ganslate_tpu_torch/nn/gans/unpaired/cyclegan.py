"""CycleGAN (the JAX package's `nn/gans/unpaired/cyclegan.py`).

Infer mode builds `G_AB` only. Training (G_BA, the discriminators, the
losses, the image pools and Adam) comes with the training port.
"""

from dataclasses import dataclass, field

from ganslate_tpu_torch import configs
from ganslate_tpu_torch.nn.gans.base import BaseGAN


@dataclass
class OptimizerConfig(configs.base.BaseOptimizerConfig):
    """CycleGAN optimizer config."""
    lambda_AB: float = 10.0
    lambda_BA: float = 10.0
    lambda_identity: float = 0
    proportion_ssim: float = 0.84


@dataclass
class CycleGANConfig(configs.base.BaseGANConfig):
    """CycleGAN config."""
    pool_size: int = 50
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)


class CycleGAN(BaseGAN):

    def __init__(self, conf):
        super().__init__(conf)
        if self.is_train:
            raise NotImplementedError("CycleGAN training is not ported yet; the "
                                      "port serves G_AB (infer mode).")
        self.networks = {"G_AB": None}
