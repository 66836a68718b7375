"""Pix2Pix conditional GAN (Isola et al., CVPR 2017; the JAX package's
`nn/gans/paired/pix2pix.py`).

Networks G and D; Adam groups {G} and {D}; no image pool. The
discriminator is conditioned on the input: it sees `cat([real_A, B])` along
the channels. One train step, in the JAX package's order: the G update
with D frozen (gradients still flow through it to fake_B), on the
adversarial loss plus lambda * L1(fake_B, real_B); then the D update on
`cat([real_A, real_B])` and the detached `cat([real_A, fake_B])`, run as one
forward where D is per-sample; metrics from the D step's predictions. The
G's dropout draws from the model's generator `rng` (`BaseGAN.apply`). Infer
mode builds G only, which translates A to B only. Spatially sharded
(`train.spatial_mesh`), D's input is the channel concatenation of this
rank's slabs of A and B, and the L1 term is this rank's share of the whole
sample's mean.
"""

from dataclasses import dataclass, field

import torch

from ganslate_tpu_torch import configs
from ganslate_tpu_torch.nn.gans.base import BaseGAN
from ganslate_tpu_torch.nn.losses.adversarial_loss import AdversarialLoss
from ganslate_tpu_torch.nn.losses.pix2pix_losses import Pix2PixLoss


@dataclass
class OptimizerConfig(configs.base.BaseOptimizerConfig):
    """Pix2Pix optimizer config."""
    lambda_pix2pix: float = 100.0


@dataclass
class Pix2PixConditionalGANConfig(configs.base.BaseGANConfig):
    """Pix2Pix config."""
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)


class Pix2PixConditionalGAN(BaseGAN):

    spatially_sharded = True

    def __init__(self, conf):
        super().__init__(conf)
        network_names = ["G", "D"] if self.is_train else ["G"]
        self.networks = {name: None for name in network_names}
        self.network_groups = {"G": ["G"], "D": ["D"]}

    def init_criterions(self):
        self.criterion_adv = AdversarialLoss(
            self.conf.train.gan.optimizer.adversarial_loss_type)
        self.criterion_pix2pix = Pix2PixLoss(self.conf)

    def init_optimizers(self):
        optimizer_conf = self.conf.train.gan.optimizer
        self.optimizers = {"G": self.make_adam("G", optimizer_conf.lr_G),
                           "D": self.make_adam("D", optimizer_conf.lr_D)}

    def init_pools(self, example_batch):
        self.pools = {}

    def _conditional(self, a, b):
        """D's input: A and B concatenated along the channels, in the compute
        dtype (as the JAX package's fp32 concat then cast: the same values)."""
        return torch.cat([a.to(self.compute_dtype), b.to(self.compute_dtype)], dim=-1)

    def train_step(self):
        real_A, real_B = self._batch["A"], self._batch["B"]
        adv = self.criterion_adv

        # ---- G update; D is frozen.
        with self.frozen(self.network_groups["D"]):
            params = self.compute_params(["G", "D"])
            fake_B = self.apply("G", real_A, params, self.rng)
            pred = self.apply("D", self._conditional(real_A, fake_B), params, self.rng)
            losses = {"G": adv(pred, target_is_real=True),
                      "pix2pix": self.criterion_pix2pix(fake_B, real_B)}
            self.backward(losses["G"] + losses["pix2pix"], "G")
        self.step("G")
        fake_B = fake_B.detach()

        # ---- D update, on the pre-update fake.
        params = self.compute_params(["D"])
        pred_real, pred_fake = self.apply_batched(
            "D", [self._conditional(real_A, real_B), self._conditional(real_A, fake_B)],
            params, self.rng)
        loss_D = adv(pred_real, True) + adv(pred_fake, False)
        self.backward(loss_D, "D")
        self.step("D")

        visuals = {"real_A": real_A, "fake_B": fake_B, "real_B": real_B}
        with torch.no_grad():
            metrics = self.training_metrics.compute_metrics_G(visuals)
            metrics.update(self.training_metrics.compute_metrics_D("D", pred_real, pred_fake))
        losses = {k: v.detach() for k, v in {**losses, "D": loss_D}.items()}
        return losses, visuals, metrics

    def infer(self, x, direction="AB", **kwargs):
        if direction != "AB":
            raise ValueError(f"Pix2Pix only translates A->B, got direction {direction!r}.")
        return super().infer(x, direction, **kwargs)
