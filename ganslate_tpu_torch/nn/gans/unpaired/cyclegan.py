"""CycleGAN (the JAX package's `nn/gans/unpaired/cyclegan.py`).

Networks G_AB, G_BA, D_B, D_A; Adam groups {G_AB, G_BA} and {D_B, D_A}. One
train step, in the original ganslate's order: both cycles (and the identity
pair when `lambda_identity > 0`), then the G update with the discriminators
frozen (gradients still flow through them to the fakes); then the image
pools, queried with the pre-update fakes, detached; then the D update on
real and pooled fake batches, each D running both as one forward; metrics
from the step's visuals and the D step's predictions. Every network
application gets the model's generator, as the JAX package passes its key:
a network draws from it only where it has train-time randomness (dropout, a
multi-scale discriminator's crops). Infer mode builds G_AB only.
"""

from dataclasses import dataclass, field

import torch

from ganslate_tpu_torch import configs
from ganslate_tpu_torch.data.utils.image_pool import ImagePool
from ganslate_tpu_torch.nn.gans.base import BaseGAN
from ganslate_tpu_torch.nn.losses.adversarial_loss import AdversarialLoss
from ganslate_tpu_torch.nn.losses.cyclegan_losses import CycleGANLosses


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

    spatially_sharded = True

    def __init__(self, conf):
        super().__init__(conf)
        network_names = ["G_AB", "G_BA", "D_B", "D_A"] if self.is_train else ["G_AB"]
        self.networks = {name: None for name in network_names}
        self.network_groups = {"G": ["G_AB", "G_BA"], "D": ["D_B", "D_A"]}
        self.pool_size = conf.train.gan.pool_size if self.is_train else 0

    def init_criterions(self):
        self.criterion_adv = AdversarialLoss(
            self.conf.train.gan.optimizer.adversarial_loss_type)
        self.criterion_G = CycleGANLosses(self.conf)

    def init_optimizers(self):
        optimizer_conf = self.conf.train.gan.optimizer
        self.optimizers = {"G": self.make_adam("G", optimizer_conf.lr_G),
                           "D": self.make_adam("D", optimizer_conf.lr_D)}

    def init_pools(self, example_batch):
        # Pools of fakes in the compute dtype, shaped like the batch's images;
        # one host generator for both, seeded from `train.seed`.
        generator = torch.Generator().manual_seed(self._seed())
        self.pools = {f"fake_{domain}": ImagePool(
            self.pool_size, tuple(example_batch[domain].shape[1:]), self.compute_dtype,
            self.device, generator) for domain in ("B", "A")}

    def train_step(self):
        real_A, real_B = self._batch["A"], self._batch["B"]
        adv = self.criterion_adv

        # ---- G update; the discriminators are frozen.
        with self.frozen(self.network_groups["D"]):
            params = self.compute_params(["G_AB", "G_BA", "D_B", "D_A"])
            fake_B = self.apply("G_AB", real_A, params, self.rng)
            fake_A = self.apply("G_BA", real_B, params, self.rng)
            rec_B = self.apply("G_AB", fake_A, params, self.rng)
            rec_A = self.apply("G_BA", fake_B, params, self.rng)
            visuals = {"real_A": real_A, "fake_B": fake_B, "rec_A": rec_A,
                       "real_B": real_B, "fake_A": fake_A, "rec_B": rec_B}
            if self.criterion_G.is_using_identity():
                visuals["idt_B"] = self.apply("G_AB", real_B, params, self.rng)
                visuals["idt_A"] = self.apply("G_BA", real_A, params, self.rng)

            losses = {"G_AB": adv(self.apply("D_B", fake_B, params, self.rng),
                                  target_is_real=True),
                      "G_BA": adv(self.apply("D_A", fake_A, params, self.rng),
                                  target_is_real=True)}
            losses.update(self.criterion_G(visuals))
            # Summed in sorted key order, as the JAX package's tree_leaves.
            self.backward(sum(losses[k] for k in sorted(losses)), "G")
        self.step("G")
        visuals = {k: v.detach() for k, v in visuals.items()}
        return self.discriminator_step(losses, visuals)

    def discriminator_step(self, losses, visuals, judged=None):
        """The step's second half, after the G update: the pools, the D
        update and the metrics; returns `(losses, visuals, metrics)` with the
        G step's `losses` and detached `visuals`. `judged` holds what the
        discriminators see, `real_A`, `real_B`, `fake_A` and `fake_B`: by
        default the batch and the visuals' fakes; a model whose
        discriminators see some channels only passes those."""
        judged = judged or {"real_A": self._batch["A"], "real_B": self._batch["B"],
                            "fake_A": visuals["fake_A"], "fake_B": visuals["fake_B"]}
        real_A, real_B = judged["real_A"], judged["real_B"]
        adv = self.criterion_adv

        # ---- Pool query with the pre-update fakes.
        fake_B_pooled = self.pools["fake_B"].query(judged["fake_B"])
        fake_A_pooled = self.pools["fake_A"].query(judged["fake_A"])

        # ---- D update.
        params = self.compute_params(["D_B", "D_A"])
        preds = {}
        preds["real_B"], preds["fake_B"] = self.apply_batched("D_B", [real_B, fake_B_pooled],
                                                              params, self.rng)
        preds["real_A"], preds["fake_A"] = self.apply_batched("D_A", [real_A, fake_A_pooled],
                                                              params, self.rng)
        losses_D = {"D_B": adv(preds["real_B"], True) + adv(preds["fake_B"], False),
                    "D_A": adv(preds["real_A"], True) + adv(preds["fake_A"], False)}
        self.backward(losses_D["D_B"] + losses_D["D_A"], "D")
        self.step("D")

        # ---- Metrics.
        with torch.no_grad():
            metrics = self.training_metrics.compute_metrics_G(visuals)
            for name, domain in (("D_B", "B"), ("D_A", "A")):
                metrics.update(self.training_metrics.compute_metrics_D(
                    name, preds[f"real_{domain}"], preds[f"fake_{domain}"]))
        losses = {k: v.detach() for k, v in {**losses, **losses_D}.items()}
        return losses, visuals, metrics
