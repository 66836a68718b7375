"""Balanced CycleGAN for HX4-PET synthesis (the twin of the JAX project's
`modules/hx4_cyclegan_balanced.py`): a project's CycleGAN subclass with a
train step of its own.

A = [FDG-PET, pCT] and B = [HX4-PET, ldCT], 2 channels each in the data;
both generators take 2 channels and emit 1, the PET. Each cycle passes the
domain's real CT through as conditioning: rec_A = G_BA([fake_B, pCT]),
rec_B = G_AB([fake_A, ldCT]). The discriminators and the cycle losses see
the PET channel only; the visuals' fakes and reconstructions are padded
with a zero CT channel to the data's channel layout, and so is `infer`'s
output. The pools hold the 1-channel PET fakes. Spatially sharded as the
CycleGAN is: the channel slices and zero channels act on slabs as on
whole volumes."""

from dataclasses import dataclass
from typing import Optional

import torch

from ganslate_tpu_torch.data.utils.image_pool import ImagePool
from ganslate_tpu_torch.nn.gans.unpaired import cyclegan
from ganslate_tpu_torch.nn.losses.adversarial_loss import AdversarialLoss

from .hx4_cyclegan_balanced_losses import HX4CycleGANBalancedLosses


@dataclass
class HX4CycleGANBalancedConfig(cyclegan.CycleGANConfig):
    """HX4CycleGANBalanced config."""


class HX4CycleGANBalanced(cyclegan.CycleGAN):

    def init_criterions(self):
        self.criterion_adv = AdversarialLoss(
            self.conf.train.gan.optimizer.adversarial_loss_type)
        self.criterion_G = HX4CycleGANBalancedLosses(self.conf)

    def init_pools(self, example_batch):
        # Pools hold the 1-channel PET fakes that the discriminators judge.
        generator = torch.Generator().manual_seed(self._seed())
        shape = (*example_batch["B"].shape[1:-1], 1)
        self.pools = {name: ImagePool(self.pool_size, shape, self.compute_dtype, self.device,
                                      generator) for name in ("fake_B", "fake_A")}

    def train_step(self):
        real_A, real_B = self._batch["A"], self._batch["B"]
        adv = self.criterion_adv
        opt_G = self.optimizers["G"]
        dtype = self.compute_dtype

        # ---- G update; the discriminators are frozen.
        with self.frozen(self.network_groups["D"]):
            params = self.compute_params(["G_AB", "G_BA", "D_B", "D_A"])
            # Forward cycle: fake HX4-PET from [FDG-PET, pCT]; FDG-PET
            # reconstructed from [fake HX4-PET, real pCT].
            fake_B1 = self.apply("G_AB", real_A, params, self.rng)
            real_A2 = real_A[..., 1:].to(dtype)
            rec_A1 = self.apply("G_BA", torch.cat([fake_B1, real_A2], -1), params, self.rng)
            # Backward cycle, with [HX4-PET, ldCT].
            fake_A1 = self.apply("G_BA", real_B, params, self.rng)
            real_B2 = real_B[..., 1:].to(dtype)
            rec_B1 = self.apply("G_AB", torch.cat([fake_A1, real_B2], -1), params, self.rng)

            # A zero CT channel on the fakes and reconstructions, so that the
            # visuals have the reals' channel split.
            zeros = torch.zeros_like(real_A2)
            visuals = {"real_A": real_A, "real_B": real_B,
                       "fake_B": torch.cat([fake_B1, zeros], -1),
                       "rec_A": torch.cat([rec_A1, zeros], -1),
                       "fake_A": torch.cat([fake_A1, zeros], -1),
                       "rec_B": torch.cat([rec_B1, zeros], -1)}

            losses = {"G_AB": adv(self.apply("D_B", fake_B1, params, self.rng),
                                  target_is_real=True),
                      "G_BA": adv(self.apply("D_A", fake_A1, params, self.rng),
                                  target_is_real=True)}
            losses.update(self.criterion_G(visuals))
            opt_G.zero_grad(set_to_none=True)
            sum(losses[k] for k in sorted(losses)).backward()
        self.step("G")
        visuals = {k: v.detach() for k, v in visuals.items()}

        # ---- Pools and D update on the PET channel only.
        return self.discriminator_step(losses, visuals, {
            "real_A": real_A[..., :1], "real_B": real_B[..., :1],
            "fake_A": visuals["fake_A"][..., :1], "fake_B": visuals["fake_B"][..., :1]})

    @torch.inference_mode()
    def infer(self, x: torch.Tensor, direction: str = "AB",
              out_dtype: Optional[torch.dtype] = torch.float32) -> torch.Tensor:
        """The generator's 1-channel PET with a zero CT channel after it, so
        that the output has the input's channel layout."""
        fake = super().infer(x, direction, out_dtype=None)
        y = torch.cat([fake, fake.new_zeros((*fake.shape[:-1], x.shape[-1] - 1))], -1)
        return y if out_dtype is None else y.to(out_dtype)
