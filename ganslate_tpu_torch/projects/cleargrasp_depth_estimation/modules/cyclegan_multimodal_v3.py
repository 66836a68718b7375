"""CycleGAN-balanced for multimodal RGB + geometry translation (the twin of
the JAX project's `modules/cyclegan_multimodal_v3.py`): a project's
CycleGAN subclass with a train step of its own.

A = [RGB, normal map] (3 + 3 channels), B = [RGB, depth map] (3 + 1). G_AB
emits a depth map and G_BA a normal map, each conditioned on the domain's
RGB: rec_A = G_BA([RGB_A, fake_B]), rec_B = G_AB([RGB_B, fake_A]). The
discriminators and the cycle losses see the geometry channels only (D_B
the 1-channel depth map, D_A the 3-channel normal map); the visuals' fakes
and reconstructions get 3 zero RGB channels before them, to the data's
channel layout, and so does `infer`'s output. The pools hold the 1- and
3-channel geometry fakes. Spatially sharded as the CycleGAN is: the
channel slices and zero channels act on slabs as on whole images."""

from dataclasses import dataclass
from typing import Optional

import torch

from ganslate_tpu_torch.data.utils.image_pool import ImagePool
from ganslate_tpu_torch.nn.gans.unpaired import cyclegan
from ganslate_tpu_torch.nn.losses.adversarial_loss import AdversarialLoss

from .cyclegan_losses_for_v3 import CycleGANLossesForV3

RGB = 3


@dataclass
class CycleGANMultiModalV3Config(cyclegan.CycleGANConfig):
    """CycleGANMultiModalV3 config."""


class CycleGANMultiModalV3(cyclegan.CycleGAN):

    def init_criterions(self):
        self.criterion_adv = AdversarialLoss(
            self.conf.train.gan.optimizer.adversarial_loss_type)
        self.criterion_G = CycleGANLossesForV3(self.conf)

    def init_pools(self, example_batch):
        # Pools hold the geometry fakes: 1-channel depth maps, 3-channel
        # normal maps.
        generator = torch.Generator().manual_seed(self._seed())
        spatial = tuple(example_batch["B"].shape[1:-1])
        self.pools = {name: ImagePool(self.pool_size, (*spatial, channels), self.compute_dtype,
                                      self.device, generator)
                      for name, channels in (("fake_B", 1), ("fake_A", 3))}

    def train_step(self):
        real_A, real_B = self._batch["A"], self._batch["B"]
        adv = self.criterion_adv
        opt_G = self.optimizers["G"]
        dtype = self.compute_dtype

        # ---- G update; the discriminators are frozen.
        with self.frozen(self.network_groups["D"]):
            params = self.compute_params(["G_AB", "G_BA", "D_B", "D_A"])
            # Forward: the depth map from [RGB_A, normal map]; the normal map
            # reconstructed from [RGB_A, fake depth map].
            fake_B2 = self.apply("G_AB", real_A, params, self.rng)
            real_A1 = real_A[..., :RGB].to(dtype)
            rec_A2 = self.apply("G_BA", torch.cat([real_A1, fake_B2], -1), params, self.rng)
            # Backward: the normal map from [RGB_B, depth map]; the depth map
            # reconstructed.
            fake_A2 = self.apply("G_BA", real_B, params, self.rng)
            real_B1 = real_B[..., :RGB].to(dtype)
            rec_B2 = self.apply("G_AB", torch.cat([real_B1, fake_A2], -1), params, self.rng)

            # Zero RGB channels before the fakes and reconstructions.
            zeros = torch.zeros_like(real_A1)
            visuals = {"real_A": real_A, "real_B": real_B,
                       "fake_B": torch.cat([zeros, fake_B2], -1),
                       "rec_A": torch.cat([zeros, rec_A2], -1),
                       "fake_A": torch.cat([zeros, fake_A2], -1),
                       "rec_B": torch.cat([zeros, rec_B2], -1)}

            losses = {"G_AB": adv(self.apply("D_B", fake_B2, params, self.rng),
                                  target_is_real=True),
                      "G_BA": adv(self.apply("D_A", fake_A2, params, self.rng),
                                  target_is_real=True)}
            losses.update(self.criterion_G(visuals))
            opt_G.zero_grad(set_to_none=True)
            sum(losses[k] for k in sorted(losses)).backward()
        self.step("G")
        visuals = {k: v.detach() for k, v in visuals.items()}

        # ---- Pools and D update on the geometry channels only.
        return self.discriminator_step(losses, visuals, {
            "real_A": real_A[..., RGB:], "real_B": real_B[..., RGB:],
            "fake_A": visuals["fake_A"][..., RGB:], "fake_B": visuals["fake_B"][..., RGB:]})

    @torch.inference_mode()
    def infer(self, x: torch.Tensor, direction: str = "AB",
              out_dtype: Optional[torch.dtype] = torch.float32) -> torch.Tensor:
        """The generator's geometry with 3 zero RGB channels before it."""
        fake = super().infer(x, direction, out_dtype=None)
        y = torch.cat([fake.new_zeros((*fake.shape[:-1], RGB)), fake], -1)
        return y if out_dtype is None else y.to(out_dtype)
