"""Adversarial (GAN) objectives (the JAX package's
`ganslate_tpu/nn/losses/adversarial_loss.py`).

Modes lsgan (MSE), vanilla (BCE with logits), wgangp (signed mean) and
nonsaturating (softplus); a dict of predictions (multiscale discriminators)
gives the mean of its losses. Discriminators output logits: no sigmoid
anywhere. Computed in fp32 whatever the compute dtype. Each mean is
`parallel.spatial.global_mean`: spatially sharded, this rank's share of the
mean over the whole sample.
"""

import torch
import torch.nn.functional as F

from ganslate_tpu_torch.parallel.spatial import global_mean

_MODES = ("lsgan", "vanilla", "wgangp", "nonsaturating")


class AdversarialLoss:
    """`loss = criterion_adv(prediction, target_is_real)`."""

    def __init__(self, gan_mode: str, target_real_label: float = 1.0,
                 target_fake_label: float = 0.0):
        if gan_mode not in _MODES:
            raise NotImplementedError(f"GAN mode {gan_mode} not implemented.")
        self.gan_mode = gan_mode
        self.real_label = target_real_label
        self.fake_label = target_fake_label

    def _calculate(self, prediction: torch.Tensor, target_is_real: bool) -> torch.Tensor:
        pred = prediction.float()
        if self.gan_mode == "lsgan":
            target = self.real_label if target_is_real else self.fake_label
            return global_mean((pred - target).square())
        if self.gan_mode == "vanilla":
            target = self.real_label if target_is_real else self.fake_label
            # BCE with logits: max(x, 0) - x * t + log(1 + exp(-|x|))
            return global_mean(pred.clamp_min(0) - pred * target
                               + torch.log1p(torch.exp(-pred.abs())))
        if self.gan_mode == "wgangp":
            return -global_mean(pred) if target_is_real else global_mean(pred)
        # nonsaturating
        return global_mean(F.softplus(-pred if target_is_real else pred))

    def __call__(self, prediction, target_is_real: bool) -> torch.Tensor:
        if isinstance(prediction, dict):
            losses = [self._calculate(p, target_is_real) for p in prediction.values()]
            return torch.stack(losses).mean()
        return self._calculate(prediction, target_is_real)
