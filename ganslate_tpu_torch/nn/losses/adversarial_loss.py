"""Adversarial (GAN) objectives (the JAX package's
`ganslate_tpu/nn/losses/adversarial_loss.py`).

Modes lsgan (MSE), vanilla (BCE with logits), wgangp (signed mean) and
nonsaturating (softplus); a dict of predictions (multiscale discriminators)
gives the mean of its losses. Discriminators output logits: no sigmoid
anywhere. Computed in fp32 whatever the compute dtype.
"""

import torch
import torch.nn.functional as F

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
            return (pred - target).square().mean()
        if self.gan_mode == "vanilla":
            target = self.real_label if target_is_real else self.fake_label
            # BCE with logits: max(x, 0) - x * t + log(1 + exp(-|x|))
            return (pred.clamp_min(0) - pred * target
                    + torch.log1p(torch.exp(-pred.abs()))).mean()
        if self.gan_mode == "wgangp":
            return -pred.mean() if target_is_real else pred.mean()
        # nonsaturating
        return F.softplus(-pred if target_is_real else pred).mean()

    def __call__(self, prediction, target_is_real: bool) -> torch.Tensor:
        if isinstance(prediction, dict):
            losses = [self._calculate(p, target_is_real) for p in prediction.values()]
            return torch.stack(losses).mean()
        return self._calculate(prediction, target_is_real)
