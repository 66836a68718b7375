"""CycleGAN generator losses: cycle consistency (L1, optionally mixed with
the SSIM distance) and identity (the JAX package's
`ganslate_tpu/nn/losses/cyclegan_losses.py`). Functions of the visuals dict
of channels-last tensors; fp32. Spatially sharded, each mean is this rank's
share of the whole sample's (`parallel.spatial.global_mean`).
"""

from ganslate_tpu_torch.nn.losses.utils.ssim import SSIMLoss
from ganslate_tpu_torch.parallel.spatial import global_mean


def l1(a, b):
    return global_mean((a.float() - b.float()).abs())


class CycleLoss:
    """L1 cycle consistency, optionally mixed with the SSIM distance:
    alpha * SSIM + (1 - alpha) * L1, with data shifted from [-1, 1] to
    [0, 1] for SSIM."""

    def __init__(self, proportion_ssim: float):
        self.ssim_criterion = SSIMLoss() if proportion_ssim > 0 else None
        self.alpha = proportion_ssim
        self.beta = 1 - proportion_ssim

    def __call__(self, real, reconstructed):
        loss_l1 = l1(reconstructed, real)
        if self.ssim_criterion is None:
            return loss_l1
        ssim_real = (real + 1) / 2
        ssim_rec = (reconstructed + 1) / 2
        loss_ssim = self.ssim_criterion(ssim_rec, ssim_real, data_range=1)
        return self.alpha * loss_ssim + self.beta * loss_l1


class IdentityLoss:

    def __init__(self, lambda_identity: float):
        self.lambda_identity = lambda_identity

    def __call__(self, idt, real):
        return l1(idt, real) * self.lambda_identity


class CycleGANLosses:
    """Cycle and identity losses over the visuals dict (keys real_A/B,
    rec_A/B, idt_A/B); returns a dict of named scalar losses."""

    def __init__(self, conf):
        optimizer = conf.train.gan.optimizer
        self.lambda_AB = optimizer.lambda_AB
        self.lambda_BA = optimizer.lambda_BA
        lambda_identity = optimizer.lambda_identity
        proportion_ssim = optimizer.proportion_ssim

        self.criterion_cycle = CycleLoss(proportion_ssim)
        self.criterion_idt = IdentityLoss(lambda_identity) if lambda_identity > 0 else None

    def is_using_identity(self) -> bool:
        return self.criterion_idt is not None

    def __call__(self, visuals) -> dict:
        losses = {}
        # || G_BA(G_AB(real_A)) - real_A ||
        losses["cycle_A"] = self.lambda_AB * self.criterion_cycle(
            visuals["real_A"], visuals["rec_A"])
        # || G_AB(G_BA(real_B)) - real_B ||
        losses["cycle_B"] = self.lambda_BA * self.criterion_cycle(
            visuals["real_B"], visuals["rec_B"])

        if self.criterion_idt:
            if visuals.get("idt_A") is None or visuals.get("idt_B") is None:
                raise ValueError(
                    "idt_A and/or idt_B is not computed but the identity loss is defined.")
            losses["idt_B"] = self.lambda_AB * self.criterion_idt(
                visuals["idt_B"], visuals["real_B"])
            losses["idt_A"] = self.lambda_BA * self.criterion_idt(
                visuals["idt_A"], visuals["real_A"])
        return losses
