"""Cycle losses on the PET channel (channel 0) only, ignoring CT (the twin
of the JAX project's `modules/hx4_cyclegan_balanced_losses.py`)."""

from ganslate_tpu_torch.nn.losses import cyclegan_losses


class HX4CycleGANBalancedLosses(cyclegan_losses.CycleGANLosses):
    """Cycle consistency restricted to the FDG-PET (A) and HX4-PET (B)
    channels; the CT channels carry no cycle loss."""

    def __init__(self, conf):
        optimizer = conf.train.gan.optimizer
        self.lambda_AB = optimizer.lambda_AB
        self.lambda_BA = optimizer.lambda_BA
        self.criterion_cycle = cyclegan_losses.CycleLoss(optimizer.proportion_ssim)
        self.criterion_idt = None

    def __call__(self, visuals):
        real_A1 = visuals['real_A'][..., :1]
        real_B1 = visuals['real_B'][..., :1]
        rec_A1 = visuals['rec_A'][..., :1]
        rec_B1 = visuals['rec_B'][..., :1]

        return {
            'cycle_A': self.lambda_AB * self.criterion_cycle(real_A1, rec_A1),
            'cycle_B': self.lambda_BA * self.criterion_cycle(real_B1, rec_B1),
        }
