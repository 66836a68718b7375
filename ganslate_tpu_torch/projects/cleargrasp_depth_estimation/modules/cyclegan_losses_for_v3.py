"""Cycle losses on the normal map and depth map channels (3:) only,
ignoring RGB (the twin of the JAX project's
`modules/cyclegan_losses_for_v3.py`)."""

from ganslate_tpu_torch.nn.losses import cyclegan_losses


class CycleGANLossesForV3(cyclegan_losses.CycleGANLosses):
    """Cycle consistency restricted to the normal map (A) and the depth map
    (B)."""

    def __init__(self, conf):
        optimizer = conf.train.gan.optimizer
        self.lambda_AB = optimizer.lambda_AB
        self.lambda_BA = optimizer.lambda_BA
        self.criterion_cycle = cyclegan_losses.CycleLoss(optimizer.proportion_ssim)
        self.criterion_idt = None

    def __call__(self, visuals):
        real_A2 = visuals['real_A'][..., 3:]
        real_B2 = visuals['real_B'][..., 3:]
        rec_A2 = visuals['rec_A'][..., 3:]
        rec_B2 = visuals['rec_B'][..., 3:]

        return {
            'cycle_A': self.lambda_AB * self.criterion_cycle(real_A2, rec_A2),
            'cycle_B': self.lambda_BA * self.criterion_cycle(real_B2, rec_B2),
        }
