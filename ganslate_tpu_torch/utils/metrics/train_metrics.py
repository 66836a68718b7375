"""Training-time metrics: discriminator output evolution and cycle SSIM (the
JAX package's `ganslate_tpu/utils/metrics/train_metrics.py`). They stay on
the device: reading them is the caller's host sync. Spatially sharded,
each is the whole sample's (`parallel.spatial.total` of the shares)."""

import torch

from ganslate_tpu_torch.nn.losses.utils.ssim import SSIMLoss
from ganslate_tpu_torch.parallel.spatial import global_mean, total


class TrainingMetrics:

    def __init__(self, conf):
        self.output_distributions = bool(conf.train.metrics.discriminator_evolution)
        self.ssim = SSIMLoss() if conf.train.metrics.ssim else None

    def get_output_metric_D(self, out):
        """Mean discriminator output on real or fake, in the output's dtype
        (as the JAX package's `jnp.mean`)."""
        if not self.output_distributions:
            return None
        if isinstance(out, dict):
            return torch.stack([v.mean() for v in out.values()]).mean()
        return total(global_mean(out))

    def get_SSIM_metric(self, input, target):
        if self.ssim is None:
            return None
        # Shift from [-1, 1] to [0, 1] (SSIM needs positive normalized data).
        input = (input + 1) / 2
        target = (target + 1) / 2
        return 1 - total(self.ssim(input, target, data_range=1))

    def compute_metrics_D(self, discriminator, pred_real, pred_fake):
        metrics = {
            f"{discriminator}_real": self.get_output_metric_D(pred_real),
            f"{discriminator}_fake": self.get_output_metric_D(pred_fake),
        }
        return {k: v for k, v in metrics.items() if v is not None}

    def compute_metrics_G(self, visuals):
        metrics_G = {}
        if all(visuals.get(k) is not None for k in ("rec_A", "real_A")):
            m = self.get_SSIM_metric(visuals["real_A"], visuals["rec_A"])
            if m is not None:
                metrics_G["ssim_A"] = m
        if all(visuals.get(k) is not None for k in ("rec_B", "real_B")):
            m = self.get_SSIM_metric(visuals["real_B"], visuals["rec_B"])
            if m is not None:
                metrics_G["ssim_B"] = m
        return metrics_G
