"""Pix2Pix pixel-wise loss, lambda * L1(fake_B, real_B), in fp32 (the JAX
package's `ganslate_tpu/nn/losses/pix2pix_losses.py`). Spatially sharded,
the mean is this rank's share of the whole sample's
(`parallel.spatial.global_mean`)."""

from ganslate_tpu_torch.parallel.spatial import global_mean


class Pix2PixLoss:

    def __init__(self, conf):
        self.lambda_pix2pix = conf.train.gan.optimizer.lambda_pix2pix

    def __call__(self, fake_B, real_B):
        return self.lambda_pix2pix * global_mean((fake_B.float() - real_B.float()).abs())
