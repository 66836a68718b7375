from ganslate_tpu_torch.nn.gans.paired.pix2pix import (  # noqa: F401
    Pix2PixConditionalGAN, Pix2PixConditionalGANConfig)
