from ganslate_tpu_torch.nn.gans.unpaired.cyclegan import CycleGAN, CycleGANConfig  # noqa: F401
