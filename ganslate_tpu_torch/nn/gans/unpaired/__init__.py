from ganslate_tpu_torch.nn.gans.unpaired.cut import CUT, CUTConfig  # noqa: F401
from ganslate_tpu_torch.nn.gans.unpaired.cyclegan import CycleGAN, CycleGANConfig  # noqa: F401
from ganslate_tpu_torch.nn.gans.unpaired.revgan import RevGAN, RevGANConfig  # noqa: F401
