from ganslate_tpu_torch.nn.generators.resnet.resnet2d import Resnet2D, Resnet2DConfig  # noqa: F401
