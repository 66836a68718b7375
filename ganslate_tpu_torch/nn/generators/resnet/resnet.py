"""ResNet encoder-decoder generator, CycleGAN's c7s1-64 design (the JAX
package's `ganslate_tpu/nn/generators/resnet/resnet.py`).

c7s1-ngf (reflection or replication padded) -> two stride-2 convs
(ngf -> 2 ngf -> 4 ngf) -> N residual blocks -> two stride-2 transposed
convs -> c7s1-out -> tanh, with instance norm + ReLU after every conv but
the last.

Parameters are registered in forward order (initial, down0, down1,
res0..res{N-1} with conv1 and conv2 each, up0, up1, out), which is the order
of the original ganslate's modules, so an order-based importer maps its
`.pth` files one to one.

Every norm here runs fused with the ReLU that follows it. The JAX package
applies a separate ReLU after the stem and down norms; fusing it is exact,
because ReLU commutes with the monotone cast from fp32 to the compute dtype.
"""

from typing import Optional

import torch
from torch import nn

from ganslate_tpu_torch.nn.layers import (Conv, ConvTranspose, NormAct, inert_bias,
                                          is_bias_before_norm, make_initializer,
                                          pad_spatial)


class ResidualBlock(nn.Module):

    def __init__(self, features: int, norm_type: str, pad_mode: str, spatial_dims: int,
                 kernel_init, generator: Optional[torch.Generator] = None):
        super().__init__()
        use_bias, inert = is_bias_before_norm(norm_type), inert_bias(norm_type)
        k = (3,) * spatial_dims
        self.conv1 = Conv(features, features, k, padding=1, pad_mode=pad_mode,
                          use_bias=use_bias, bias_inert=inert, kernel_init=kernel_init,
                          generator=generator)
        self.norm1 = NormAct(norm_type, "relu")
        self.conv2 = Conv(features, features, k, padding=1, pad_mode=pad_mode,
                          use_bias=use_bias, bias_inert=inert, kernel_init=kernel_init,
                          generator=generator)
        self.norm2 = NormAct(norm_type)

    def forward(self, x):
        h = self.norm1(self.conv1(x))
        return x + self.norm2(self.conv2(h))


class ResnetGenerator(nn.Module):
    """Takes and returns `(N, C, *spatial)`."""

    spatial_dims = 2
    # 2D reference uses ReflectionPad, 3D uses ReplicationPad.
    pad_mode = "reflect"

    def __init__(self, in_channels: int, out_channels: int, norm_type: str = "instance",
                 n_residual_blocks: int = 9, ngf: int = 64,
                 weight_init_type: str = "normal", weight_init_gain: float = 0.02,
                 use_cells_boundary: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        # `use_cells_boundary` selects a TPU execution form in the JAX package
        # that computes the same function with the same parameters; the port
        # accepts it and runs the plain path.
        del use_cells_boundary
        init = make_initializer(weight_init_type, weight_init_gain)
        # Every conv but the last feeds an instance norm: their biases are
        # inert (`layers.inert_bias`).
        use_bias, inert = is_bias_before_norm(norm_type), inert_bias(norm_type)
        k3 = (3,) * self.spatial_dims
        k7 = (7,) * self.spatial_dims

        self.initial = Conv(in_channels, ngf, k7, padding=0, use_bias=use_bias,
                            bias_inert=inert, kernel_init=init, generator=generator)
        self.initial_norm = NormAct(norm_type, "relu")

        feats = ngf
        for i in range(2):
            setattr(self, f"down{i}", Conv(feats, feats * 2, k3, strides=2, padding=1,
                                           use_bias=use_bias, bias_inert=inert,
                                           kernel_init=init, generator=generator))
            setattr(self, f"down{i}_norm", NormAct(norm_type, "relu"))
            feats *= 2

        self.n_residual_blocks = n_residual_blocks
        for i in range(n_residual_blocks):
            setattr(self, f"res{i}", ResidualBlock(feats, norm_type, self.pad_mode,
                                                   self.spatial_dims, init, generator))

        for i in range(2):
            setattr(self, f"up{i}", ConvTranspose(feats, feats // 2, k3, strides=2,
                                                  padding=1, output_padding=1,
                                                  bias_inert=inert, kernel_init=init,
                                                  generator=generator))
            setattr(self, f"up{i}_norm", NormAct(norm_type, "relu"))
            feats //= 2

        self.out = Conv(feats, out_channels, k7, padding=3, pad_mode=self.pad_mode,
                        use_bias=use_bias, kernel_init=init, generator=generator)

    def forward(self, x):
        h = pad_spatial(x, (3,) * self.spatial_dims, self.pad_mode)
        h = self.initial_norm(self.initial(h))
        for i in range(2):
            h = getattr(self, f"down{i}_norm")(getattr(self, f"down{i}")(h))
        for i in range(self.n_residual_blocks):
            h = getattr(self, f"res{i}")(h)
        for i in range(2):
            h = getattr(self, f"up{i}_norm")(getattr(self, f"up{i}")(h))
        return torch.tanh(self.out(h))
