"""ResNet encoder-decoder generator, CycleGAN's c7s1-64 design (the JAX
package's `ganslate_tpu/nn/generators/resnet/resnet.py`).

c7s1-ngf (reflection or replication padded) -> two stride-2 convs
(ngf -> 2 ngf -> 4 ngf) -> N residual blocks -> two stride-2 transposed
convs -> c7s1-out -> tanh, with instance norm + ReLU after every conv but
the last.

Parameters are registered in forward order (initial, down0, down1,
res0..res{N-1} with conv1 and conv2 each, up0, up1, out, each conv followed
by its norm's), which is the order of the original ganslate's modules, so an
order-based importer maps its `.pth` files one to one. The norms carry the
JAX package's flax names, which only batch norm's parameters show: the stem
and down norms are bare `BatchNorm_0..2` of the network, the up norms
`NormAct_0`, `NormAct_1`, and a residual block's `NormAct_0`, `NormAct_1`.

Every norm here runs fused with the ReLU that follows it. The JAX package
applies a separate ReLU after the stem and down norms; fusing it is exact,
because ReLU commutes with the monotone cast from fp32 to the compute dtype.

`forward(x, extract_features=[...])` returns CUT's encoder taps instead of
the image, at the flattened layer indices of the original's encoder
(`nce_layers` in the experiment YAMLs): 0 pad | 1 conv | 2 norm | 3 relu |
4, 5, 6 and 7, 8, 9 the same for the two stride-2 convs | 10 + k residual
block k. A tap call splits the stem and down norms from their ReLUs (taps
2, 5 and 8 are norm outputs; the split is exact by the same argument),
gives the stem and down convs' biases their gradient (taps 1, 4 and 7 are
raw conv outputs, bias included, as in the JAX package), and stops after
the last requested tap.
"""

import itertools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ganslate_tpu_torch.nn.layers import (Conv, ConvTranspose, NormAct, batch_norm_or_none,
                                          check_s2d_norm, inert_bias, is_bias_before_norm,
                                          make_initializer, norm_act, pad_spatial)


class ResidualBlock(nn.Module):
    spatially_sharded = True

    def __init__(self, features: int, norm_type: str, pad_mode: str, spatial_dims: int,
                 kernel_init, generator: Optional[torch.Generator] = None):
        super().__init__()
        use_bias, inert = is_bias_before_norm(norm_type), inert_bias(norm_type)
        k = (3,) * spatial_dims
        self.conv1 = Conv(features, features, k, padding=1, pad_mode=pad_mode,
                          use_bias=use_bias, bias_inert=inert, kernel_init=kernel_init,
                          generator=generator)
        self.NormAct_0 = NormAct(norm_type, "relu", features=features)
        self.conv2 = Conv(features, features, k, padding=1, pad_mode=pad_mode,
                          use_bias=use_bias, bias_inert=inert, kernel_init=kernel_init,
                          generator=generator)
        self.NormAct_1 = NormAct(norm_type, features=features)

    def forward(self, x):
        h = self.NormAct_0(self.conv1(x))
        return x + self.NormAct_1(self.conv2(h))


class ResnetGenerator(nn.Module):
    """Takes and returns `(N, C, *spatial)`."""

    spatially_sharded = True
    spatial_dims = 2
    # 2D reference uses ReflectionPad, 3D uses ReplicationPad.
    pad_mode = "reflect"

    def __init__(self, in_channels: int, out_channels: int, norm_type: str = "instance",
                 n_residual_blocks: int = 9, ngf: int = 64,
                 weight_init_type: str = "normal", weight_init_gain: float = 0.02,
                 use_cells_boundary: bool = False, use_s2d_exec: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm_type = norm_type
        # `use_cells_boundary` (2D) and `use_s2d_exec` (3D) select TPU
        # execution forms in the JAX package that compute the same function
        # with the same parameters; the port accepts them and runs the plain
        # path, keeping the checks of `use_s2d_exec`, so that the same calls
        # are refused.
        del use_cells_boundary
        check_s2d_norm(norm_type, 2 if use_s2d_exec else 0)
        self.use_s2d_exec = use_s2d_exec
        init = make_initializer(weight_init_type, weight_init_gain)
        # Every conv but the last feeds an instance norm: their biases are
        # inert (`layers.inert_bias`).
        use_bias, inert = is_bias_before_norm(norm_type), inert_bias(norm_type)
        k3 = (3,) * self.spatial_dims
        k7 = (7,) * self.spatial_dims

        self.initial = Conv(in_channels, ngf, k7, padding=3, pad_mode=self.pad_mode,
                            use_bias=use_bias, bias_inert=inert, kernel_init=init,
                            generator=generator)
        self.BatchNorm_0 = batch_norm_or_none(norm_type, ngf)

        feats = ngf
        for i in range(2):
            setattr(self, f"down{i}", Conv(feats, feats * 2, k3, strides=2, padding=1,
                                           use_bias=use_bias, bias_inert=inert,
                                           kernel_init=init, generator=generator))
            setattr(self, f"BatchNorm_{i + 1}", batch_norm_or_none(norm_type, feats * 2))
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
            setattr(self, f"NormAct_{i}", NormAct(norm_type, "relu", features=feats // 2))
            feats //= 2

        self.out = Conv(feats, out_channels, k7, padding=3, pad_mode=self.pad_mode,
                        use_bias=use_bias, kernel_init=init, generator=generator)

    @property
    def num_feature_levels(self) -> int:
        """Encoder taps: 4 of the stem, 3 of each down conv, one per block."""
        return 10 + self.n_residual_blocks

    def _norm(self, i, h, activation="relu"):
        """Stem (i = 0) or down (i = 1, 2) norm, then `activation`."""
        return norm_act(h, self.norm_type, activation,
                        batch_norm=getattr(self, f"BatchNorm_{i}"))

    def _encoder(self, x):
        """The encoder's activations in tap order, computed as they are read."""
        yield pad_spatial(x, (3,) * self.spatial_dims, self.pad_mode)
        h = x
        for i, conv in enumerate(("initial", "down0", "down1")):
            h = getattr(self, conv)(h, live_bias=True)
            yield h
            h = self._norm(i, h, activation="none")
            yield h
            h = F.relu(h)
            yield h
        for i in range(self.n_residual_blocks):
            h = getattr(self, f"res{i}")(h)
            yield h

    def forward(self, x, extract_features: Optional[Sequence[int]] = None):
        if self.use_s2d_exec:
            if extract_features is not None:
                raise ValueError("use_s2d_exec does not support CUT feature taps; run plain "
                                 "execution for CUT")
            if any(d % 8 for d in x.shape[2:]):
                raise ValueError(f"use_s2d_exec needs spatial extents divisible by 8 (two "
                                 f"stride-2 levels on r=2 cells), got {tuple(x.shape[2:])}")
        if extract_features is not None:
            indices = list(extract_features)
            if any(not 0 <= i < self.num_feature_levels for i in indices):
                raise ValueError(f"feature taps {indices} out of range: the encoder has "
                                 f"{self.num_feature_levels}")
            taps = list(itertools.islice(self._encoder(x), max(indices, default=-1) + 1))
            return [taps[i] for i in indices]
        h = self._norm(0, self.initial(x))
        for i in range(2):
            h = self._norm(i + 1, getattr(self, f"down{i}")(h))
        for i in range(self.n_residual_blocks):
            h = getattr(self, f"res{i}")(h)
        for i in range(2):
            h = getattr(self, f"NormAct_{i}")(getattr(self, f"up{i}")(h))
        return torch.tanh(self.out(h))
