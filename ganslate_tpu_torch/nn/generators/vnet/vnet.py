"""Rank-generic partially-invertible V-Net generator (the JAX package's
`ganslate_tpu/nn/generators/vnet/vnet.py`).

InputBlock (k5 conv + norm + the input repeated over the channels as a
residual + PReLU); per level a DownBlock (k2 s2 conv + norm + PReLU, an
invertible coupling core, residual + PReLU); per level an UpBlock (k2 s2
transposed conv to half width + norm + PReLU, concatenated with the skip,
coupling core, residual + PReLU); OutBlock (k5 conv + norm + PReLU + k1 conv
+ tanh). With `use_inverse`, separate BA in, out, down and up convs and an
inverse forward through the shared cores (RevGAN).

Takes and returns `(N, C, *spatial)`. The submodules carry the JAX
package's names (`in_ab`, `downs_0`, `core`, `PReLU_0`, ...), so
`utils/flax_weights.load_flax_params` carries its parameter tree. They are
registered in the original ganslate's order (the JAX package's
`torch_param_order_rank`): in_ab, in_ba, out_ab, out_ba, the down blocks,
the up blocks, and inside a block its AB conv, its BA conv, the core, the
PReLU.

`use_s2d_exec` selects the JAX package's space-to-depth execution form,
which computes the same function with the same parameters; the port runs
the plain computation and keeps its check of the input's extents, so that
the same configs are refused.
"""

from typing import Optional, Sequence

import torch
from torch import nn

from ganslate_tpu_torch.nn.invertible import InvertibleSequence
from ganslate_tpu_torch.nn.layers import (Conv, ConvTranspose, PReLU, apply_norm_s2d,
                                          inert_bias, is_bias_before_norm, make_initializer)


def _conv(in_features, features, k, spatial_dims, norm_type, kernel_init, generator, **kw):
    """A conv before a norm: its bias is kept, and inert (`layers.inert_bias`)."""
    return Conv(in_features, features, (k,) * spatial_dims,
                use_bias=is_bias_before_norm(norm_type), bias_inert=inert_bias(norm_type),
                kernel_init=kernel_init, generator=generator, **kw)


def _norm_prelu(norm_type, h, prelu):
    return prelu(apply_norm_s2d(norm_type, h))


class VnetInvBlock(nn.Module):
    """The half-width function inside the couplings: k5 conv + norm + PReLU."""

    def __init__(self, features, norm_type, spatial_dims, kernel_init, generator=None):
        super().__init__()
        self.norm_type = norm_type
        self.conv = _conv(features, features, 5, spatial_dims, norm_type, kernel_init,
                          generator, padding=2)
        self.PReLU_0 = PReLU(features)

    def forward(self, x):
        return _norm_prelu(self.norm_type, self.conv(x), self.PReLU_0)


class InputBlock(nn.Module):

    def __init__(self, in_channels, out_channels, norm_type, spatial_dims, kernel_init,
                 generator=None):
        super().__init__()
        self.norm_type = norm_type
        self.n_repeats = out_channels // in_channels
        self.conv1 = _conv(in_channels, out_channels, 5, spatial_dims, norm_type, kernel_init,
                           generator, padding=2)
        self.PReLU_0 = PReLU(out_channels)

    def forward(self, x):
        out = apply_norm_s2d(self.norm_type, self.conv1(x))
        # The input repeated over the channels (`jnp.tile`); one channel
        # broadcasts, without a copy.
        residual = x if x.shape[1] == 1 else x.repeat(1, self.n_repeats, *(1,) * (x.ndim - 2))
        return self.PReLU_0(out + residual)


class _DownConv(nn.Module):

    def __init__(self, in_features, features, norm_type, spatial_dims, kernel_init,
                 generator=None):
        super().__init__()
        self.norm_type = norm_type
        self.conv = _conv(in_features, features, 2, spatial_dims, norm_type, kernel_init,
                          generator, strides=2)
        self.PReLU_0 = PReLU(features)

    def forward(self, x):
        return _norm_prelu(self.norm_type, self.conv(x), self.PReLU_0)


class _UpConv(nn.Module):

    def __init__(self, in_features, features, norm_type, spatial_dims, kernel_init,
                 generator=None):
        super().__init__()
        self.norm_type = norm_type
        self.convt = ConvTranspose(in_features, features, (2,) * spatial_dims, strides=2,
                                   use_bias=is_bias_before_norm(norm_type),
                                   bias_inert=inert_bias(norm_type), kernel_init=kernel_init,
                                   generator=generator)
        self.PReLU_0 = PReLU(features)

    def forward(self, x):
        return _norm_prelu(self.norm_type, self.convt(x), self.PReLU_0)


def _core(channels, n_blocks, norm_type, spatial_dims, use_memory_saving, kernel_init,
          generator):
    return InvertibleSequence(
        n_blocks, lambda: VnetInvBlock(channels // 2, norm_type, spatial_dims, kernel_init,
                                       generator),
        use_memory_saving)


class DownBlock(nn.Module):

    def __init__(self, in_channels, n_conv_blocks, norm_type, spatial_dims, use_memory_saving,
                 use_inverse, kernel_init, generator=None):
        super().__init__()
        out = 2 * in_channels
        args = (norm_type, spatial_dims, kernel_init, generator)
        self.down_conv_ab = _DownConv(in_channels, out, *args)
        if use_inverse:
            self.down_conv_ba = _DownConv(in_channels, out, *args)
        self.core = _core(out, n_conv_blocks, norm_type, spatial_dims, use_memory_saving,
                          kernel_init, generator)
        self.relu = PReLU(out)

    def forward(self, x, inverse: bool = False):
        down = (self.down_conv_ba if inverse else self.down_conv_ab)(x)
        return self.relu(self.core(down, inverse) + down)


class UpBlock(nn.Module):

    def __init__(self, in_channels, out_channels, n_conv_blocks, norm_type, spatial_dims,
                 use_memory_saving, use_inverse, kernel_init, generator=None):
        super().__init__()
        args = (norm_type, spatial_dims, kernel_init, generator)
        self.up_conv_ab = _UpConv(in_channels, out_channels // 2, *args)
        if use_inverse:
            self.up_conv_ba = _UpConv(in_channels, out_channels // 2, *args)
        self.core = _core(out_channels, n_conv_blocks, norm_type, spatial_dims,
                          use_memory_saving, kernel_init, generator)
        self.relu = PReLU(out_channels)

    def forward(self, x, skipx, inverse: bool = False):
        up = (self.up_conv_ba if inverse else self.up_conv_ab)(x)
        xcat = torch.cat([up, skipx], dim=1)
        del up
        return self.relu(self.core(xcat, inverse) + xcat)


class OutBlock(nn.Module):

    def __init__(self, in_channels, out_channels, norm_type, spatial_dims, kernel_init,
                 generator=None):
        super().__init__()
        self.norm_type = norm_type
        self.conv1 = _conv(in_channels, in_channels, 5, spatial_dims, norm_type, kernel_init,
                           generator, padding=2)
        self.PReLU_0 = PReLU(in_channels)
        self.conv2 = Conv(in_channels, out_channels, (1,) * spatial_dims,
                          kernel_init=kernel_init, generator=generator)

    def forward(self, x):
        h = _norm_prelu(self.norm_type, self.conv1(x), self.PReLU_0)
        return torch.tanh(self.conv2(h))


class VnetGenerator(nn.Module):
    """Takes and returns `(N, C, *spatial)`; `spatial_dims` is set by
    `Vnet3D` and `Vnet2D`."""

    spatial_dims = 3

    def __init__(self, in_channels: int, out_channels: int, norm_type: str = "instance",
                 first_layer_channels: int = 16,
                 down_blocks: Sequence[int] = (1, 2, 3, 2),
                 up_blocks: Sequence[int] = (2, 2, 1, 1),
                 use_memory_saving: bool = True, use_inverse: bool = True,
                 is_separable: bool = False,
                 enable_attention_block: Optional[Sequence[bool]] = None,
                 use_s2d_exec: bool = False,
                 weight_init_type: str = "normal", weight_init_gain: float = 0.02,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if first_layer_channels % in_channels:
            raise ValueError("`first_layer_channels` has to be divisible by `in_channels`.")
        if len(down_blocks) != len(up_blocks):
            raise ValueError("Number of `down_blocks` and `up_blocks` has to be equal.")
        if is_separable:
            raise NotImplementedError("Separable convolutions (`is_separable`) are not "
                                      "ported yet: they come with the rest of the network zoo.")
        if enable_attention_block and any(enable_attention_block):
            raise NotImplementedError("The self-attention V-Net (`enable_attention_block`) "
                                      "is not ported yet: it comes with the rest of the "
                                      "network zoo.")
        # Read by `BaseGAN._batch_fusable`.
        self.norm_type = norm_type
        self.use_inverse = use_inverse
        self.use_s2d_exec = use_s2d_exec
        self.n_levels = len(down_blocks)
        init = make_initializer(weight_init_type, weight_init_gain)
        flc, sd = first_layer_channels, self.spatial_dims
        args = (norm_type, sd, init, generator)

        self.in_ab = InputBlock(in_channels, flc, *args)
        if use_inverse:
            self.in_ba = InputBlock(in_channels, flc, *args)
        self.out_ab = OutBlock(flc * 2, out_channels, *args)
        if use_inverse:
            self.out_ba = OutBlock(flc * 2, out_channels, *args)

        for i, n_convs in enumerate(down_blocks):
            setattr(self, f"downs_{i}", DownBlock(flc * 2 ** i, n_convs, norm_type, sd,
                                                  use_memory_saving, use_inverse, init,
                                                  generator))
        # Level widths from the bottom up: the first up block keeps its width,
        # each later one halves it.
        widths = [flc * 2 ** (self.n_levels - i) for i in range(self.n_levels)]
        for i, n_convs in enumerate(up_blocks):
            in_w, out_w = widths[max(i - 1, 0)], widths[i]
            setattr(self, f"ups_{i}", UpBlock(in_w, out_w, n_convs, norm_type, sd,
                                              use_memory_saving, use_inverse, init, generator))

    def forward(self, x, inverse: bool = False):
        if inverse and not self.use_inverse:
            raise ValueError(
                "Trying to perform inverse forward while `use_inverse` flag is turned off.")
        if self.use_s2d_exec:
            multiple = 2 ** (self.n_levels + 1)
            if any(d % multiple for d in x.shape[2:]):
                raise ValueError(f"use_s2d_exec needs spatial extents divisible by "
                                 f"2^(levels+1)={multiple}, got {tuple(x.shape[2:])}.")
        suffix = "ba" if inverse else "ab"
        # The input block's output is also the last up block's skip.
        skips = [getattr(self, f"in_{suffix}")(x)]
        for i in range(self.n_levels):
            skips.append(getattr(self, f"downs_{i}")(skips[-1], inverse))
        out = skips.pop()
        for i in range(self.n_levels):
            out = getattr(self, f"ups_{i}")(out, skips.pop(), inverse)
        return getattr(self, f"out_{suffix}")(out)
