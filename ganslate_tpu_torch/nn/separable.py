"""Separable 3D convolutions (the JAX package's `ganslate_tpu/nn/separable.py`):
a (1, kh, kw) in-plane conv followed by a (kd, 1, 1) through-plane conv, and
the transposed pair.

This is a spatial factorisation across all channels (both factors mix the
channels), not a channelwise depthwise conv. The factors carry flax's names,
`depthwise` and `pointwise`, so `utils/flax_weights.load_flax_params` carries
the JAX tree, and are registered in that order, the original ganslate's.

Only the last factor's bias may be inert (`bias_inert`): the first factor's
bias reaches the following norm through the second conv's zero padding, so it
does not cancel there.

Spatially sharded, each factor is a `Conv` or `ConvTranspose`, which
exchanges its own halo along the sharded dim (dim 0 of the spatial axes):
the in-plane factor's (1, kh, kw) window needs none, the through-plane
factor's (kd, 1, 1) window the rows it reaches.
"""

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ganslate_tpu_torch.nn.layers import Conv, ConvTranspose


def _triple(v) -> Tuple[int, int, int]:
    return (v,) * 3 if isinstance(v, int) else tuple(v)


class _Separable(nn.Module):
    spatially_sharded = True
    layer = Conv

    def __init__(self, in_features: int, features: int,
                 kernel_size: Union[int, Sequence[int]],
                 strides: Union[int, Sequence[int]] = 1,
                 padding: Union[int, Sequence[int]] = 0, use_bias: bool = True,
                 bias_inert: bool = False, kernel_init=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        k, s, p = _triple(kernel_size), _triple(strides), _triple(padding)
        self.depthwise = self.layer(in_features, features, (1, k[1], k[2]),
                                    strides=(1, s[1], s[2]), padding=(0, p[1], p[2]),
                                    use_bias=use_bias, kernel_init=kernel_init,
                                    generator=generator)
        self.pointwise = self.layer(features, features, (k[0], 1, 1), strides=(s[0], 1, 1),
                                    padding=(p[0], 0, 0), use_bias=use_bias,
                                    bias_inert=bias_inert, kernel_init=kernel_init,
                                    generator=generator)

    def forward(self, x):
        return self.pointwise(self.depthwise(x))


class SeparableConv3d(_Separable):
    layer = Conv


class SeparableConvTranspose3d(_Separable):
    layer = ConvTranspose
