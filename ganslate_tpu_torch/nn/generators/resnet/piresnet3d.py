"""Partially-invertible ResNet 3D generator, RevGAN's generator (the JAX
package's `ganslate_tpu/nn/generators/resnet/piresnet3d.py`).

Separate AB and BA down paths (replicate-padded k5 conv -> norm -> ReLU ->
k3 s2 conv -> norm -> ReLU) and up paths (k3 s2 transposed conv -> norm ->
ReLU -> replicate-padded k5 conv -> tanh) around a shared invertible core
of `depth` additive couplings (`nn/invertible.py`, with Piresnet's
`InvResidualBlock`). `inverse=True` runs BA: the BA down path, the core
inverted, the BA up path. `use_memory_saving` trains the core by
recompute-by-inverse.

Takes and returns `(N, C, *spatial)`. Every ReLU is fused into the norm
before it (exact). The submodules carry the JAX package's names (`down_ab`
with `conv1`, `conv2`; `up_ab` with `convt`, `conv`; `core`; batch norms
`BatchNorm_0`, `BatchNorm_1` in the order the block applies them), so
`utils/flax_weights.load_flax_params` carries its parameter tree, and are
registered in the original ganslate's order (the JAX package's
`torch_param_order_rank`): down_ab, up_ab, down_ba, up_ba, core.

`use_s2d_exec` selects the JAX package's space-to-depth execution form,
which computes the same function with the same parameters; the port runs
the plain computation and keeps its check of the input's extents.

Spatially sharded (`parallel/spatial.py`), its convs exchange halos and its
norms take the whole sample's statistics; the memory-saving core's
backward reruns them (`nn/invertible.py`).
"""

from dataclasses import dataclass
from typing import Optional, Sequence

import torch
from torch import nn

from ganslate_tpu_torch import configs
from ganslate_tpu_torch.configs.omega import MISSING
from ganslate_tpu_torch.nn.invertible import InvertibleSequence, InvResidualBlock
from ganslate_tpu_torch.nn.layers import (Conv, ConvTranspose, batch_norm_or_none, check_s2d_norm,
                                          inert_bias, is_bias_before_norm, make_initializer,
                                          norm_act)
from ganslate_tpu_torch.parallel import spatial


@dataclass
class Piresnet3DConfig(configs.base.BaseGeneratorConfig):
    """Partially-invertible Resnet generator, the RevGAN-compatible ResNet."""
    # Recompute-by-inverse training of the invertible core.
    use_memory_saving: bool = True
    # Build the BA-direction convs, so that the inverse forward exists.
    use_inverse: bool = True
    first_layer_channels: int = 32
    depth: int = MISSING
    # A space-to-depth execution form of the JAX package (same function, same
    # parameters); the port runs the plain computation.
    use_s2d_exec: bool = False


class _DownConv(nn.Module):

    spatially_sharded = True

    def __init__(self, in_channels, features, norm_type, spatial_dims, kernel_init,
                 generator=None):
        super().__init__()
        self.norm_type = norm_type
        use_bias, inert = is_bias_before_norm(norm_type), inert_bias(norm_type)
        self.conv1 = Conv(in_channels, features, (5,) * spatial_dims, padding=2,
                          pad_mode="replicate", use_bias=use_bias, bias_inert=inert,
                          kernel_init=kernel_init, generator=generator)
        self.BatchNorm_0 = batch_norm_or_none(norm_type, features)
        self.conv2 = Conv(features, features * 2, (3,) * spatial_dims, strides=2, padding=1,
                          use_bias=use_bias, bias_inert=inert, kernel_init=kernel_init,
                          generator=generator)
        self.BatchNorm_1 = batch_norm_or_none(norm_type, features * 2)

    def forward(self, x):
        h = norm_act(self.conv1(x), self.norm_type, "relu", batch_norm=self.BatchNorm_0)
        return norm_act(self.conv2(h), self.norm_type, "relu", batch_norm=self.BatchNorm_1)


class _UpConv(nn.Module):

    spatially_sharded = True

    def __init__(self, features, out_channels, norm_type, spatial_dims, kernel_init,
                 generator=None):
        super().__init__()
        self.norm_type = norm_type
        self.convt = ConvTranspose(features * 2, features, (3,) * spatial_dims, strides=2,
                                   padding=1, output_padding=1,
                                   use_bias=is_bias_before_norm(norm_type),
                                   bias_inert=inert_bias(norm_type), kernel_init=kernel_init,
                                   generator=generator)
        self.BatchNorm_0 = batch_norm_or_none(norm_type, features)
        self.conv = Conv(features, out_channels, (5,) * spatial_dims, padding=2,
                         pad_mode="replicate", kernel_init=kernel_init, generator=generator)

    def forward(self, x):
        h = norm_act(self.convt(x), self.norm_type, "relu", batch_norm=self.BatchNorm_0)
        return torch.tanh(self.conv(h))


class Piresnet3D(nn.Module):

    spatially_sharded = True
    spatial_dims = 3

    def __init__(self, in_channels: int, out_channels: int, depth: int,
                 norm_type: str = "instance", first_layer_channels: int = 64,
                 use_memory_saving: bool = True, use_inverse: bool = True,
                 use_s2d_exec: bool = False, weight_init_type: str = "normal",
                 weight_init_gain: float = 0.02,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_s2d_norm(norm_type, 2 if use_s2d_exec else 0)
        # Read by `BaseGAN._batch_fusable`.
        self.norm_type = norm_type
        self.use_inverse = use_inverse
        self.use_s2d_exec = use_s2d_exec
        init = make_initializer(weight_init_type, weight_init_gain)
        flc, sd = first_layer_channels, self.spatial_dims
        self.down_ab = _DownConv(in_channels, flc, norm_type, sd, init, generator)
        self.up_ab = _UpConv(flc, out_channels, norm_type, sd, init, generator)
        if use_inverse:
            self.down_ba = _DownConv(in_channels, flc, norm_type, sd, init, generator)
            self.up_ba = _UpConv(flc, out_channels, norm_type, sd, init, generator)
        self.core = InvertibleSequence(
            depth, lambda: InvResidualBlock(flc, norm_type, sd, init, generator),
            use_memory_saving)

    def forward(self, x, inverse: bool = False,
                extract_features: Optional[Sequence[int]] = None):
        if inverse and not self.use_inverse:
            raise ValueError(
                "Trying to perform inverse forward while `use_inverse` flag is turned off.")
        extents = spatial.global_extent(x.shape)
        if self.use_s2d_exec and any(d % 4 for d in extents):
            raise ValueError(f"use_s2d_exec needs spatial extents divisible by 4, "
                             f"got {extents}.")
        suffix = "ba" if inverse else "ab"
        h = getattr(self, f"down_{suffix}")(x)
        feats = [h]
        h = self.core(h, inverse)
        feats.append(h)
        if extract_features is not None:
            # Coarse encoder taps: 0 = the down path's output, 1 = the core's.
            return [feats[i] for i in extract_features]
        return getattr(self, f"up_{suffix}")(h)
