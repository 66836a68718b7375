"""Rank-generic partially-invertible V-Net generator (the JAX package's
`ganslate_tpu/nn/generators/vnet/vnet.py`).

InputBlock (k5 conv + norm + the input repeated over the channels as a
residual + PReLU); per level a DownBlock (k2 s2 conv + norm + PReLU, an
invertible coupling core, residual + PReLU); per level an UpBlock (k2 s2
transposed conv to half width + norm + PReLU, concatenated with the skip,
coupling core, residual + PReLU); OutBlock (k5 conv + norm + PReLU + k1 conv
+ tanh). With `use_inverse`, separate BA in, out, down and up convs and an
inverse forward through the shared cores (RevGAN). `is_separable` makes every
conv the separable pair of `nn/separable.py` (3D only, the 1x1x1 output conv
too); `enable_attention_block` puts a `SelfAttentionBlock` after the down
blocks it flags (`attns_{i}`), applied in both directions: the inverse pass
does not invert it, and its output is the level's CUT tap and skip.

Takes and returns `(N, C, *spatial)`. The submodules carry the JAX
package's names (`in_ab`, `downs_0`, `core`, `PReLU_0`, and with batch norm
each block's `BatchNorm_0`, ...), so
`utils/flax_weights.load_flax_params` carries its parameter tree. They are
registered in the original ganslate's order (the JAX package's
`torch_param_order_rank`): in_ab, in_ba, out_ab, out_ba, the down blocks,
the attention blocks, the up blocks, and inside a block its AB conv, its BA conv, the core, the
PReLU; inside a conv block its conv, its batch norm, its PReLU.

`forward(x, extract_features=[...])` returns CUT's encoder taps instead of
the image: 0 is the input block's output, 1 + i down block i's; the call
stops after the last requested tap, and the decoder does not run.

Spatially sharded (`parallel/spatial.py`), each level runs on slabs while
the down conv halves the slab's rows evenly and the next level's k5 convs
find their 2 halo rows on the neighbour. A deep V-Net on a thin slab does
not (the zoo's 4-level self-attention V-Net on 32 rows over 2 ranks leaves
1 row a rank at level 4): from the first down block whose output slab
would be thinner, its input is gathered along the sharded dim (site
'vnet_bottom') and the bottom levels, down and back up, run replicated;
`slab` then returns to this rank's rows (and a deeper CUT tap to its
slab), and its backward keeps only those rows, so the ranks' gradients sum
to the whole.

`use_s2d_exec` selects the JAX package's space-to-depth execution form,
which computes the same function with the same parameters; the port runs
the plain computation and keeps its check of the input's extents, so that
the same configs are refused.
"""

from typing import Optional, Sequence

import torch
from torch import nn

from ganslate_tpu_torch.nn.attention import SelfAttentionBlock
from ganslate_tpu_torch.nn.invertible import InvertibleSequence
from ganslate_tpu_torch.nn.layers import (Conv, ConvTranspose, PReLU, apply_norm_s2d,
                                          batch_norm_or_none, check_s2d_norm, inert_bias,
                                          is_bias_before_norm, make_initializer)
from ganslate_tpu_torch.nn.separable import SeparableConv3d, SeparableConvTranspose3d
from ganslate_tpu_torch.parallel import spatial


# The rows a core's k5 conv reaches on each side.
_CORE_HALO = 2


def _conv_layer(is_separable, spatial_dims, transposed=False):
    """The conv of a block (the JAX package's `_conv`/`_convt`): the
    separable pair in 3D with `is_separable`, else a cube kernel."""
    if is_separable:
        if spatial_dims != 3:
            raise ValueError("separable convs are 3D-only")
        return SeparableConvTranspose3d if transposed else SeparableConv3d
    layer = ConvTranspose if transposed else Conv
    return lambda in_f, feats, k, **kw: layer(in_f, feats, (k,) * spatial_dims, **kw)


def _conv(in_features, features, k, spatial_dims, norm_type, kernel_init, generator,
          is_separable=False, transposed=False, **kw):
    """A conv before a norm: its bias is kept, and inert (`layers.inert_bias`)."""
    return _conv_layer(is_separable, spatial_dims, transposed)(
        in_features, features, k, use_bias=is_bias_before_norm(norm_type),
        bias_inert=inert_bias(norm_type), kernel_init=kernel_init, generator=generator, **kw)


def _norm_prelu(block, h):
    """`block`'s norm (its own `BatchNorm_0` for batch norm), then its PReLU."""
    return block.PReLU_0(apply_norm_s2d(block.norm_type, h, norm=block.BatchNorm_0))


class VnetInvBlock(nn.Module):
    """The half-width function inside the couplings: k5 conv + norm + PReLU."""

    spatially_sharded = True

    def __init__(self, features, norm_type, spatial_dims, kernel_init, generator=None,
                 is_separable=False):
        super().__init__()
        self.norm_type = norm_type
        self.conv = _conv(features, features, 5, spatial_dims, norm_type, kernel_init,
                          generator, is_separable, padding=2)
        self.BatchNorm_0 = batch_norm_or_none(norm_type, features)
        self.PReLU_0 = PReLU(features)

    def forward(self, x):
        return _norm_prelu(self, self.conv(x))


class InputBlock(nn.Module):

    spatially_sharded = True

    def __init__(self, in_channels, out_channels, norm_type, spatial_dims, kernel_init,
                 generator=None, is_separable=False):
        super().__init__()
        self.norm_type = norm_type
        self.n_repeats = out_channels // in_channels
        self.conv1 = _conv(in_channels, out_channels, 5, spatial_dims, norm_type, kernel_init,
                           generator, is_separable, padding=2)
        self.BatchNorm_0 = batch_norm_or_none(norm_type, out_channels)
        self.PReLU_0 = PReLU(out_channels)

    def forward(self, x):
        out = apply_norm_s2d(self.norm_type, self.conv1(x), norm=self.BatchNorm_0)
        # The input repeated over the channels (`jnp.tile`); one channel
        # broadcasts, without a copy.
        residual = x if x.shape[1] == 1 else x.repeat(1, self.n_repeats, *(1,) * (x.ndim - 2))
        return self.PReLU_0(out + residual)


class _DownConv(nn.Module):

    spatially_sharded = True

    def __init__(self, in_features, features, norm_type, spatial_dims, kernel_init,
                 generator=None, is_separable=False):
        super().__init__()
        self.norm_type = norm_type
        self.conv = _conv(in_features, features, 2, spatial_dims, norm_type, kernel_init,
                          generator, is_separable, strides=2)
        self.BatchNorm_0 = batch_norm_or_none(norm_type, features)
        self.PReLU_0 = PReLU(features)

    def forward(self, x):
        return _norm_prelu(self, self.conv(x))


class _UpConv(nn.Module):

    spatially_sharded = True

    def __init__(self, in_features, features, norm_type, spatial_dims, kernel_init,
                 generator=None, is_separable=False):
        super().__init__()
        self.norm_type = norm_type
        self.convt = _conv(in_features, features, 2, spatial_dims, norm_type, kernel_init,
                           generator, is_separable, transposed=True, strides=2)
        self.BatchNorm_0 = batch_norm_or_none(norm_type, features)
        self.PReLU_0 = PReLU(features)

    def forward(self, x):
        return _norm_prelu(self, self.convt(x))


def _core(channels, n_blocks, norm_type, spatial_dims, use_memory_saving, kernel_init,
          generator, is_separable):
    return InvertibleSequence(
        n_blocks, lambda: VnetInvBlock(channels // 2, norm_type, spatial_dims, kernel_init,
                                       generator, is_separable),
        use_memory_saving)


class DownBlock(nn.Module):

    spatially_sharded = True

    def __init__(self, in_channels, n_conv_blocks, norm_type, spatial_dims, use_memory_saving,
                 use_inverse, kernel_init, generator=None, is_separable=False):
        super().__init__()
        out = 2 * in_channels
        args = (norm_type, spatial_dims, kernel_init, generator, is_separable)
        self.down_conv_ab = _DownConv(in_channels, out, *args)
        if use_inverse:
            self.down_conv_ba = _DownConv(in_channels, out, *args)
        self.core = _core(out, n_conv_blocks, norm_type, spatial_dims, use_memory_saving,
                          kernel_init, generator, is_separable)
        self.relu = PReLU(out)

    def forward(self, x, inverse: bool = False):
        down = (self.down_conv_ba if inverse else self.down_conv_ab)(x)
        return self.relu(self.core(down, inverse) + down)


class UpBlock(nn.Module):

    spatially_sharded = True

    def __init__(self, in_channels, out_channels, n_conv_blocks, norm_type, spatial_dims,
                 use_memory_saving, use_inverse, kernel_init, generator=None,
                 is_separable=False):
        super().__init__()
        args = (norm_type, spatial_dims, kernel_init, generator, is_separable)
        self.up_conv_ab = _UpConv(in_channels, out_channels // 2, *args)
        if use_inverse:
            self.up_conv_ba = _UpConv(in_channels, out_channels // 2, *args)
        self.core = _core(out_channels, n_conv_blocks, norm_type, spatial_dims,
                          use_memory_saving, kernel_init, generator, is_separable)
        self.relu = PReLU(out_channels)

    def forward(self, x, skipx, inverse: bool = False):
        up = (self.up_conv_ba if inverse else self.up_conv_ab)(x)
        xcat = torch.cat([up, skipx], dim=1)
        del up
        return self.relu(self.core(xcat, inverse) + xcat)


class OutBlock(nn.Module):

    spatially_sharded = True

    def __init__(self, in_channels, out_channels, norm_type, spatial_dims, kernel_init,
                 generator=None, is_separable=False):
        super().__init__()
        self.norm_type = norm_type
        self.conv1 = _conv(in_channels, in_channels, 5, spatial_dims, norm_type, kernel_init,
                           generator, is_separable, padding=2)
        self.BatchNorm_0 = batch_norm_or_none(norm_type, in_channels)
        self.PReLU_0 = PReLU(in_channels)
        # Separable too, as in the JAX package: two 1x1x1 factors, both biased.
        self.conv2 = _conv_layer(is_separable, spatial_dims)(
            in_channels, out_channels, 1, kernel_init=kernel_init, generator=generator)

    def forward(self, x):
        h = _norm_prelu(self, self.conv1(x))
        return torch.tanh(self.conv2(h))


class VnetGenerator(nn.Module):
    """Takes and returns `(N, C, *spatial)`; `spatial_dims` is set by
    `Vnet3D`, `Vnet2D` and `SelfAttentionVnet3D`."""

    spatially_sharded = True
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
        if enable_attention_block is not None and len(enable_attention_block) < len(down_blocks):
            raise ValueError(f"`enable_attention_block` needs one flag per down block "
                             f"({len(down_blocks)}), got {list(enable_attention_block)}")
        check_s2d_norm(norm_type, 2 if use_s2d_exec else 0)
        # Read by `BaseGAN._batch_fusable`.
        self.norm_type = norm_type
        self.use_inverse = use_inverse
        self.use_s2d_exec = use_s2d_exec
        self.n_levels = len(down_blocks)
        init = make_initializer(weight_init_type, weight_init_gain)
        flc, sd = first_layer_channels, self.spatial_dims
        args = (norm_type, sd, init, generator)

        self.in_ab = InputBlock(in_channels, flc, *args, is_separable)
        if use_inverse:
            self.in_ba = InputBlock(in_channels, flc, *args, is_separable)
        self.out_ab = OutBlock(flc * 2, out_channels, *args, is_separable)
        if use_inverse:
            self.out_ba = OutBlock(flc * 2, out_channels, *args, is_separable)

        for i, n_convs in enumerate(down_blocks):
            setattr(self, f"downs_{i}", DownBlock(flc * 2 ** i, n_convs, norm_type, sd,
                                                  use_memory_saving, use_inverse, init,
                                                  generator, is_separable))
        # The attention blocks after all down blocks, as the original
        # registers its `attn` list (the JAX package's `torch_param_order_rank`).
        self.attended = [bool(enable_attention_block and enable_attention_block[i])
                         for i in range(self.n_levels)]
        for i, on in enumerate(self.attended):
            if on:
                setattr(self, f"attns_{i}", SelfAttentionBlock(flc * 2 ** (i + 1), sd, init,
                                                               generator))
        # Level widths from the bottom up: the first up block keeps its width,
        # each later one halves it.
        widths = [flc * 2 ** (self.n_levels - i) for i in range(self.n_levels)]
        for i, n_convs in enumerate(up_blocks):
            in_w, out_w = widths[max(i - 1, 0)], widths[i]
            setattr(self, f"ups_{i}", UpBlock(in_w, out_w, n_convs, norm_type, sd,
                                              use_memory_saving, use_inverse, init, generator,
                                              is_separable))

    @property
    def num_feature_levels(self) -> int:
        """Encoder taps: the input block and each down block."""
        return 1 + self.n_levels

    def _bottom(self, x, scope, depth: int) -> int:
        """The first down block whose output slab the sharded convs cannot
        run on (its input's rows odd, or its output thinner than a core's
        halo), where a sharded forward gathers; `depth` for none."""
        if scope is None:
            return depth
        rows = x.shape[2 + scope.spatial_dim]
        for i in range(depth):
            if rows % 2 or rows // 2 < _CORE_HALO:
                return i
            rows //= 2
        return depth

    def _down(self, i, h, inverse):
        """Down block `i`, then its attention where the level has one (in
        both directions: the inverse pass does not invert it)."""
        h = getattr(self, f"downs_{i}")(h, inverse)
        return getattr(self, f"attns_{i}")(h) if self.attended[i] else h

    def forward(self, x, inverse: bool = False,
                extract_features: Optional[Sequence[int]] = None):
        if inverse and not self.use_inverse:
            raise ValueError(
                "Trying to perform inverse forward while `use_inverse` flag is turned off.")
        if self.use_s2d_exec:
            multiple = 2 ** (self.n_levels + 1)
            extents = spatial.global_extent(x.shape)
            if any(d % multiple for d in extents):
                raise ValueError(f"use_s2d_exec needs spatial extents divisible by "
                                 f"2^(levels+1)={multiple}, got {extents}.")
        suffix = "ba" if inverse else "ab"
        depth = self.n_levels
        if extract_features is not None:
            indices = list(extract_features)
            if any(not 0 <= i < self.num_feature_levels for i in indices):
                raise ValueError(f"feature taps {indices} out of range: the encoder has "
                                 f"{self.num_feature_levels}")
            if not indices:
                return []
            depth = max(indices)
        scope = spatial.active()
        bottom = self._bottom(x, scope, depth)
        # The input block's output is also the last up block's skip; a level's
        # output (after its attention) is its tap and its skip. From level
        # `bottom` on they are whole (replicated).
        skips = [getattr(self, f"in_{suffix}")(x)]
        for i in range(depth):
            if i == bottom:
                skips[i] = spatial.gather(skips[i], 2 + scope.spatial_dim, scope,
                                          site="vnet_bottom")
            with spatial.replicated(i >= bottom):
                skips.append(self._down(i, skips[-1], inverse))
        if extract_features is not None:
            return [skips[i] if i < bottom or bottom == depth
                    else spatial.slab(skips[i], 2 + scope.spatial_dim, scope) for i in indices]
        out = skips.pop()
        for i in range(self.n_levels):
            level = self.n_levels - 1 - i
            with spatial.replicated(level >= bottom):
                out = getattr(self, f"ups_{i}")(out, skips.pop(), inverse)
            if level == bottom:
                out = spatial.slab(out, 2 + scope.spatial_dim, scope)
        return getattr(self, f"out_{suffix}")(out)
