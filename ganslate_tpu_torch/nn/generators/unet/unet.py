"""Rank-generic U-Net generator, pix2pix's skip architecture (the JAX
package's `ganslate_tpu/nn/generators/unet/unet.py`).

`num_downs` levels: k4 s2 down convs to widths ngf, 2 ngf, 4 ngf, then 8 ngf
for every deeper level; k4 s2 transposed up convs back, each concatenated
with the skip of its level; LeakyReLU(0.2) at the start of each down but
the first, ReLU at the start of each up, tanh at the end. A norm follows
downs 1..n-2 and ups 1..n-1; the skips are the normed, pre-activation
outputs. With `use_dropout`, dropout(0.5) follows the norm of the ups at
levels 4..n-2, the constant-width middle, when the caller passes a
generator (`BaseGAN.apply` does in training).

Takes and returns `(N, C, *spatial)`; each spatial extent must be a
multiple of 2^num_downs. The convs carry the JAX package's names (`down{i}`,
`up{i}`) and the norms flax's automatic ones (`InstanceNorm_{k}`,
`BatchNorm_{k}`, `IdentityNorm_{k}`, counted downs first, then ups from the
innermost out), so `utils/flax_weights.load_flax_params` carries a U-Net's
parameter tree as it is. They are registered in forward order, which is the
original ganslate's order (its recursive blocks register the down conv and
norm, the inner block, then the up conv and norm).

`use_s2d_exec` selects the JAX package's space-to-depth execution form of
the 3D U-Net, which computes the same function with the same parameters;
the port runs the plain computation and keeps its checks, so that the same
configs are refused.

Spatially sharded (`parallel/spatial.py`), each level runs on slabs while
the slab's rows halve evenly. The deepest levels may leave fewer rows than
that (a 7-level U-Net on 128 rows over 2 ranks: 1 row a rank at level 6):
from the first level whose input the k4 s2 down conv cannot split, the
input is gathered along the sharded dim (site 'unet_bottom') and the
bottom levels, down and back up to that level, run replicated; `slab` then
returns to this rank's rows before the skip concatenation, and its
backward keeps only those rows, so the ranks' gradients sum to the whole.
The checks of the extents read the whole sample's.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ganslate_tpu_torch.nn.layers import (Conv, ConvTranspose, Dropout, apply_norm_s2d,
                                          get_norm_layer, inert_bias, is_bias_before_norm,
                                          leaky_relu, make_initializer)
from ganslate_tpu_torch.parallel import spatial as spatial_sharding


def s2d_depth(spatial_shape, num_downs: int) -> int:
    """Levels that the JAX package's s2d form runs folded: level i's down
    conv needs its input extent divisible by 4 (`UnetGenerator._s2d_depth`
    there)."""
    depth = 0
    while depth < num_downs and all((d >> depth) % 4 == 0 and d % (1 << depth) == 0
                                    for d in spatial_shape):
        depth += 1
    return depth


class UnetGenerator(nn.Module):
    """`spatial_dims` is set by `Unet2D` and `Unet3D`."""

    spatially_sharded = True
    spatial_dims = 2

    def __init__(self, in_channels: int, out_channels: int, num_downs: int = 7,
                 ngf: int = 64, norm_type: str = "instance", use_dropout: bool = False,
                 use_s2d_exec: bool = False, weight_init_type: str = "normal",
                 weight_init_gain: float = 0.02, generator: Optional[torch.Generator] = None):
        super().__init__()
        if use_s2d_exec and self.spatial_dims != 3:
            raise ValueError("use_s2d_exec is for the 3D U-Net (2D convs already run at "
                             "MXU peak; docs/benchmarks.md)")
        # Read by `BaseGAN._batch_fusable` and `BaseGAN.apply`.
        self.norm_type = norm_type
        self.use_dropout = use_dropout
        self.use_s2d_exec = use_s2d_exec
        self.num_downs = num_downs
        init = make_initializer(weight_init_type, weight_init_gain)
        use_bias, inert = is_bias_before_norm(norm_type), inert_bias(norm_type)
        norm_cls = get_norm_layer(norm_type)
        k = (4,) * self.spatial_dims

        widths = [min(ngf * 2 ** i, ngf * 8) for i in range(num_downs)]
        self.dropout_levels = set(range(4, num_downs - 1)) if use_dropout else set()
        self.down_norms, self.up_norms = {}, {}

        def add_norm(level, features, table):
            name = f"{norm_cls.__name__}_{len(self.down_norms) + len(self.up_norms)}"
            setattr(self, name, norm_cls(features))
            table[level] = name

        feats = in_channels
        for i, w in enumerate(widths):
            normed = 0 < i < num_downs - 1
            setattr(self, f"down{i}", Conv(feats, w, k, strides=2, padding=1,
                                           use_bias=use_bias, bias_inert=inert and normed,
                                           kernel_init=init, generator=generator))
            if normed:
                add_norm(i, w, self.down_norms)
            feats = w
        for i in reversed(range(num_downs)):
            outermost = i == 0
            out_w = out_channels if outermost else widths[i - 1]
            setattr(self, f"up{i}", ConvTranspose(feats, out_w, k, strides=2, padding=1,
                                                  use_bias=outermost or use_bias,
                                                  bias_inert=inert and not outermost,
                                                  kernel_init=init, generator=generator))
            if not outermost:
                add_norm(i, out_w, self.up_norms)
            feats = 2 * out_w           # the skip is concatenated
        self.dropout = Dropout(0.5)

    def _check_input(self, x):
        spatial = spatial_sharding.global_extent(x.shape)
        multiple = 2 ** self.num_downs
        if any(d % multiple for d in spatial):
            raise ValueError(f"a U-Net of {self.num_downs} levels needs spatial extents that "
                             f"are multiples of 2^{self.num_downs}={multiple}, got {spatial}")
        if self.use_s2d_exec:
            depth = s2d_depth(spatial, self.num_downs)
            if depth == 0:
                raise ValueError(f"use_s2d_exec needs spatial extents divisible by 4, "
                                 f"got {spatial}")
            return depth
        return 0

    def _norm(self, table, level, h, channels, folded):
        return apply_norm_s2d(self.norm_type, h, channels, 2 if level < folded else 0,
                              norm=getattr(self, table[level]))

    def _bottom(self, x, scope) -> int:
        """The first level whose input slab the down conv cannot split (its
        rows odd), where a sharded forward gathers; `num_downs` for none."""
        if scope is None:
            return self.num_downs
        rows = x.shape[2 + scope.spatial_dim]
        for i in range(self.num_downs):
            if spatial_sharding.conv_halo(4, 2, 1, rows) is None:
                return i
            rows //= 2
        return self.num_downs

    def forward(self, x, generator: Optional[torch.Generator] = None):
        folded = self._check_input(x)
        scope = spatial_sharding.active()
        bottom = self._bottom(x, scope)
        skips = []
        h = x
        for i in range(self.num_downs):
            if i > 0:
                h = leaky_relu(h)
            if i == bottom:
                h = spatial_sharding.gather(h, 2 + scope.spatial_dim, scope,
                                            site="unet_bottom")
            with spatial_sharding.replicated(i >= bottom):
                h = getattr(self, f"down{i}")(h)
                if i in self.down_norms:
                    h = self._norm(self.down_norms, i, h, h.shape[1], folded)
            skips.append(h)
        for i in reversed(range(self.num_downs)):
            with spatial_sharding.replicated(i >= bottom):
                h = getattr(self, f"up{i}")(F.relu(h))
                if i > 0:
                    h = self._norm(self.up_norms, i, h, h.shape[1], folded)
                    if i in self.dropout_levels:
                        h = self.dropout(h, generator)
            if i == bottom:
                h = spatial_sharding.slab(h, 2 + scope.spatial_dim, scope)
            if i == 0:
                break
            h = torch.cat([skips[i - 1], h], dim=1)
        return torch.tanh(h)
