"""3D PatchGAN with SAGAN self-attention (the JAX package's
`nn/discriminators/patchgan/selfattention_patchgan3d.py`): a stride-3 stem,
which keeps the attention's N x N matrix affordable, `attn1` after the
widest down stage and `attn2` after the penultimate conv.

Takes and returns `(N, C, *spatial)`. The convs carry the JAX package's
names (`stem`, `down{n}`, `penultimate`, `head`), the attention blocks
theirs (`attn1`, `attn2`), and a batch norm flax's automatic name
(`BatchNorm_{k}`), all registered in forward order. Each norm runs with its
LeakyReLU fused (the instance-norm kernels). An input whose output extent
would be 0 raises a ValueError (`check_output_extents`) where the JAX
package returns an empty output.

Spatially sharded, it runs as the PatchGAN does (`patchgan.run_steps`):
each conv on slabs while its output splits evenly (the stride-3 stem needs
slabs of a multiple of 3 rows), `attn1` on slabs (its keys and values
gathered), and from the stride-1 tail on replicated, `attn2` included.
"""

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ganslate_tpu_torch import configs
from ganslate_tpu_torch.nn.attention import SelfAttentionBlock
from ganslate_tpu_torch.nn.discriminators.patchgan.patchgan import (check_output_extents,
                                                                   run_steps)
from ganslate_tpu_torch.nn.layers import (Conv, batch_norm_or_none, inert_bias,
                                          is_bias_before_norm, leaky_relu, make_initializer,
                                          norm_act)
from ganslate_tpu_torch.parallel import spatial


@dataclass
class SelfAttentionPatchGAN3DConfig(configs.base.BaseDiscriminatorConfig):
    ndf: int = 64
    n_layers: int = 3
    kernel_size: Tuple[int] = (4, 4, 4)


class SelfAttentionPatchGAN3D(nn.Module):

    spatially_sharded = True

    def __init__(self, in_channels: int, ndf: int = 64, n_layers: int = 3,
                 kernel_size: Sequence[int] = (4, 4, 4), norm_type: str = "instance",
                 weight_init_type: str = "normal", weight_init_gain: float = 0.02,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        # Read by `BaseGAN._batch_fusable`.
        self.norm_type = norm_type
        self.n_layers = n_layers
        init = make_initializer(weight_init_type, weight_init_gain)
        use_bias, inert = is_bias_before_norm(norm_type), inert_bias(norm_type)
        kw = tuple(kernel_size)
        common = dict(padding=1, kernel_init=init, generator=generator)
        normed = dict(use_bias=use_bias, bias_inert=inert, **common)

        self.stem = Conv(in_channels, ndf, kw, strides=3, **common)
        feats = ndf
        for n in range(1, n_layers):
            out = ndf * min(2 ** n, 8)
            setattr(self, f"down{n}", Conv(feats, out, kw, strides=2, **normed))
            setattr(self, f"BatchNorm_{n - 1}", batch_norm_or_none(norm_type, out))
            feats = out
        self.attn1 = SelfAttentionBlock(feats, 3, init, generator)
        out = ndf * min(2 ** n_layers, 8)
        self.penultimate = Conv(feats, out, kw, strides=1, **normed)
        setattr(self, f"BatchNorm_{n_layers - 1}", batch_norm_or_none(norm_type, out))
        self.attn2 = SelfAttentionBlock(out, 3, init, generator)
        self.head = Conv(out, 1, kw, strides=1, **common)
        self.stages = ([(kw, 3, 1)] + [(kw, 2, 1)] * (n_layers - 1) + [(kw, 1, 1)] * 2)

    def _norm(self, h, k):
        return norm_act(h, self.norm_type, "leaky_relu",
                        batch_norm=getattr(self, f"BatchNorm_{k}"))

    def forward(self, x):
        check_output_extents(type(self).__name__, spatial.global_extent(x.shape),
                             self.stages, self.n_layers)
        steps = [(self.stem, leaky_relu)]
        steps += [(getattr(self, f"down{n}"), lambda h, k=n - 1: self._norm(h, k))
                  for n in range(1, self.n_layers)]
        steps += [(None, self.attn1),
                  (self.penultimate, lambda h: self._norm(h, self.n_layers - 1)),
                  (None, self.attn2), (self.head, None)]
        return run_steps(steps, x)
