"""SAGAN self-attention block, for 2D and 3D (the JAX package's
`ganslate_tpu/nn/attention.py`).

1x1(x1) query, key and value convs (query and key at `max(C // 8, 1)`
channels), a softmax over all flattened spatial positions, and a learned
residual weight `gamma`, zero at initialisation (the block starts as the
identity).

As in the JAX package, the two products and the softmax run in fp32 whatever
the compute dtype; the result is cast back to the input's dtype, and so is
`gamma` (kept in fp32) before the residual. The products are plain batched
GEMMs (`torch.bmm` through `@`); `scaled_dot_product_attention` is not used,
since it scales the energies and keeps the input's dtype.

The three 1x1 convs are held as `Conv` modules named `query`, `key` and
`value` (the JAX package's names, registered in that order, then `gamma`:
the original ganslate's order), and run as one GEMM over the channels-last
rows `(N, S, C)` with their weights concatenated. A GEMM in fp32 takes no
TF32 path unless the caller turns on `torch.backends.cuda.matmul.allow_tf32`
(off by default), where cuDNN's 1x1 convs take TF32 by default.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ganslate_tpu_torch.nn.layers import Conv, make_initializer
from ganslate_tpu_torch.parallel import spatial as spatial_sharding


class SelfAttentionBlock(nn.Module):
    """Takes and returns `(N, C, *spatial)`, `C = in_dim`."""

    def __init__(self, in_dim: int, spatial_dims: int = 3, kernel_init=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kernel_init = kernel_init or make_initializer()
        k1 = (1,) * spatial_dims
        self.qk_dim = max(in_dim // 8, 1)
        self.query = Conv(in_dim, self.qk_dim, k1, kernel_init=kernel_init, generator=generator)
        self.key = Conv(in_dim, self.qk_dim, k1, kernel_init=kernel_init, generator=generator)
        self.value = Conv(in_dim, in_dim, k1, kernel_init=kernel_init, generator=generator)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        spatial_sharding.refuse("The self-attention block")
        n, c, *spatial = x.shape
        # (N, C, *spatial) -> (N, S, C): a view for a channels-last input.
        rows = x.permute(0, *range(2, x.ndim), 1).reshape(n, -1, c)
        convs = (self.query, self.key, self.value)
        weight = torch.cat([m.weight.flatten(1) for m in convs])
        bias = torch.cat([m.bias for m in convs])
        qkv = F.linear(rows, weight, bias).float()
        q, k, v = qkv.split([self.qk_dim, self.qk_dim, c], dim=-1)
        attention = torch.softmax(q @ k.transpose(1, 2), dim=-1)        # (N, S, S)
        out = (attention @ v).to(x.dtype)                                # (N, S, C)
        # Back to (N, C, *spatial), channels-last in memory.
        out = out.reshape(n, *spatial, c).permute(0, x.ndim - 1, *range(1, x.ndim - 1))
        return self.gamma.to(x.dtype) * out + x
