"""Invertible additive couplings (the JAX package's `ganslate_tpu/nn/invertible.py`).

One coupling splits its input's channels into halves (x1, x2) and computes
y1 = x1 + F(x2), y2 = x2 + G(y1); its inverse is x2 = y2 - G(y1),
x1 = y1 - F(x2). `InvertibleSequence` chains `n_blocks` of them, each with
its own F and G, and its inverse runs the blocks in reverse order.

The JAX package stacks the blocks' parameters on a leading axis and runs
the chain as one scan; the port keeps the blocks as an indexable list of
modules (`blocks[i]["F"]`, `blocks[i]["G"]`), registered block by block, F
before G, as the original ganslate registers them. `utils/flax_weights.py`
unstacks the JAX tree into them.

`use_memory_saving` selects, in the JAX package, a backward that rebuilds
each block's input by running the inverse instead of storing activations.
A forward without gradient computes the same numbers either way, which is
all serving runs. That backward is not ported: a module with it set raises
when it would record a gradient.
"""

from typing import Callable

import torch
from torch import nn


class InvertibleSequence(nn.Module):
    """`n_blocks` couplings over `(N, C, *spatial)`; `make_block()` returns
    one half-width module (C // 2 channels in and out), called twice per
    block, for F and for G.

    The halves are split once and concatenated once for the whole chain:
    the couplings in between need no concatenation, which computes the same
    numbers as the JAX package's concat-and-split per block."""

    def __init__(self, n_blocks: int, make_block: Callable[[], nn.Module],
                 use_memory_saving: bool = False):
        super().__init__()
        self.use_memory_saving = use_memory_saving
        self.blocks = nn.ModuleList(
            nn.ModuleDict({"F": make_block(), "G": make_block()}) for _ in range(n_blocks))

    def forward(self, x, inverse: bool = False):
        if self.use_memory_saving and self.training and torch.is_grad_enabled():
            raise NotImplementedError(
                "`use_memory_saving` trains through the JAX package's recompute-by-"
                "inverse backward, which is not ported (it comes with RevGAN); set "
                "`use_memory_saving: false` to train with stored activations.")
        h1, h2 = x.chunk(2, dim=1)
        if inverse:
            for block in reversed(self.blocks):
                h2 = h2 - block["G"](h1)
                h1 = h1 - block["F"](h2)
        else:
            for block in self.blocks:
                h1 = h1 + block["F"](h2)
                h2 = h2 + block["G"](h1)
        return torch.cat([h1, h2], dim=1)
