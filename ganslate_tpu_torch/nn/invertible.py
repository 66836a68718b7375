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

`use_memory_saving` trains through the recompute-by-inverse backward of the
JAX package's `_make_sequence` (`MemorySavingSequence`): the forward keeps
no activation of the chain but its output, and the backward rebuilds each
block's input by running the opposite coupling, then differentiates the
block there. A forward without a gradient to record runs the plain chain,
which computes the same numbers.

Spatially sharded (`parallel/spatial.py`), the backward's recompute and
rerun exchange halos and all-reduce norm statistics again, inside
autograd. It runs them in the spatial scope of the forward (kept on the
context), and every rank walks the same blocks in the same order, so the
ranks issue the same collectives in the same order.
"""

from typing import Callable, Dict, List, Tuple

import torch
from torch import nn
from torch.func import functional_call

from ganslate_tpu_torch.nn.layers import (Conv, batch_norm_or_none, inert_bias,
                                          is_bias_before_norm, make_initializer, norm_act)
from ganslate_tpu_torch.parallel import spatial


def coupling_forward(f, g, h):
    """y1 = x1 + F(x2), y2 = x2 + G(y1) on the list of halves `h`, in place:
    each old half is released as soon as it is replaced, before the next
    half is computed (a caller holding the old halves would keep a third
    half-width tensor alive through G)."""
    h[0] = h[0] + f(h[1])
    h[1] = h[1] + g(h[0])
    return h


def coupling_inverse(f, g, h):
    """x2 = y2 - G(y1), x1 = y1 - F(x2) on the list of halves `h`, in place."""
    h[1] = h[1] - g(h[0])
    h[0] = h[0] - f(h[1])
    return h


class MemorySavingSequence(torch.autograd.Function):
    """The chain of couplings of `seq` in one direction, differentiated by
    recompute-by-inverse (the JAX package's `_make_sequence` custom VJP).

    Inputs: `x` and `tensors`, the tensors that the blocks compute with in
    this call (`seq.block_tensors()`: the parameters, or under
    `functional_call` the compute-dtype casts of them), in the order of
    `names`. Taking them as inputs, and not the module's parameters in the
    backward, sends their gradients through the cast to the fp32 masters.

    The forward runs without a graph and saves the chain's output and the
    block tensors, no activation. The backward walks the blocks in the
    opposite order; for each, it rebuilds the block's input from its output
    with the opposite coupling (no graph), reruns the block at that input
    with gradients on, and takes the gradients of the input and of the
    block's tensors with `torch.autograd.grad`. A tensor that the block uses
    without a gradient (an inert bias) gets None."""

    @staticmethod
    def forward(ctx, seq, inverse, names, x, *tensors):
        ctx.seq, ctx.inverse, ctx.names = seq, inverse, names
        ctx.scope = spatial.current()
        y = seq.chain(x, inverse)
        ctx.save_for_backward(y, *tensors)
        return y

    @staticmethod
    def backward(ctx, grad_y):
        with spatial.spatial_scope(ctx.scope):
            return MemorySavingSequence._backward(ctx, grad_y)

    @staticmethod
    def _backward(ctx, grad_y):
        y, *tensors = ctx.saved_tensors
        seq, names = ctx.seq, ctx.names
        needs = ctx.needs_input_grad[4:]
        undo = coupling_forward if ctx.inverse else coupling_inverse
        order = range(len(seq.blocks)) if ctx.inverse else reversed(range(len(seq.blocks)))
        h = list(y.chunk(2, dim=1))
        g = grad_y.chunk(2, dim=1)
        grads: List = [None] * len(tensors)
        for i in order:
            with torch.profiler.record_function("coupling_recompute"), torch.no_grad():
                undo(*seq.block_fns(i, names, tensors), h)
            out, inputs, own = seq.rerun(i, names, tensors, needs, *h, ctx.inverse)
            with torch.enable_grad():
                got = torch.autograd.grad(out, [*inputs, *own.values()], g,
                                          allow_unused=True)
            g = got[:2]
            for j, grad in zip(own, got[2:]):
                grads[j] = grad
            del out, inputs, own, got
        grad_x = torch.cat(g, dim=1) if ctx.needs_input_grad[3] else None
        return (None, None, None, grad_x, *grads)


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

    spatially_sharded = True

    def block_tensors(self) -> Tuple[List[Tuple[int, str, str]], List[torch.Tensor]]:
        """`(names, tensors)`: every tensor the blocks compute with in this
        call, as `(block, "F" or "G", parameter name)` and the tensor bound
        to it (a parameter, or what `functional_call` put in its place)."""
        names, tensors = [], []
        for i, block in enumerate(self.blocks):
            for half in ("F", "G"):
                for name, t in block[half].named_parameters():
                    names.append((i, half, name))
                    tensors.append(t)
        return names, tensors

    def block_fns(self, i: int, names, tensors):
        """Block `i`'s F and G as functions computing with `tensors`."""
        bound: Dict[str, Dict[str, torch.Tensor]] = {"F": {}, "G": {}}
        for (j, half, name), t in zip(names, tensors):
            if j == i:
                bound[half][name] = t
        block = self.blocks[i]
        return tuple(lambda h, m=block[half], p=bound[half]: functional_call(m, p, (h,))
                     for half in ("F", "G"))

    def rerun(self, i: int, names, tensors, needs, h1, h2, inverse: bool = False):
        """Block `i`'s coupling (inverted for `inverse`) recomputed with a
        graph at its input `(h1, h2)`, as the memory-saving backward runs
        it: returns its output, the input as fresh leaves, and `{index:
        leaf}` of the block's tensors that `needs` marks for a gradient."""
        step = coupling_inverse if inverse else coupling_forward
        leaves = list(tensors)
        own = {}
        for j, (name, need) in enumerate(zip(names, needs)):
            if name[0] == i and need:
                leaves[j] = own[j] = tensors[j].detach().requires_grad_()
        inputs = (h1.detach().requires_grad_(), h2.detach().requires_grad_())
        with torch.profiler.record_function("coupling_recompute"), torch.enable_grad():
            out = step(*self.block_fns(i, names, leaves), list(inputs))
        return out, inputs, own

    def chain(self, x, inverse: bool = False):
        """The couplings' function, recording a graph where autograd is on.
        The halves start as views: the first norm or conv that reads one
        copies it (a channel half of a channels-last tensor is not
        contiguous), and every later half is a result of its own; copying
        both here would keep a second copy of the input alive."""
        h = list(x.chunk(2, dim=1))
        blocks = reversed(self.blocks) if inverse else self.blocks
        step = coupling_inverse if inverse else coupling_forward
        for block in blocks:
            step(block["F"], block["G"], h)
        return torch.cat(h, dim=1)

    def forward(self, x, inverse: bool = False):
        if not (self.use_memory_saving and torch.is_grad_enabled()):
            return self.chain(x, inverse)
        names, tensors = self.block_tensors()
        if not (x.requires_grad or any(t.requires_grad for t in tensors)):
            return self.chain(x, inverse)
        return MemorySavingSequence.apply(self, inverse, names, x, *tensors)


class InvResidualBlock(nn.Module):
    """The half-width function inside Piresnet's couplings (the JAX
    package's `InvResidualBlock`): norm -> replicate-padded k3 conv -> norm
    -> ReLU, the ReLU fused into the second norm (exact). The conv is named
    `conv` and the batch norms `BatchNorm_0`, `BatchNorm_1`, as in the JAX
    package."""

    spatially_sharded = True

    def __init__(self, features: int, norm_type: str = "instance", spatial_dims: int = 3,
                 kernel_init=None, generator=None):
        super().__init__()
        self.norm_type = norm_type
        self.BatchNorm_0 = batch_norm_or_none(norm_type, features)
        self.conv = Conv(features, features, (3,) * spatial_dims, padding=1,
                         pad_mode="replicate", use_bias=is_bias_before_norm(norm_type),
                         bias_inert=inert_bias(norm_type),
                         kernel_init=kernel_init or make_initializer(), generator=generator)
        self.BatchNorm_1 = batch_norm_or_none(norm_type, features)

    def forward(self, x):
        h = self.conv(norm_act(x, self.norm_type, batch_norm=self.BatchNorm_0))
        return norm_act(h, self.norm_type, "relu", batch_norm=self.BatchNorm_1)
