"""The port's counterpart of the JAX package's `data` mesh axis
(`ganslate_tpu/parallel/mesh.py`).

The JAX package shards a global batch over the `data` axis of one device
mesh: XLA sums the gradients with `psum`, a mean over the batch axis (batch
norm) is global, and replicated state (parameters, optimizer moments, image
pools, generator keys) is the same everywhere. The port runs one process
per rank (`utils/communication.py`), each with its local share of the
batch, and does explicitly what XLA does there:

- `average_gradients`: one flat all-reduce of an optimizer group's
  gradients, divided by the data size: the gradient of the global-batch
  mean, as the JAX package's `psum` gives it;
- `broadcast_module`: rank 0's parameters and buffers on every rank
  (`replicate_to_mesh`);
- `all_gather_batch`: every rank's batch, in rank order (a replicated pool
  over the global batch);
- `all_reduce_sum`: a differentiable sum over the ranks (batch norm's
  global statistics);
- `global_batch` / `batch_spans_ranks`: the train step's scope, inside
  which batch statistics are the global batch's;
- `check_local_batch`: the divisibility check of `shard_batch`.

The data group is the default process group: every rank holds a share of
the batch. It exists from one rank up, so that a one-rank NCCL run goes
through the same collectives; without a process group every function here
is the identity and no collective runs.

On gloo, CUDA tensors are all-reduced and broadcast by gloo's own CUDA path;
`all_gather`, which gloo has for CPU tensors only, is staged through pinned
host buffers.
"""

import contextlib
import itertools
from typing import Iterable

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ganslate_tpu_torch.utils import communication


# Is a train step running (`global_batch`)?
_in_train_step = False


@contextlib.contextmanager
def global_batch():
    """The scope of one train step on this rank's share of the global
    batch: inside it, batch statistics span the data ranks
    (`batch_spans_ranks`), in every forward of the step, whether autograd
    records it or not (the keys CUT computes without a graph, the
    memory-saving couplings' forward and their recompute), as in the JAX
    package's one compiled step over the sharded batch. Outside it (the
    Validator, the Tester, `infer`) each rank's batch is its own."""
    global _in_train_step
    outer, _in_train_step = _in_train_step, True
    try:
        yield
    finally:
        _in_train_step = outer


def batch_spans_ranks() -> bool:
    """Do batch statistics here span the data ranks: inside `global_batch`,
    with a process group?"""
    return _in_train_step and communication.is_distributed()


def check_local_batch(batch: int) -> int:
    """This rank's share of the global `batch`; raises when the data ranks do
    not divide it (equal shares keep the global mean an average of the
    ranks' means)."""
    size = communication.get_world_size()
    if batch % size:
        raise ValueError(f"the global batch {batch} does not divide over {size} data "
                         f"ranks; make it a multiple of the world size")
    return batch // size


def average_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Replace each gradient of `params` by its mean over the data ranks:
    one all-reduce of all of them flattened, then a divide by the data
    size. Parameters without a gradient (the same on every rank: one
    graph) are skipped."""
    if not communication.is_distributed():
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = _flatten_dense_tensors(grads)
    dist.all_reduce(flat)
    flat.div_(communication.get_world_size())
    for grad, mean in zip(grads, _unflatten_dense_tensors(flat, grads)):
        grad.copy_(mean)


@torch.no_grad()
def broadcast_module(net: torch.nn.Module, src: int = 0) -> None:
    """Rank `src`'s parameters and buffers into `net` on every rank: one
    flat broadcast per dtype."""
    if not communication.is_distributed():
        return
    tensors = list(itertools.chain(net.parameters(), net.buffers()))
    for dtype in dict.fromkeys(t.dtype for t in tensors):   # one order on every rank
        same = [t for t in tensors if t.dtype == dtype]
        flat = _flatten_dense_tensors(same)
        dist.broadcast(flat, src=src)
        for t, value in zip(same, _unflatten_dense_tensors(flat, same)):
            t.copy_(value)


def all_gather_batch(x: torch.Tensor) -> torch.Tensor:
    """Every data rank's `x` concatenated on dim 0, in rank order (not
    differentiable)."""
    if not communication.is_distributed():
        return x
    x = x.detach().contiguous()
    staged = x.is_cuda and communication.backend() == "gloo"
    local = torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x) if staged else x
    parts = [torch.empty_like(local) for _ in range(communication.get_world_size())]
    dist.all_gather(parts, local)
    out = torch.cat(parts)
    return out.to(x.device) if staged else out


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the data ranks, differentiably: the backward
    sums the incoming gradients over the ranks too."""
    if not communication.is_distributed():
        return x
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(x, op=dist.ReduceOp.SUM)
