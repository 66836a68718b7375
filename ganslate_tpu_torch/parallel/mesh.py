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
- `check_local_batch`: the divisibility check of `shard_batch`;
- `leaf_is_sharded` / `spatial_slab`: the counterpart of the JAX package's
  `_leaf_batch_spec` for a spatial axis, and this rank's slab of a leaf;
- `broadcast_spatial`: one sample for the ranks that share it.

Without spatial groups the data group is the default process group: every
rank holds a share of the batch. It exists from one rank up, so that a
one-rank NCCL run goes through the same collectives; without a process
group every function here is the identity and no collective runs. Under
`train.spatial_mesh` (`communication.init_groups`) the ranks of a spatial
group share one sample, each holding a slab of it (`parallel/spatial.py`):
a rank's loss is its share of the global mean (local sum / global count),
so the gradients are summed over the spatial group and averaged over the
data group, one all-reduce over the world divided by the data size; pools
gather over the data group.

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
    size = communication.get_data_size()
    if batch % size:
        raise ValueError(f"the global batch {batch} does not divide over {size} data "
                         f"ranks; make it a multiple of the data ranks")
    return batch // size


def leaf_is_sharded(shape, n_spatial: int) -> bool:
    """Is a batch leaf of channels-last `shape` (N, *spatial, C) split over
    `n_spatial` ranks along its first spatial dim? The JAX package's rule
    (`parallel/mesh.py:_leaf_batch_spec`): when that dim divides over the
    ranks and is at least 2 of them; otherwise the leaf is replicated over
    the spatial group. (Tensor dim 2 in the networks' NC-first layout.)"""
    return (n_spatial > 1 and len(shape) >= 3 and shape[1] % n_spatial == 0
            and shape[1] >= 2 * n_spatial)


def spatial_slab(x, dim: int, index: int, n: int):
    """Slab `index` of `n` equal slabs of `x` (a tensor or a numpy array)
    along `dim`: a view."""
    size = x.shape[dim] // n
    return x[(slice(None),) * dim + (slice(index * size, (index + 1) * size),)]


def average_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Replace each gradient of `params` by its mean over the data ranks:
    one all-reduce of all of them flattened over the world, then a divide
    by the data size (the spatial ranks' gradients are shares of their
    sample's, and sum). Parameters without a gradient (the same on every
    rank: one graph) are skipped."""
    if not communication.is_distributed():
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = _flatten_dense_tensors(grads)
    dist.all_reduce(flat)
    flat.div_(communication.get_data_size())
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


def broadcast_spatial(tensors: dict) -> None:
    """Overwrite each tensor of `tensors`, in place, with the first rank's of
    this rank's spatial group (nothing without spatial groups): the ranks
    that share a sample then hold the same one."""
    group = communication.get_spatial_group()
    if group is None:
        return
    src = communication.get_spatial_ranks()[0]
    for k in sorted(tensors):
        dist.broadcast(tensors[k], src=src, group=group)


def all_gather_batch(x: torch.Tensor) -> torch.Tensor:
    """Every data rank's `x` concatenated on dim 0, in data-rank order (not
    differentiable)."""
    if not communication.is_distributed():
        return x
    return torch.cat(all_gather(x.detach(), communication.get_data_group(),
                                communication.get_data_size()))


def staged(x: torch.Tensor) -> bool:
    """Does `x` cross gloo through host memory? gloo's all-gather and
    point-to-point take CPU tensors only."""
    return x.is_cuda and communication.backend() == "gloo"


def to_host(x: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of a CUDA tensor."""
    return torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x)


def all_gather(x: torch.Tensor, group, size: int):
    """The `x` of each of the `size` ranks of `group`, in group order (not
    differentiable); staged through pinned host buffers on gloo."""
    x = x.contiguous()
    local = to_host(x) if staged(x) else x
    parts = [torch.empty_like(local) for _ in range(size)]
    dist.all_gather(parts, local, group=group)
    return [p.to(x.device) for p in parts] if local is not x else parts


def all_reduce_sum(x: torch.Tensor, over: str = "data") -> torch.Tensor:
    """The sum of `x` over the data ranks (`over="data"`), the world
    (`"world"`) or this rank's spatial group (`"spatial"`), differentiably:
    the backward sums the incoming gradients over the same ranks."""
    if not communication.is_distributed():
        return x
    from torch.distributed.nn.functional import all_reduce
    if over == "spatial" and communication.get_spatial_size() == 1:
        return x
    group = {"data": communication.get_data_group(), "world": None,
             "spatial": communication.get_spatial_group()}[over]
    if group is None:
        return all_reduce(x, op=dist.ReduceOp.SUM)
    return all_reduce(x, op=dist.ReduceOp.SUM, group=group)
