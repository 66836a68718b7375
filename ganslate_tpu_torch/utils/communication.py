"""Process identity and verbs across processes for the port (the JAX
package's `utils/communication.py`), over `torch.distributed`.

A data-parallel run is one process per rank, launched by torchrun
(`python -m torch.distributed.run --nproc_per_node N -m ganslate_tpu_torch
train config=...`), which sets the env:// rendezvous (`RANK`, `WORLD_SIZE`,
`LOCAL_RANK`, `LOCAL_WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`).
`init_distributed` makes the default process group from them; a group that
the caller made already is used as it is. The backend is `nccl` when the
ranks run on CUDA and each local rank has a card of its own, else `gloo`
(CPU runs, several ranks sharing one card); either way the compute stays
on the mode's device. Every group waits at most `TIMEOUT` in a collective,
so that a lost rank fails the run instead of hanging it.

The host verbs (`reduce`, `gather`, `all_gather`, `broadcast`,
`shared_random_seed`, `synchronize`) carry picklable objects and keep the
JAX package's semantics: rank order, `gather` empty on the ranks that are
not `dst`, `reduce` onto rank 0 unless `all_reduce`. With one process they
return their input. The tensor collectives of the train step (gradients,
batch-norm statistics, image pools, the sliding window's canvas) live in
`ganslate_tpu_torch.parallel`.

Spatially sharded runs (`train.spatial_mesh`, `spatial_sharding` in
val/test/infer) split the world into data x spatial ranks, the JAX
package's `{"data": -1, "spatial": n}` mesh reshaped row-major: rank
`d * n_spatial + s` is spatial rank `s` of data rank `d`. `init_groups`
builds two sets of process groups from it, created on every rank in the
same order: a spatial group (the ranks with the same `d`, which share one
sample, each holding a slab of it) and a data group (the ranks with the
same `s`). Without them (`n_spatial = 1`) the data group is the default
group and the spatial group is this rank alone, which is the data-parallel
layout. Unlike the JAX package, whose spatial axis stays inside one
process, the spatial axis here crosses processes: every rank is one
process.
"""

import datetime
import logging
import os
from typing import Any, List

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

TIMEOUT = datetime.timedelta(minutes=10)

# Did `init_distributed` make the default group (and so owns its teardown)?
_owned_group = False

# The data x spatial layout (`init_groups`): spatial ranks per sample, and
# this rank's spatial and data groups (None: the default group, or no group).
_n_spatial = 1
_spatial_group = None
_data_group = None


def pick_backend(cuda: bool) -> str:
    """`nccl` when the ranks run on CUDA and every local rank has a card of
    its own (`LOCAL_WORLD_SIZE <= device_count`), else `gloo`: NCCL refuses
    two ranks on one device."""
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    if cuda and torch.cuda.is_available() and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(cuda: bool = False) -> None:
    """Make the default process group from torchrun's environment, when
    `WORLD_SIZE` is set and no group exists yet; otherwise do nothing.
    `cuda`: the ranks run on CUDA (the mode's `cuda` field), which decides
    the backend (`pick_backend`) and, for NCCL, binds each rank to card
    `LOCAL_RANK % device_count` first."""
    global _owned_group
    if "WORLD_SIZE" not in os.environ or is_distributed():
        return
    backend = pick_backend(cuda)
    if backend == "nccl":
        torch.cuda.set_device(get_local_rank() % local_device_count())
    dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT)
    _owned_group = True
    logger.info(f"Process group: backend {backend}, rank {get_rank()} of "
                f"{get_world_size()}, local rank {get_local_rank()}")


def destroy_distributed() -> None:
    """Tear down the default group, if `init_distributed` made it."""
    global _owned_group
    if _owned_group and is_distributed():
        reset_groups()
        dist.destroy_process_group()
    _owned_group = False


def init_groups(n_spatial: int) -> None:
    """Split the world into `world / n_spatial` data ranks of `n_spatial`
    spatial ranks each (rank = d * n_spatial + s), and build the spatial
    and data groups. Every rank calls it with the same `n_spatial`; a second
    call with the layout in place does nothing. `n_spatial = 1` is the
    data-parallel layout, with no group made. Raises when `n_spatial` does
    not divide the world."""
    global _n_spatial, _spatial_group, _data_group
    n_spatial, world = int(n_spatial or 1), get_world_size()
    if n_spatial < 1 or world % n_spatial:
        raise ValueError(f"{n_spatial} spatial ranks do not divide the world of {world} "
                         f"ranks: launch a multiple of them (torchrun --nproc_per_node)")
    if n_spatial == _n_spatial:
        return
    reset_groups()
    if n_spatial == 1:
        return
    rank = get_rank()
    for d in range(world // n_spatial):     # every rank makes every group, in one order
        group = dist.new_group([d * n_spatial + s for s in range(n_spatial)], timeout=TIMEOUT)
        if rank // n_spatial == d:
            _spatial_group = group
    for s in range(n_spatial):
        group = dist.new_group(list(range(s, world, n_spatial)), timeout=TIMEOUT)
        if rank % n_spatial == s:
            _data_group = group
    _n_spatial = n_spatial
    logger.info(f"Spatial layout: {world // n_spatial} data x {n_spatial} spatial ranks; "
                f"rank {rank} is spatial rank {get_spatial_rank()} of data rank "
                f"{get_data_rank()}")


def reset_groups() -> None:
    """Back to the data-parallel layout (the groups are left to the default
    group's teardown)."""
    global _n_spatial, _spatial_group, _data_group
    _n_spatial, _spatial_group, _data_group = 1, None, None


def get_spatial_size() -> int:
    """Spatial ranks per sample (1 without `init_groups`)."""
    return _n_spatial


def get_spatial_rank() -> int:
    """This rank's place in its spatial group: the slab it holds."""
    return get_rank() % _n_spatial


def get_spatial_ranks() -> List[int]:
    """The global ranks of this rank's spatial group, in spatial order."""
    first = get_rank() - get_spatial_rank()
    return list(range(first, first + _n_spatial))


def get_spatial_group():
    """The spatial group (None when it is this rank alone)."""
    return _spatial_group


def get_data_size() -> int:
    """Data ranks: the ways the global batch is split."""
    return get_world_size() // _n_spatial


def get_data_rank() -> int:
    """This rank's share of the global batch."""
    return get_rank() // _n_spatial


def get_data_group():
    """The data group (None: the default group)."""
    return _data_group


def is_distributed() -> bool:
    """Does a process group exist (of any size, one rank included)?"""
    return dist.is_available() and dist.is_initialized()


def backend() -> str:
    """The default group's backend; empty without a group."""
    return dist.get_backend() if is_distributed() else ""


def get_rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def get_local_rank() -> int:
    """This process's rank on its host (torchrun's `LOCAL_RANK`)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def get_world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def device_count() -> int:
    """The cards of the job: one per rank on CUDA, else the ranks."""
    return get_world_size()


def local_device_count() -> int:
    """The cards this host shows (0 without CUDA)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def _many() -> bool:
    return get_world_size() > 1


def synchronize() -> None:
    """Barrier across processes."""
    if _many():
        dist.barrier()


def all_gather(data: Any) -> List[Any]:
    """Every process's picklable `data`, in rank order."""
    if not _many():
        return [data]
    out = [None] * get_world_size()
    dist.all_gather_object(out, data)
    return out


def gather_data(data: Any) -> List[Any]:
    """`gather` to rank 0 of every data rank's `data`, in data-rank order:
    one entry per spatial group (its spatial rank 0's), whose ranks hold the
    same whole samples after a spatially sharded inference. The same as
    `gather` without spatial groups."""
    gathered = gather(data)
    return gathered[::_n_spatial]


def gather(data: Any, dst: int = 0) -> List[Any]:
    """Every process's `data` in rank order on `dst`; an empty list on the
    other ranks."""
    if not _many():
        return [data]
    out = [None] * get_world_size() if get_rank() == dst else None
    dist.gather_object(data, out, dst=dst)
    return out if get_rank() == dst else []


def broadcast(value: Any, src: int = 0) -> Any:
    """Rank `src`'s picklable `value` on every process."""
    if not _many():
        return value
    box = [value]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def reduce(data, average: bool = True, all_reduce: bool = False):
    """Reduce numbers, dicts or lists of numbers across processes: each
    value's mean on each rank, then their sum over the ranks (divided by
    the world size when `average`), in float64, on rank 0 (the other ranks
    keep their own values) or on every rank with `all_reduce`."""
    if isinstance(data, dict):
        keys = sorted(data)
        values = np.array([float(np.asarray(data[k]).mean()) for k in keys], np.float64)
        return {k: float(v) for k, v in zip(keys, _reduce_array(values, average, all_reduce))}
    if isinstance(data, (list, tuple)):
        values = np.array([float(np.asarray(v).mean()) for v in data], np.float64)
        return [float(v) for v in _reduce_array(values, average, all_reduce)]
    values = np.array([float(np.asarray(data).mean())], np.float64)
    return float(_reduce_array(values, average, all_reduce)[0])


def _reduce_array(values: np.ndarray, average: bool, all_reduce: bool) -> np.ndarray:
    if not _many():
        return values
    gathered = np.stack(all_gather(values))          # (world, n), rank order
    if not all_reduce and not is_main_process():
        return values
    out = gathered.sum(axis=0)
    return out / get_world_size() if average else out


def shared_random_seed() -> int:
    """A random seed, the same on every process: rank 0's draw."""
    return int(broadcast(int(np.random.randint(2 ** 31))))
