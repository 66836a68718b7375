"""Process identity and host-side verbs for the port (the JAX package's
`utils/communication.py`).

The port trains and serves from one process. Rank and world size come from
`torch.distributed` when a process group has been initialised by the caller,
and are 0 and 1 otherwise. The verbs the data plane and the trackers call
(`reduce`, `gather`, `shared_random_seed`, `synchronize`) have their
single-process forms only: with a process group of more than one process
they raise, because data-parallel training is not ported.
"""

from typing import Any, List

import numpy as np
import torch.distributed as dist


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def get_local_rank() -> int:
    """One process per host: rank 0 on it."""
    return 0


def get_world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def is_main_process() -> bool:
    return get_rank() == 0


def _single_process(verb: str) -> None:
    if get_world_size() > 1:
        raise NotImplementedError(
            f"communication.{verb} across {get_world_size()} processes is not ported: "
            f"the port runs one process")


def synchronize() -> None:
    """Barrier across processes: nothing to wait for in one."""
    _single_process("synchronize")


def gather(data: Any, dst: int = 0) -> List[Any]:
    """Gather picklable objects onto `dst`: a list of this process's one."""
    _single_process("gather")
    return [data]


def reduce(data, average: bool = True, all_reduce: bool = False):
    """Host-side reduce of numbers, dicts or lists of numbers (each value's
    mean), as the JAX package's; in one process the values themselves."""
    _single_process("reduce")
    if isinstance(data, dict):
        return {k: float(np.asarray(data[k]).mean()) for k in sorted(data)}
    if isinstance(data, (list, tuple)):
        return [float(np.asarray(v).mean()) for v in data]
    return float(np.asarray(data).mean())


def shared_random_seed() -> int:
    """A random seed, the same on every process (one here)."""
    _single_process("shared_random_seed")
    return int(np.random.randint(2 ** 31))
