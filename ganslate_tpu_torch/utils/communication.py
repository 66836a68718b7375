"""Process identity for the port (the JAX package's `utils/communication.py`).

The port serves from one process. Rank and world size come from
`torch.distributed` when a process group has been initialised by the caller,
and are 0 and 1 otherwise. Collectives arrive with the training slice.
"""

import torch.distributed as dist


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def get_world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def is_main_process() -> bool:
    return get_rank() == 0
