"""Index samplers for the host data plane (the JAX package's
`data/samplers.py`, with the same arithmetic).

`InfiniteSampler`: an infinite shuffled index stream, rank-strided so every
process draws disjoint indices from one shared-seed permutation stream, and
resumable from `(seed, position)`. `SequentialShardSampler`: a finite,
in-order pass for evaluation and inference.
"""

import itertools
from typing import Iterator

import numpy as np

from ganslate_tpu_torch.utils import communication


class InfiniteSampler:
    """Infinite stream of dataset indices: shuffle(range(size)) repeated, with
    each process taking `indices[rank::world_size]`. The permutation seed is
    shared across processes so shards are disjoint.

    The stream is resumable: `position` counts indices this process has
    yielded since the stream origin, and `set_state(seed, position)`
    fast-forwards a fresh sampler to continue the same stream. The Trainer
    checkpoints `{seed, position}` so that a preempted run's data order
    continues where it stopped."""

    def __init__(self, size: int, shuffle: bool = True, seed=None):
        if size <= 0:
            raise ValueError(f"a sampler needs a non-empty dataset, got size {size}")
        self._size = size
        self._shuffle = shuffle
        self._seed = communication.shared_random_seed() if seed is None else seed
        self._rank = communication.get_rank()
        self._world_size = communication.get_world_size()
        self._position = 0

    @property
    def seed(self) -> int:
        return int(self._seed)

    @property
    def position(self) -> int:
        """Indices yielded by this process since the stream origin. Live: it
        runs ahead of the training loop when the loader prefetches, so a
        checkpoint records the consumed count (iterations x local batch)."""
        return self._position

    def set_state(self, seed: int, position: int) -> None:
        """Restore the stream to `position` indices already yielded (per
        process). The next `__iter__` continues from there."""
        self._seed = int(seed)
        self._position = int(position)

    def __iter__(self) -> Iterator[int]:
        # This process owns raw-stream slots rank, rank+world, ...; having
        # yielded `position` of them, the next is raw index rank + pos*world.
        raw_start = self._rank + self._position * self._world_size
        stream = self._raw_indices(raw_start)
        for idx in itertools.islice(stream, 0, None, self._world_size):
            self._position += 1
            yield idx

    def _raw_indices(self, start: int):
        """The shared (pre-striding) index stream, fast-forwarded to raw
        offset `start`. Skipping a whole permutation block draws it: the RNG
        must consume exactly what an uninterrupted run consumed."""
        blocks, within = divmod(start, self._size)
        rng = np.random.default_rng(self._seed)
        if self._shuffle:
            for _ in range(blocks):
                rng.permutation(self._size)
        first = True
        while True:
            if self._shuffle:
                perm = rng.permutation(self._size).tolist()
            else:
                perm = range(self._size)
            yield from (itertools.islice(perm, within, None) if first else perm)
            first = False


class SequentialShardSampler:
    """Finite, in-order pass over the dataset, strided across processes
    (evaluation and inference): deterministic results."""

    def __init__(self, size: int, shard: int = 0, num_shards: int = 1):
        if size <= 0:
            raise ValueError(f"a sampler needs a non-empty dataset, got size {size}")
        self._size = size
        self._shard = shard
        self._num_shards = num_shards

    def __iter__(self) -> Iterator[int]:
        yield from range(self._shard, self._size, self._num_shards)

    def __len__(self) -> int:
        return len(range(self._shard, self._size, self._num_shards))
