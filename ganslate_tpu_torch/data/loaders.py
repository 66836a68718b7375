"""Host-side prefetching data loader (the JAX package's `data/loaders.py`).

- `num_workers` threads map `dataset.__getitem__` over the sampler's index
  stream (PIL and numpy release the GIL for the heavy parts);
- batches are collated into numpy arrays (stacked on a new leading axis;
  strings and other metadata collected into lists);
- a bounded queue holds `prefetch` ready batches, so that the training loop
  does not wait on decoding in steady state.

The loader yields numpy batches; the model's `set_input` moves them to the
device. Each process loads its share of the global batch (`batch_size /
world_size`); the sampler strides the indices across processes.
"""

import inspect
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List

import numpy as np

from ganslate_tpu_torch.utils import communication


def collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack a list of sample dicts into one batch dict (recursively)."""
    out: Dict[str, Any] = {}
    first = samples[0]
    for key in first:
        values = [s[key] for s in samples]
        if isinstance(first[key], dict):
            out[key] = collate(values)
        elif isinstance(first[key], (str, bytes)):
            out[key] = values  # strings stay lists (metadata)
        elif isinstance(first[key], np.ndarray) or np.isscalar(first[key]):
            out[key] = np.stack([np.asarray(v) for v in values])
        else:
            out[key] = values  # metadata passthrough (paths, tuples, ...)
    return out


class DataLoader:
    """Iterable over collated batches.

    `batch_size` is the global batch size; this loader yields this process's
    share (global / world size). A finite sampler yields a final short batch
    unless `drop_last`.
    """

    def __init__(self, dataset, sampler, batch_size: int, num_workers: int = 4,
                 prefetch: int = 2, drop_last: bool = False):
        self.dataset = dataset
        self.sampler = sampler
        world = communication.get_world_size()
        if batch_size % world:
            raise ValueError(f"global batch {batch_size} not divisible by {world} processes")
        self.local_batch_size = batch_size // world
        self.num_workers = max(0, int(num_workers))
        self.prefetch = max(1, int(prefetch))
        self.drop_last = drop_last
        # A dataset whose __getitem__ takes `rng` gets a np.random.Generator
        # seeded by (sampler seed, raw stream position): every random draw of
        # the data plane is a function of the stream position, so thread
        # scheduling cannot reorder draws and a resumed stream reproduces
        # the uninterrupted one. Other datasets keep the global RNGs.
        try:
            params = inspect.signature(dataset.__getitem__).parameters
            self._dataset_takes_rng = "rng" in params
        except (TypeError, ValueError):
            self._dataset_takes_rng = False

    def __len__(self):
        if hasattr(self.sampler, "__len__"):
            n = len(self.sampler)
            if self.drop_last:
                return n // self.local_batch_size
            return -(-n // self.local_batch_size)
        raise TypeError("Infinite loader has no length")

    def _index_batches(self) -> Iterator[List[tuple]]:
        """Batches of (index, raw_position) pairs; raw_position is the
        sample's slot in the shared pre-striding stream (rank + pos*world),
        unique and stable across a resume, so it can seed the sample's RNG."""
        rank = communication.get_rank()
        world = communication.get_world_size()
        pos = int(getattr(self.sampler, "position", 0))
        batch: List[tuple] = []
        for idx in self.sampler:
            batch.append((idx, rank + pos * world))
            pos += 1
            if len(batch) == self.local_batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def _load(self, index: int, raw_position: int):
        if self._dataset_takes_rng:
            seed = int(getattr(self.sampler, "seed", 0))
            rng = np.random.default_rng([seed, raw_position])
            return self.dataset.__getitem__(index, rng=rng)
        return self.dataset[index]

    def _iter_sync(self) -> Iterator[Dict[str, Any]]:
        for indices in self._index_batches():
            yield collate([self._load(i, p) for i, p in indices])

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if self.num_workers == 0:
            yield from self._iter_sync()
            return
        yield from self._iter_threaded()

    def _iter_threaded(self) -> Iterator[Dict[str, Any]]:
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        sentinel = object()

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    # Keep `prefetch + 1` batches of futures in flight.
                    pending: "queue.Queue" = queue.Queue()
                    idx_iter = self._index_batches()

                    def submit_next():
                        try:
                            indices = next(idx_iter)
                        except StopIteration:
                            return False
                        pending.put([pool.submit(self._load, i, p) for i, p in indices])
                        return True

                    for _ in range(self.prefetch + 1):
                        if not submit_next():
                            break
                    while not pending.empty():
                        if stop.is_set():
                            return
                        batch = collate([f.result() for f in pending.get()])
                        submit_next()
                        # Put with a timeout, so that `stop` is noticed.
                        while not stop.is_set():
                            try:
                                out_q.put(batch, timeout=0.5)
                                break
                            except queue.Full:
                                continue
            except Exception as e:  # a worker's error, raised in the consumer
                out_q.put(e)
                return
            out_q.put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is sentinel:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
