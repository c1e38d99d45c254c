"""Host-side batching loader with background prefetch (counterpart of the JAX
``data_loading/loader.py``), in its design: a thread pool maps
``dataset[i]`` (decode and augmentation) and a producer thread collates one
batch ahead of the consumer; epoch ``e`` shuffles with
``RandomState(seed + e)``, counting the epochs this loader has served.

Threads, not ``torch.utils.data.DataLoader``'s worker processes: a dataset's
augmentation draws from one shared ``RandomState``, which every worker
process would copy and draw alike. JPEG decode (``native/``) releases the
interpreter lock, so threads overlap it.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator

import numpy as np


def default_collate(samples: list) -> dict:
    """Stack dict-of-array samples into a dict of batched arrays."""
    if isinstance(samples[0], dict):
        return {
            k: np.stack([np.asarray(s[k]) for s in samples]) for k in samples[0]
        }
    if isinstance(samples[0], (tuple, list)):
        return tuple(
            default_collate([s[i] for s in samples]) for i in range(len(samples[0]))
        )
    return np.stack([np.asarray(s) for s in samples])


class DataLoader:
    """Map-style dataset -> iterator of collated batches; ``drop_last``
    defaults to ``shuffle``. ``num_workers <= 0`` reads in the caller's
    thread."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool | None = None,
        collate_fn: Callable = default_collate,
        num_workers: int = 8,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last if drop_last is not None else shuffle
        self.collate_fn = collate_fn
        self.num_workers = num_workers
        self.prefetch = prefetch
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self) -> list[np.ndarray]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(order)
        batches = []
        for start in range(0, n, self.batch_size):
            idx = order[start : start + self.batch_size]
            if len(idx) < self.batch_size and self.drop_last:
                continue
            batches.append(idx)
        return batches

    def __iter__(self) -> Iterator[dict]:
        batches = self._index_batches()
        self._epoch += 1
        if self.num_workers <= 0:
            for idx in batches:
                yield self.collate_fn([self.dataset[int(i)] for i in idx])
            return
        yield from self._prefetch_iter(batches)

    def _prefetch_iter(self, batches):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        def put(item) -> bool:
            # give up once the consumer has gone, so the thread ends
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idx in batches:
                        samples = list(
                            pool.map(self.dataset.__getitem__, [int(i) for i in idx])
                        )
                        if not put(self.collate_fn(samples)):
                            return
            except BaseException as e:  # handed to the consumer, which raises it
                put(e)
                return
            put(sentinel)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join()
