"""Background-thread batch prefetcher (counterpart of
airv2x_tpu/data/prefetch.py).

Worker threads fill a bounded window of host-prepared batches so that device
steps do not wait on file reads; batches come out in the order of the
indices. An exception raised while a worker prepares a batch is re-raised in
the consumer when that batch is due, never swallowed.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator


class _WorkerError:
    """Exception captured in a worker, re-raised at the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class Prefetcher:
    """Iterate ``make_batch(idx)`` over ``indices`` with bounded lookahead."""

    def __init__(self, make_batch: Callable[[object], object], indices,
                 num_workers: int = 2, buffer_size: int = 4):
        self.make_batch = make_batch
        self.indices = list(indices)
        self.buffer_size = max(1, buffer_size)
        self.num_workers = max(1, num_workers)

    def __iter__(self) -> Iterator:
        work: queue.Queue = queue.Queue()
        for pos, idx in enumerate(self.indices):
            work.put((pos, idx))
        out: dict = {}
        cond = threading.Condition()
        slots = threading.Semaphore(self.buffer_size)  # bounds the lookahead
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                if not slots.acquire(timeout=0.5):
                    continue
                try:
                    pos, idx = work.get_nowait()
                except queue.Empty:
                    slots.release()
                    return
                try:
                    batch = self.make_batch(idx)
                except BaseException as e:  # re-raised by the consumer, so a
                    # bad sample fails the epoch instead of hanging it
                    batch = _WorkerError(e)
                with cond:
                    out[pos] = batch
                    cond.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for pos in range(len(self.indices)):
                with cond:
                    while pos not in out:
                        cond.wait(timeout=120.0)
                        if (pos not in out and work.empty()
                                and not any(t.is_alive() for t in threads)):
                            raise RuntimeError("prefetch workers died")
                    batch = out.pop(pos)
                slots.release()
                if isinstance(batch, _WorkerError):
                    raise RuntimeError(
                        "prefetch worker failed while preparing a batch"
                    ) from batch.exc
                yield batch
        finally:
            stop.set()
