"""Background batch prefetching.

The port's own copy of the JAX package's ``data/prefetch.py``
``PrefetchIterator``: a daemon thread builds the next ``depth`` batches
(file reads, crops, collation) while the card runs the current step.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator


class PrefetchIterator:
    """Wraps a batch iterable; ``epoch()`` yields the same batches, made
    ahead of time on a background thread. An error in the producer is
    raised on the consumer's side."""

    def __init__(self, base, depth: int = 2):
        self.base = base
        self.depth = depth
        for attr in ("steps_per_epoch", "batch_size"):
            if hasattr(base, attr):
                setattr(self, attr, getattr(base, attr))

    def _source(self) -> Iterable:
        if hasattr(self.base, "epoch"):
            return self.base.epoch()
        return iter(self.base)

    def epoch(self) -> Iterator:
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        end = object()
        err = []

        def worker():
            try:
                for item in self._source():
                    q.put(item)
            except BaseException as e:  # surfaced on the consumer side
                err.append(e)
            finally:
                q.put(end)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is end:
                break
            yield item
        t.join()
        if err:
            raise err[0]

    def __iter__(self) -> Iterator:
        return self.epoch()
