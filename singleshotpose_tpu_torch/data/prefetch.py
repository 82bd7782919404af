"""Background-thread batch prefetching.

The port's own copy of ``singleshotpose_tpu/data/prefetch.py`` (plain
Python), so the port imports nothing of the JAX package.

The reference overlaps host data work with GPU compute via DataLoader worker
processes (reference: ``train.py:366`` ``num_workers``/``pin_memory``).  Here
a single daemon thread runs the (already internally-threaded) Loader one or
two batches ahead, so host decode/augment overlaps the device step — the
device work is launched asynchronously, so depth 2 is enough to keep the
device fed.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

__all__ = ["prefetch"]

_SENTINEL = object()


def prefetch(iterable: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Iterate ``iterable`` on a daemon thread, ``depth`` items ahead.

    Exceptions raised by the producer are re-raised at the consumer's next
    ``next()`` call.  Abandoning the iterator (consumer exception, early
    break, GC) sets a stop flag the producer polls, so it exits instead of
    blocking forever on a full queue holding decoded batches.
    """
    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    stop = threading.Event()

    def producer():
        try:
            for item in iterable:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # propagate to consumer
            if not stop.is_set():
                q.put((_SENTINEL, e))
            return
        if not stop.is_set():
            q.put((_SENTINEL, None))

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, tuple) and len(item) == 2 \
                    and item[0] is _SENTINEL:
                if item[1] is not None:
                    raise item[1]
                return
            yield item
    finally:
        stop.set()
