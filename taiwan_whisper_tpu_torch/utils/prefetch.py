"""Background-thread batch prefetcher (port of
taiwan_whisper_tpu/utils/prefetch.py): one daemon thread keeps a small
queue of host batches warm so audio decode and tokenisation overlap the
device's train step."""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_STOP = object()


def prefetch(iterable: Iterable[T], buffer_size: int = 2) -> Iterator[T]:
    """Iterate ``iterable`` on a background thread with a bounded buffer;
    an exception in the producer is raised in the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
    err: list = []

    def worker():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # re-raised in the consumer below
            err.append(e)
        finally:
            q.put(_STOP)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _STOP:
            if err:
                raise err[0]
            return
        yield item
