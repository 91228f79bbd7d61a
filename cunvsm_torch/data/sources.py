"""Background prefetch of host batches.

``Prefetcher`` is copied from ``cunvsm_tpu.data.sources`` (the AsyncSource
role, data_async.cpp:36-191): a daemon thread runs the iterator ahead of
the consumer into a bounded queue, so host batch assembly overlaps the
device's work.  The similarity streams of that module are not part of this
package yet.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional


class Prefetcher:
    """Background-thread prefetch with a bounded buffer ring
    (AsyncSource, data_async.cpp:36-191; default ring of 10 buffers)."""

    _SENTINEL = object()

    def __init__(self, iterator: Iterator, depth: int = 10):
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._iterator = iterator
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for item in self._iterator:
                self._queue.put(item)
        except BaseException as e:  # propagate into the consumer
            self._exc = e
        finally:
            self._queue.put(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._SENTINEL:
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        return item
