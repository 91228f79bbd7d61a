"""Batch-stream composition: similarity pairs, repetition, zipping, prefetch.

Copied from ``cunvsm_tpu/data/sources.py`` (numpy only); the reference
composes its data sources as decorators:

* ``SimilaritySource``: the (id, id, weight) pair stream with per-epoch
  shuffling (RepresentationSimilarity::DataSource, data.cu:289-344), read
  from a file by ``load_similarities`` (data.cu:234-287);
* ``repeating``: a finite source reset for N (or infinite) epochs, so that
  the similarity stream cycles while the text stream paces the epoch
  (RepeatingSource, data_repeating.cpp:3-53, main.cu:256-258);
* ``zip_sources``: the lockstep zip of two streams for the composite
  objectives (MultiSource, data_multi.cpp:22-170);
* ``Prefetcher``: a daemon thread runs the iterator ahead of the consumer
  into a bounded queue, so host batch assembly overlaps the device's work
  (AsyncSource, data_async.cpp:36-191).
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np


class SimilarityBatchNp(NamedTuple):
    ids: np.ndarray  # [B, 2] int32
    weights: np.ndarray  # [B] float32


def load_similarities(
    path: str, identifiers: Dict[str, int]
) -> Tuple[np.ndarray, np.ndarray]:
    """Parse ``id1 id2 weight`` lines; join external ids to model ids,
    skipping pairs with unknown members (LoadSimilarities, data.cu:234-287).
    """
    pairs: List[Tuple[int, int]] = []
    weights: List[float] = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if len(parts) != 3:
                raise ValueError(f"malformed similarity line: {line!r}")
            a, b, w = parts
            if a not in identifiers or b not in identifiers:
                continue
            pairs.append((identifiers[a], identifiers[b]))
            weights.append(float(w))
    return (
        np.asarray(pairs, dtype=np.int32).reshape(-1, 2),
        np.asarray(weights, dtype=np.float32),
    )


class SimilaritySource:
    """Per-epoch shuffled stream of similarity pairs (data.cu:289-344)."""

    def __init__(
        self,
        ids: np.ndarray,
        weights: np.ndarray,
        batch_size: int,
        seed: int = 1,
        drop_remainder: bool = True,
    ):
        if ids.shape[0] != weights.shape[0]:
            raise ValueError(f"{ids.shape[0]} pairs but {weights.shape[0]} weights")
        self.ids = ids
        self.weights = weights
        self.batch_size = batch_size
        self.rng = np.random.RandomState(seed)
        self.drop_remainder = drop_remainder

    def epoch_batches(self) -> Iterator[SimilarityBatchNp]:
        n = len(self.ids)
        perm = self.rng.permutation(n)
        bs = self.batch_size
        full = n - (n % bs) if self.drop_remainder else n
        for start in range(0, full, bs):
            sel = perm[start : min(start + bs, n)]
            yield SimilarityBatchNp(self.ids[sel], self.weights[sel])


def repeating(source, num_repeats: int = -1):
    """Endless (or N-epoch) batch iterator over an epoch-oriented source
    (RepeatingSource, data_repeating.cpp:3-53)."""
    count = itertools.count() if num_repeats < 0 else range(num_repeats)
    for _ in count:
        yield from source.epoch_batches()


def zip_sources(primary_iter, secondary_iter):
    """Lockstep zip: the primary stream paces the epoch, the secondary is
    expected to be infinite/repeating (MultiSource semantics,
    data_multi.cpp:22-170 + main.cu:256-258)."""
    for a in primary_iter:
        b = next(secondary_iter)
        yield (a, b)


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
