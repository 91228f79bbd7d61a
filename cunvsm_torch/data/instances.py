"""Instance generation: sliding-window and stochastic n-gram sampling.

Copied from ``cunvsm_tpu.data.instances`` (numpy only), without the
reference-RNG replay (``reference_rng``), which needs the bit-exact
``minstd_rand0`` twin of ``cunvsm_tpu.data.stdrng`` and is not part of this
package yet.  For one seed the two packages give identical batches
(tests/test_torch_host.py).

Vectorized re-implementation of the reference's two instance generators
(data_indri.cpp:138-410).  Instead of per-document deque walks, an epoch is
described by flat (doc_id, position) arrays and batches are materialized with
one fancy-indexing gather from the packed token array.

* ``SEQUENTIAL`` (SequentialInstanceGenerator, data_indri.cpp:138-222):
  deterministic document order, stride-1 windows, instance weight =
  avg_index_doc_length / index_doc_length.
* ``STOCHASTIC`` (StochasticInstanceGenerator, data_indri.cpp:224-410): per
  epoch each document contributes ``max(ceil(avg_invocab_len - w + 1), 1)``
  uniformly-sampled window positions, globally shuffled; weights UNIFORM by
  default.

Strategy resolution (data_indri.cpp:640-646): shuffle -> stochastic sampling
+ UNIFORM weighting; no_shuffle -> sequential + INV_DOC_FREQUENCY.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Iterator, NamedTuple

import numpy as np

from cunvsm_torch.data.corpus import Corpus


class Weighting(enum.Enum):
    AUTOMATIC = "auto"
    UNIFORM = "uniform"
    INV_DOC_FREQUENCY = "inv_doc_frequency"


class FeatureWeighting(enum.Enum):
    UNIFORM = "uniform"
    SELF_INFORMATION = "self_information"


class TextEntityBatchNp(NamedTuple):
    """Host-side batch (pinned-buffer analog of TextEntity::Batch,
    data.cu:8-60)."""

    features: np.ndarray  # [B, W] int32
    feature_weights: np.ndarray  # [B, W] float32
    labels: np.ndarray  # [B] int32
    weights: np.ndarray  # [B] float32


@dataclasses.dataclass
class InstanceEpoch:
    """One epoch's worth of instances as flat pointer arrays."""

    doc_ids: np.ndarray  # int32 [N]
    positions: np.ndarray  # int64 [N]

    def __len__(self) -> int:
        return len(self.doc_ids)


class TextEntitySource:
    """Epoch-oriented batch stream over a packed corpus.

    Replaces IndriSource + the instance generators.  Each call to
    ``epoch_batches`` regenerates (and reshuffles) the instance pointers,
    mirroring ``DataSource::reset`` (data_indri.cpp:497-501, 328-398).
    """

    def __init__(
        self,
        corpus: Corpus,
        batch_size: int,
        shuffle: bool = True,
        weighting: Weighting = Weighting.AUTOMATIC,
        feature_weighting: FeatureWeighting = FeatureWeighting.UNIFORM,
        seed: int = 1,
        drop_remainder: bool = True,
        pad_remainder: bool = False,
    ):
        """``drop_remainder`` skips the final partial batch (the reference
        skips batches whose size isn't a multiple of maxThreadsPerBlock,
        main.cu:392-398).  ``pad_remainder`` instead pads it to the full
        batch size with zero-weight instances (keeping shapes static for
        XLA; the InMemoryDocumentSource pad_batch analog, data.h:301-364) —
        note the cost normalizer stays the full batch size, matching how the
        padded instances contribute zero mass."""
        self.corpus = corpus
        self.batch_size = batch_size
        self.shuffle = shuffle
        if weighting == Weighting.AUTOMATIC:
            weighting = (
                Weighting.UNIFORM if shuffle else Weighting.INV_DOC_FREQUENCY
            )
        self.weighting = weighting
        self.feature_weighting = feature_weighting
        self.rng = np.random.RandomState(seed)
        self.drop_remainder = drop_remainder and not pad_remainder
        self.pad_remainder = pad_remainder

        w = corpus.window_size
        lengths = corpus.doc_lengths  # in-vocabulary lengths
        # Stochastic generation needs in-vocab length >= window
        # (data_indri.cpp:259-270 drops shorter docs with a warning).
        self._eligible = np.flatnonzero(lengths >= w).astype(np.int32)
        self._eligible_lengths = lengths[self._eligible]
        if len(self._eligible):
            self._avg_invocab_len = float(self._eligible_lengths.mean())
        else:
            self._avg_invocab_len = 0.0
        # Samples per document per epoch (data_indri.cpp:337-344).
        self._samples_per_doc = max(
            int(math.ceil(self._avg_invocab_len - w + 1)), 1
        )
        if feature_weighting == FeatureWeighting.SELF_INFORMATION:
            self._term_weights = corpus.vocab.self_information().astype(
                np.float32
            )
        else:
            self._term_weights = None
        # Cache corpus-wide statistics used by INV_DOC_FREQUENCY weighting;
        # doc_lengths is a derived property (np.diff) and must not be
        # recomputed per batch on the host hot path.
        self._doc_lengths = lengths
        self._index_lengths = corpus.index_lengths
        self._avg_index_length = corpus.avg_index_length

    # -- epoch structure ----------------------------------------------------

    def _sequential_epoch(self) -> InstanceEpoch:
        counts = np.maximum(self._eligible_lengths - self.corpus.window_size + 1, 0)
        doc_ids = np.repeat(self._eligible, counts)
        # Positions 0..count-1 within each doc.
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        positions = np.arange(counts.sum(), dtype=np.int64) - np.repeat(
            starts, counts
        )
        return InstanceEpoch(doc_ids.astype(np.int32), positions)

    def _stochastic_epoch(self) -> InstanceEpoch:
        n_docs = len(self._eligible)
        k = self._samples_per_doc
        doc_ids = np.repeat(self._eligible, k)
        max_pos = np.repeat(
            self._eligible_lengths - self.corpus.window_size + 1, k
        )
        positions = (
            self.rng.random_sample(n_docs * k) * max_pos
        ).astype(np.int64)
        perm = self.rng.permutation(len(doc_ids))
        return InstanceEpoch(
            doc_ids[perm].astype(np.int32), positions[perm]
        )

    def _next_epoch(self) -> InstanceEpoch:
        return (
            self._stochastic_epoch() if self.shuffle
            else self._sequential_epoch()
        )

    def skip_epochs(self, n: int) -> None:
        """Advance the sampling RNG past n epochs (resume support): a
        resumed run's epoch N+1 draws the instances an uninterrupted run
        would have drawn."""
        for _ in range(n):
            if self.shuffle:
                self._next_epoch()

    def instances_per_epoch(self) -> int:
        if self.shuffle:
            return len(self._eligible) * self._samples_per_doc
        counts = np.maximum(
            self._eligible_lengths - self.corpus.window_size + 1, 0
        )
        return int(counts.sum())

    def batches_per_epoch(self) -> int:
        n = self.instances_per_epoch()
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    # -- batch materialization ----------------------------------------------

    def _materialize(
        self, doc_ids: np.ndarray, positions: np.ndarray
    ) -> TextEntityBatchNp:
        w = self.corpus.window_size
        base = self.corpus.doc_offsets[doc_ids] + positions
        gather_idx = base[:, None] + np.arange(w)[None, :]
        features = self.corpus.tokens[gather_idx]

        if self._term_weights is not None:
            feature_weights = self._term_weights[features]
        else:
            feature_weights = np.ones_like(features, dtype=np.float32)

        if self.weighting == Weighting.INV_DOC_FREQUENCY:
            if self.shuffle:
                # Stochastic generator computes the ratio over in-vocab
                # lengths (data_indri.cpp:300-310).
                lengths = self._doc_lengths[doc_ids]
                weights = (self._avg_invocab_len / lengths).astype(np.float32)
            else:
                # Sequential generator uses index lengths
                # (data_indri.cpp:158-165).
                lengths = self._index_lengths[doc_ids]
                weights = (
                    self._avg_index_length / lengths
                ).astype(np.float32)
        else:
            weights = np.ones(len(doc_ids), dtype=np.float32)

        return TextEntityBatchNp(
            features=features.astype(np.int32),
            feature_weights=feature_weights.astype(np.float32),
            labels=doc_ids.astype(np.int32),
            weights=weights,
        )

    def epoch_batches(self) -> Iterator[TextEntityBatchNp]:
        epoch = self._next_epoch()
        n = len(epoch)
        bs = self.batch_size
        full = n - (n % bs) if self.drop_remainder else n
        for start in range(0, full, bs):
            end = min(start + bs, n)
            batch = self._materialize(
                epoch.doc_ids[start:end], epoch.positions[start:end]
            )
            if self.pad_remainder and end - start < bs:
                pad = bs - (end - start)
                batch = TextEntityBatchNp(
                    features=np.pad(batch.features, ((0, pad), (0, 0))),
                    feature_weights=np.pad(
                        batch.feature_weights, ((0, pad), (0, 0))
                    ),
                    labels=np.pad(batch.labels, (0, pad)),
                    weights=np.pad(batch.weights, (0, pad)),  # zero weight
                )
            yield batch
