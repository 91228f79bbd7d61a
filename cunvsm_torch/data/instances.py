"""Instance generation: sliding-window and stochastic n-gram sampling.

Copied from ``cunvsm_tpu.data.instances`` (numpy only), with its
reference-RNG replay (``reference_rng``) over this package's copy of the
``minstd_rand0`` twin (``data/stdrng.py``).  For one seed the two packages
give identical batches, negatives included (tests/test_torch_host.py,
tests/test_torch_reference_rng.py).

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
import logging
import math
from typing import Iterator, NamedTuple, Optional

import numpy as np

from cunvsm_torch.data.corpus import Corpus
from cunvsm_torch.data.stdrng import (
    _RANGE,
    MinstdRand0,
    fast_forward_uniform_draws,
    past_threshold,
    reference_negative_labels,
    shuffle_draw_pasts,
    std_shuffle,
    uniform_int,
)

logger = logging.getLogger(__name__)


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
    negatives: Optional[np.ndarray] = None  # [B, k] int32 (reference RNG)


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
        reference_rng: bool = False,
        num_negative: int = 0,
    ):
        """``drop_remainder`` skips the final partial batch (the reference
        skips batches whose size isn't a multiple of maxThreadsPerBlock,
        main.cu:392-398).  ``pad_remainder`` instead pads it to the full
        batch size with zero-weight instances (keeping shapes static for
        XLA; the InMemoryDocumentSource pad_batch analog, data.h:301-364) —
        note the cost normalizer stays the full batch size, matching how the
        padded instances contribute zero mass.

        ``reference_rng`` replays the CUDA reference's host minstd_rand0
        stream bit-for-bit (data/stdrng.py): per-epoch window positions and
        the instance shuffle (data_indri.cpp:385-397) plus, when
        ``num_negative`` > 0, per-instance negative entity ids attached to
        each batch in consumption order (labels.cu:3-22) — all from ONE
        shared stream seeded with ``seed``, exactly as the reference's
        single RNG threads through its pipeline (main.cu:729-756)."""
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
        self.reference_rng = reference_rng
        self._num_negative = num_negative
        if reference_rng:
            if not shuffle:
                raise ValueError(
                    "reference_rng replay covers the stochastic generator"
                )
            if pad_remainder:
                raise ValueError(
                    "reference_rng is incompatible with pad_remainder "
                    "(the reference drops partial batches, main.cu:392-398)"
                )
            self._std_rng = MinstdRand0(seed)
        self._pending_epoch: Optional[InstanceEpoch] = None
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
        if self.reference_rng:
            # The reference's reset() (data_indri.cpp:328-397): per
            # document, ascending id (std::map order), k position draws of
            # uniform_int(0, max_pos - 1); then std::shuffle of the
            # pointer list — all from the shared minstd_rand0 stream.
            g = self._std_rng
            max_pos = self._eligible_lengths - self.corpus.window_size + 1
            positions = np.empty(n_docs * k, dtype=np.int64)
            i = 0
            for mp in max_pos:
                hi = int(mp) - 1
                for _ in range(k):
                    positions[i] = uniform_int(g, 0, hi)
                    i += 1
            perm = list(range(len(doc_ids)))
            std_shuffle(perm, g)
            perm = np.asarray(perm, dtype=np.int64)
            return InstanceEpoch(
                doc_ids[perm].astype(np.int32), positions[perm]
            )
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
        """The next epoch's instances, consuming the pre-drawn epoch if
        ``draw_next_epoch`` already paid for it."""
        if self._pending_epoch is not None:
            epoch, self._pending_epoch = self._pending_epoch, None
            return epoch
        return (
            self._stochastic_epoch() if self.shuffle
            else self._sequential_epoch()
        )

    def draw_next_epoch(self) -> None:
        """Consume the next epoch's instance draws NOW and cache the result.

        Reference draw-order hook: the CUDA binary performs epoch 1's
        position draws + pointer shuffle inside the StochasticInstance-
        Generator *constructor* (data_indri.cpp:279,328-398), BEFORE
        model.initialize's Glorot draws from the same shared engine
        (main.cu:499,520).  A trainer replaying the full stream calls this
        before drawing the Glorot init (models.params.reference_init_params)
        so draws land in the reference's order:
        [epoch-1 reset][Glorot][epoch-1 labels][epoch-2 reset][...]."""
        if self._pending_epoch is not None:
            raise RuntimeError("an epoch is already drawn and pending")
        self._pending_epoch = (
            self._stochastic_epoch() if self.shuffle
            else self._sequential_epoch()
        )

    @property
    def std_rng(self) -> MinstdRand0:
        """The shared libstdc++-twin engine (reference_rng only)."""
        return self._std_rng

    def skip_epochs(self, n: int) -> None:
        """Advance the sampling RNG past n epochs (resume support): a
        resumed run's epoch N+1 draws the instances an uninterrupted run
        would have drawn.  Under reference_rng the negative draws each
        trained batch consumed are replayed too (rejection sampling makes
        the consumed count data-dependent), exactly but vectorized
        (stdrng.fast_forward_uniform_draws)."""
        if self.reference_rng and n and self.shuffle:
            self._skip_reference_epochs(n)
            return
        for _ in range(n):
            if self.shuffle:
                self._next_epoch()

    def _skip_reference_epochs(self, n: int) -> None:
        k = self._samples_per_doc
        # uniform_int(0, max_pos - 1) accepts below max_pos * (R // max_pos).
        ue = (self._eligible_lengths - self.corpus.window_size + 1).astype(np.int64)
        pos_pasts = np.repeat(ue * (_RANGE // ue), k)
        shuf_pasts = shuffle_draw_pasts(len(self._eligible) * k)
        neg_pasts = np.zeros(0, np.int64)
        if self._num_negative:
            n_inst = self.instances_per_epoch()
            full = n_inst - (n_inst % self.batch_size) if self.drop_remainder else n_inst
            neg_pasts = np.full(
                full * self._num_negative, past_threshold(self.corpus.num_docs), np.int64
            )
        logger.info(
            "reference_rng resume: fast-forwarding ~%d host RNG draws over %d "
            "skipped epochs (vectorized exact replay).",
            n * (len(pos_pasts) + len(shuf_pasts) + len(neg_pasts)), n,
        )
        for _ in range(n):
            if self._pending_epoch is not None:
                # Pre-drawn epoch (draw_next_epoch): its position and
                # shuffle draws were already consumed.
                self._pending_epoch = None
            else:
                fast_forward_uniform_draws(self._std_rng, pos_pasts)
                fast_forward_uniform_draws(self._std_rng, shuf_pasts)
            if len(neg_pasts):
                fast_forward_uniform_draws(self._std_rng, neg_pasts)

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
            if self.reference_rng and self._num_negative:
                # Negative labels in consumption order from the shared
                # stream (labels.cu:3-22): k draws per instance, batch by
                # batch; dropped partial batches consume no draws.
                batch = batch._replace(negatives=np.asarray(
                    reference_negative_labels(
                        self._std_rng, batch.labels, self.corpus.num_docs,
                        self._num_negative,
                    ),
                    dtype=np.int32,
                ))
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
