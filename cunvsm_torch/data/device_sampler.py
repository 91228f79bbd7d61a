"""On-device instance sampling: the corpus lives on the card and each
training step samples its own batch there.

Port of the single-device part of ``cunvsm_tpu/data/device_sampler.py``.
The host sends nothing per step: the packed tokens, the document offsets
and lengths and the weights are device tensors, the per-epoch pointer
permutation is made on the device, and the host keeps only the cursor into
it, as a Python int.

Two sampling modes, as in the JAX package:

* **epoch-exact** (the trainer's): every eligible document (in-vocabulary
  length >= window) contributes exactly ``max(ceil(avg_len - w + 1), 1)``
  pointers per epoch, globally shuffled once per epoch
  (StochasticInstanceGenerator, data_indri.cpp:224-410); each batch is the
  next contiguous slice of the shuffled pointers;
* **i.i.d.**: documents drawn uniformly per batch.

Window positions are uniform per draw in both.  Each draw is separate from
the fetch: ``sample_batch`` and the multistep runner accept the uniforms
(and the negative ids) as arguments, so the fetch and the steps can be held
to the JAX package on the same draws.  The JAX package's TPU gather
workarounds (the overlapped wide-row token view, the packed pointer-meta
shuffle) are not carried: the fetch is one [B, W] gather.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from cunvsm_torch.data.corpus import Corpus
from cunvsm_torch.data.instances import FeatureWeighting, Weighting
from cunvsm_torch.models.objectives import TextEntityBatch
from cunvsm_torch.train.step import ObjectiveKind, make_train_step, objective_kind_from_config


class DeviceCorpus(NamedTuple):
    """The device-resident packed corpus that sampling reads."""

    tokens: torch.Tensor  # [total_tokens] int32
    doc_offsets: torch.Tensor  # [num_docs] int64 start offsets
    doc_lengths: torch.Tensor  # [num_docs] int64 in-vocabulary lengths
    eligible: torch.Tensor  # [num_eligible] int64 doc ids with length >= window
    inv_doc_weight: Optional[torch.Tensor]  # [num_docs] float32 or None (UNIFORM)
    term_weights: Optional[torch.Tensor]  # [vocab] float32 or None (UNIFORM)
    window_size: int
    samples_per_doc: int  # pointers per eligible document per epoch

    def nbytes(self) -> int:
        return sum(
            t.numel() * t.element_size() for t in self
            if isinstance(t, torch.Tensor)
        )


def prepare_device_corpus(
    corpus: Corpus,
    device,
    weighting: Weighting = Weighting.UNIFORM,
    feature_weighting: FeatureWeighting = FeatureWeighting.UNIFORM,
) -> DeviceCorpus:
    """Copy ``corpus`` to ``device``, with the weights in float32 as in the
    JAX package."""
    w = corpus.window_size
    lengths = corpus.doc_lengths.astype(np.int64)
    eligible = np.flatnonzero(lengths >= w)
    avg = float(lengths[eligible].mean()) if len(eligible) else 0.0

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    inv = None
    if weighting == Weighting.INV_DOC_FREQUENCY:
        inv = put((avg / np.maximum(lengths, 1)).astype(np.float32))
    term_weights = None
    if feature_weighting == FeatureWeighting.SELF_INFORMATION:
        term_weights = put(corpus.vocab.self_information().astype(np.float32))
    return DeviceCorpus(
        tokens=put(corpus.tokens.astype(np.int32)),
        doc_offsets=put(corpus.doc_offsets[:-1].astype(np.int64)),
        doc_lengths=put(lengths),
        eligible=put(eligible.astype(np.int64)),
        inv_doc_weight=inv,
        term_weights=term_weights,
        window_size=w,
        # data_indri.cpp:337-344: the count is the same for every document.
        samples_per_doc=max(int(math.ceil(avg - w + 1)), 1),
    )


def epoch_doc_pointers(dc: DeviceCorpus) -> torch.Tensor:
    """The per-epoch instance multiset: every eligible document repeated
    ``samples_per_doc`` times, on the corpus's device."""
    return dc.eligible.repeat_interleave(dc.samples_per_doc)


def make_epoch_permuter(dc: DeviceCorpus):
    """(permute, pointers_per_epoch): ``permute(generator)`` shuffles the
    per-epoch pointer array on the device with ``torch.randperm`` drawn from
    ``generator`` (DataSource::reset, data_indri.cpp:328-398)."""
    ptrs = epoch_doc_pointers(dc)

    def permute(generator: torch.Generator) -> torch.Tensor:
        order = torch.randperm(
            ptrs.shape[0], generator=generator, device=ptrs.device
        )
        return ptrs[order]

    return permute, int(ptrs.shape[0])


def _perm_slice(doc_perm: torch.Tensor, cursor: int, batch_size: int) -> torch.Tensor:
    """The next ``batch_size`` pointers from the shuffled epoch array.

    The trainer's epoch accounting keeps cursor + B <= len(doc_perm), so
    this is a contiguous slice (a start past the end is clamped, as
    ``lax.dynamic_slice`` clamps it); only corpora smaller than one batch
    wrap modulo the array's length."""
    n = doc_perm.shape[0]
    if n >= batch_size:
        start = min(cursor, n - batch_size)
        return doc_perm[start:start + batch_size]
    idx = (cursor + torch.arange(batch_size, device=doc_perm.device)) % n
    return doc_perm[idx]


def sample_batch(
    dc: DeviceCorpus,
    batch_size: int,
    generator: Optional[torch.Generator] = None,
    docs: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> TextEntityBatch:
    """One training batch, sampled on the corpus's device.

    ``docs`` [B] selects the documents (the epoch-exact path passes a slice
    of the shuffled pointers); otherwise they are drawn uniformly over the
    eligible documents from ``generator``.  ``uniforms`` [B] in [0, 1)
    place the windows; otherwise they are drawn from ``generator`` (after
    the documents) in float32, the JAX package's default.  The window of
    instance b starts at ``min(floor(u_b * max_pos), max_pos - 1)`` with
    ``max_pos = len - W + 1``, computed in the uniforms' dtype.  The
    batch's weights are float32 whatever the parameters' dtype, as the JAX
    package's (in float64 the NCE weights then round as JAX rounds them).
    """
    device = dc.tokens.device
    if docs is None:
        idx = torch.randint(
            0, dc.eligible.shape[0], (batch_size,), generator=generator, device=device
        )
        docs = dc.eligible[idx]
    if uniforms is None:
        uniforms = torch.rand(
            batch_size, generator=generator, device=device, dtype=torch.float32
        )
    offsets = dc.doc_offsets[docs]
    max_pos = dc.doc_lengths[docs] - dc.window_size + 1
    # floor(u * n) with the largest float32 u < 1 may round up to n: clamp,
    # or a draw could take a window one token past the document's end.
    pos = torch.minimum(
        torch.floor(uniforms * max_pos.to(uniforms.dtype)).to(torch.int64),
        max_pos - 1,
    )
    base = offsets + pos
    window = torch.arange(dc.window_size, device=device)
    features = dc.tokens[base[:, None] + window[None, :]].to(torch.int64)
    if dc.term_weights is not None:
        feature_weights = dc.term_weights[features]
    else:
        feature_weights = torch.ones(features.shape, dtype=torch.float32, device=device)
    if dc.inv_doc_weight is not None:
        weights = dc.inv_doc_weight[docs]
    else:
        weights = torch.ones(batch_size, dtype=torch.float32, device=device)
    return TextEntityBatch(features, feature_weights, docs, weights)


class StepDraws(NamedTuple):
    """The draws of one step, injected in place of the generator's."""

    uniforms: torch.Tensor  # [B] float32 window placements
    negative_ids: torch.Tensor  # [P] pool ids, [k] shared ids or [B, k] negatives


def make_device_sampled_multistep(
    desc,
    cfg,
    dc: DeviceCorpus,
    num_steps: int,
    generator: torch.Generator,
    num_entities: Optional[int] = None,
    epoch_exact: bool = True,
):
    """K = ``num_steps`` training steps per call, each sampling its own
    batch from the device corpus.

    Returns ``run(params, opt_state, doc_perm=None, start=0, draws=None)``,
    which updates ``params`` and ``opt_state`` in place and returns the K
    costs as one [K] device tensor.  In epoch-exact mode step i takes the
    pointers ``doc_perm[start + i*B : start + (i+1)*B]`` (``doc_perm`` from
    ``make_epoch_permuter``); the cursor is host arithmetic.  Each step
    draws its uniforms, then its negatives, from ``generator``, unless
    ``draws`` gives K ``StepDraws``.  Nothing in a call waits for the
    device, so the K steps are enqueued back to back.  Only the text-entity
    objective samples on the device.
    """
    if objective_kind_from_config(cfg) != ObjectiveKind.TEXT_ENTITY:
        raise ValueError("on-device sampling supports only the text-entity objective")
    step = make_train_step(
        desc, cfg, dc.tokens.device, generator, num_entities=num_entities
    )
    batch_size = cfg.batch_size

    def run(params, opt_state, doc_perm=None, start: int = 0,
            draws: Optional[Sequence[StepDraws]] = None) -> torch.Tensor:
        if epoch_exact and doc_perm is None:
            raise ValueError("epoch-exact sampling needs the shuffled pointers")
        if draws is not None and len(draws) != num_steps:
            raise ValueError(f"{len(draws)} draws for {num_steps} steps")
        costs = []
        for i in range(num_steps):
            docs = None
            if epoch_exact:
                docs = _perm_slice(doc_perm, start + i * batch_size, batch_size)
            d = draws[i] if draws is not None else StepDraws(None, None)
            batch = sample_batch(dc, batch_size, generator, docs=docs, uniforms=d.uniforms)
            costs.append(step(params, opt_state, batch, negative_ids=d.negative_ids))
        return torch.stack(costs)

    return run

