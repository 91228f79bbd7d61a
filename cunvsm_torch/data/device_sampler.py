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

Under a mesh (``parallel/mesh.py``, one process per device) there are two
layouts, as in the JAX package:

* **replicated corpus** (``make_device_sampled_sharded_multistep``): every
  rank holds the whole corpus and draws the *same* B documents and window
  positions, from a generator that every rank seeds alike, and samples only
  the rows of its data group.  A mesh run therefore consumes the stream of
  the single-device run of that seed;
* **corpus sharded over the data axis** (``ShardedDeviceCorpus``,
  ``make_corpus_sharded_multistep``): documents are split into one
  contiguous group per data index, balanced by token count, and a rank holds
  only its group's tokens, re-packed into a local flat stream.  Each group
  shuffles its own pointers and draws its B/data rows from local memory,
  from a generator of its own seeded from the shared generator's seed and
  the data index; every global batch then holds exactly B/data instances of
  each group (stratified rather than exchangeable, the usual data-parallel
  relaxation).  The shard's token stream is flat, so unlike the JAX
  package's wide-row shard it has no upper limit on the window size.
  ``make_stratified_epoch_permuter`` gives a single device that batch
  composition, to compare the relaxed shuffle with the global one.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from cunvsm_torch.data.corpus import Corpus
from cunvsm_torch.data.instances import FeatureWeighting, Weighting
from cunvsm_torch.models.objectives import TextEntityBatch
from cunvsm_torch.spans import span
from cunvsm_torch.train.step import ObjectiveKind, make_train_step, objective_kind_from_config

GROUP_STREAM = 2  # the derived_seed stream of a data group's own generator


def derived_seed(seed: int, stream: int, counter: int) -> int:
    """The 63-bit seed of (seed, stream, counter), from numpy's
    ``SeedSequence``: a host-side function of three integers, so every
    device and every resumed run derives the same one."""
    state = np.random.SeedSequence([seed, stream, counter]).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


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


def _window_positions(uniforms: torch.Tensor, lengths: torch.Tensor, window_size: int):
    """Window starts ``min(floor(u * max_pos), max_pos - 1)`` with
    ``max_pos = len - W + 1``, computed in the uniforms' dtype.  floor(u * n)
    with the largest float32 u < 1 may round up to n: the clamp keeps a draw
    from taking a window one token past the document's end."""
    max_pos = lengths - window_size + 1
    return torch.minimum(
        torch.floor(uniforms * max_pos.to(uniforms.dtype)).to(torch.int64),
        max_pos - 1,
    )


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
    return _fetch_batch(dc, docs, uniforms, labels=docs)


def _fetch_batch(dc, docs: torch.Tensor, uniforms: torch.Tensor, labels: torch.Tensor):
    """The batch of the windows that ``uniforms`` place in the documents
    ``docs`` (indices into the corpus's document arrays), labelled
    ``labels``; ``dc`` is a ``DeviceCorpus`` or a ``ShardedDeviceCorpus``."""
    device = dc.tokens.device
    pos = _window_positions(uniforms, dc.doc_lengths[docs], dc.window_size)
    base = dc.doc_offsets[docs] + pos
    window = torch.arange(dc.window_size, device=device)
    features = dc.tokens[base[:, None] + window[None, :]].to(torch.int64)
    if dc.term_weights is not None:
        feature_weights = dc.term_weights[features]
    else:
        feature_weights = torch.ones(features.shape, dtype=torch.float32, device=device)
    if dc.inv_doc_weight is not None:
        weights = dc.inv_doc_weight[docs]
    else:
        weights = torch.ones(docs.shape[0], dtype=torch.float32, device=device)
    return TextEntityBatch(features, feature_weights, labels, weights)


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
            d = draws[i] if draws is not None else StepDraws(None, None)
            with span("cunvsm.sampler.batch"):
                docs = None
                if epoch_exact:
                    docs = _perm_slice(doc_perm, start + i * batch_size, batch_size)
                batch = sample_batch(dc, batch_size, generator, docs=docs, uniforms=d.uniforms)
            costs.append(step(params, opt_state, batch, negative_ids=d.negative_ids))
        return torch.stack(costs)

    return run



# ---------------------------------------------------------------------------
# Under a mesh: the replicated corpus.
# ---------------------------------------------------------------------------


def _check_stream_split(cfg, mesh) -> None:
    if cfg.batch_size % mesh.size:
        raise ValueError(
            f"batch_size {cfg.batch_size} not divisible by the total "
            f"device count {mesh.size} (mesh {dict(mesh.shape)}): the "
            f"sharded word accumulation splits the update stream over "
            f"every mesh axis"
        )


def _local_draws(mesh, d: StepDraws) -> StepDraws:
    """A step's injected global draws as this data group takes them."""
    uniforms, ids = d
    if uniforms is not None:
        uniforms = uniforms[mesh.batch_rows(uniforms.shape[0])]
    if ids is not None and ids.ndim == 2:
        ids = ids[mesh.batch_rows(ids.shape[0])]
    return StepDraws(uniforms, ids)


def make_device_sampled_sharded_multistep(
    desc,
    cfg,
    dc: DeviceCorpus,
    num_steps: int,
    mesh,
    generator: torch.Generator,
    num_entities: int,
    epoch_exact: bool = True,
):
    """``make_device_sampled_multistep`` as one rank's part of a mesh run,
    the corpus replicated: every rank draws the same B documents (the same
    slice of the same shuffled pointers) and the same B window placements
    from ``generator``, which every rank seeds alike, and fetches only the
    rows of its data group.  ``run`` has the single-device runner's
    signature and returns the K global costs; ``params`` and ``opt_state``
    are the rank's shards (``parallel.mesh.shard_params``).  Injected
    ``draws`` are the global batch's."""
    if objective_kind_from_config(cfg) != ObjectiveKind.TEXT_ENTITY:
        raise ValueError("on-device sampling supports only the text-entity objective")
    _check_stream_split(cfg, mesh)
    step = make_train_step(
        desc, cfg, dc.tokens.device, generator, num_entities=num_entities, mesh=mesh
    )
    batch_size = cfg.batch_size
    rows = mesh.batch_rows(batch_size)
    device = dc.tokens.device

    def run(params, opt_state, doc_perm=None, start: int = 0,
            draws: Optional[Sequence[StepDraws]] = None) -> torch.Tensor:
        if epoch_exact and doc_perm is None:
            raise ValueError("epoch-exact sampling needs the shuffled pointers")
        if draws is not None and len(draws) != num_steps:
            raise ValueError(f"{len(draws)} draws for {num_steps} steps")
        costs = []
        for i in range(num_steps):
            d = _local_draws(mesh, draws[i]) if draws is not None else StepDraws(None, None)
            # The global batch's draws, in the single-device order
            # (documents, then placements), of which this group keeps its
            # rows.
            with span("cunvsm.sampler.batch"):
                if epoch_exact:
                    docs = _perm_slice(doc_perm, start + i * batch_size, batch_size)[rows]
                else:
                    idx = torch.randint(
                        0, dc.eligible.shape[0], (batch_size,), generator=generator,
                        device=device,
                    )
                    docs = dc.eligible[idx[rows]]
                uniforms = d.uniforms
                if uniforms is None:
                    uniforms = torch.rand(
                        batch_size, generator=generator, device=device, dtype=torch.float32
                    )[rows]
                batch = _fetch_batch(dc, docs, uniforms, labels=docs)
            costs.append(step(params, opt_state, batch, negative_ids=d.negative_ids))
        return torch.stack(costs)

    return run


# ---------------------------------------------------------------------------
# Under a mesh: the corpus sharded over the data axis.
# ---------------------------------------------------------------------------


def _token_balanced_groups(eligible, elig_lengths, n_groups):
    """Split eligible documents into ``n_groups`` contiguous-by-id groups
    with near-equal token mass: cut the token cumsum at multiples of
    total/n_groups."""
    cum = np.cumsum(elig_lengths)
    bounds = [0]
    for s in range(1, n_groups):
        bounds.append(
            int(np.searchsorted(cum, cum[-1] * s / n_groups, side="left"))
            + 1
        )
    bounds.append(len(eligible))
    bounds = np.maximum.accumulate(np.asarray(bounds))  # monotone guard
    groups = [eligible[bounds[s]:bounds[s + 1]] for s in range(n_groups)]
    if any(len(g) == 0 for g in groups):
        raise ValueError(
            "token-balanced split produced an empty shard; fewer data "
            "shards or more documents required"
        )
    return groups


class CorpusShardArrays(NamedTuple):
    """One data group's part of the corpus, on the host.  The document
    arrays of every group are padded to the longest group's ``d_pad`` rows
    and the pointers to ``p_pad = d_pad * samples_per_doc``, as the JAX
    package pads them, so that every group takes the same number of steps."""

    tokens: np.ndarray  # [group tokens] int32, the group's documents re-packed
    doc_offsets: np.ndarray  # [d_pad] int64 offsets into ``tokens``
    doc_lengths: np.ndarray  # [d_pad] int64; padding rows hold the window size
    global_doc_id: np.ndarray  # [d_pad] int64 (the labels / entity rows)
    inv_doc_weight: Optional[np.ndarray]  # [d_pad] float32 or None
    local_pointers: np.ndarray  # [p_pad] int64 local document indices
    num_docs: int  # the group's real documents


def sharded_corpus_arrays(
    corpus: Corpus,
    num_shards: int,
    weighting: Weighting = Weighting.UNIFORM,
):
    """(one ``CorpusShardArrays`` per data group, samples_per_doc): the
    host-side layout of the data-axis-sharded corpus.  Groups are
    contiguous by document id and balanced by token count; a group shorter
    than the longest pads its pointers by wrapping its own stream (at most
    ``samples_per_doc`` extra instances per group per epoch)."""
    w = corpus.window_size
    lengths = corpus.doc_lengths.astype(np.int64)
    eligible = np.flatnonzero(lengths >= w).astype(np.int32)
    if len(eligible) < num_shards:
        raise ValueError(
            f"{len(eligible)} eligible documents < data axis {num_shards}"
        )
    elig_lengths = lengths[eligible]
    avg = float(elig_lengths.mean())
    samples_per_doc = max(int(math.ceil(avg - w + 1)), 1)
    groups = _token_balanced_groups(eligible, elig_lengths, num_shards)
    d_pad = max(len(g) for g in groups)
    p_pad = d_pad * samples_per_doc
    shards = []
    for docs in groups:
        pieces = [
            corpus.tokens[corpus.doc_offsets[d]:corpus.doc_offsets[d] + lengths[d]]
            for d in docs
        ]
        n = len(docs)
        doc_offsets = np.zeros(d_pad, np.int64)
        doc_offsets[:n] = np.concatenate([[0], np.cumsum(lengths[docs])[:-1]])
        # Padded document rows keep length >= window, so that a sample of
        # one (no pointer names them) could not index out of bounds.
        doc_lengths = np.full(d_pad, w, np.int64)
        doc_lengths[:n] = lengths[docs]
        global_doc_id = np.zeros(d_pad, np.int64)
        global_doc_id[:n] = docs
        inv = None
        if weighting == Weighting.INV_DOC_FREQUENCY:
            inv = np.ones(d_pad, np.float32)
            inv[:n] = (avg / np.maximum(lengths[docs], 1)).astype(np.float32)
        ptrs = np.repeat(np.arange(n, dtype=np.int64), samples_per_doc)
        shards.append(CorpusShardArrays(
            tokens=np.concatenate(pieces).astype(np.int32),
            doc_offsets=doc_offsets, doc_lengths=doc_lengths,
            global_doc_id=global_doc_id, inv_doc_weight=inv,
            local_pointers=np.resize(ptrs, p_pad), num_docs=n,
        ))
    return shards, samples_per_doc


class ShardedDeviceCorpus(NamedTuple):
    """This rank's part of the device corpus sharded over the mesh's data
    axis: rank (d, m) holds data group d's tokens only (the ranks of one
    data group hold the same shard).  Document indices are local to the
    group; ``global_doc_id`` maps them to labels."""

    tokens: torch.Tensor  # [group tokens] int32
    doc_offsets: torch.Tensor  # [d_pad] int64 local offsets
    doc_lengths: torch.Tensor  # [d_pad] int64
    global_doc_id: torch.Tensor  # [d_pad] int64
    inv_doc_weight: Optional[torch.Tensor]  # [d_pad] float32 or None
    term_weights: Optional[torch.Tensor]  # [vocab] float32 or None (replicated)
    local_pointers: torch.Tensor  # [p_pad] int64, unshuffled
    window_size: int
    samples_per_doc: int
    num_shards: int
    shard: int  # this rank's data index

    def nbytes(self) -> int:
        return sum(
            t.numel() * t.element_size() for t in self
            if isinstance(t, torch.Tensor)
        )


def prepare_sharded_device_corpus(
    corpus: Corpus,
    mesh,
    device,
    weighting: Weighting = Weighting.UNIFORM,
    feature_weighting: FeatureWeighting = FeatureWeighting.UNIFORM,
) -> ShardedDeviceCorpus:
    """This rank's shard of ``corpus`` on ``device`` (see
    ``sharded_corpus_arrays``); the host corpus is the same on every rank."""
    shards, samples_per_doc = sharded_corpus_arrays(corpus, mesh.data, weighting)
    mine = shards[mesh.data_index]

    def put(x):
        return None if x is None else torch.from_numpy(np.ascontiguousarray(x)).to(device)

    term_weights = None
    if feature_weighting == FeatureWeighting.SELF_INFORMATION:
        term_weights = put(corpus.vocab.self_information().astype(np.float32))
    return ShardedDeviceCorpus(
        tokens=put(mine.tokens), doc_offsets=put(mine.doc_offsets),
        doc_lengths=put(mine.doc_lengths), global_doc_id=put(mine.global_doc_id),
        inv_doc_weight=put(mine.inv_doc_weight), term_weights=term_weights,
        local_pointers=put(mine.local_pointers), window_size=corpus.window_size,
        samples_per_doc=samples_per_doc, num_shards=mesh.data, shard=mesh.data_index,
    )


def _group_generator(generator: torch.Generator, group: int, out: torch.Generator):
    """``out`` seeded for data group ``group`` from the seed that the
    shared ``generator`` was last given (a host-side integer)."""
    return out.manual_seed(derived_seed(generator.initial_seed(), GROUP_STREAM, group))


def sample_sharded_batch(
    sdc: ShardedDeviceCorpus,
    local_batch_size: int,
    perm_row: torch.Tensor,
    cursor: int,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> TextEntityBatch:
    """This data group's B/data rows of a batch, from local memory: the
    next slice of the group's shuffled pointers at the *local* ``cursor``,
    the window placements from ``uniforms`` or drawn from ``generator``
    (the group's own) in float32."""
    local_docs = _perm_slice(perm_row, cursor, local_batch_size)
    if uniforms is None:
        uniforms = torch.rand(
            local_batch_size, generator=generator, device=sdc.tokens.device,
            dtype=torch.float32,
        )
    return _fetch_batch(sdc, local_docs, uniforms, labels=sdc.global_doc_id[local_docs])


def make_sharded_epoch_permuter(sdc: ShardedDeviceCorpus):
    """(permute, pointers_per_epoch): ``permute(generator)`` shuffles this
    group's pointer array on the device with the group's own generator,
    seeded from the shared generator's seed and the data index (the
    per-group DataSource::reset)."""
    group_gen = torch.Generator(device=sdc.tokens.device)

    def permute(generator: torch.Generator) -> torch.Tensor:
        _group_generator(generator, sdc.shard, group_gen)
        order = torch.randperm(
            sdc.local_pointers.shape[0], generator=group_gen, device=sdc.tokens.device
        )
        return sdc.local_pointers[order]

    return permute, int(sdc.local_pointers.shape[0]) * sdc.num_shards


def make_corpus_sharded_multistep(
    desc,
    cfg,
    sdc: ShardedDeviceCorpus,
    num_steps: int,
    mesh,
    generator: torch.Generator,
    num_entities: int,
):
    """The mesh multistep whose corpus is sharded over the data axis: the
    runner's signature is that of ``make_device_sampled_sharded_multistep``,
    with ``doc_perm`` this group's shuffled pointers (from
    ``make_sharded_epoch_permuter``) and ``start`` the *global* instance
    cursor, divided into the group's inside.  The placements come from the
    group's own generator, reseeded at every call from the seed that
    ``generator`` holds; the negatives from ``generator`` itself, alike on
    every rank.  Injected ``draws`` hold this group's [B/data] uniforms and
    the global negative ids."""
    if objective_kind_from_config(cfg) != ObjectiveKind.TEXT_ENTITY:
        raise ValueError("on-device sampling supports only the text-entity objective")
    if cfg.batch_size % mesh.size:
        raise ValueError(
            f"batch_size {cfg.batch_size} not divisible by the total "
            f"device count {mesh.size} (mesh {dict(mesh.shape)})"
        )
    if sdc.num_shards != mesh.data or sdc.shard != mesh.data_index:
        raise ValueError("the corpus shard was not prepared for this mesh position")
    step = make_train_step(
        desc, cfg, sdc.tokens.device, generator, num_entities=num_entities, mesh=mesh
    )
    b_local = cfg.batch_size // mesh.data
    group_gen = torch.Generator(device=sdc.tokens.device)

    def run(params, opt_state, doc_perm, start: int = 0,
            draws: Optional[Sequence[StepDraws]] = None) -> torch.Tensor:
        if draws is not None and len(draws) != num_steps:
            raise ValueError(f"{len(draws)} draws for {num_steps} steps")
        _group_generator(generator, sdc.shard, group_gen)
        cursor = start // mesh.data
        costs = []
        for i in range(num_steps):
            d = draws[i] if draws is not None else StepDraws(None, None)
            ids = d.negative_ids
            if ids is not None and ids.ndim == 2:
                ids = ids[mesh.batch_rows(ids.shape[0])]
            with span("cunvsm.sampler.batch"):
                batch = sample_sharded_batch(
                    sdc, b_local, doc_perm, cursor + i * b_local, group_gen, d.uniforms
                )
            costs.append(step(params, opt_state, batch, negative_ids=ids))
        return torch.stack(costs)

    return run


def make_stratified_epoch_permuter(dc: DeviceCorpus, num_groups: int, batch_size: int):
    """A single-device permuter with the epoch semantics of the corpus
    sharded over ``num_groups`` data groups, so that the relaxed shuffle can
    be compared with the global one without a mesh.

    The documents are split into the same token-balanced contiguous groups,
    each group's wrap-padded pointer stream is shuffled on its own every
    epoch (with the group's generator, seeded as the sharded permuter seeds
    it), and the flat stream interleaves ``b_local = batch_size /
    num_groups`` consecutive pointers of each group: every batch draws
    exactly b_local instances from each group, the sharded sampler's batch
    composition.  The group streams are wrap-padded to a common multiple of
    b_local (at most samples_per_doc + b_local - 1 extra draws per group
    per epoch); the per-document sample counts are otherwise exact."""
    if batch_size % num_groups:
        raise ValueError(
            f"batch_size {batch_size} not divisible by num_groups "
            f"{num_groups}"
        )
    b_local = batch_size // num_groups
    device = dc.tokens.device
    lengths = dc.doc_lengths.cpu().numpy()
    eligible = dc.eligible.cpu().numpy()
    groups = _token_balanced_groups(eligible, lengths[eligible], num_groups)
    d_pad = max(len(g) for g in groups)
    p_pad = -(-(d_pad * dc.samples_per_doc) // b_local) * b_local
    ptrs = torch.from_numpy(np.stack([
        np.resize(np.repeat(docs.astype(np.int64), dc.samples_per_doc), p_pad)
        for docs in groups
    ])).to(device)
    group_gen = torch.Generator(device=device)

    def permute(generator: torch.Generator) -> torch.Tensor:
        shuffled = []
        for g in range(num_groups):
            _group_generator(generator, g, group_gen)
            shuffled.append(ptrs[g][torch.randperm(p_pad, generator=group_gen, device=device)])
        blocks = torch.stack(shuffled).view(num_groups, p_pad // b_local, b_local)
        return blocks.transpose(0, 1).reshape(-1)

    return permute, int(num_groups * p_pad)
