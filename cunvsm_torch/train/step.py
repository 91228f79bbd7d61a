"""Training steps for all five objective flavours: forward, backward and
the optimizer's update, in place.

Port of ``cunvsm_tpu/train/step.py`` (model.cu:222-228):

* TEXT_ENTITY, the NVSM / LSE loss (the default), with per-instance,
  rolled-pool or batch-shared negatives;
* ENTITY_ENTITY / TERM_TERM, the representation-similarity objective of one
  table;
* TEXT_ENTITY_ENTITY_ENTITY / TEXT_ENTITY_TERM_TERM, the "Mix 'n Match"
  composites (objective.cu:698-795), which merge the constituents'
  gradients by their mixture weights.

The negative-sampling resolution (``resolve_negative_sampling`` and its
constants) is copied unchanged, so both packages pick the same layout for
the same configuration.  Under reference-RNG replay the host draws every
instance's negatives and they ride in the batch (``TextEntityBatch.negatives``).

Under a mesh (``make_train_step(..., mesh=)``, ``parallel/mesh.py``) the
step is one rank's part of an SPMD program: ``batch`` holds the rows of the
rank's data group, ``params`` and ``opt_state`` its shards.  The negatives
are drawn for the *global* batch from a generator that every rank seeds
alike, and the rank keeps its rows, so a mesh run consumes the stream of
the single-device run of that seed.  The cost's normalizer is the global
batch size; the cost and the transform gradients are summed over the data
axis in one all-reduce (``cost_and_transform_grads``); the objectives and
the optimizer call the other collectives.

On a CUDA device a single-device text-entity or composite step captures
its ``compute_cost_and_grads`` once as a CUDA graph and replays it at every
later step of the same shapes (``StepGraph``), so that the card runs the
step's few hundred small kernels without waiting for the host to launch
each.  The optimizer stays eager and follows the replay on the same stream.
"""

from __future__ import annotations

import enum
import functools
from typing import Optional, Tuple

import torch

from cunvsm_torch.config import ModelDesc, TrainConfig, UpdateMethod
from cunvsm_torch.models import objectives as obj
from cunvsm_torch.models.params import ModelParams
from cunvsm_torch.ops.cast import cast_table
from cunvsm_torch.ops.window_mean import window_mean
from cunvsm_torch.optim.updates import Optimizer, OptState, is_full_adam
from cunvsm_torch.spans import span


class ObjectiveKind(enum.Enum):
    TEXT_ENTITY = "text_entity"
    ENTITY_ENTITY = "entity_entity"
    TERM_TERM = "term_term"
    TEXT_ENTITY_ENTITY_ENTITY = "text_entity_entity_entity"
    TEXT_ENTITY_TERM_TERM = "text_entity_term_term"


COMPOSITES = (ObjectiveKind.TEXT_ENTITY_ENTITY_ENTITY, ObjectiveKind.TEXT_ENTITY_TERM_TERM)


def objective_kind_from_config(cfg: TrainConfig) -> ObjectiveKind:
    """Mixture-weight dispatch (main.cu:733-757)."""
    if cfg.entity_entity_weight != 0.0:
        if cfg.term_term_weight != 0.0:
            raise ValueError("entity_entity_weight and term_term_weight cannot both be set")
        return ObjectiveKind.TEXT_ENTITY_ENTITY_ENTITY
    if cfg.term_term_weight != 0.0:
        return ObjectiveKind.TEXT_ENTITY_TERM_TERM
    return ObjectiveKind.TEXT_ENTITY


def _accumulate_only_optimizer(cfg: TrainConfig) -> bool:
    """True when the optimizer consumes entity descriptors only through
    dense accumulation (SGD scatter / full_adam segment-sum) — the factored
    rank-1 entity-gradient layout is exact there; the window-averaged
    statistics of Adagrad and sparse/dense-update Adam need the expanded
    per-update layout."""
    return cfg.update_method == UpdateMethod.SGD or is_full_adam(cfg)


_AUTO_POOL_CANDIDATES = (2048, 1024, 512, 256, 128, 64)
# Auto-resolution is scale-aware: the rolled pool is selected only when it
# covers at most this fraction of the entity collection.  Measured quality
# at three collection scales (PERFORMANCE.md): at ~3% coverage (P=2048,
# 64k docs) pooled BEATS per-instance (+0.0097 MAP, t=+11.0), at 12.5%
# coverage (P=2048, 16k docs, round 5: 5+5 seeds,
# results/collection_scale_r5_16k.jsonl) it still wins (+0.0030, t=+3.4),
# as it does at ~20% coverage (P=12800 on 64k: +0.0034, t=+3.2); at
# >=100% coverage (P=2048, 1398-doc Cranfield) it loses a small but real
# -0.0044 (t~2.2).  The crossover therefore sits between 20% and 100%
# coverage; 0.25 keeps every measured winning regime pooled and resolves
# small collections to the reference-exact per-instance path (shrinking
# the pool instead measurably hurts at small scale — P=1024 gives up
# ~0.5% on Cranfield).
_AUTO_POOL_MAX_COVERAGE = 0.25


def resolve_negative_sampling(cfg: TrainConfig, desc: ModelDesc,
                              batch_size: int,
                              num_entities: Optional[int] = None):
    """Resolve (pool_size, pool_stride) for a concrete batch size.

    ``negative_pool_size=-1`` (the default) selects the TPU-native
    rolled-pool layout automatically — the largest candidate pool dividing
    the batch — whenever the mode's requirements hold (accumulate-only
    optimizer, no entity L2 normalization, no shared negatives) AND, when
    ``num_entities`` (the real entity-collection size) is known, the pool
    covers at most ``_AUTO_POOL_MAX_COVERAGE`` of the collection; the
    per-example loss is exactly the reference's either way, so the auto
    choice only changes the execution layout and the cross-instance
    correlation of the draws (quality table in PERFORMANCE.md).  Returns
    (0, 1) for per-instance sampling."""
    k = cfg.num_random_entities
    p = cfg.negative_pool_size
    if cfg.reference_rng:
        # Reference-RNG replay feeds host-drawn per-instance negatives;
        # pooled/shared layouts sample differently by construction.
        if cfg.shared_negatives or p > 0:
            raise ValueError(
                "reference_rng requires per-instance negative sampling "
                "(negative_pool_size 0 or -1, no shared_negatives)"
            )
        return 0, 1
    if p == -1:
        if (
            cfg.shared_negatives
            or not _accumulate_only_optimizer(cfg)
            or desc.l2_normalize_entity_reprs
        ):
            return 0, 1
        p = next(
            (c for c in _AUTO_POOL_CANDIDATES
             if batch_size % c == 0 and c >= k),
            0,
        )
        if (
            p
            and num_entities is not None
            and p > _AUTO_POOL_MAX_COVERAGE * num_entities
        ):
            return 0, 1
    if p <= 0:
        return 0, 1
    # Validate the explicit pool configuration up front: the stride search
    # below can never produce k distinct residues mod p when p < k (it
    # would spin forever), and the pooled objective itself requires the
    # batch divisible by the pool — surface both as clear errors here at
    # step-build time instead of deep inside the traced objective.
    if p < k:
        raise ValueError(
            f"negative_pool_size {p} < num_random_entities {k}: the pool "
            "must hold at least one slot per negative"
        )
    if batch_size % p != 0:
        raise ValueError(
            f"batch size {batch_size} not divisible by negative_pool_size {p}"
        )
    s = cfg.negative_pool_stride
    if s == 0:
        # About P // k, rounded up to odd (coprime with power-of-two
        # pools), adjusted until the k slots are distinct mod P.
        s = max(p // max(k, 1), 1)
        if s % 2 == 0:
            s += 1
        s %= p
        if s == 0:
            s = 1
        while len({(j * s) % p for j in range(k)}) != k:
            s += 2
    return p, s


def _dtype(name: Optional[str]) -> Optional[torch.dtype]:
    return None if name is None else getattr(torch, name)


def _text_entity_grads(
    params: ModelParams, batch: obj.TextEntityBatch, generator, device, desc,
    cfg, num_entities=None, negative_ids=None, mesh=None,
):
    """(cost, AscentGrads).  ``negative_ids`` replaces the draw from
    ``generator``: the [P] pool ids under the rolled-pool layout, the [k]
    shared ids under ``shared_negatives``, the [B, k] per-instance
    negatives otherwise, where the batch's own ``negatives`` (host-drawn
    under reference-RNG replay) come next.  Under a ``mesh`` the batch and
    given per-instance negatives are this data group's rows, drawn
    negatives are the global batch's, of which the group keeps its rows,
    and ``num_entities`` (the real, unpadded count) is required."""
    if cfg.shared_negatives and cfg.negative_pool_size > 0:
        raise ValueError("shared_negatives and negative_pool_size are mutually exclusive")
    if mesh is not None and not num_entities:
        raise ValueError("a step under a mesh needs num_entities, the real entity count")
    num_entities = num_entities or params.num_entities
    local_rows = batch.features.shape[0]
    global_rows = local_rows * (1 if mesh is None else mesh.data)
    pool, pool_stride = resolve_negative_sampling(
        cfg, desc, global_rows, num_entities=num_entities
    )
    if (cfg.shared_negatives or pool) and not _accumulate_only_optimizer(cfg):
        raise ValueError(
            "shared/pooled negatives require an accumulate-only optimizer (sgd or full_adam)"
        )
    common = dict(
        stream_dtype=_dtype(cfg.resolved_stream_dtype()),
        uniform_feature_weights=cfg.uniform_feature_weights,
        window_sum_dtype=_dtype(cfg.resolved_window_sum_dtype()),
        batch_size_normalizer=global_rows,
        mesh=mesh,
    )
    if pool:
        pool_ids = negative_ids
        if pool_ids is None:
            pool_ids = obj.sample_negative_pool(generator, num_entities, pool, device)
        cost, _, grads = obj.text_entity_cost_and_grads_pooled(
            params, batch, pool_ids, cfg.num_random_entities, desc,
            pool_stride=pool_stride, **common,
        )
        return cost, grads
    if cfg.shared_negatives:
        neg_ids = negative_ids
        if neg_ids is None:
            neg_ids = obj.sample_shared_negative_entities(
                generator, num_entities, cfg.num_random_entities, device
            )
        cost, _, grads = obj.text_entity_cost_and_grads_shared(
            params, batch, neg_ids, desc, **common
        )
        return cost, grads
    if negative_ids is None:
        negative_ids = batch.negatives
    if negative_ids is None:
        # Uniform over [0, num_entities) per instance (labels.cu:3-22), for
        # the global batch.
        negative_ids = torch.randint(
            0, num_entities, (global_rows, cfg.num_random_entities),
            generator=generator, device=batch.labels.device, dtype=batch.labels.dtype,
        )
        if mesh is not None:
            negative_ids = negative_ids[mesh.batch_rows(global_rows)]
    entity_ids = torch.cat([batch.labels[:, None], negative_ids], dim=1)
    cost, _, grads = obj.text_entity_cost_and_grads(
        params, batch, entity_ids, desc,
        factored_entity_grads=_accumulate_only_optimizer(cfg), **common
    )
    return cost, grads


def _similarity_grads(params: ModelParams, batch: obj.SimilarityBatch, desc, table_name: str,
                      mesh=None):
    table = params.word_reprs if table_name == "word" else params.entity_reprs
    cost, _, sparse = obj.similarity_cost_and_grads(
        table, batch, desc,
        batch_size_normalizer=batch.ids.shape[0] * (1 if mesh is None else mesh.data),
        mesh=mesh, sharded_table=table_name == "entity",
    )
    if table_name == "word":
        return cost, obj.AscentGrads((sparse,), (), None, None)
    return cost, obj.AscentGrads((), (sparse,), None, None)


def _similarity_table_and_weight(kind: ObjectiveKind, cfg: TrainConfig) -> Tuple[str, float]:
    if kind == ObjectiveKind.TEXT_ENTITY_ENTITY_ENTITY:
        return "entity", cfg.entity_entity_weight
    return "word", cfg.term_term_weight


def compute_cost_and_grads(
    kind: ObjectiveKind,
    params: ModelParams,
    batch,
    generator,
    device,
    desc: ModelDesc,
    cfg: TrainConfig,
    num_entities: Optional[int] = None,
    negative_ids=None,
    mesh=None,
):
    """(cost, merged AscentGrads) for any objective flavour.

    For a composite ``batch`` is a (TextEntityBatch, SimilarityBatch) pair;
    the reported cost is the *mean* of the constituent costs
    (MultiForwardResultBase::get_cost, intermediate_results.cu:222-230)
    while the gradients merge weighted by the mixture weights
    (objective.cu:724-743, intermediate_results.cu:3-60).
    ``negative_ids`` is that of ``_text_entity_grads``.  Under a ``mesh``
    the cost and the transform gradients returned are the global ones, on
    every rank.
    """
    cost, grads = _local_cost_and_grads(
        kind, params, batch, generator, device, desc, cfg, num_entities, negative_ids, mesh
    )
    if mesh is not None:
        cost, grads = _sum_over_data_groups(mesh, cost, grads)
    return cost, grads


def _local_cost_and_grads(kind, params, batch, generator, device, desc, cfg, num_entities,
                          negative_ids, mesh):
    if kind == ObjectiveKind.TEXT_ENTITY:
        return _text_entity_grads(
            params, batch, generator, device, desc, cfg, num_entities, negative_ids, mesh
        )
    if kind == ObjectiveKind.ENTITY_ENTITY:
        return _similarity_grads(params, batch, desc, "entity", mesh)
    if kind == ObjectiveKind.TERM_TERM:
        return _similarity_grads(params, batch, desc, "word", mesh)
    te_batch, sim_batch = batch
    te_cost, te_grads = _text_entity_grads(
        params, te_batch, generator, device, desc, cfg, num_entities, negative_ids, mesh
    )
    table, sim_weight = _similarity_table_and_weight(kind, cfg)
    with span("cunvsm.step.similarity"):
        sim_cost, sim_grads = _similarity_grads(params, sim_batch, desc, table, mesh)
    merged = obj.merge_ascent_grads(
        ((te_grads, cfg.text_entity_weight), (sim_grads, sim_weight))
    )
    return 0.5 * (te_cost + sim_cost), merged


def _sum_over_data_groups(mesh, cost, grads: obj.AscentGrads):
    """The global cost and transform gradients from the data groups' parts
    (each normalized by the global batch size): one all-reduce over the
    data axis of the three packed into one buffer."""
    parts = [cost.reshape(1)]
    if grads.transform_w is not None:
        parts += [grads.transform_w.reshape(-1), grads.transform_b.reshape(-1)]
    packed = mesh.all_reduce(torch.cat(parts), "data", "cost_and_transform_grads")
    cost = packed[0]
    if grads.transform_w is not None:
        n_w = grads.transform_w.numel()
        grads = grads._replace(
            transform_w=packed[1:1 + n_w].view_as(grads.transform_w),
            transform_b=packed[1 + n_w:].view_as(grads.transform_b),
        )
    return cost, grads


def scaled_regularization_lambda(cfg: TrainConfig) -> float:
    """lambda / batch_size (intermediate_results.cu:126-129); for a
    composite the mean over the constituents, which share the batch size
    (intermediate_results.cu:232-240), so the same value."""
    return cfg.regularization_lambda / cfg.batch_size


GRAPHED = (ObjectiveKind.TEXT_ENTITY,) + COMPOSITES


def batch_parts(batch) -> tuple:
    """The batches of one step: a text-entity or similarity batch alone, or
    a composite's (TextEntityBatch, SimilarityBatch) pair."""
    return batch if type(batch) is tuple else (batch,)


def graph_signature(kind: ObjectiveKind, mesh, device, params: ModelParams, batch,
                    negative_ids=None):
    """What a step's CUDA graph is captured for, or None where the step
    runs eagerly: a device other than CUDA, a mesh (whose collectives stay
    out of a capture), a bare similarity objective.  The signature holds
    the shape and dtype of each field of ``batch`` (of both batches of a
    composite) and of ``negative_ids`` (None where absent) and the address,
    shape and dtype of each parameter table, which the graph reads where it
    was captured."""
    if kind not in GRAPHED or mesh is not None or torch.device(device).type != "cuda":
        return None

    def shape(t):
        return None if t is None else (tuple(t.shape), t.dtype)

    return (tuple(tuple(shape(t) for t in part) for part in batch_parts(batch)),
            shape(negative_ids), tuple((t.data_ptr(), shape(t)) for t in params))


# The kernels of the model step that count their launches.
_COUNTED = (cast_table, window_mean)


class _CapturedStep:
    """One CUDA graph of ``cost_and_grads(batch, negative_ids)``: static
    copies of the inputs that the step reads (both batches of a composite),
    which each replay refreshes, and the outputs, which each replay
    overwrites.  The generator's draws inside the graph advance its state at
    each replay as the eager draws would, from the seed and offset it holds
    then."""

    def __init__(self, cost_and_grads, generator, batch, negative_ids,
                 uniform_feature_weights: bool):
        parts = tuple(type(b)(*(None if t is None else t.clone() for t in b))
                      for b in batch_parts(batch))
        self.batch = parts if type(batch) is tuple else parts[0]
        self.negative_ids = None if negative_ids is None else negative_ids.clone()
        # The feature weights are not read under uniform feature weights.
        self._skip = {"feature_weights"} if uniform_feature_weights else set()
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        before = [kernel.launches for kernel in _COUNTED]
        # Thread-local: the host-fed prefetch thread copies batches meanwhile.
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.outputs = cost_and_grads(self.batch, self.negative_ids)
        # The launch counters count the kernels that ran: each replay's, not
        # the capture's.
        self._launches = [kernel.launches - n for kernel, n in zip(_COUNTED, before)]
        for kernel, n in zip(_COUNTED, before):
            kernel.launches = n

    def _inputs(self, batch, negative_ids):
        read = [t for b in batch_parts(batch) for name, t in zip(b._fields, b)
                if name not in self._skip]
        return [t for t in read + [negative_ids] if t is not None]

    def replay(self, batch, negative_ids):
        for static, t in zip(self._inputs(self.batch, self.negative_ids),
                             self._inputs(batch, negative_ids)):
            static.copy_(t)
        self.graph.replay()
        for kernel, n in zip(_COUNTED, self._launches):
            kernel.launches += n
        return self.outputs


class StepGraph:
    """``cost_and_grads(params, batch, negative_ids)`` of one step closure,
    replayed from a CUDA graph where ``graph_signature`` allows.

    The first call of a signature runs eagerly: it loads torch's lazy
    modules, builds the cast kernel and sets cuBLAS up for the shapes.  The
    next call of that signature captures the graph (a capture runs nothing)
    and replays it, and so does every later call of it; a call of another
    signature runs eagerly.  The closure holds one graph.  The returned cost
    is a copy of the graph's; the gradients are the graph's own, which the
    next replay overwrites in stream order.  ``replays`` counts the steps
    replayed."""

    def __init__(self, cost_and_grads, kind: ObjectiveKind, mesh, device, generator,
                 uniform_feature_weights: bool):
        self._cost_and_grads = cost_and_grads
        self._kind, self._mesh, self._device = kind, mesh, device
        self._generator = generator
        self._uniform = uniform_feature_weights
        self._warm = None  # the signature of the last eager call that had one
        self._signature = None  # the captured one
        self._captured = None
        self.replays = 0

    def __call__(self, params: ModelParams, batch, negative_ids=None):
        signature = graph_signature(self._kind, self._mesh, self._device, params, batch,
                                    negative_ids)
        if signature is None:
            return self._cost_and_grads(params, batch, negative_ids)
        if self._captured is None:
            if signature != self._warm:
                self._warm = signature
                return self._cost_and_grads(params, batch, negative_ids)
            with span("cunvsm.step.capture"):
                self._captured = _CapturedStep(
                    functools.partial(self._cost_and_grads, params), self._generator, batch,
                    negative_ids, self._uniform,
                )
            self._signature = signature
        elif signature != self._signature:
            return self._cost_and_grads(params, batch, negative_ids)
        with span("cunvsm.step.replay"):
            cost, grads = self._captured.replay(batch, negative_ids)
            self.replays += 1
            return cost.clone(), grads


def make_train_step(
    desc: ModelDesc,
    cfg: TrainConfig,
    device,
    generator: torch.Generator,
    num_entities: Optional[int] = None,
    kind: Optional[ObjectiveKind] = None,
    mesh=None,
):
    """Build ``step(params, opt_state, batch, negative_ids=None) -> cost``
    for ``kind`` (by default the one the mixture weights of ``cfg`` give).

    The step updates ``params`` and ``opt_state`` in place; that replaces
    the JAX package's buffer donation.  ``generator`` (on ``device``) draws
    the negatives unless ``negative_ids`` gives them (see
    ``_text_entity_grads``).  ``num_entities`` bounds the negative draws
    when the entity table is larger than the collection.  The returned cost
    is a 0-d tensor on ``device``; reading it waits for the step.

    ``mesh`` (a ``parallel.mesh.Mesh``) makes it this rank's part of the
    mesh step (see the module doc): ``batch`` is then the rank's rows of the
    global batch and the returned cost the global one.

    On a CUDA device without a mesh a text-entity or composite step replays
    its cost and gradients from a CUDA graph from its second call on
    (``StepGraph``, ``step.graph``, whose ``replays`` counts the replayed
    steps).
    """
    if kind is None:
        kind = objective_kind_from_config(cfg)
    optimizer = Optimizer(cfg, mesh=mesh)
    lr = cfg.resolved_learning_rate()
    lam = scaled_regularization_lambda(cfg)

    def cost_and_grads(params: ModelParams, batch, negative_ids):
        return compute_cost_and_grads(
            kind, params, batch, generator, device, desc, cfg, num_entities, negative_ids, mesh,
        )

    graph = StepGraph(cost_and_grads, kind, mesh, device, generator, cfg.uniform_feature_weights)

    def step(params: ModelParams, opt_state: OptState, batch, negative_ids=None):
        with span("cunvsm.step.cost_and_grads"):
            cost, grads = graph(params, batch, negative_ids)
        optimizer.apply(params, opt_state, grads, lr, lam)
        return cost

    step.graph = graph
    return step


def make_cost_fn(desc: ModelDesc, cfg: TrainConfig, kind: ObjectiveKind, device,
                 generator: Optional[torch.Generator] = None, num_entities: Optional[int] = None,
                 mesh=None):
    """Forward-only ``cost(params, batch, negative_ids=None)`` (Model::get_cost,
    model.cu:154-174): the reported cost of ``compute_cost_and_grads``.  The
    same draws (or ``negative_ids``) give the same cost."""

    def cost(params: ModelParams, batch, negative_ids=None):
        c, _ = compute_cost_and_grads(
            kind, params, batch, generator, device, desc, cfg, num_entities,
            negative_ids=negative_ids, mesh=mesh,
        )
        return c

    return cost


def make_optimized_cost_fn(desc: ModelDesc, cfg: TrainConfig, kind: ObjectiveKind, device,
                           generator: Optional[torch.Generator] = None):
    """The scalar whose gradient the merged ascent gradients are.

    For a single objective it is the reported cost.  For a composite the
    reference *reports* the mean of the constituent costs
    (intermediate_results.cu:222-230) but *optimizes* sum_i(w_i * c_i) /
    sum_i(w_i) (MergeGradientsFn, intermediate_results.cu:30-38); the two
    agree only at equal weights.
    """
    if kind not in COMPOSITES:
        return make_cost_fn(desc, cfg, kind, device, generator)
    table, sim_weight = _similarity_table_and_weight(kind, cfg)
    total = cfg.text_entity_weight + sim_weight

    def cost(params: ModelParams, batch, negative_ids=None):
        te_batch, sim_batch = batch
        te_cost, _ = _text_entity_grads(
            params, te_batch, generator, device, desc, cfg, negative_ids=negative_ids
        )
        sim_cost, _ = _similarity_grads(params, sim_batch, desc, table)
        return (cfg.text_entity_weight * te_cost + sim_weight * sim_cost) / total

    return cost
