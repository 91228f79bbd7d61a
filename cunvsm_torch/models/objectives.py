"""The NVSM / LSE objectives in PyTorch: cost plus ascent gradients.

Port of ``cunvsm_tpu/models/objectives.py``:

* the per-instance path (``text_entity_cost_and_grads``): k uniform
  negatives per instance, the entity gradient either in rank-1 factored
  form (``_cost_and_grads_factored``, for the accumulate-only optimizers)
  or expanded to one row per (instance, slot), which the window-averaged
  optimizers and the entity L2 normalizer need;
* the rolled-pool path (``text_entity_cost_and_grads_pooled``): a pool of P
  negative ids per step, instance b (residue r = b // (B/P)) scoring against
  pool slots (r + j*stride) % P, with the negative dots and gradients as
  [P]-batched GEMMs;
* batch-shared negatives (``text_entity_cost_and_grads_shared``): k
  negatives for the whole batch, the negative side as GEMMs;
* the representation-similarity objective of one table
  (``similarity_cost_and_grads``) and the weighted merge of the
  constituents of a composite (``merge_ascent_grads``).

As in the JAX package, gradients are *ascent* gradients (the negation of
d cost / d theta), the VJPs come from autodiff (``torch.func.vjp`` here,
``jax.vjp`` / ``jax.value_and_grad`` there), and every function takes its
negative, pool or shared ids explicitly, so that both packages can score
the same draws.

Under a mesh (``parallel/mesh.py``; every function takes ``mesh=None``) a
rank holds its data group's rows of the batch and its model index's rows of
the entity table, and the functions call the collectives that the JAX
package's partitioner inserts:

* entity rows are read from their owners: every rank of a data group
  selects the rows it owns (zeros elsewhere) and one all-reduce over the
  model axis puts the gathered rows together (``entity_rows``); adding
  zeros is exact, so the rows are bitwise the owner's.  The traffic is that
  of the gathered rows, never of the table;
* batch normalization takes its statistics over the global batch
  (``ops/batchnorm.py``);
* the cost's normalizer is the global batch size, so the returned cost and
  transform gradients are this data group's *part* of the global ones: the
  step sums them over the data axis, once;
* the entity descriptors that come back are global, so that every owner
  sees every instance's update: per-instance rows are all-gathered over the
  data axis (``entity_grads``); the rolled pool's [P, d] gradient and the
  shared negatives' [k, d] gradient are partial sums over this group's
  rows and are all-reduced over the data axis (``pool_grad``,
  ``shared_neg_grad``).  The word descriptors stay local: the optimizer
  reduces them (``optim/updates.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from cunvsm_torch.config import ModelDesc, Nonlinearity
from cunvsm_torch.models.params import ModelParams
from cunvsm_torch.ops.activations import (
    hard_tanh,
    l2_normalize_rows,
    log_truncated_sigmoid,
    truncated_sigmoid,
)
from cunvsm_torch.ops.batchnorm import batch_norm_train
from cunvsm_torch.ops.cast import cast_table
from cunvsm_torch.spans import span


class TextEntityBatch(NamedTuple):
    """Batch for the text->entity objective (data.cu:8-60).

    features:        [B, W] int64 word ids.
    feature_weights: [B, W] per-term weights.
    labels:          [B] int64 entity (document) ids.
    weights:         [B] per-instance weights; padding rows carry 0.
    negatives:       optional [B, k] int64 negative entity ids drawn on the
                     host (reference-RNG replay, labels.cu:3-22); None
                     lets the step draw them.
    """

    features: torch.Tensor
    feature_weights: torch.Tensor
    labels: torch.Tensor
    weights: torch.Tensor
    negatives: Optional[torch.Tensor] = None

    @classmethod
    def from_numpy(cls, np_batch, device=None, dtype=torch.float32):
        """From a host batch (``data.instances.TextEntityBatchNp``)."""

        def put(x, dt):
            return torch.from_numpy(x).to(device=device, dtype=dt)

        negatives = getattr(np_batch, "negatives", None)
        return cls(
            features=put(np_batch.features, torch.int64),
            feature_weights=put(np_batch.feature_weights, dtype),
            labels=put(np_batch.labels, torch.int64),
            weights=put(np_batch.weights, dtype),
            negatives=None if negatives is None else put(negatives, torch.int64),
        )


class SimilarityBatch(NamedTuple):
    """Batch of (id, id, weight) pairs (data.cu:154-188)."""

    ids: torch.Tensor  # [B, 2] int64
    weights: torch.Tensor  # [B]

    @classmethod
    def from_numpy(cls, np_batch, device=None, dtype=torch.float32):
        """From a host batch (``data.sources.SimilarityBatchNp``)."""
        return cls(
            ids=torch.from_numpy(np_batch.ids).to(device=device, dtype=torch.int64),
            weights=torch.from_numpy(np_batch.weights).to(device=device, dtype=dtype),
        )


class SparseGrad(NamedTuple):
    """Sparse ascent-gradient descriptor of a representations table:
    ``table[indices[i, w]] += lr * weights[i, w] * grad[i]`` for every
    instance i and window slot w; duplicate indices accumulate
    (update_repr_kernel, storage.cu:37-49)."""

    grad: torch.Tensor  # [num_instances, dim]
    indices: torch.Tensor  # [num_instances, window]
    weights: Optional[torch.Tensor]  # [num_instances, window] or None
    # Under a model-sharded table: [num_instances, window] bool, true where
    # this rank owns the row; ``indices`` are then local rows, and the
    # updates of rows owned elsewhere are dropped
    # (``optim.updates.localize_descriptor``).
    owned: Optional[torch.Tensor] = None


class AscentGrads(NamedTuple):
    """All gradients of one step; the transform's are None for a
    similarity objective, which does not touch it."""

    word: Tuple[SparseGrad, ...]
    entity: Tuple[SparseGrad, ...]
    transform_w: Optional[torch.Tensor]
    transform_b: Optional[torch.Tensor]


def sample_shared_negative_entities(
    generator: torch.Generator, num_entities: int, num_negative: int, device=None
) -> torch.Tensor:
    """One batch-shared set of k uniform negative entity ids: every
    instance of the batch scores against the same k negatives."""
    return torch.randint(
        0, num_entities, (num_negative,), generator=generator, device=device
    )


def sample_negative_pool(
    generator: torch.Generator, num_entities: int, pool_size: int, device=None
) -> torch.Tensor:
    """Per-step pool of uniform negative ids for the rolled-pool scheme."""
    return torch.randint(
        0, num_entities, (pool_size,), generator=generator, device=device
    )


def rolled_pool_negative_ids(
    pool_ids: torch.Tensor, batch_size: int, num_negative: int, stride: int = 1
) -> torch.Tensor:
    """The per-instance negative ids of the rolled-pool scheme: instance b
    has residue r = b // (B/P) and uses pool slots (r + j*stride) % P."""
    P = pool_ids.shape[0]
    q = batch_size // P
    if q == 0 or batch_size % P:
        raise ValueError(
            f"batch size {batch_size} must be a positive multiple of the "
            f"pool size {P}"
        )
    r = torch.arange(batch_size, device=pool_ids.device) // q
    j = torch.arange(num_negative, device=pool_ids.device)
    return pool_ids[(r[:, None] + stride * j[None, :]) % P]


def gather_phrase_reprs(
    word_reprs: torch.Tensor,
    features: torch.Tensor,
    feature_weights: Optional[torch.Tensor],
    window_sum_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """out[i] = (1/window) * sum_w feature_weights[i, w] * word_reprs[features[i, w]]

    (average_repr_kernel, params.cu:77-95: division by the window, not by
    the weight sum).  ``feature_weights=None`` means uniform weights and
    skips the multiply.  A bfloat16 table is gathered at half width and the
    window sum widens to float32, unless ``window_sum_dtype`` is the table's
    dtype: then the sum and the division run at stream width and widen
    after.
    """
    batch, window = features.shape
    flat = word_reprs.index_select(0, features.reshape(-1))  # [B*W, d]
    acc_dtype = torch.float32 if flat.dtype == torch.bfloat16 else flat.dtype
    if feature_weights is not None:
        flat = flat * feature_weights.reshape(-1).to(flat.dtype)[:, None]
    sum_dtype = flat.dtype if window_sum_dtype == flat.dtype else acc_dtype
    summed = flat.view(batch, window, -1).sum(dim=1, dtype=sum_dtype)
    return (summed / window).to(acc_dtype)


def apply_transform(
    phrase: torch.Tensor,
    transform_w: torch.Tensor,
    transform_b: torch.Tensor,
    desc: ModelDesc,
    batch_normalization: bool,
    mesh=None,
) -> torch.Tensor:
    """tanh/hard_tanh(x @ W + b), or with batch normalization
    tanh/hard_tanh(BN(x @ W) + b) where the bias is BN's beta
    (Transform::transform, params.cu:377-451)."""
    projected = phrase @ transform_w
    if batch_normalization:
        projected = batch_norm_train(projected, transform_b, desc.batch_norm_eps, mesh)
    else:
        projected = projected + transform_b[None, :]
    if desc.nonlinearity == Nonlinearity.TANH:
        return torch.tanh(projected)
    if desc.nonlinearity == Nonlinearity.HARD_TANH:
        return hard_tanh(projected)
    raise ValueError(f"unknown nonlinearity {desc.nonlinearity}")


def _first_and_rest(first: float, rest: float, n: int, like: torch.Tensor) -> torch.Tensor:
    """[first, rest, ..., rest] of length n on ``like``'s device, built by
    device fills: writing a Python number into a CUDA tensor element waits
    for the device."""
    opts = dict(dtype=like.dtype, device=like.device)
    return torch.cat([torch.full((1,), first, **opts), torch.full((n - 1,), rest, **opts)])


def nce_instance_weights(
    weights: torch.Tensor, num_negative: int, desc: ModelDesc
) -> torch.Tensor:
    """Instance weights over the (k+1) slots with the negative-sampling bias
    correction (objective.cu:258-290): unless ``bias_negative_samples``,
    for k > 1 every weight is scaled by (k+1)/(2k) and positives by k."""
    k = num_negative
    broadcast = weights[:, None].repeat(1, k + 1)
    if not desc.bias_negative_samples and k > 1:
        broadcast = broadcast * ((k + 1.0) / (2.0 * k))
        broadcast = broadcast * _first_and_rest(float(k), 1.0, k + 1, broadcast)[None, :]
    return broadcast


def _project_fn(desc: ModelDesc, mesh=None):
    def project(phrase_pre, w, b):
        phrase = phrase_pre
        if desc.l2_normalize_phrase_reprs:
            phrase = l2_normalize_rows(phrase)
        return apply_transform(phrase, w, b, desc, desc.batch_normalization, mesh)

    return project


def _nce_loss(dots_raw, nce_w, desc: ModelDesc, batch_size_normalizer):
    """(cost, similarity_probs) of the NCE loss over the pre-sign dot
    products [B, k+1], positive column first; the negative columns are
    negated (objective.cu:176-189), and cost = -(sum of weighted log
    probabilities) / batch_size (intermediate_results.cu:81-124)."""
    signs = _first_and_rest(1.0, -1.0, dots_raw.shape[1], dots_raw)
    eps_f = desc.sigmoid_eps_forward if desc.clip_sigmoid else 0.0
    eps_b = desc.sigmoid_eps_backward if desc.clip_sigmoid else 0.0
    dots = dots_raw * signs[None, :]
    log_probs = log_truncated_sigmoid(dots, eps_f, eps_b)
    cost = -torch.sum(nce_w * log_probs) / batch_size_normalizer
    return cost, truncated_sigmoid(dots, eps_f)


def _nce_tail(dots_raw, nce_w, desc: ModelDesc, batch_size_normalizer):
    """(cost, similarity_probs, d cost / d dots_raw) of ``_nce_loss``."""

    def tail(dots_raw_):
        return _nce_loss(dots_raw_, nce_w, desc, batch_size_normalizer)

    cost, tail_vjp, similarity_probs = torch.func.vjp(tail, dots_raw, has_aux=True)
    (g_dots_raw,) = tail_vjp(torch.ones_like(cost))
    return cost, similarity_probs, g_dots_raw


def _word_descriptor(g_phrase, batch, window, feature_weights):
    return SparseGrad(
        grad=-g_phrase / window, indices=batch.features, weights=feature_weights
    )


class TextEntityIntermediates(NamedTuple):
    """The gathered tensors that gradients are taken with respect to:
    ``phrase_pre`` is the window average before the optional phrase L2
    normalizer, ``entity_pre`` the gathered entity rows before the entity
    L2 normalizer (objective.cu:164-189, 444-478)."""

    phrase_pre: torch.Tensor  # [B, d_w]
    entity_pre: torch.Tensor  # [B, k+1, d_e]


def text_entity_loss(
    inter: TextEntityIntermediates,
    transform_w: torch.Tensor,
    transform_b: torch.Tensor,
    nce_weights: torch.Tensor,
    desc: ModelDesc,
    batch_size_normalizer,
    mesh=None,
):
    """(cost, similarity_probs) of the NCE loss given the gathered tensors
    (objective.cu:30-313)."""
    projections = _project_fn(desc, mesh)(inter.phrase_pre, transform_w, transform_b)
    entity = inter.entity_pre
    if desc.l2_normalize_entity_reprs:
        entity = l2_normalize_rows(entity)
    dots_raw = torch.einsum("bd,bkd->bk", projections, entity)
    return _nce_loss(dots_raw, nce_weights, desc, batch_size_normalizer)


def _gather_entities(
    entity_reprs: torch.Tensor, entity_ids: torch.Tensor, mesh=None,
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """[..., d] rows ``entity_ids`` of ``entity_reprs``, cast to ``dtype``
    when given.  With ``mesh``, ``entity_reprs`` is this rank's shard of the
    table and ``entity_ids`` are global rows, the same on every rank of the
    data group: the rows come from their owners (``Mesh.gather_rows``)."""
    flat = entity_ids.reshape(-1)
    if mesh is None:
        rows = entity_reprs.index_select(0, flat)
        if dtype is not None:
            rows = rows.to(dtype)
    else:
        rows = mesh.gather_rows(entity_reprs, flat, "entity_rows", dtype)
    return rows.view(*entity_ids.shape, -1)


def _global_descriptor(desc: SparseGrad, mesh) -> SparseGrad:
    """The descriptor of every data group's instances from this group's:
    gradient rows, indices and weights all-gathered over the data axis."""
    if mesh is None:
        return desc

    def gather(t):
        return None if t is None else mesh.all_gather(t, "data", "entity_grads")

    return SparseGrad(gather(desc.grad), gather(desc.indices), gather(desc.weights))


def text_entity_cost(
    params: ModelParams,
    batch: TextEntityBatch,
    entity_ids: torch.Tensor,
    desc: ModelDesc,
    batch_size_normalizer=None,
):
    """Forward-only (cost, similarity_probs) (Model::get_cost parity)."""
    if batch_size_normalizer is None:
        batch_size_normalizer = batch.features.shape[0]
    inter = TextEntityIntermediates(
        phrase_pre=gather_phrase_reprs(params.word_reprs, batch.features, batch.feature_weights),
        entity_pre=_gather_entities(params.entity_reprs, entity_ids),
    )
    nce_w = nce_instance_weights(batch.weights, entity_ids.shape[1] - 1, desc)
    return text_entity_loss(
        inter, params.transform_w, params.transform_b, nce_w, desc, batch_size_normalizer
    )


def text_entity_cost_and_grads(
    params: ModelParams,
    batch: TextEntityBatch,
    entity_ids: torch.Tensor,
    desc: ModelDesc,
    batch_size_normalizer=None,
    factored_entity_grads: bool = False,
    stream_dtype: Optional[torch.dtype] = None,
    uniform_feature_weights: bool = False,
    window_sum_dtype: Optional[torch.dtype] = None,
    mesh=None,
):
    """(cost, similarity_probs, AscentGrads) on the per-instance path;
    ``entity_ids`` is [B, k+1], the label first.

    Word descriptor: (d ascent / d phrase_pre) / window over the batch's
    word ids.  Entity descriptor: with ``factored_entity_grads`` (and the
    entity L2 normalizer off) rank-1 factored, grad = projections [B, d],
    indices = entity_ids, weights = the signed multipliers
    (objective.cu:380-403), which accumulates like the expanded form but
    never builds it; otherwise expanded, one row per (instance, slot) with
    window 1 (intermediate_results.cu:300-308), as the window-averaged
    optimizers and the entity L2 normalizer need.  ``stream_dtype``
    (bfloat16) casts, on the factored path only, the word table with
    :func:`cast_table` and the gathered entity rows, for the gathers and the
    NCE dots; masters stay float32.
    """
    if batch_size_normalizer is None:
        batch_size_normalizer = batch.features.shape[0]
    window = batch.features.shape[1]
    num_negative = entity_ids.shape[1] - 1
    feature_weights = None if uniform_feature_weights else batch.feature_weights
    use_factored = factored_entity_grads and not desc.l2_normalize_entity_reprs

    word_table = params.word_reprs
    cast = use_factored and stream_dtype is not None and stream_dtype != word_table.dtype
    if cast:
        with span("cunvsm.step.cast"):
            word_table = cast_table(word_table, stream_dtype)
    phrase_pre = gather_phrase_reprs(
        word_table, batch.features, feature_weights, window_sum_dtype
    )
    # Gathering the float32 rows and casting them is bitwise the JAX
    # package's whole-table astype followed by the gather.
    entity_pre = _gather_entities(
        params.entity_reprs, entity_ids, mesh, stream_dtype if cast else None
    )
    nce_w = nce_instance_weights(batch.weights, num_negative, desc)
    if use_factored:
        return _cost_and_grads_factored(
            phrase_pre, entity_pre, params, batch, entity_ids, nce_w, desc,
            batch_size_normalizer, window, feature_weights, mesh,
        )

    def loss_fn(phrase_pre_, entity_pre_, w_, b_):
        inter = TextEntityIntermediates(phrase_pre_, entity_pre_)
        return text_entity_loss(inter, w_, b_, nce_w, desc, batch_size_normalizer, mesh)

    cost, loss_vjp, similarity_probs = torch.func.vjp(
        loss_fn, phrase_pre, entity_pre, params.transform_w, params.transform_b,
        has_aux=True,
    )
    g_phrase, g_entity, g_w, g_b = loss_vjp(torch.ones_like(cost))
    ascent = AscentGrads(
        word=(_word_descriptor(g_phrase, batch, window, feature_weights),),
        entity=(
            _global_descriptor(
                SparseGrad(
                    grad=-g_entity.reshape(-1, g_entity.shape[-1]),
                    indices=entity_ids.reshape(-1, 1),
                    weights=None,
                ),
                mesh,
            ),
        ),
        transform_w=-g_w,
        transform_b=-g_b,
    )
    return cost, similarity_probs, ascent


def _cost_and_grads_factored(
    phrase_pre, entity_pre, params, batch, entity_ids, nce_w, desc,
    batch_size_normalizer, window, feature_weights, mesh=None,
):
    """Rank-1 entity gradients with explicitly staged VJPs:

      d cost / d proj[b]        = sum_k g_dots_raw[b, k] * entity_pre[b, k]
      d ascent / d entity[b, k] = -g_dots_raw[b, k] * proj[b]

    where g_dots_raw is the cotangent of the pre-sign dot products.  Both
    dot products run at the stream dtype and sum in float32."""
    acc_dtype = torch.float32 if entity_pre.dtype == torch.bfloat16 else entity_pre.dtype
    projections, project_vjp = torch.func.vjp(
        _project_fn(desc, mesh), phrase_pre, params.transform_w, params.transform_b
    )
    proj_s = projections.to(entity_pre.dtype)
    dots_raw = torch.sum(proj_s[:, None, :] * entity_pre, dim=-1, dtype=acc_dtype)
    with span("cunvsm.step.loss"):
        cost, similarity_probs, g_dots_raw = _nce_tail(
            dots_raw, nce_w, desc, batch_size_normalizer
        )
    with span("cunvsm.step.backward"):
        g_projections = torch.sum(
            g_dots_raw.to(entity_pre.dtype)[:, :, None] * entity_pre,
            dim=1, dtype=acc_dtype,
        ).to(projections.dtype)
        g_phrase, g_w, g_b = project_vjp(g_projections)
        ascent = AscentGrads(
            word=(_word_descriptor(g_phrase, batch, window, feature_weights),),
            entity=(
                _global_descriptor(
                    SparseGrad(grad=projections, indices=entity_ids, weights=-g_dots_raw), mesh
                ),
            ),
            transform_w=-g_w,
            transform_b=-g_b,
        )
    return cost, similarity_probs, ascent


def text_entity_cost_and_grads_pooled(
    params: ModelParams,
    batch: TextEntityBatch,
    pool_ids: torch.Tensor,
    num_negative: int,
    desc: ModelDesc,
    batch_size_normalizer=None,
    stream_dtype: Optional[torch.dtype] = None,
    uniform_feature_weights: bool = False,
    window_sum_dtype: Optional[torch.dtype] = None,
    pool_stride: int = 1,
    mesh=None,
):
    """(cost, similarity_probs, AscentGrads) with rolled-pool negatives.

    Residue r owns the contiguous batch rows [r*Q, (r+1)*Q), Q = B/P, and
    scores against the pool window pool[(r + j*stride) % P], j < k.  The
    negative dots, their transpose and the negative-row gradients are three
    [P]-batched GEMMs (``torch.bmm``, float32 accumulation); the window
    gradients fold back onto pool rows with k rolls,
    pool_grad[p] = sum_j window_grads[(p - j*stride) % P, j].  The entity
    update is B rank-1 label rows plus P dense pool rows, both weight-free.
    Requires B % P == 0 and P >= k.

    Under a mesh the batch rows are this data group's, so the group holds
    the residues [d*P/D, (d+1)*P/D) of the D data groups (P % D == 0) and
    all P pool rows, since its windows reach round the whole pool.  Its
    window gradients sit at that offset of the global [P, k, d] tensor, zero
    elsewhere; the k rolls act on the global pool axis, and the partial
    [P, d] pool gradient is summed over the data axis after them.
    """
    if desc.l2_normalize_entity_reprs:
        raise ValueError("pooled negatives do not support l2_normalize_entity_reprs")
    B, window = batch.features.shape
    P = pool_ids.shape[0]
    groups = 1 if mesh is None else mesh.data
    if (B * groups) % P != 0:
        raise ValueError(f"batch size {B * groups} not divisible by pool size {P}")
    if P % groups != 0:
        raise ValueError(f"pool size {P} not divisible by data axis {groups}")
    if P < num_negative:
        raise ValueError(f"pool size {P} < num negatives {num_negative}")
    Q, k, S = B * groups // P, num_negative, pool_stride
    P_loc = P // groups  # the residues of this data group
    first = 0 if mesh is None else mesh.data_index * P_loc
    if len({(j * S) % P for j in range(k)}) != k:
        raise ValueError(f"pool stride {S} does not give {k} distinct slots mod {P}")
    if batch_size_normalizer is None:
        batch_size_normalizer = B
    feature_weights = None if uniform_feature_weights else batch.feature_weights

    word_table = params.word_reprs
    cast = stream_dtype is not None and stream_dtype != word_table.dtype
    if cast:
        with span("cunvsm.step.cast"):
            word_table = cast_table(word_table, stream_dtype)
    phrase_pre = gather_phrase_reprs(
        word_table, batch.features, feature_weights, window_sum_dtype
    )
    # Only B + P entity rows are read: gather from the float32 master and
    # cast the gathered rows.
    row_dtype = stream_dtype if cast else None
    pos = _gather_entities(params.entity_reprs, batch.labels, mesh, row_dtype)  # [B, d]
    pool = _gather_entities(params.entity_reprs, pool_ids, mesh, row_dtype)  # [P, d]
    ar = first + torch.arange(P_loc, device=pool_ids.device)
    win_slots = (ar[:, None] + S * torch.arange(k, device=pool_ids.device)[None, :]) % P
    pool_windows = pool.index_select(0, win_slots.reshape(-1)).view(P_loc, k, -1)
    nce_w = nce_instance_weights(batch.weights, k, desc)

    acc_dtype = torch.float32 if pos.dtype == torch.bfloat16 else pos.dtype
    projections, project_vjp = torch.func.vjp(
        _project_fn(desc, mesh), phrase_pre, params.transform_w, params.transform_b
    )
    proj_s = projections.to(pos.dtype)
    # Residue-major view: a free contiguous reshape.  The GEMM operands are
    # widened to the accumulation dtype (exact for bfloat16 values), which
    # is the JAX package's preferred_element_type=float32.
    proj_r = proj_s.reshape(P_loc, Q, -1).to(acc_dtype)
    windows_acc = pool_windows.to(acc_dtype)

    pos_dots = torch.sum(proj_s * pos, dim=-1, dtype=acc_dtype)  # [B]
    neg_dots = torch.bmm(proj_r, windows_acc.transpose(1, 2))  # [P, Q, k]
    dots_raw = torch.cat([pos_dots[:, None], neg_dots.reshape(B, k)], dim=1)
    with span("cunvsm.step.loss"):
        cost, similarity_probs, g_dots_raw = _nce_tail(
            dots_raw, nce_w, desc, batch_size_normalizer
        )
    with span("cunvsm.step.backward"):
        g0 = g_dots_raw[:, 0]
        g_neg_r = g_dots_raw[:, 1:].to(pos.dtype).reshape(P_loc, Q, k).to(acc_dtype)

        g_proj_neg = torch.bmm(g_neg_r, windows_acc)  # [P, Q, d]
        g_projections = (
            g0.to(acc_dtype)[:, None] * pos.to(acc_dtype) + g_proj_neg.reshape(B, -1)
        ).to(projections.dtype)
        g_phrase, g_w, g_b = project_vjp(g_projections)

        window_grads = torch.bmm(g_neg_r.transpose(1, 2), proj_r)  # [P_loc, k, d]
        if mesh is not None:
            placed = window_grads.new_zeros((P, *window_grads.shape[1:]))
            placed[first:first + P_loc] = window_grads
            window_grads = placed
        pool_grad = window_grads[:, 0, :]
        for j in range(1, k):
            pool_grad = pool_grad + torch.roll(window_grads[:, j, :], j * S, 0)
        if mesh is not None:
            pool_grad = mesh.all_reduce(pool_grad, "data", "pool_grad")

        ascent = AscentGrads(
            word=(_word_descriptor(g_phrase, batch, window, feature_weights),),
            entity=(
                _global_descriptor(
                    SparseGrad(
                        grad=-g_dots_raw[:, :1] * projections.to(acc_dtype),
                        indices=batch.labels[:, None],
                        weights=None,
                    ),
                    mesh,
                ),
                SparseGrad(
                    grad=-pool_grad.to(acc_dtype), indices=pool_ids[:, None], weights=None
                ),
            ),
            transform_w=-g_w,
            transform_b=-g_b,
        )
    return cost, similarity_probs, ascent


def text_entity_cost_and_grads_shared(
    params: ModelParams,
    batch: TextEntityBatch,
    neg_ids: torch.Tensor,
    desc: ModelDesc,
    batch_size_normalizer=None,
    stream_dtype: Optional[torch.dtype] = None,
    uniform_feature_weights: bool = False,
    window_sum_dtype: Optional[torch.dtype] = None,
    mesh=None,
):
    """(cost, similarity_probs, AscentGrads) with the k negatives
    ``neg_ids`` shared by the whole batch; the loss has the per-instance
    form (objective.cu:30-313), and the negative side is GEMMs:

      dots_raw[b, 0]   = <proj_b, pos_b>
      dots_raw[b, 1+n] = <proj_b, neg_n>          ([B, d] @ [d, k])
      d cost/d proj_b  = g0_b * pos_b + g_neg[b] @ negs
      d ascent/d pos_b = -g0_b * proj_b           (weight-free label rows)
      d ascent/d neg_n = -sum_b g_neg[b, n] proj_b ([k, B] @ [B, d], k rows)

    The entity L2 normalizer is refused: its per-row backward does not
    share the GEMM structure.
    """
    if desc.l2_normalize_entity_reprs:
        raise ValueError("shared negatives do not support l2_normalize_entity_reprs")
    if batch_size_normalizer is None:
        batch_size_normalizer = batch.features.shape[0]
    window = batch.features.shape[1]
    num_negative = neg_ids.shape[0]
    feature_weights = None if uniform_feature_weights else batch.feature_weights

    word_table = params.word_reprs
    cast = stream_dtype is not None and stream_dtype != word_table.dtype
    if cast:
        with span("cunvsm.step.cast"):
            word_table = cast_table(word_table, stream_dtype)
    phrase_pre = gather_phrase_reprs(
        word_table, batch.features, feature_weights, window_sum_dtype
    )
    # Gather from the float32 master and cast only the B + k rows read.
    row_dtype = stream_dtype if cast else None
    pos = _gather_entities(params.entity_reprs, batch.labels, mesh, row_dtype)  # [B, d]
    negs = _gather_entities(params.entity_reprs, neg_ids, mesh, row_dtype)  # [k, d]
    nce_w = nce_instance_weights(batch.weights, num_negative, desc)

    acc_dtype = torch.float32 if pos.dtype == torch.bfloat16 else pos.dtype
    projections, project_vjp = torch.func.vjp(
        _project_fn(desc, mesh), phrase_pre, params.transform_w, params.transform_b
    )
    proj_s = projections.to(pos.dtype)
    # The GEMM operands are widened to the accumulation dtype (exact for
    # bfloat16 values): the JAX package's preferred_element_type=float32.
    proj_acc = proj_s.to(acc_dtype)
    negs_acc = negs.to(acc_dtype)
    pos_dots = torch.sum(proj_s * pos, dim=-1, dtype=acc_dtype)  # [B]
    neg_dots = proj_acc @ negs_acc.T  # [B, k]
    dots_raw = torch.cat([pos_dots[:, None], neg_dots], dim=1)
    with span("cunvsm.step.loss"):
        cost, similarity_probs, g_dots_raw = _nce_tail(
            dots_raw, nce_w, desc, batch_size_normalizer
        )
    with span("cunvsm.step.backward"):
        g0 = g_dots_raw[:, 0]
        g_neg = g_dots_raw[:, 1:].to(pos.dtype).to(acc_dtype)  # [B, k]
        g_projections = (
            g0.to(acc_dtype)[:, None] * pos.to(acc_dtype) + g_neg @ negs_acc
        ).to(projections.dtype)
        g_phrase, g_w, g_b = project_vjp(g_projections)
        g_negs_rows = g_neg.T @ proj_acc  # [k, d]
        if mesh is not None:
            # This data group's rows only: the sum over the groups.
            g_negs_rows = mesh.all_reduce(g_negs_rows, "data", "shared_neg_grad")

        ascent = AscentGrads(
            word=(_word_descriptor(g_phrase, batch, window, feature_weights),),
            entity=(
                _global_descriptor(
                    SparseGrad(
                        grad=-g_dots_raw[:, :1] * projections.to(acc_dtype),
                        indices=batch.labels[:, None],
                        weights=None,
                    ),
                    mesh,
                ),
                SparseGrad(grad=-g_negs_rows, indices=neg_ids[:, None], weights=None),
            ),
            transform_w=-g_w,
            transform_b=-g_b,
        )
    return cost, similarity_probs, ascent


def similarity_loss(gathered: torch.Tensor, weights: torch.Tensor, desc: ModelDesc,
                    batch_size_normalizer):
    """Representation-similarity loss (objective.cu:487-575): gathered
    [B, 2, d] pairs, cost = -(sum_i weights[i] * log
    trunc_sigmoid(<r_i1, r_i2>)) / B.  Returns (cost, similarity_probs)."""
    dots = torch.sum(gathered[:, 0, :] * gathered[:, 1, :], dim=-1)
    eps_f = desc.sigmoid_eps_forward if desc.clip_sigmoid else 0.0
    eps_b = desc.sigmoid_eps_backward if desc.clip_sigmoid else 0.0
    log_probs = log_truncated_sigmoid(dots, eps_f, eps_b)
    cost = -torch.sum(weights * log_probs) / batch_size_normalizer
    return cost, truncated_sigmoid(dots, eps_f)


def similarity_cost_and_grads(
    table: torch.Tensor, batch: SimilarityBatch, desc: ModelDesc, batch_size_normalizer=None,
    mesh=None, sharded_table: bool = False,
):
    """(cost, similarity_probs, SparseGrad) of one representations table.
    The gradient of each member of a pair is the other member scaled by the
    multiplier (flip_adjacent_columns, objective.cu:641-661), here from
    autodiff; the descriptor has one row per (pair, member), window 1.
    Under a mesh the pairs are this data group's; ``sharded_table`` says
    that ``table`` is the model-sharded entity table, whose rows are read
    from their owners and whose descriptor comes back global (the word
    table's stays local, as every word descriptor does)."""
    if batch_size_normalizer is None:
        batch_size_normalizer = batch.ids.shape[0]
    row_mesh = mesh if sharded_table else None
    gathered = _gather_entities(table, batch.ids, row_mesh)  # [B, 2, d]

    def loss_fn(g):
        return similarity_loss(g, batch.weights, desc, batch_size_normalizer)

    cost, loss_vjp, similarity_probs = torch.func.vjp(loss_fn, gathered, has_aux=True)
    (g,) = loss_vjp(torch.ones_like(cost))
    sparse = _global_descriptor(
        SparseGrad(
            grad=-g.reshape(-1, table.shape[1]), indices=batch.ids.reshape(-1, 1), weights=None,
        ),
        row_mesh,
    )
    return cost, similarity_probs, sparse


def scale_sparse(g: SparseGrad, scale: float) -> SparseGrad:
    return g._replace(grad=g.grad * scale)


def merge_ascent_grads(grads_and_weights) -> AscentGrads:
    """Weighted merge of the constituents' gradients (MergeGradientsFn,
    intermediate_results.cu:3-60): each is scaled by weight / sum of
    weights; the transform gradients are summed and the sparse descriptors
    concatenated."""
    total = sum(w for _, w in grads_and_weights)
    word: list = []
    entity: list = []
    t_w = t_b = None
    for g, w in grads_and_weights:
        s = w / total
        word.extend(scale_sparse(sg, s) for sg in g.word)
        entity.extend(scale_sparse(sg, s) for sg in g.entity)
        if g.transform_w is not None:
            t_w = g.transform_w * s if t_w is None else t_w + g.transform_w * s
        if g.transform_b is not None:
            t_b = g.transform_b * s if t_b is None else t_b + g.transform_b * s
    return AscentGrads(word=tuple(word), entity=tuple(entity), transform_w=t_w, transform_b=t_b)
