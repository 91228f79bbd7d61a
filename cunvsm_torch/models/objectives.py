"""The TEXT_ENTITY NCE objective in PyTorch: cost plus ascent gradients.

Port of the TEXT_ENTITY paths of ``cunvsm_tpu/models/objectives.py``:

* the factored per-instance path (``text_entity_cost_and_grads`` /
  ``_cost_and_grads_factored``): k uniform negatives per instance, the
  entity gradient in rank-1 descriptor form;
* the rolled-pool path (``text_entity_cost_and_grads_pooled``): a pool of P
  negative ids per step, instance b (residue r = b // (B/P)) scoring against
  pool slots (r + j*stride) % P, with the negative dots and gradients as
  [P]-batched GEMMs.

As in the JAX package, gradients are *ascent* gradients (the negation of
d cost / d theta), the ``project`` and ``tail`` VJPs come from autodiff
(``torch.func.vjp`` here, ``jax.vjp`` there), and every function takes its
negative or pool ids explicitly, so that both packages can score the same
draws.  The expanded per-slot entity layout that the entity L2 normalizer
and the window-averaged optimizers need, the batch-shared negatives and the
similarity objectives are not part of this package yet (ROADMAP.md,
queue 1, "Still to port").
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


class TextEntityBatch(NamedTuple):
    """Batch for the text->entity objective (data.cu:8-60).

    features:        [B, W] int64 word ids.
    feature_weights: [B, W] per-term weights.
    labels:          [B] int64 entity (document) ids.
    weights:         [B] per-instance weights; padding rows carry 0.
    """

    features: torch.Tensor
    feature_weights: torch.Tensor
    labels: torch.Tensor
    weights: torch.Tensor

    @classmethod
    def from_numpy(cls, np_batch, device=None, dtype=torch.float32):
        """From a host batch (``data.instances.TextEntityBatchNp``)."""

        def put(x, dt):
            return torch.from_numpy(x).to(device=device, dtype=dt)

        return cls(
            features=put(np_batch.features, torch.int64),
            feature_weights=put(np_batch.feature_weights, dtype),
            labels=put(np_batch.labels, torch.int64),
            weights=put(np_batch.weights, dtype),
        )


class SparseGrad(NamedTuple):
    """Sparse ascent-gradient descriptor of a representations table:
    ``table[indices[i, w]] += lr * weights[i, w] * grad[i]`` for every
    instance i and window slot w; duplicate indices accumulate
    (update_repr_kernel, storage.cu:37-49)."""

    grad: torch.Tensor  # [num_instances, dim]
    indices: torch.Tensor  # [num_instances, window]
    weights: Optional[torch.Tensor]  # [num_instances, window] or None


class AscentGrads(NamedTuple):
    word: Tuple[SparseGrad, ...]
    entity: Tuple[SparseGrad, ...]
    transform_w: torch.Tensor
    transform_b: torch.Tensor


def sample_negative_entities(
    generator: torch.Generator, labels: torch.Tensor, num_entities: int,
    num_negative: int,
) -> torch.Tensor:
    """[positive, neg_1..neg_k] per instance, negatives uniform over
    [0, num_entities) (labels.cu:3-22)."""
    negatives = torch.randint(
        0, num_entities, (labels.shape[0], num_negative),
        generator=generator, device=labels.device, dtype=labels.dtype,
    )
    return torch.cat([labels[:, None], negatives], dim=1)


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
) -> torch.Tensor:
    """tanh/hard_tanh(x @ W + b), or with batch normalization
    tanh/hard_tanh(BN(x @ W) + b) where the bias is BN's beta
    (Transform::transform, params.cu:377-451)."""
    projected = phrase @ transform_w
    if batch_normalization:
        projected = batch_norm_train(projected, transform_b, desc.batch_norm_eps)
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


def _project_fn(desc: ModelDesc):
    def project(phrase_pre, w, b):
        phrase = phrase_pre
        if desc.l2_normalize_phrase_reprs:
            phrase = l2_normalize_rows(phrase)
        return apply_transform(phrase, w, b, desc, desc.batch_normalization)

    return project


def _nce_tail(dots_raw, nce_w, desc: ModelDesc, batch_size_normalizer):
    """(cost, similarity_probs, d cost / d dots_raw) of the NCE loss over the
    pre-sign dot products [B, k+1], positive column first; the negative
    columns are negated (objective.cu:176-189)."""
    signs = _first_and_rest(1.0, -1.0, dots_raw.shape[1], dots_raw)
    eps_f = desc.sigmoid_eps_forward if desc.clip_sigmoid else 0.0
    eps_b = desc.sigmoid_eps_backward if desc.clip_sigmoid else 0.0

    def tail(dots_raw_):
        dots = dots_raw_ * signs[None, :]
        log_probs = log_truncated_sigmoid(dots, eps_f, eps_b)
        cost = -torch.sum(nce_w * log_probs) / batch_size_normalizer
        return cost, truncated_sigmoid(dots, eps_f)

    cost, tail_vjp, similarity_probs = torch.func.vjp(tail, dots_raw, has_aux=True)
    (g_dots_raw,) = tail_vjp(torch.ones_like(cost))
    return cost, similarity_probs, g_dots_raw


def _word_descriptor(g_phrase, batch, window, feature_weights):
    return SparseGrad(
        grad=-g_phrase / window, indices=batch.features, weights=feature_weights
    )


def text_entity_cost_and_grads(
    params: ModelParams,
    batch: TextEntityBatch,
    entity_ids: torch.Tensor,
    desc: ModelDesc,
    batch_size_normalizer=None,
    stream_dtype: Optional[torch.dtype] = None,
    uniform_feature_weights: bool = False,
    window_sum_dtype: Optional[torch.dtype] = None,
):
    """(cost, similarity_probs, AscentGrads) on the factored per-instance
    path; ``entity_ids`` is [B, k+1], the label first.

    Word descriptor: (d ascent / d phrase_pre) / window over the batch's
    word ids.  Entity descriptor: rank-1 factored, grad = projections [B, d],
    indices = entity_ids, weights = the signed multipliers
    (objective.cu:380-403).  ``stream_dtype`` (bfloat16) casts the word
    table with :func:`cast_table` and the gathered entity rows, for the
    gathers and the NCE dots; masters stay float32.
    """
    if desc.l2_normalize_entity_reprs:
        raise NotImplementedError(
            "the entity L2 normalizer needs the expanded entity layout, "
            "not ported yet (ROADMAP.md queue 1)"
        )
    if batch_size_normalizer is None:
        batch_size_normalizer = batch.features.shape[0]
    window = batch.features.shape[1]
    num_negative = entity_ids.shape[1] - 1
    feature_weights = None if uniform_feature_weights else batch.feature_weights

    word_table = params.word_reprs
    cast = stream_dtype is not None and stream_dtype != word_table.dtype
    if cast:
        word_table = cast_table(word_table, stream_dtype)
    phrase_pre = gather_phrase_reprs(
        word_table, batch.features, feature_weights, window_sum_dtype
    )
    # Gathering the float32 rows and casting them is bitwise the JAX
    # package's whole-table astype followed by the gather.
    entity_pre = params.entity_reprs.index_select(0, entity_ids.reshape(-1))
    entity_pre = entity_pre.view(*entity_ids.shape, -1)
    if cast:
        entity_pre = entity_pre.to(stream_dtype)
    nce_w = nce_instance_weights(batch.weights, num_negative, desc)
    return _cost_and_grads_factored(
        phrase_pre, entity_pre, params, batch, entity_ids, nce_w, desc,
        batch_size_normalizer, window, feature_weights,
    )


def _cost_and_grads_factored(
    phrase_pre, entity_pre, params, batch, entity_ids, nce_w, desc,
    batch_size_normalizer, window, feature_weights,
):
    """Rank-1 entity gradients with explicitly staged VJPs:

      d cost / d proj[b]        = sum_k g_dots_raw[b, k] * entity_pre[b, k]
      d ascent / d entity[b, k] = -g_dots_raw[b, k] * proj[b]

    where g_dots_raw is the cotangent of the pre-sign dot products.  Both
    dot products run at the stream dtype and sum in float32."""
    acc_dtype = torch.float32 if entity_pre.dtype == torch.bfloat16 else entity_pre.dtype
    projections, project_vjp = torch.func.vjp(
        _project_fn(desc), phrase_pre, params.transform_w, params.transform_b
    )
    proj_s = projections.to(entity_pre.dtype)
    dots_raw = torch.sum(proj_s[:, None, :] * entity_pre, dim=-1, dtype=acc_dtype)
    cost, similarity_probs, g_dots_raw = _nce_tail(
        dots_raw, nce_w, desc, batch_size_normalizer
    )
    g_projections = torch.sum(
        g_dots_raw.to(entity_pre.dtype)[:, :, None] * entity_pre,
        dim=1, dtype=acc_dtype,
    ).to(projections.dtype)
    g_phrase, g_w, g_b = project_vjp(g_projections)
    ascent = AscentGrads(
        word=(_word_descriptor(g_phrase, batch, window, feature_weights),),
        entity=(SparseGrad(grad=projections, indices=entity_ids, weights=-g_dots_raw),),
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
    """
    if desc.l2_normalize_entity_reprs:
        raise ValueError("pooled negatives do not support l2_normalize_entity_reprs")
    B, window = batch.features.shape
    P = pool_ids.shape[0]
    if B % P != 0:
        raise ValueError(f"batch size {B} not divisible by pool size {P}")
    if P < num_negative:
        raise ValueError(f"pool size {P} < num negatives {num_negative}")
    Q, k, S = B // P, num_negative, pool_stride
    if len({(j * S) % P for j in range(k)}) != k:
        raise ValueError(f"pool stride {S} does not give {k} distinct slots mod {P}")
    if batch_size_normalizer is None:
        batch_size_normalizer = B
    feature_weights = None if uniform_feature_weights else batch.feature_weights

    word_table = params.word_reprs
    cast = stream_dtype is not None and stream_dtype != word_table.dtype
    if cast:
        word_table = cast_table(word_table, stream_dtype)
    phrase_pre = gather_phrase_reprs(
        word_table, batch.features, feature_weights, window_sum_dtype
    )
    # Only B + P entity rows are read: gather from the float32 master and
    # cast the gathered rows.
    pos = params.entity_reprs.index_select(0, batch.labels)  # [B, d]
    pool = params.entity_reprs.index_select(0, pool_ids)  # [P, d]
    if cast:
        pos = pos.to(stream_dtype)
        pool = pool.to(stream_dtype)
    ar = torch.arange(P, device=pool_ids.device)
    win_slots = (ar[:, None] + S * torch.arange(k, device=pool_ids.device)[None, :]) % P
    pool_windows = pool.index_select(0, win_slots.reshape(-1)).view(P, k, -1)
    nce_w = nce_instance_weights(batch.weights, k, desc)

    acc_dtype = torch.float32 if pos.dtype == torch.bfloat16 else pos.dtype
    projections, project_vjp = torch.func.vjp(
        _project_fn(desc), phrase_pre, params.transform_w, params.transform_b
    )
    proj_s = projections.to(pos.dtype)
    # Residue-major view: a free contiguous reshape.  The GEMM operands are
    # widened to the accumulation dtype (exact for bfloat16 values), which
    # is the JAX package's preferred_element_type=float32.
    proj_r = proj_s.reshape(P, Q, -1).to(acc_dtype)
    windows_acc = pool_windows.to(acc_dtype)

    pos_dots = torch.sum(proj_s * pos, dim=-1, dtype=acc_dtype)  # [B]
    neg_dots = torch.bmm(proj_r, windows_acc.transpose(1, 2))  # [P, Q, k]
    dots_raw = torch.cat([pos_dots[:, None], neg_dots.reshape(B, k)], dim=1)
    cost, similarity_probs, g_dots_raw = _nce_tail(
        dots_raw, nce_w, desc, batch_size_normalizer
    )
    g0 = g_dots_raw[:, 0]
    g_neg_r = g_dots_raw[:, 1:].to(pos.dtype).reshape(P, Q, k).to(acc_dtype)

    g_proj_neg = torch.bmm(g_neg_r, windows_acc)  # [P, Q, d]
    g_projections = (
        g0.to(acc_dtype)[:, None] * pos.to(acc_dtype) + g_proj_neg.reshape(B, -1)
    ).to(projections.dtype)
    g_phrase, g_w, g_b = project_vjp(g_projections)

    window_grads = torch.bmm(g_neg_r.transpose(1, 2), proj_r)  # [P, k, d]
    pool_grad = window_grads[:, 0, :]
    for j in range(1, k):
        pool_grad = pool_grad + torch.roll(window_grads[:, j, :], j * S, 0)

    ascent = AscentGrads(
        word=(_word_descriptor(g_phrase, batch, window, feature_weights),),
        entity=(
            SparseGrad(
                grad=-g_dots_raw[:, :1] * projections.to(acc_dtype),
                indices=batch.labels[:, None],
                weights=None,
            ),
            SparseGrad(
                grad=-pool_grad.to(acc_dtype), indices=pool_ids[:, None], weights=None
            ),
        ),
        transform_w=-g_w,
        transform_b=-g_b,
    )
    return cost, similarity_probs, ascent
