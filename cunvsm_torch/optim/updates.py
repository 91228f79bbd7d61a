"""Every optimizer of the reference with its update semantics, in place.

Port of ``cunvsm_tpu/optim/updates.py`` (the single-device paths):

* gradients are *ascent* gradients: ``param += lr * update``
  (model.cu:187-220);
* L2 regularization folds into a multiplicative decay of the whole table
  before the sparse addition, ``param * (1 - lambda * lr) + lr * update``
  (storage.cu:65-67), once per table per step; the bias is never
  regularized (storage.cu:222-227);
* SGD: the decay fold, then every descriptor scattered with scale lr;
* Adagrad: one scalar accumulator per object, fed the dimension-averaged
  squared gradient and read back averaged over the window, with eps
  *inside* the square root (updates_adagrad.cu:21-31, 72-179); the
  transform accumulates g² before dividing (:33-70);
* sparse Adam (SPARSE) and DENSE_UPDATE Adam: a dense first moment and a
  scalar-per-object second moment, both decayed over the *whole* table
  every step while only touched rows receive additions
  (updates_adam.cu:195-252); SPARSE reads both back averaged over the window
  and scatters the step (:332-384), DENSE_UPDATE sweeps every row
  (:293-311); eps sits *outside* the square root;
* full_adam (DENSE_UPDATE_DENSE_VARIANCE): dense m and v with the L2 term
  folded into the moments; one dense accumulation of the sparse descriptors
  feeds both moments, and the sweep over every row is the Triton kernel of
  ``ops/adam_sweep.py`` (updates_adam.cu:203-213, 253-282, 312-328);
* the step counter t starts at 1 (updates.h:197).

Where the JAX package returns new arrays (and donates the old buffers),
this package updates the parameter and state tensors in place.  The
scatters of sgd, Adagrad and the sparse Adam modes add one window slot at a
time with ``index_add_`` over the [B, d] gradient rows, so the [B*W, d]
update stream is never materialized; full_adam's dense accumulation is one
sorted segment sum a table on a card (``_sorted_segment_accumulate``).

Under a mesh (``Optimizer(cfg, mesh=)``, ``parallel/mesh.py``) the
optimizer is one rank's part of the SPMD program:

* the **word table** is replicated and its descriptors are the rank's data
  group's.  For full_adam every rank accumulates its own slice of the
  update stream, split over *every* mesh axis, into a local dense [V, d]
  partial, and **one** all-reduce of that partial over all ranks
  (``word_partial``; narrowed to ``cfg.resolved_cross_chip_reduce_dtype()``
  for the reduce when that is bfloat16, and widened back) gives every rank
  the accumulator of the global batch: the counterpart of the JAX
  package's ``_data_sharded_accumulate``.  The [B*W, d] stream never
  crosses ranks.  The other optimizers' statistics are per instance
  (window averages of state that every instance of the step updates), so
  their [B/D, d] descriptors are all-gathered over the data axis
  (``word_grads``) and every rank applies the global update to its
  replica;
* the **entity table** is sharded by rows over the model axis, and its
  descriptors arrive global (``models/objectives.py``).
  :func:`localize_descriptor` maps their rows to the shard and marks the
  rows owned elsewhere, whose updates the scatters below drop by
  selection, not by a multiply, so that no value read from a row of
  another owner can leak in.  Every optimizer then runs unchanged on the
  shard.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from cunvsm_torch.config import AdamMode, TrainConfig, UpdateMethod
from cunvsm_torch.models.objectives import AscentGrads, SparseGrad
from cunvsm_torch.models.params import ModelParams, tensor_from_numpy
from cunvsm_torch.ops.adam_sweep import fused_adam_dense_sweep
from cunvsm_torch.ops import segment_kernels
from cunvsm_torch.ops.segment_kernels import keep_owned, sorted_segment_sum
from cunvsm_torch.spans import span


class SGDState(NamedTuple):
    """SGD keeps no state; like the JAX package's, it has no leaves."""


class TransformAdagradState(NamedTuple):
    acc_w: torch.Tensor
    acc_b: torch.Tensor


class TransformAdamState(NamedTuple):
    m_w: torch.Tensor
    m_b: torch.Tensor
    v_w: torch.Tensor
    v_b: torch.Tensor
    t: torch.Tensor  # 0-d int32, starts at 1


class ReprAdagradState(NamedTuple):
    acc: torch.Tensor  # [num_objects] scalar accumulator per object


class ReprAdamState(NamedTuple):
    m: torch.Tensor  # [num_objects, dim]
    v: torch.Tensor  # [num_objects] (SPARSE / DENSE_UPDATE) or [num_objects, dim]
    t: torch.Tensor


TransformState = Union[SGDState, TransformAdagradState, TransformAdamState]
ReprState = Union[SGDState, ReprAdagradState, ReprAdamState]


class OptState(NamedTuple):
    word: ReprState
    entity: ReprState
    transform: TransformState


# The state class of each field layout: the JAX package's state types have
# the same field names.
_STATE_TYPES = {
    cls._fields: cls
    for cls in (SGDState, TransformAdagradState, TransformAdamState,
                ReprAdagradState, ReprAdamState)
}


def _state_from_numpy(state, device, dtype):
    cls = _STATE_TYPES[tuple(getattr(state, "_fields", ()))]
    return cls(
        *(
            tensor_from_numpy(
                x, device,
                dtype if np.issubdtype(np.asarray(x).dtype, np.floating) else None,
            )
            for x in state
        )
    )


def opt_state_from_numpy(state, device=None, dtype=None) -> OptState:
    """OptState from any nested triple of NamedTuples with the field names
    of this module's state types, such as the JAX package's OptState of
    any optimizer: the kind of each part is read from its field names."""
    return OptState(
        word=_state_from_numpy(state.word, device, dtype),
        entity=_state_from_numpy(state.entity, device, dtype),
        transform=_state_from_numpy(state.transform, device, dtype),
    )


def opt_state_to_numpy(state: OptState) -> OptState:
    """The same nested NamedTuples holding numpy arrays (host copies: of a
    CPU tensor too, which the in-place steps would otherwise change)."""
    return OptState(
        *(type(s)(*(t.detach().cpu().numpy().copy() for t in s)) for s in state)
    )


# ---------------------------------------------------------------------------
# Shared helpers.
# ---------------------------------------------------------------------------


def _scatter_add(table: torch.Tensor, desc: SparseGrad, scale) -> None:
    """table[indices[i, w]] += scale * weights[i, w] * grad[i], in place;
    one ``index_add_`` per window slot (update_repr_kernel,
    storage.cu:37-49)."""
    for w in range(desc.indices.shape[1]):
        upd = desc.grad
        if desc.weights is not None:
            upd = upd * desc.weights[:, w, None].to(upd.dtype)
        upd = scale * upd
        if desc.owned is not None:
            upd = keep_owned(upd, desc.owned[:, w, None])
        sorted_segment_sum(table, desc.indices[:, w], upd)


def _scatter_add_scalar(
    vec: torch.Tensor, desc: SparseGrad, values: torch.Tensor, scale
) -> None:
    """vec[indices[i, w]] += scale * weights[i, w] * values[i], in place."""
    upd = values[:, None].expand(desc.indices.shape)
    if desc.weights is not None:
        upd = upd * desc.weights.to(upd.dtype)
    upd = scale * upd
    if desc.owned is not None:
        upd = keep_owned(upd, desc.owned)
    vec.index_add_(0, desc.indices.reshape(-1), upd.reshape(-1))


def localize_descriptor(desc: SparseGrad, shard_rows: int, model_index: int) -> SparseGrad:
    """``desc`` over global entity rows, as this rank's shard takes it: the
    shard holds the global rows [model_index * shard_rows, (model_index + 1)
    * shard_rows).  Indices become local rows (clamped into the shard where
    the row is owned elsewhere) and ``owned`` marks the rows that are this
    rank's."""
    local = desc.indices - model_index * shard_rows
    owned = (local >= 0) & (local < shard_rows)
    return desc._replace(indices=local.clamp(0, shard_rows - 1), owned=owned)


def _window_mean_gather(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """out[i] = mean over w of table[indices[i, w]], gathered one window
    slot at a time."""
    acc = table.index_select(0, indices[:, 0])
    for w in range(1, indices.shape[1]):
        acc = acc + table.index_select(0, indices[:, w])
    return acc / indices.shape[1]


def _single_descriptor(descs, name: str) -> SparseGrad:
    # The reference CHECK-fails here (updates_adagrad.cu:108,
    # updates_adam.cu:348); the JAX package asserts.
    if len(descs) != 1:
        raise ValueError(f"{name} does not implement multiple gradients ({len(descs)} given)")
    return descs[0]


def _sorted_segment_accumulate(
    num_rows: int,
    descs: Tuple[SparseGrad, ...],
    stream_dtype: Optional[torch.dtype] = None,
    accum_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """S[v] = sum over (i, w) with indices[i, w] == v of weights[i, w] * grad[i].

    Duplicate indices accumulate.  Under a ``stream_dtype`` the gradient
    rows (and weights) are rounded to it *before* the product, which runs
    at stream width, and widened to the accumulator's dtype before the sum
    (``_finish`` in the JAX package).  On a card with a float32 accumulator
    all of the table's descriptors go through one sorted segment sum
    (``ops/segment_kernels.py:segment_sum``): the entries sorted by row and
    each row summed in that order (a row that crosses a chunk boundary of
    the sorted array by pieces, then the pieces in order), every row written
    once, so two runs of a step give the same bits.  A CPU table and an
    ``accum_dtype`` of bfloat16 keep ``index_add_sum``, one ``index_add_``
    per window slot: with bfloat16 the partial sums round, to a relative
    error of about 2^-9 * sqrt(updates per row), the accumulator is returned
    as it is (the consumer widens), and on a card the adds run in no fixed
    order.
    """
    if segment_kernels.kernel_takes(descs, stream_dtype, accum_dtype):
        return segment_kernels.segment_sum(num_rows, descs, stream_dtype)
    return segment_kernels.index_add_sum(num_rows, descs, stream_dtype, accum_dtype)


def _every_rank_slice(desc: SparseGrad, mesh) -> SparseGrad:
    """This rank's slice of a data group's descriptor: the group's rows
    split over the model axis, so that the global update stream is split
    over every mesh axis."""
    rows = desc.indices.shape[0]
    if rows % mesh.model:
        raise ValueError(
            f"data-sharded accumulation: instance count "
            f"{rows * mesh.data} not divisible by the total device "
            f"count {mesh.size} (mesh {dict(mesh.shape)}); pick a batch "
            f"size divisible by data*model"
        )
    n = rows // mesh.model
    part = slice(mesh.model_index * n, (mesh.model_index + 1) * n)
    return SparseGrad(
        desc.grad[part], desc.indices[part],
        None if desc.weights is None else desc.weights[part],
    )


def _data_sharded_accumulate(
    num_rows: int,
    descs: Tuple[SparseGrad, ...],
    mesh,
    stream_dtype: Optional[torch.dtype] = None,
    accum_dtype: Optional[torch.dtype] = None,
    reduce_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``_sorted_segment_accumulate`` of the global batch for a replicated
    table, from the data groups' descriptors: each rank accumulates its
    slice of the stream into a dense [num_rows, d] partial and one
    all-reduce over every rank sums the partials.  Only the order of the
    sums differs from the single-device accumulation.  ``reduce_dtype``
    narrows the all-reduce alone: the local partial still accumulates at
    full width."""
    local = tuple(_every_rank_slice(d, mesh) for d in descs)
    dense = _sorted_segment_accumulate(num_rows, local, stream_dtype, accum_dtype)
    if reduce_dtype is not None and reduce_dtype != dense.dtype:
        return mesh.all_reduce(dense.to(reduce_dtype), None, "word_partial").to(dense.dtype)
    return mesh.all_reduce(dense, None, "word_partial")


def _gather_word_descriptor(desc: SparseGrad, mesh) -> SparseGrad:
    """The global batch's word descriptor from the data groups' (the
    optimizers whose statistics are per instance need every row)."""

    def gather(t):
        return None if t is None else mesh.all_gather(t, "data", "word_grads")

    return SparseGrad(gather(desc.grad), gather(desc.indices), gather(desc.weights))


def _adam_bias_correction(beta1, beta2, t, dtype):
    # sqrt(1 - beta2^t) / (1 - beta1^t)  (updates_adam.cu:91,285).  The
    # betas are filled on the device: torch.tensor(x, device=cuda) would
    # copy from the host and wait for the stream, once per table per step.
    tf = t.to(dtype)
    b1 = torch.full((), beta1, dtype=dtype, device=t.device)
    b2 = torch.full((), beta2, dtype=dtype, device=t.device)
    return torch.sqrt(1.0 - torch.pow(b2, tf)) / (1.0 - torch.pow(b1, tf))


# ---------------------------------------------------------------------------
# Transform (dense W + bias) updates.
# ---------------------------------------------------------------------------


def _transform_sgd(w, b, g_w, g_b, lr, lam):
    # storage.cu:200-228 via storage_inl.h: the decay fold on W only.
    w.copy_(w * (1.0 - lam * lr) + lr * g_w)
    b.copy_(b + lr * g_b)


def _transform_adagrad(state: TransformAdagradState, w, b, g_w, g_b, lr, lam, eps):
    # updates_adagrad.cu:33-70: accumulate g^2, then divide.
    state.acc_w.add_(torch.square(g_w))
    state.acc_b.add_(torch.square(g_b))
    _transform_sgd(
        w, b, g_w / torch.sqrt(state.acc_w + eps), g_b / torch.sqrt(state.acc_b + eps),
        lr, lam,
    )


def _transform_adam(state: TransformAdamState, w, b, g_w, g_b, lr, lam, beta1, beta2, eps):
    # updates_adam.cu:46-105: regularize the W gradient (never the bias),
    # update the moments, bias-corrected step with no decay fold.
    g_w = g_w - lam * w
    state.m_w.copy_(beta1 * state.m_w + (1.0 - beta1) * g_w)
    state.m_b.copy_(beta1 * state.m_b + (1.0 - beta1) * g_b)
    state.v_w.copy_(beta2 * state.v_w + (1.0 - beta2) * torch.square(g_w))
    state.v_b.copy_(beta2 * state.v_b + (1.0 - beta2) * torch.square(g_b))
    bc = _adam_bias_correction(beta1, beta2, state.t, w.dtype)
    w.copy_(w + lr * bc * state.m_w / (torch.sqrt(state.v_w) + eps))
    b.copy_(b + lr * bc * state.m_b / (torch.sqrt(state.v_b) + eps))
    state.t.add_(1)


# ---------------------------------------------------------------------------
# Representations (sparse embedding-table) updates.
# ---------------------------------------------------------------------------


def _repr_sgd(table, descs, lr, lam):
    # RepresentationsStorage::update (storage.cu:51-102): one decay fold,
    # then every descriptor scattered.
    table.mul_(1.0 - lam * lr)
    for desc in descs:
        _scatter_add(table, desc, lr)


def _repr_adagrad(state: ReprAdagradState, table, descs, lr, lam, eps):
    # updates_adagrad.cu:99-179: the accumulator is updated before the
    # gradient is scaled by its window average.
    desc = _single_descriptor(descs, "Adagrad")
    msq = torch.mean(torch.square(desc.grad), dim=1)  # dim-averaged squared grad
    _scatter_add_scalar(state.acc, desc, msq, 1.0)
    agg = _window_mean_gather(state.acc, desc.indices)  # [num_instances]
    scaled = desc._replace(grad=desc.grad / torch.sqrt(agg + eps)[:, None])
    _repr_sgd(table, (scaled,), lr, lam)


def _repr_adam_moments_sparse(state: ReprAdamState, descs, beta1, beta2):
    """m/v updates shared by SPARSE and DENSE_UPDATE (updates_adam.cu:195-252):
    the decay of the whole table, then the sparse additions; v holds the
    dimension-averaged squared gradient per object."""
    state.m.mul_(beta1)
    state.v.mul_(beta2)
    for desc in descs:
        _scatter_add(state.m, desc, 1.0 - beta1)
        msq = torch.mean(torch.square(desc.grad), dim=1)
        _scatter_add_scalar(state.v, desc, msq, 1.0 - beta2)


def _repr_adam_sparse(state: ReprAdamState, table, descs, lr, lam, beta1, beta2, eps):
    # SPARSE (updates_adam.cu:332-384): statistics per object, the step
    # averaged over the window (adam_sparse_update_kernel).
    desc = _single_descriptor(descs, "Sparse Adam")
    _repr_adam_moments_sparse(state, descs, beta1, beta2)
    bc = _adam_bias_correction(beta1, beta2, state.t, table.dtype)
    agg_m = _window_mean_gather(state.m, desc.indices)  # [I, dim]
    agg_v = _window_mean_gather(state.v, desc.indices)  # [I]
    step = desc._replace(grad=bc * agg_m / (torch.sqrt(agg_v)[:, None] + eps))
    _repr_sgd(table, (step,), lr, lam)
    state.t.add_(1)


def _repr_adam_dense_update(state: ReprAdamState, table, descs, lr, lam, beta1, beta2, eps):
    # DENSE_UPDATE (updates_adam.cu:293-311): sparse moments, then a sweep
    # of every row with the scalar variance broadcast over the row.
    _repr_adam_moments_sparse(state, descs, beta1, beta2)
    bc = _adam_bias_correction(beta1, beta2, state.t, table.dtype)
    update = bc * state.m / (torch.sqrt(state.v)[:, None] + eps)
    table.copy_(table * (1.0 - lam * lr) + lr * update)
    state.t.add_(1)


def _repr_adam_full(
    state: ReprAdamState, table, descs, lr, lam, beta1, beta2, eps, stream_dtype=None,
    accum_dtype=None, data_shard_mesh=None, reduce_dtype=None,
):
    # DENSE_UPDATE_DENSE_VARIANCE (updates_adam.cu:203-213,253-282,312-328):
    # one dense accumulation feeds both moments, then one fused sweep.  A
    # narrower accumulator is widened here, before the sweep reads it.
    # ``data_shard_mesh``: the table is replicated under a mesh and the
    # descriptors are the data group's.
    with span("cunvsm.optimizer.accumulate"):
        if data_shard_mesh is not None:
            scattered = _data_sharded_accumulate(
                table.shape[0], tuple(descs), data_shard_mesh, stream_dtype, accum_dtype,
                reduce_dtype,
            )
        else:
            scattered = _sorted_segment_accumulate(
                table.shape[0], tuple(descs), stream_dtype, accum_dtype
            )
        scattered = scattered.to(table.dtype)
    with span("cunvsm.optimizer.sweep"):
        bc = _adam_bias_correction(beta1, beta2, state.t, table.dtype)
        fused_adam_dense_sweep(
            table, state.m, state.v, scattered, lr * bc,
            lam=lam, beta1=beta1, beta2=beta2, eps=eps,
        )
        state.t.add_(1)


# ---------------------------------------------------------------------------
# Public optimizer facade.
# ---------------------------------------------------------------------------


def _is_full_adam(cfg: TrainConfig) -> bool:
    return (
        cfg.update_method == UpdateMethod.ADAM
        and cfg.adam.mode == AdamMode.DENSE_UPDATE_DENSE_VARIANCE
    )


class Optimizer:
    """The update method of ``cfg`` over both representation tables and the
    transform (params.cu:45-62, 341-358): sgd, adagrad, and Adam in its
    SPARSE, DENSE_UPDATE and DENSE_UPDATE_DENSE_VARIANCE modes."""

    def __init__(self, cfg: TrainConfig, mesh=None):
        """``mesh``: this optimizer is one rank's part of a mesh step (see
        the module doc); ``params`` and ``opt_state`` are then the rank's
        shards, the word descriptors its data group's and the entity
        descriptors global."""
        self.cfg = cfg
        self.mesh = mesh
        reduce = cfg.resolved_cross_chip_reduce_dtype()
        self.reduce_dtype = None if reduce is None else getattr(torch, reduce)
        stream = cfg.resolved_stream_dtype()
        self.stream_dtype = None if stream is None else getattr(torch, stream)
        accum = cfg.resolved_accum_dtype()
        self.accum_dtype = None if accum is None else getattr(torch, accum)

    def init(self, params: ModelParams) -> OptState:
        method = self.cfg.update_method
        if method == UpdateMethod.SGD:
            return OptState(SGDState(), SGDState(), SGDState())
        if method == UpdateMethod.ADAGRAD:
            def acc(table):
                return ReprAdagradState(table.new_zeros((table.shape[0],)))

            return OptState(
                word=acc(params.word_reprs),
                entity=acc(params.entity_reprs),
                transform=TransformAdagradState(
                    torch.zeros_like(params.transform_w), torch.zeros_like(params.transform_b),
                ),
            )
        dense_v = _is_full_adam(self.cfg)

        def repr_state(table):
            return ReprAdamState(
                m=torch.zeros_like(table),
                v=torch.zeros_like(table) if dense_v else table.new_zeros((table.shape[0],)),
                t=torch.ones((), dtype=torch.int32, device=table.device),
            )

        return OptState(
            word=repr_state(params.word_reprs),
            entity=repr_state(params.entity_reprs),
            transform=TransformAdamState(
                m_w=torch.zeros_like(params.transform_w),
                m_b=torch.zeros_like(params.transform_b),
                v_w=torch.zeros_like(params.transform_w),
                v_b=torch.zeros_like(params.transform_b),
                t=torch.ones((), dtype=torch.int32, device=params.transform_w.device),
            ),
        )

    def apply(
        self,
        params: ModelParams,
        opt_state: OptState,
        grads: AscentGrads,
        learning_rate: float,
        scaled_regularization_lambda: float,
    ) -> Tuple[ModelParams, OptState]:
        """One update step (Model::update, model.cu:187-220), in place on
        ``params`` and ``opt_state``, which it returns.
        ``scaled_regularization_lambda`` is lambda / batch_size.  A table
        with no descriptors is left as it is (no decay fold either), and the
        transform when its gradients are None (a similarity objective)."""
        with span("cunvsm.optimizer.apply"):
            cfg = self.cfg
            lr, lam = learning_rate, scaled_regularization_lambda
            word, entity = grads.word, grads.entity
            mesh = self.mesh
            word_mesh = None
            if mesh is not None:
                if _is_full_adam(cfg):
                    word_mesh = mesh
                else:
                    word = tuple(_gather_word_descriptor(d, mesh) for d in word)
                shard_rows = params.entity_reprs.shape[0]
                entity = tuple(
                    localize_descriptor(d, shard_rows, mesh.model_index) for d in entity
                )
            if word:
                self._apply_repr(params.word_reprs, opt_state.word, word, lr, lam, word_mesh)
            if entity:
                self._apply_repr(params.entity_reprs, opt_state.entity, entity, lr, lam)
            if grads.transform_w is not None:
                args = (params.transform_w, params.transform_b,
                        grads.transform_w, grads.transform_b, lr, lam)
                with span("cunvsm.optimizer.transform"):
                    if cfg.update_method == UpdateMethod.SGD:
                        _transform_sgd(*args)
                    elif cfg.update_method == UpdateMethod.ADAGRAD:
                        _transform_adagrad(opt_state.transform, *args, cfg.adagrad_epsilon)
                    else:
                        _transform_adam(opt_state.transform, *args,
                                        cfg.adam.beta1, cfg.adam.beta2, cfg.adam.epsilon)
        return params, opt_state

    def _apply_repr(self, table, state, descs, lr, lam, data_shard_mesh=None):
        cfg = self.cfg
        if cfg.update_method == UpdateMethod.SGD:
            _repr_sgd(table, descs, lr, lam)
            return
        if cfg.update_method == UpdateMethod.ADAGRAD:
            _repr_adagrad(state, table, descs, lr, lam, cfg.adagrad_epsilon)
            return
        args = (state, table, descs, lr, lam, cfg.adam.beta1, cfg.adam.beta2, cfg.adam.epsilon)
        if cfg.adam.mode == AdamMode.SPARSE:
            _repr_adam_sparse(*args)
        elif cfg.adam.mode == AdamMode.DENSE_UPDATE:
            _repr_adam_dense_update(*args)
        else:
            _repr_adam_full(*args, stream_dtype=self.stream_dtype, accum_dtype=self.accum_dtype,
                            data_shard_mesh=data_shard_mesh, reduce_dtype=self.reduce_dtype)
