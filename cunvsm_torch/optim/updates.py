"""The full_adam optimizer with the reference's update semantics, in place.

Port of the DENSE_UPDATE_DENSE_VARIANCE ("full_adam", the canonical NVSM
configuration) paths of ``cunvsm_tpu/optim/updates.py``:

* gradients are *ascent* gradients: ``param += lr * update``
  (model.cu:187-220);
* the representation tables keep dense m and v; the L2 term folds into the
  moments and eps sits *outside* the square root (updates_adam.cu:203-213,
  253-282, 312-328); one dense accumulation of the sparse descriptors feeds
  both moments, and the sweep over every row is the Triton kernel of
  ``ops/adam_sweep.py``;
* the transform regularizes W but never the bias (updates_adam.cu:46-105);
* the step counter t starts at 1 (updates.h:197).

Where the JAX package returns new arrays (and donates the old buffers),
this package updates the parameter and state tensors in place.  SGD,
Adagrad and the sparse Adam modes are not part of this package yet
(ROADMAP.md queue 1).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from cunvsm_torch.config import AdamMode, TrainConfig, UpdateMethod
from cunvsm_torch.models.objectives import AscentGrads, SparseGrad
from cunvsm_torch.models.params import ModelParams, tensor_from_numpy
from cunvsm_torch.ops.adam_sweep import fused_adam_dense_sweep
from cunvsm_torch.ops.segment_kernels import sorted_segment_sum


class TransformAdamState(NamedTuple):
    m_w: torch.Tensor
    m_b: torch.Tensor
    v_w: torch.Tensor
    v_b: torch.Tensor
    t: torch.Tensor  # 0-d int32, starts at 1


class ReprAdamState(NamedTuple):
    m: torch.Tensor  # [num_objects, dim]
    v: torch.Tensor  # [num_objects, dim]
    t: torch.Tensor


class OptState(NamedTuple):
    word: ReprAdamState
    entity: ReprAdamState
    transform: TransformAdamState


def _state_from_numpy(cls, state, device, dtype):
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
    """OptState from any nested triple with the same fields as arrays, such
    as the JAX package's full_adam OptState."""
    return OptState(
        word=_state_from_numpy(ReprAdamState, state.word, device, dtype),
        entity=_state_from_numpy(ReprAdamState, state.entity, device, dtype),
        transform=_state_from_numpy(TransformAdamState, state.transform, device, dtype),
    )


def opt_state_to_numpy(state: OptState) -> OptState:
    """The same nested NamedTuples holding numpy arrays (host copies)."""
    return OptState(
        *(type(s)(*(t.detach().cpu().numpy() for t in s)) for s in state)
    )


def _sorted_segment_accumulate(
    num_rows: int,
    descs: Tuple[SparseGrad, ...],
    stream_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """S[v] = sum over (i, w) with indices[i, w] == v of weights[i, w] * grad[i].

    Duplicate indices accumulate.  Under a ``stream_dtype`` the gradient
    rows (and weights) are rounded to it *before* the product, which runs
    at stream width, and widened to the gradient dtype before the sum
    (``_finish`` in the JAX package).  Each window slot adds its B rows
    with one ``index_add_``, so the [B*W, d] update stream is never
    materialized.
    """
    out_dtype = descs[0].grad.dtype
    out = torch.zeros(
        (num_rows, descs[0].grad.shape[1]), dtype=out_dtype,
        device=descs[0].grad.device,
    )
    for d in descs:
        grad = d.grad
        if stream_dtype is not None and stream_dtype != grad.dtype:
            grad = grad.to(stream_dtype)
        widened = grad.to(out_dtype)
        weights = None if d.weights is None else d.weights.to(grad.dtype)
        for w in range(d.indices.shape[1]):
            upd = widened if weights is None else (grad * weights[:, w, None]).to(out_dtype)
            sorted_segment_sum(out, d.indices[:, w], upd)
    return out


def _adam_bias_correction(beta1, beta2, t, dtype):
    # sqrt(1 - beta2^t) / (1 - beta1^t)  (updates_adam.cu:91,285).  The
    # betas are filled on the device: torch.tensor(x, device=cuda) would
    # copy from the host and wait for the stream, once per table per step.
    tf = t.to(dtype)
    b1 = torch.full((), beta1, dtype=dtype, device=t.device)
    b2 = torch.full((), beta2, dtype=dtype, device=t.device)
    return torch.sqrt(1.0 - torch.pow(b2, tf)) / (1.0 - torch.pow(b1, tf))


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


def _repr_adam_full(
    state: ReprAdamState, table, descs, lr, lam, beta1, beta2, eps, stream_dtype=None
):
    # DENSE_UPDATE_DENSE_VARIANCE (updates_adam.cu:203-213,253-282,312-328):
    # one dense accumulation feeds both moments, then one fused sweep.
    scattered = _sorted_segment_accumulate(table.shape[0], tuple(descs), stream_dtype)
    bc = _adam_bias_correction(beta1, beta2, state.t, table.dtype)
    fused_adam_dense_sweep(
        table, state.m, state.v, scattered, lr * bc,
        lam=lam, beta1=beta1, beta2=beta2, eps=eps,
    )
    state.t.add_(1)


class Optimizer:
    """full_adam over both representation tables and the transform
    (params.cu:45-62, 341-358)."""

    def __init__(self, cfg: TrainConfig):
        if (
            cfg.update_method != UpdateMethod.ADAM
            or cfg.adam.mode != AdamMode.DENSE_UPDATE_DENSE_VARIANCE
        ):
            raise NotImplementedError(
                f"only full_adam is ported (got {cfg.update_method.value}"
                f"/{cfg.adam.mode.value}); the other optimizers are not "
                "ported yet (ROADMAP.md queue 1)"
            )
        if cfg.accum_dtype != "float32":
            raise NotImplementedError("accum_dtype other than float32")
        self.cfg = cfg
        stream = cfg.resolved_stream_dtype()
        self.stream_dtype = None if stream is None else getattr(torch, stream)

    def init(self, params: ModelParams) -> OptState:
        def repr_state(table):
            return ReprAdamState(
                m=torch.zeros_like(table),
                v=torch.zeros_like(table),
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
        ``scaled_regularization_lambda`` is lambda / batch_size."""
        adam = self.cfg.adam
        hyper = (learning_rate, scaled_regularization_lambda, adam.beta1, adam.beta2, adam.epsilon)
        for table, state, descs in (
            (params.word_reprs, opt_state.word, grads.word),
            (params.entity_reprs, opt_state.entity, grads.entity),
        ):
            if descs:
                _repr_adam_full(state, table, descs, *hyper, stream_dtype=self.stream_dtype)
        _transform_adam(
            opt_state.transform, params.transform_w, params.transform_b,
            grads.transform_w, grads.transform_b, *hyper,
        )
        return params, opt_state
