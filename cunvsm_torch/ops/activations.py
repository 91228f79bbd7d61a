"""Elementwise math with the reference's numeric semantics, in PyTorch.

Port of ``cunvsm_tpu/ops/activations.py``.  The deliberate forward/backward
asymmetries are ``torch.autograd.Function``s (the JAX package's
``jax.custom_vjp``), written in the ``setup_context`` form so that
``torch.func.vjp`` differentiates through them:

* ``log_truncated_sigmoid``: forward log(clip(sigmoid(x), eps_f, 1-eps_f));
  backward g * (1 - p), zeroed where p <= eps_b or p >= 1 - eps_b, with a
  different epsilon (1e-7 forward, 1e-6 backward at the call sites).
* ``hard_tanh``: clip to [-1, 1] with derivative 1 exactly when the *input*
  lies in the closed interval [-1, 1].
"""

from __future__ import annotations

import torch


def stable_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid (cuda_utils.h:201-207)."""
    e = torch.exp(-torch.abs(x))
    return torch.where(x >= 0, 1.0 / (1.0 + e), e / (1.0 + e))


def truncated_sigmoid(x: torch.Tensor, eps: float) -> torch.Tensor:
    """sigmoid clipped into [eps, 1-eps] (cuda_utils.h:192-214)."""
    return torch.clamp(stable_sigmoid(x), eps, 1.0 - eps)


class _LogTruncatedSigmoid(torch.autograd.Function):
    @staticmethod
    def forward(x, eps_forward, eps_backward):
        return torch.log(truncated_sigmoid(x, eps_forward))

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, eps_forward, eps_backward = inputs
        ctx.eps_backward = eps_backward
        # p = exp(log p) would round differently; keep the clipped p itself.
        ctx.save_for_backward(truncated_sigmoid(x, eps_forward))

    @staticmethod
    def backward(ctx, g):
        (p,) = ctx.saved_tensors
        eps_b = ctx.eps_backward
        inside = (p > eps_b) & (p < 1.0 - eps_b)
        return g * torch.where(inside, 1.0 - p, torch.zeros_like(p)), None, None


def log_truncated_sigmoid(
    x: torch.Tensor, eps_forward: float, eps_backward: float
) -> torch.Tensor:
    """log(truncated_sigmoid(x)) with the reference's surrogate gradient
    (objective.cu:241-256, 354-371)."""
    return _LogTruncatedSigmoid.apply(x, eps_forward, eps_backward)


class _HardTanh(torch.autograd.Function):
    @staticmethod
    def forward(x):
        return torch.clamp(x, -1.0, 1.0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        (x,) = inputs
        ctx.save_for_backward(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        inside = (x >= -1.0) & (x <= 1.0)
        return torch.where(inside, g, torch.zeros_like(g))


def hard_tanh(x: torch.Tensor) -> torch.Tensor:
    """clip(x, -1, 1); derivative 1 iff x in [-1, 1] (cuda_utils.h:85-147)."""
    return _HardTanh.apply(x)


def l2_normalize_rows(x: torch.Tensor) -> torch.Tensor:
    """Per-row L2 normalization (Normalizer, cuda_utils.cu:3-141); all-zero
    rows normalize to zero instead of NaN."""
    norms = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp(norms, min=1e-30)
