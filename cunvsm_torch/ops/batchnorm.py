"""Per-activation batch normalization with the reference's cuDNN quirks.

Port of ``cunvsm_tpu/ops/batchnorm.py``: gamma frozen at 1, the transform
bias plays BN's beta, training-mode statistics only, biased (1/N)
variance, epsilon 1e-4 from ``ModelDesc.batch_norm_eps``.  Autograd
through the expression gives cuDNN's data and beta gradients.
"""

from __future__ import annotations

import torch


def batch_norm_train(x: torch.Tensor, beta: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalize ``x`` [batch, features] over the batch axis; add ``beta``."""
    mean = torch.mean(x, dim=0, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=0, keepdim=True)
    inv_std = torch.rsqrt(var + eps)
    return (x - mean) * inv_std + beta[None, :]
