"""Per-activation batch normalization with the reference's cuDNN quirks.

Port of ``cunvsm_tpu/ops/batchnorm.py``: gamma frozen at 1, the transform
bias plays BN's beta, training-mode statistics only, biased (1/N)
variance, epsilon 1e-4 from ``ModelDesc.batch_norm_eps``.  Autograd
through the expression gives cuDNN's data and beta gradients.

Under a mesh (``parallel/mesh.py``) a rank holds only its data group's rows
of the batch, while the statistics are those of the *global* batch, as they
are under the JAX package's partitioner: the column sums are all-reduced
over the data axis, with an all-reduce in the backward pass as well.  A rank
that normalized its own rows alone would train another model.
"""

from __future__ import annotations

import torch


def batch_norm_train(x: torch.Tensor, beta: torch.Tensor, eps: float, mesh=None) -> torch.Tensor:
    """Normalize ``x`` [batch, features] over the batch axis; add ``beta``.
    With ``mesh``, ``x`` holds this data group's rows and the batch axis is
    that of all data groups together."""
    if mesh is None:
        mean = torch.mean(x, dim=0, keepdim=True)
        var = torch.mean(torch.square(x - mean), dim=0, keepdim=True)
    else:
        rows = x.shape[0] * mesh.data
        mean = mesh.all_reduce_grad(
            torch.sum(x, dim=0, keepdim=True), "data", "batch_norm_mean") / rows
        var = mesh.all_reduce_grad(
            torch.sum(torch.square(x - mean), dim=0, keepdim=True), "data", "batch_norm_var"
        ) / rows
    inv_std = torch.rsqrt(var + eps)
    return (x - mean) * inv_std + beta[None, :]
