"""Segment sum for the gradient accumulation, in plain PyTorch.

Port of ``cunvsm_tpu/ops/segment_kernels.py:sorted_segment_sum``, which is
no Pallas kernel (XLA's segment sum).  ``index_add_`` accumulates duplicate
rows like the reference's atomicAdd scatter (``update_repr_kernel``,
storage.cu:37-49), so the rows need not be sorted; on CUDA the order of
the adds is not fixed.
"""

from __future__ import annotations

import torch


def sorted_segment_sum(
    out: torch.Tensor, rows: torch.Tensor, upd: torch.Tensor
) -> torch.Tensor:
    """out[rows[i]] += upd[i] for every i, in place; returns ``out``."""
    return out.index_add_(0, rows, upd)
