"""Fused dense full_adam sweep: a Triton kernel for Hopper and its plain
PyTorch version.

Replaces the Pallas kernel of ``cunvsm_tpu/ops/adam_sweep.py``
(``_sweep_pallas`` / ``_sweep_kernel``), which the full_adam representation
update (``optim/updates.py:_repr_adam_full``) runs over both tables every
step.  Update rule, in place on ``m``, ``v`` and ``table`` (``scattered`` is
read only), in the JAX package's order of operations:

    agg    = scattered - lam * table          # L2 folded into the moments
    m     <- beta1 * m + (1 - beta1) * agg
    v     <- beta2 * v + (1 - beta2) * agg * agg
    table <- table + (scale * m) / (sqrt(v) + eps)

What bounds it on the card: device-memory bytes.  Each element costs 4
reads and 3 writes of 4 bytes and about ten flops; at the canonical shapes
([65536, 300] words + [262144, 256] entities, 86.8M elements) that is
2.43 GB per step.  Design: one program per BLOCK contiguous elements of the
flattened table (d = 300 is no power of two, so rows are not tiled), each
thread moving whole 16-byte vectors; no reuse, no shared memory.  ``scale``
(lr * bias_correction(t)) is read through a pointer to a 0-d device tensor,
so a step neither waits for the host nor recompiles.  ``tl.sqrt_rn`` and
``tl.div_rn`` keep the IEEE rounding of ``torch.sqrt`` and ``/`` (Triton's
plain sqrt and division are approximate in float32), and floating-point
contraction is off, so the kernel computes the plain version's operations
in the same order.
"""

from __future__ import annotations

import functools

import torch

from cunvsm_torch.ops.triton_build import check_operands, import_triton

BLOCK = 1024


def sweep_plain(table, m, v, scattered, step_scale, *, lam, beta1, beta2, eps):
    """The plain PyTorch sweep (``_sweep_xla`` of the JAX package), in
    place on ``m``, ``v`` and ``table``."""
    agg = scattered - lam * table
    m_new = beta1 * m + (1.0 - beta1) * agg
    v_new = beta2 * v + (1.0 - beta2) * torch.square(agg)
    p_new = table + step_scale * m_new / (torch.sqrt(v_new) + eps)
    m.copy_(m_new)
    v.copy_(v_new)
    table.copy_(p_new)


def _sweep_body(
    s_ptr, m_ptr, v_ptr, p_ptr, scale_ptr, n,
    lam, beta1, one_minus_beta1, beta2, one_minus_beta2, eps,
    BLOCK: "tl.constexpr",
):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    s = tl.load(s_ptr + offs, mask=mask)
    m = tl.load(m_ptr + offs, mask=mask)
    v = tl.load(v_ptr + offs, mask=mask)
    p = tl.load(p_ptr + offs, mask=mask)
    scale = tl.load(scale_ptr)
    agg = s - lam * p
    m_new = beta1 * m + one_minus_beta1 * agg
    v_new = beta2 * v + one_minus_beta2 * (agg * agg)
    p_new = p + tl.div_rn(scale * m_new, tl.sqrt_rn(v_new) + eps)
    tl.store(m_ptr + offs, m_new, mask=mask)
    tl.store(v_ptr + offs, v_new, mask=mask)
    tl.store(p_ptr + offs, p_new, mask=mask)


@functools.lru_cache(maxsize=None)
def _sweep_kernel():
    # The body's `tl` is this module's global, bound here at the first
    # launch: triton is imported only then.
    global tl
    triton, tl = import_triton()
    return triton.jit(_sweep_body)


def _launch_sweep(table, m, v, scattered, step_scale, lam, beta1, beta2, eps):
    check_operands(
        "fused_adam_dense_sweep", torch.float32,
        table, m, v, scattered, step_scale,
    )
    if not (m.shape == v.shape == scattered.shape == table.shape):
        raise ValueError("fused_adam_dense_sweep: operand shapes differ")
    if step_scale.dim() != 0:
        raise ValueError("fused_adam_dense_sweep: step_scale must be 0-d")
    n = table.numel()
    _sweep_kernel()[((n + BLOCK - 1) // BLOCK,)](
        scattered, m, v, table, step_scale, n,
        float(lam), float(beta1), 1.0 - beta1, float(beta2), 1.0 - beta2,
        float(eps),
        BLOCK=BLOCK, num_warps=4, enable_fp_fusion=False,
    )


def fused_adam_dense_sweep(
    table, m, v, scattered, step_scale, *, lam, beta1, beta2, eps
):
    """One full_adam dense sweep, in place on ``m``, ``v`` and ``table``.

    ``step_scale`` is the 0-d tensor lr * bias_correction(t) on the table's
    device; ``lam`` is the scaled regularization lambda / batch.  A CUDA
    table runs the Triton kernel (and raises if it cannot); a CPU table runs
    :func:`sweep_plain`; any other device raises.
    """
    if table.is_cuda:
        _launch_sweep(table, m, v, scattered, step_scale, lam, beta1, beta2, eps)
        fused_adam_dense_sweep.launches += 1
    elif table.device.type == "cpu":
        sweep_plain(
            table, m, v, scattered, step_scale,
            lam=lam, beta1=beta1, beta2=beta2, eps=eps,
        )
    else:
        raise ValueError(f"fused_adam_dense_sweep: no kernel for {table.device}")


fused_adam_dense_sweep.launches = 0
