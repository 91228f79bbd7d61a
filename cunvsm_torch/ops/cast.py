"""float32 -> bfloat16 table cast: a Triton kernel for Hopper and its plain
PyTorch version.

Replaces the Pallas kernel of ``cunvsm_tpu/ops/cast.py`` (``_cast_pallas`` /
``_cast_kernel``).  Under ``stream_dtype=bfloat16`` every training step
casts the float32 master word table to the bfloat16 copy that feeds the
window gathers (``models/objectives.py``).  The result is bitwise that of
``x.to(torch.bfloat16)``: round to nearest even.

What bounds it on the card: device-memory bytes, 4 read and 2 written per
element, 118 MB per step for the canonical [65536, 300] word table.
Design: one program per BLOCK contiguous elements of the flattened table,
a float32 load, ``.to(tl.bfloat16, fp_downcast_rounding="rtne")`` and a
bfloat16 store; no reuse, no shared memory.
"""

from __future__ import annotations

import functools

import torch

from cunvsm_torch.ops.triton_build import check_operands, import_triton

BLOCK = 2048


def cast_plain(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The plain PyTorch cast."""
    return x.to(dtype)


def _cast_body(x_ptr, o_ptr, n, BLOCK: "tl.constexpr"):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    x = tl.load(x_ptr + offs, mask=mask)
    y = x.to(tl.bfloat16, fp_downcast_rounding="rtne")
    tl.store(o_ptr + offs, y, mask=mask)


@functools.lru_cache(maxsize=None)
def _cast_kernel():
    # The body's `tl` is this module's global, bound here at the first
    # launch: triton is imported only then.
    global tl
    triton, tl = import_triton()
    return triton.jit(_cast_body)


def _launch_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    check_operands("cast_table", torch.float32, x)
    if dtype != torch.bfloat16:
        raise ValueError(f"cast_table: no kernel for float32 -> {dtype}")
    out = torch.empty_like(x, dtype=dtype)
    n = x.numel()
    _cast_kernel()[((n + BLOCK - 1) // BLOCK,)](x, out, n, BLOCK=BLOCK, num_warps=4)
    return out


def cast_table(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x.to(dtype)`` for a float32 table; ``x`` itself when it already has
    ``dtype``.  A CUDA tensor runs the Triton kernel (and raises if it
    cannot); a CPU tensor runs :func:`cast_plain`; any other device raises.
    """
    if x.dtype == dtype:
        return x
    if x.is_cuda:
        out = _launch_cast(x, dtype)
        cast_table.launches += 1
        return out
    if x.device.type == "cpu":
        return cast_plain(x, dtype)
    raise ValueError(f"cast_table: no kernel for {x.device}")


cast_table.launches = 0
