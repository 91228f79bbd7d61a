"""float32 -> bfloat16 table cast: a CUDA C++ kernel for Hopper and its plain
PyTorch version.

Replaces the Pallas kernel of ``cunvsm_tpu/ops/cast.py`` (``_cast_pallas`` /
``_cast_kernel``).  Under ``stream_dtype=bfloat16`` every training step
casts the float32 master word table to the bfloat16 copy that feeds the
window gathers (``models/objectives.py``).  The result is bitwise that of
``x.to(torch.bfloat16)``: round to nearest even.

What bounds it on the card: device-memory bytes, 4 read and 2 written per
element, 117.96 MB per step for the canonical [65536, 300] word table
(35.2 us at 3.35 TB/s).  The kernel (``csrc/cast_bf16.cu``, built by nvcc at
first use) runs one short block per 8192 elements; each thread keeps four
chunks of 8 elements (two 16-byte loads each) in flight before it converts
them and writes each chunk with one 16-byte streaming store.  The source
says more.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cunvsm_torch.ops import cuda_build


def cast_plain(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The plain PyTorch cast."""
    return x.to(dtype)


def bind(lib):
    """The library's entry point with its C signature declared:
    ``int cunvsm_cast_f32_bf16(const float*, __nv_bfloat16*, long long n,
    cudaStream_t)``, which returns the launch's ``cudaError_t``."""
    fn = lib.cunvsm_cast_f32_bf16
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _cast_kernel():
    return bind(cuda_build.load_library("cast_bf16", ("cast_bf16.cu",)))


def _launch_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype != torch.bfloat16 or x.dtype != torch.float32:
        raise ValueError(f"cast_table: no kernel for {x.dtype} -> {dtype}")
    if not x.is_contiguous():
        raise ValueError("cast_table: expected a contiguous tensor")
    out = torch.empty_like(x, dtype=dtype)
    with torch.cuda.device(x.device):
        rc = _cast_kernel()(x.data_ptr(), out.data_ptr(), x.numel(),
                            torch.cuda.current_stream().cuda_stream)
        torch.cuda.check_error(rc)
    return out


def cast_table(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x.to(dtype)`` for a float32 table; ``x`` itself when it already has
    ``dtype``.  A CUDA tensor runs the CUDA kernel (and raises if it
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
