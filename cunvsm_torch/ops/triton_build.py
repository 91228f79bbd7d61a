"""Build location of the package's Triton kernels.

Triton compiles a kernel at its first launch and caches the binary.  The
cache goes under the checkout's ``build/`` directory (which ``.gitignore``
lists), so a fresh checkout builds every kernel from the sources in the
repository and writes nothing outside it.  ``triton`` is imported only by
the functions that launch a kernel: a machine without triton or without a
card imports every module of this package.
"""

from __future__ import annotations

import os

import torch

BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build",
    "triton",
)


def import_triton():
    """(triton, triton.language), with the kernel cache under ``build/``.

    An explicitly set ``TRITON_CACHE_DIR`` is respected."""
    os.environ.setdefault("TRITON_CACHE_DIR", BUILD_DIR)
    import triton
    import triton.language as tl

    return triton, tl


def check_operands(name: str, dtype: torch.dtype, *tensors: torch.Tensor):
    """Raise unless every tensor is a contiguous CUDA tensor of ``dtype``
    that int32 offsets can address."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
        if t.numel() >= 2**31:
            raise ValueError(
                f"{name}: {t.numel()} elements exceed int32 offsets"
            )
