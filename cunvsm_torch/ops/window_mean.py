"""The window gather-mean of the text objectives: a CUDA C++ kernel for
Hopper and its plain PyTorch version.

    out[i] = (1 / W) * sum_w feature_weights[i, w] * table[features[i, w]]

(average_repr_kernel, params.cu:77-95: division by the window, not by the
weight sum).  The JAX package leaves this to XLA, so the kernel replaces no
Pallas kernel.  The plain version gathers the [B * W, d] rows into device
memory and sums them; the kernel (``csrc/window_mean.cu``, built by nvcc at
first use) reads each window's rows once, mostly from L2, sums them in
registers and writes only the [B, d] mean: 105 MB for the main path under
bfloat16 streams (144 MB under float32), 0.031 ms (0.043 ms) at 3.35 TB/s.
Both round at the same places (see :func:`window_mean_plain`); the kernel
adds the window's terms in the order w = 0, 1, ..., W - 1.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from cunvsm_torch.ops import cuda_build


def window_mean_plain(
    word_reprs: torch.Tensor,
    features: torch.Tensor,
    feature_weights: Optional[torch.Tensor],
    window_sum_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The window mean in plain PyTorch.  ``feature_weights=None`` means
    uniform weights and skips the multiply.  A bfloat16 table is gathered at
    half width and the window sum widens to float32, unless
    ``window_sum_dtype`` is the table's dtype: then the sum and the division
    run at stream width and widen after."""
    batch, window = features.shape
    flat = word_reprs.index_select(0, features.reshape(-1))  # [B*W, d]
    acc_dtype = torch.float32 if flat.dtype == torch.bfloat16 else flat.dtype
    if feature_weights is not None:
        flat = flat * feature_weights.reshape(-1).to(flat.dtype)[:, None]
    sum_dtype = flat.dtype if window_sum_dtype == flat.dtype else acc_dtype
    summed = flat.view(batch, window, -1).sum(dim=1, dtype=sum_dtype)
    return (summed / window).to(acc_dtype)


def bind(lib):
    """The library's entry point with its C signature declared (see the
    source's ``cunvsm_window_mean``); it returns the launch's
    ``cudaError_t``."""
    fn = lib.cunvsm_window_mean
    ptr, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr, i, ptr, ptr, ptr, ctypes.c_longlong, i, ctypes.c_longlong, i,
                   ctypes.c_float, ptr]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _window_mean_kernel():
    return bind(cuda_build.load_library("window_mean", ("window_mean.cu",)))


def _launch(word_reprs, features, feature_weights, window_sum_dtype) -> torch.Tensor:
    dtype = word_reprs.dtype
    if dtype not in (torch.float32, torch.bfloat16) or features.dtype != torch.int64:
        raise ValueError(f"window_mean: no kernel for a {dtype} table and {features.dtype} ids")
    if features.device != word_reprs.device or word_reprs.ndim != 2 or features.ndim != 2:
        raise ValueError("window_mean: expected a [V, d] table and [B, W] ids on one device")
    batch, window = features.shape
    if window < 1:
        raise ValueError("window_mean: the window is empty")
    table = word_reprs.contiguous()
    ids = features.contiguous()
    weights = None
    if feature_weights is not None:
        if feature_weights.device != word_reprs.device or feature_weights.shape != features.shape:
            raise ValueError("window_mean: feature weights must be [B, W] on the table's device")
        weights = feature_weights.to(dtype).contiguous()
    out = torch.empty((batch, table.shape[1]), dtype=torch.float32, device=table.device)
    bf16 = dtype == torch.bfloat16
    with torch.cuda.device(table.device):
        rc = _window_mean_kernel()(
            table.data_ptr(), int(bf16), ids.data_ptr(),
            None if weights is None else weights.data_ptr(), out.data_ptr(), batch, window,
            table.shape[1], int(bf16 and window_sum_dtype == dtype),
            # PyTorch divides a tensor by a Python number on a card as a
            # multiply by the float32 reciprocal.
            float(np.float32(1.0) / np.float32(window)),
            torch.cuda.current_stream().cuda_stream,
        )
        torch.cuda.check_error(rc)
    return out


def window_mean(
    word_reprs: torch.Tensor,
    features: torch.Tensor,
    feature_weights: Optional[torch.Tensor],
    window_sum_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The window mean of :func:`window_mean_plain`.  A CUDA table runs the
    CUDA kernel (a float32 or bfloat16 table, int64 ids: the dtypes of
    every training path; it raises on anything else); a CPU table runs the
    plain version; any other device raises."""
    if word_reprs.is_cuda:
        out = _launch(word_reprs, features, feature_weights, window_sum_dtype)
        window_mean.launches += 1
        return out
    if word_reprs.device.type == "cpu":
        return window_mean_plain(word_reprs, features, feature_weights, window_sum_dtype)
    raise ValueError(f"window_mean: no kernel for {word_reprs.device}")


window_mean.launches = 0
