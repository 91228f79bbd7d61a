"""full_adam's dense accumulation as a sorted segment sum: a CUDA C++ kernel
for Hopper, its plain PyTorch version, and the ``index_add_`` path that the
CPU and a bfloat16 accumulator keep.

    S[v] = sum over every descriptor's (i, w) with indices[i, w] == v of
           weights[i, w] * grad[i]

The JAX package sorts the flat row ids with their instance ids, gathers
the gradient rows after the sort and takes a segment sum
(``cunvsm_tpu/optim/updates.py:_sorted_segment_accumulate``).  Here the same
order runs on the card:

* **Plan** (:func:`plan_segments`, PyTorch ops of static shapes, no host
  sync): the (row, entry) pairs of all of a table's descriptors, in the
  order of the descriptors and, within one, of its [B, W] entries, stably
  sorted by row; an entry of a row owned by another rank gets the row
  ``num_rows`` and sorts last.  ``searchsorted`` finds the first sorted
  position of every row, ``num_rows + 1`` offsets.
* **Sum** (``csrc/segment_sum.cu``, :func:`segment_sum`): the sorted array
  is cut into chunks of :data:`CHUNK` entries, one warp each.  A row within
  one chunk is summed term by term in sorted order from 0; a row that
  crosses a chunk boundary is cut there, each piece summed the same way into
  a scratch row, and a second pass sums the pieces in order from 0.  Every
  row of the result is written once (an empty row as zeros), with no
  atomics, so the result is bitwise the same from run to run.
  :func:`segment_sum_plain` computes the same operations in the same order.

A term rounds as the JAX package's ``_finish``: under a bfloat16
``stream_dtype`` the gradient row and the weight are rounded to bfloat16,
their product is rounded to bfloat16 and widened; otherwise it is one
float32 product.  :func:`kernel_takes` says which accumulations the kernel
takes: CUDA descriptors that sum into float32.  The others (a CPU table, a
bfloat16 accumulator, whose partial sums round at stream width) take
:func:`index_add_sum`, one ``index_add_`` per window slot, which on a card
adds in no fixed order.  ``segment_sum.launches`` and
``index_add_sum.calls`` count the two.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence

import torch

from cunvsm_torch.ops import cuda_build

# The entries of the sorted array that one warp sums, the places where a
# row is cut into pieces (the kernel's constant; the plain version cuts at
# the same places).
CHUNK = 256
MAX_DESCRIPTORS = 3
_STREAM_DTYPES = (None, torch.float32, torch.bfloat16)


class SegmentPlan(NamedTuple):
    rows: torch.Tensor     # [n] int32, every entry's row, ascending
    perm: torch.Tensor     # [n] int64, the entry at each sorted position
    offsets: torch.Tensor  # [num_rows + 1] int32, each row's first position


def sorted_segment_sum(
    out: torch.Tensor, rows: torch.Tensor, upd: torch.Tensor
) -> torch.Tensor:
    """out[rows[i]] += upd[i] for every i, in place, with ``index_add_``;
    returns ``out``.  The rows need not be sorted; on a card the adds run
    in no fixed order."""
    return out.index_add_(0, rows, upd)


def keep_owned(upd: torch.Tensor, owned: torch.Tensor) -> torch.Tensor:
    """``upd`` where ``owned``, zero elsewhere (a selection: a NaN or inf
    computed for a row of another owner is dropped, not multiplied)."""
    return torch.where(owned, upd, torch.zeros((), dtype=upd.dtype, device=upd.device))


def index_add_sum(
    num_rows: int,
    descs: Sequence,
    stream_dtype: Optional[torch.dtype] = None,
    accum_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """S with one ``index_add_`` per window slot over the [B, d] gradient
    rows, so the [B*W, d] update stream is never materialized.  Under an
    ``accum_dtype`` the terms are cast to it and summed into an accumulator
    of that dtype, which is returned as it is (the consumer widens): with
    bfloat16 the partial sums round, to a relative error of about 2^-9 *
    sqrt(updates per row)."""
    index_add_sum.calls += 1
    out_dtype = accum_dtype or descs[0].grad.dtype
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
            if d.owned is not None:
                upd = keep_owned(upd, d.owned[:, w, None])
            sorted_segment_sum(out, d.indices[:, w], upd)
    return out


index_add_sum.calls = 0


def kernel_takes(
    descs: Sequence,
    stream_dtype: Optional[torch.dtype] = None,
    accum_dtype: Optional[torch.dtype] = None,
) -> bool:
    """Whether :func:`segment_sum` takes this accumulation: one to three
    descriptors of one width on a card, float32 gradients and weights, a
    float32 accumulator and a float32 or bfloat16 stream."""
    if not 1 <= len(descs) <= MAX_DESCRIPTORS:
        return False
    if accum_dtype not in (None, torch.float32) or stream_dtype not in _STREAM_DTYPES:
        return False
    dim = descs[0].grad.shape[1]
    n = sum(d.indices.numel() for d in descs)
    return n < 2**31 and all(
        d.grad.is_cuda and d.grad.dtype == torch.float32 and d.grad.shape[1] == dim
        and (d.weights is None or d.weights.dtype == torch.float32)
        for d in descs
    )


def plan_segments(num_rows: int, descs: Sequence) -> SegmentPlan:
    """The entries of ``descs`` sorted by row (see the module doc)."""
    keys = []
    for d in descs:
        k = d.indices.reshape(-1)
        if d.owned is not None:
            k = torch.where(d.owned.reshape(-1), k, num_rows)
        keys.append(k)
    keys = torch.cat(keys) if len(keys) > 1 else keys[0]
    rows, perm = torch.sort(keys.to(torch.int32), stable=True)
    bounds = torch.arange(num_rows + 1, dtype=torch.int32, device=rows.device)
    return SegmentPlan(rows, perm, torch.searchsorted(rows, bounds, out_int32=True))


def _sorted_terms(descs, plan: SegmentPlan, stream_dtype) -> torch.Tensor:
    """[n, d] float32: the term of each sorted position, rounded as the
    kernel rounds it."""
    dim = descs[0].grad.shape[1]
    terms = torch.zeros((plan.perm.numel(), dim), dtype=torch.float32, device=plan.perm.device)
    start = 0
    for d in descs:
        count = d.indices.numel()
        at = torch.nonzero((plan.perm >= start) & (plan.perm < start + count)).reshape(-1)
        local = plan.perm[at] - start
        grad = d.grad
        if stream_dtype is not None and stream_dtype != grad.dtype:
            grad = grad.to(stream_dtype)
        t = grad[local // d.indices.shape[1]]
        if d.weights is not None:
            t = t * d.weights.reshape(-1)[local].to(grad.dtype)[:, None]
        terms[at] = t.to(torch.float32)
        start += count
    return terms


def segment_sum_plain(
    num_rows: int,
    descs: Sequence,
    stream_dtype: Optional[torch.dtype] = None,
    plan: Optional[SegmentPlan] = None,
) -> torch.Tensor:
    """The kernel's sums in plain PyTorch, each add in the kernel's order: a
    row within one chunk of the sorted array term by term from 0, a row
    that crosses the multiples of :data:`CHUNK` by pieces, then the pieces
    in order from 0.  Bitwise the kernel's result on the same plan; it
    reads the plan's sizes on the host."""
    if plan is None:
        plan = plan_segments(num_rows, descs)
    terms = _sorted_terms(descs, plan, stream_dtype)
    off = plan.offsets.to(torch.int64)
    starts, ends = off[:-1], off[1:]
    first_chunk, last_chunk = starts // CHUNK, (ends - 1) // CHUNK
    out = torch.zeros((num_rows, terms.shape[1]), dtype=torch.float32, device=terms.device)

    def add_in_order(firsts, lengths, values):
        # acc[r] = (((0 + values[firsts[r]]) + values[firsts[r] + 1]) + ...)
        acc = torch.zeros((firsts.numel(), values.shape[1]), dtype=torch.float32,
                          device=values.device)
        for j in range(int(lengths.max()) if lengths.numel() else 0):
            live = torch.nonzero(lengths > j).reshape(-1)
            acc[live] = acc[live] + values[firsts[live] + j]
        return acc

    whole = torch.nonzero((ends > starts) & (first_chunk == last_chunk)).reshape(-1)
    out[whole] = add_in_order(starts[whole], ends[whole] - starts[whole], terms)
    cut = torch.nonzero((ends > starts) & (first_chunk < last_chunk)).reshape(-1)
    if cut.numel():
        num_pieces = last_chunk[cut] - first_chunk[cut] + 1
        row_of_piece = torch.repeat_interleave(torch.arange(cut.numel(), device=off.device),
                                               num_pieces)
        first_piece = torch.cumsum(num_pieces, 0) - num_pieces
        chunk = first_chunk[cut][row_of_piece] + (
            torch.arange(row_of_piece.numel(), device=off.device) - first_piece[row_of_piece])
        p_start = torch.maximum(starts[cut][row_of_piece], chunk * CHUNK)
        p_end = torch.minimum(ends[cut][row_of_piece], (chunk + 1) * CHUNK)
        pieces = add_in_order(p_start, p_end - p_start, terms)
        out[cut] = add_in_order(first_piece, num_pieces, pieces)
    return out


def bind(lib):
    """The library's entry point with its C signature declared (see the
    source's ``cunvsm_segment_sum_f32``); it returns the launches'
    ``cudaError_t``."""
    fn = lib.cunvsm_segment_sum_f32
    ptr, ll = ctypes.c_void_p, ctypes.c_longlong
    fn.argtypes = [ptr, ptr, ptr, ll, ll, ll, ctypes.c_int, ptr, ptr, ptr, ptr,
                   ctypes.c_int, ll, ptr, ptr, ptr]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _segment_kernel():
    return bind(cuda_build.load_library("segment_sum", ("segment_sum.cu",)))


def _launch(num_rows: int, descs, stream_dtype, plan: SegmentPlan) -> torch.Tensor:
    grads = [d.grad.contiguous() for d in descs]
    weights = [None if d.weights is None else d.weights.contiguous() for d in descs]
    dim = grads[0].shape[1]
    n = plan.perm.numel()
    device = grads[0].device
    out = torch.empty((num_rows, dim), dtype=torch.float32, device=device)
    partials = torch.empty((2 * (-(-n // CHUNK)), dim), dtype=torch.float32, device=device)
    k = len(descs)
    starts, start = [], 0
    for d in descs:
        starts.append(start)
        start += d.indices.numel()
    with torch.cuda.device(device):
        rc = _segment_kernel()(
            plan.rows.data_ptr(), plan.perm.data_ptr(), plan.offsets.data_ptr(),
            n, num_rows, dim, k,
            (ctypes.c_void_p * k)(*(g.data_ptr() for g in grads)),
            (ctypes.c_void_p * k)(*(None if w is None else w.data_ptr() for w in weights)),
            (ctypes.c_longlong * k)(*starts),
            (ctypes.c_longlong * k)(*(d.indices.shape[1] for d in descs)),
            int(stream_dtype == torch.bfloat16), CHUNK,
            out.data_ptr(), partials.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
        torch.cuda.check_error(rc)
    return out


def segment_sum(
    num_rows: int, descs: Sequence, stream_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """S of ``descs`` as a new [num_rows, d] float32 tensor, by the plan and
    the kernel on the card.  Raises unless :func:`kernel_takes` the
    accumulation."""
    if not kernel_takes(descs, stream_dtype):
        raise ValueError("segment_sum: no kernel for these descriptors")
    out = _launch(num_rows, descs, stream_dtype, plan_segments(num_rows, descs))
    segment_sum.launches += 1
    return out


segment_sum.launches = 0
