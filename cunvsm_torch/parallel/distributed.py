"""Multi-process runtime: one process per device, ``torch.distributed``.

Port of ``cunvsm_tpu/parallel/distributed.py``.  The JAX package drives a
mesh of local chips from one process and lets GSPMD insert the
collectives; PyTorch has no such partitioner, so a mesh run of this package
is N identical processes, one per device, that call their collectives
explicitly.  What this module holds:

* **initialization**: :func:`initialize` joins the process group, either
  from the manual triple (``--coordinator_address/--num_processes/
  --process_id``; ``host:port`` means ``tcp://host:port``, and any
  ``scheme://`` rendezvous that ``init_process_group`` knows is passed on)
  or, with no arguments, from the environment that ``torchrun`` sets
  (``env://``).  The backend is an explicit argument (``nccl`` for CUDA
  devices, ``gloo`` for the CPU) and is never switched quietly;
* **who writes**: :func:`is_primary`, true on rank 0 and in a single
  process;
* **host materialization**: :func:`fetch` all-gathers a row-sharded tensor
  to every rank.  It is a collective: every rank of the group must call it
  at the same point;
* **the collectives layer** that GSPMD gave the JAX package for free:
  :func:`all_reduce` and :func:`all_gather` over a process group, each call
  recorded under a name in :func:`collective_log` with its count and bytes.
  The log is what the tests assert communication volume on (the JAX
  package's tests parse compiled HLO for that).  :func:`all_reduce_grad` is
  the all-reduce whose backward is an all-reduce too, as an
  ``autograd.Function`` in the ``setup_context`` form that
  ``torch.func.vjp`` accepts.

A backend that has no collective for the tensor's device raises, with one
exception that the caller has to ask for by name: a ``gloo`` group given
CUDA tensors stages each buffer through the host, and the log says so
(``staged_through_host``).  No rank carries on on the CPU when its device
is missing.

A single process that never called :func:`initialize` has no group: it
counts as one process, and a mesh over it calls no collective.
"""

from __future__ import annotations

import datetime
from typing import Dict, Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_SECONDS = 600.0


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: str,
    device=None,
    timeout: float = DEFAULT_TIMEOUT_SECONDS,
) -> None:
    """Join the process group.

    With no address, count or id the rendezvous is read from the
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
    as ``torchrun`` sets them); otherwise all three are needed.  ``backend``
    is ``"nccl"`` or ``"gloo"``; ``nccl`` needs ``device`` to be a CUDA
    device, which becomes the process's current device.  ``timeout``
    (seconds) bounds the rendezvous and every collective of the group and
    of the groups made from it, so that a rank that never arrives fails the
    others instead of hanging them.
    """
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', not {backend!r}")
    manual = (coordinator_address, num_processes, process_id)
    kwargs = {}
    if all(x is None for x in manual):
        init_method = "env://"
    elif any(x is None for x in manual):
        raise ValueError(
            "a manual launch needs coordinator_address, num_processes and "
            "process_id together"
        )
    else:
        init_method = coordinator_address
        if "://" not in init_method:
            init_method = f"tcp://{init_method}"
        kwargs = dict(world_size=int(num_processes), rank=int(process_id))
    if backend == "nccl":
        if device is None or torch.device(device).type != "cuda":
            raise ValueError("the nccl backend needs a CUDA device")
        if not torch.cuda.is_available():
            raise RuntimeError("the nccl backend needs a CUDA device; none is available")
        torch.cuda.set_device(torch.device(device))
        kwargs["device_id"] = torch.device(device)
    dist.init_process_group(
        backend, init_method=init_method,
        timeout=datetime.timedelta(seconds=timeout), **kwargs,
    )


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    if is_initialized():
        dist.destroy_process_group()


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_primary() -> bool:
    """True on the one process that owns file writes (checkpoints, meta,
    sidecars, the run file).  Always true in a single process."""
    return process_index() == 0


# ---------------------------------------------------------------------------
# The collectives layer.
# ---------------------------------------------------------------------------

_LOG: Dict[str, Dict[str, object]] = {}


def collective_log() -> Dict[str, Dict[str, object]]:
    """{name: {"op", "calls", "bytes", "staged_through_host"}} since the last
    :func:`reset_collective_log`.  ``bytes`` sums, per call, the buffer an
    all-reduce reduces or the gathered result an all-gather returns."""
    return {name: dict(entry) for name, entry in _LOG.items()}


def reset_collective_log() -> None:
    _LOG.clear()


def _record(name: str, op: str, nbytes: int, staged: bool) -> None:
    entry = _LOG.setdefault(
        name, {"op": op, "calls": 0, "bytes": 0, "staged_through_host": False}
    )
    entry["calls"] += 1
    entry["bytes"] += int(nbytes)
    entry["staged_through_host"] = bool(entry["staged_through_host"] or staged)


def _staged(tensor: torch.Tensor, group) -> bool:
    """Whether ``tensor`` has to pass through the host: only a CUDA tensor
    in a gloo group, which the caller chose by name.  A CPU tensor in an
    nccl group raises."""
    backend = dist.get_backend(group)
    if backend == "gloo":
        return tensor.is_cuda
    if not tensor.is_cuda:
        raise RuntimeError(
            f"the {backend} backend has no collective for a CPU tensor; "
            "initialize the group with backend='gloo' for CPU runs"
        )
    return False


def all_reduce(tensor: torch.Tensor, name: str, group=None) -> torch.Tensor:
    """The sum of ``tensor`` over the ranks of ``group`` (all ranks by
    default), on every rank.  Reduces a contiguous tensor in place and
    returns it.  Without a process group it returns ``tensor`` as it is and
    records nothing."""
    if not is_initialized():
        return tensor
    buf = tensor.contiguous()
    staged = _staged(buf, group)
    if dist.get_world_size(group) == 1:
        # The sum over one rank: recorded, so that the log reads alike on
        # every mesh shape, and not sent through the backend.
        _record(name, "all_reduce", buf.numel() * buf.element_size(), False)
        return buf
    _record(name, "all_reduce", buf.numel() * buf.element_size(), staged)
    if staged:
        host = buf.cpu()
        dist.all_reduce(host, group=group)
        buf.copy_(host)
    else:
        dist.all_reduce(buf, group=group)
    return buf


def all_gather(tensor: torch.Tensor, name: str, group=None, dim: int = 0) -> torch.Tensor:
    """The ranks' tensors (of one shape) concatenated along ``dim`` in rank
    order, on every rank."""
    if not is_initialized():
        return tensor
    buf = tensor.contiguous()
    size = dist.get_world_size(group)
    staged = _staged(buf, group)
    if size == 1:
        _record(name, "all_gather", buf.numel() * buf.element_size(), False)
        return buf
    _record(name, "all_gather", size * buf.numel() * buf.element_size(), staged)
    src = buf.cpu() if staged else buf
    if src.ndim == 0:
        src = src.reshape(1)
    # One buffer, which is the concatenation along dim 0 as it lies.
    out = src.new_empty((size * src.shape[0], *src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    if dim != 0:
        out = torch.cat(out.chunk(size, dim=0), dim=dim)
    return out.to(buf.device) if staged else out


def fetch(tensor: torch.Tensor, group=None, name: str = "fetch") -> torch.Tensor:
    """The whole of a tensor that is sharded by rows over ``group``, on
    every rank: a collective, which every rank of the group must call."""
    return all_gather(tensor, name, group, dim=0)


def barrier(device) -> None:
    """Every rank waits here for every other: a one-element all-reduce on
    ``device`` (recorded as ``barrier``), read back on the host."""
    if is_initialized():
        float(all_reduce(torch.zeros(1, device=device), "barrier"))


class _AllReduceGrad(torch.autograd.Function):
    """y = sum over ranks of x, on every rank.  Every rank goes on to use
    y in its own part of a loss that is summed over the ranks, so the
    cotangent of x is the sum over ranks of the cotangents of y."""

    @staticmethod
    def forward(x, name, group):
        # all_reduce works in place: the input's storage is left alone.
        return all_reduce(x.detach().clone(), name, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.name, ctx.group = inputs

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.detach().clone(), ctx.name + "_grad", ctx.group), None, None


def all_reduce_grad(tensor: torch.Tensor, name: str, group=None) -> torch.Tensor:
    """:func:`all_reduce` that autograd (and ``torch.func.vjp``) can
    differentiate; the backward's call is recorded as ``<name>_grad``."""
    if not is_initialized():
        return tensor
    return _AllReduceGrad.apply(tensor, name, group)
