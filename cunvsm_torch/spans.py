"""Named host spans of the port's layers, on the profiler's clock.

``span("cunvsm.<layer>.<what>")`` marks a stretch of host work of one layer
(``trainer``, ``sampler``, ``step``, ``optimizer``).  While a
``torch.profiler`` trace runs, the span is a host event of that trace, on
the clock of the card's kernels, so an operator's ``--profile_dir`` trace
and any other profiler pick it up; nesting gives each span its parent.  A
span still open when the profiler stops is left out of its trace (torch
2.11), so a profiled stretch closes its spans before the stop.
With no profiler running it is one shared no-op context: no torch call, no
allocation.

Why not ``torch.profiler.record_function``:

* it enters the dispatcher whether or not a profiler runs: 13-15 us a span
  with none running, against 0.4-0.6 us for a bare ``nullcontext`` (torch
  2.11 on an H100 machine's host, loops of 100,000 spans);
* it opens a *user annotation*, which a CUDA trace mirrors as a
  device-typed ``gpu_user_annotation`` event spanning the kernels launched
  inside it: an epoch-long span would then read as device work over the
  whole epoch.

``_RecordFunctionFast`` opens a plain function-scope event instead (2.6 us
a span while a CPU and CUDA profiler records, in the same loop), and
``_is_profiler_enabled``, which every profiler's start and stop set, skips
even that when nothing records (0.3-0.6 us a span, the ``nullcontext``'s
cost).  This module is the only user of either private name.
"""

from __future__ import annotations

import contextlib

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` as a host event while a profiler
    runs, and the shared no-op context otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _RecordFunctionFast(name)
