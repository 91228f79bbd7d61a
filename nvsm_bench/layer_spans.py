"""The program's own spans in a profiled segment, and the per-layer metrics
that read them.

``cunvsm_torch/spans.py`` names its host spans ``cunvsm.<layer>.<what>``
with the layer one of ``LAYERS``; nesting gives each its parent.  Over the
segment, every instant on the host belongs to the innermost ``cunvsm.``
span open then, or to none.  Two quantities follow, per step:

* ``idle_ms_per_step.<layer>``: the card's idle time (between its first
  and last operation, outside the union of its operations) during which
  the innermost open span was the layer's;
* ``host_ms_per_step.<layer>``: the self time of the layer's spans, each
  span's length less what its ``cunvsm.`` children cover: the layer's own
  host dispatch, the profiler's cost of each operation included.

Idle under no span is ``outside``, printed and not reported.  The steps
are the program's: the count of ``STEP_SPAN`` spans, which must equal the
harness's ``units``; without any ``cunvsm.`` span (a program that has
none) or with another count the metrics are not read.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Tuple

from nvsm_bench import yardstick
from nvsm_bench.harness import log

PREFIX = "cunvsm."
LAYERS = ("trainer", "sampler", "step", "optimizer")
OUTSIDE = "outside"
STEP_SPAN = "cunvsm.step.cost_and_grads"

Interval = Tuple[float, float, str]


def innermost_pieces(spans: List[Interval]) -> List[Interval]:
    """Disjoint ``(start, end, name)`` pieces of the host's time, each under
    the innermost of ``spans`` open over it (the one that started last;
    spans of one thread nest).  A span that outlives its parent is cut at
    the parent's end."""
    pieces: List[Interval] = []
    stack: List[Tuple[float, str]] = []  # (end, name), innermost last
    t = 0.0

    def close_until(when: float) -> float:
        at = t
        while stack and stack[-1][0] <= when:
            end, name = stack.pop()
            if end > at:
                pieces.append((at, end, name))
                at = end
        return at

    for start, end, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        t = close_until(start)
        if stack and start > t:
            pieces.append((t, start, stack[-1][1]))
        t = start
        if stack:
            end = min(end, stack[-1][0])
        stack.append((end, name))
    close_until(float("inf"))
    return pieces


def idle_gaps(device: List[Interval]) -> List[Tuple[float, float]]:
    """The card's idle intervals between its first and last operation."""
    busy = yardstick.merged((s, e) for s, e, _ in device)
    return [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]


def layer_of(name: str) -> str:
    return name[len(PREFIX):].split(".", 1)[0]


def split(trace) -> Tuple[Dict[str, float], Dict[str, float]]:
    """(idle seconds by layer, ``outside`` included; host self seconds by
    layer) over the whole segment."""
    pieces = innermost_pieces([h for h in trace.host if h[2].startswith(PREFIX)])
    host: Dict[str, float] = collections.Counter()
    for s, e, name in pieces:
        host[layer_of(name)] += e - s
    idle: Dict[str, float] = collections.Counter()
    gaps = idle_gaps(trace.device)
    i = 0
    for g0, g1 in gaps:
        covered = 0.0
        # Pieces and gaps are sorted and disjoint: walk both once.
        while i < len(pieces) and pieces[i][1] <= g0:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < g1:
            s, e, name = pieces[j]
            part = min(e, g1) - max(s, g0)
            if part > 0:
                idle[layer_of(name)] += part
                covered += part
            j += 1
        idle[OUTSIDE] += (g1 - g0) - covered
    return idle, host


def steps(rec) -> Optional[int]:
    """The steps of the profiled segment by the program's count, or None
    (and why, on standard error) where the spans cannot be read."""
    t = rec.trace
    if t is None:
        return None
    names = [h[2] for h in t.host if h[2].startswith(PREFIX)]
    if not names:
        log("layer_spans: the trace holds no cunvsm. span; the per-layer span metrics "
            "are not read")
        return None
    n = names.count(STEP_SPAN)
    if n != t.units:
        log(f"layer_spans: {n} {STEP_SPAN} spans against {t.units} steps; "
            f"the per-layer span metrics are not read")
        return None
    return n


def idle_ms_per_step(rec, layer: str, show_split: bool = False) -> Optional[float]:
    n = steps(rec)
    if n is None or not rec.trace.device:
        return None
    idle, _ = split(rec.trace)
    if show_split:
        total = sum(idle.values())
        parts = " ".join(f"{k} {1e3 * idle[k] / n!r}" for k in LAYERS + (OUTSIDE,))
        log(f"idle_ms_per_step: {parts}; traced idle {1e3 * total / n!r} ms a step")
    return 1e3 * idle[layer] / n


def host_ms_per_step(rec, layer: str) -> Optional[float]:
    n = steps(rec)
    if n is None:
        return None
    _, host = split(rec.trace)
    return 1e3 * host[layer] / n
