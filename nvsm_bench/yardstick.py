"""The benchmark's yardstick: the card's peaks, the least time of a piece of
work, the union of device intervals, and the reduction of a profiler trace
to busy time, kernel times and labelled idle gaps.

Frozen copies, so that a change to the program cannot move the ruler:
``HBM_BYTES_PER_S``, ``F32_OPS_PER_S`` and ``bound`` from
``chip_smoke.py``; ``busy_union`` from ``profile_torch_step.py:busy_us``.
The peaks are NVIDIA's data sheet for the H100 SXM part at its 700 W limit;
the run prints the card's own power limit beside every number.
"""

from __future__ import annotations

import bisect
import collections
import statistics
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound(num_bytes: float, ops: float) -> Tuple[float, str]:
    """(seconds, what bounds it): the least time the card could take, bytes
    over the HBM rate or float32 operations over the float32 rate, whichever
    is larger."""
    bytes_s, ops_s = num_bytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (bytes_s, "bytes") if bytes_s >= ops_s else (ops_s, "operations")


def busy_union(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def merged(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of the intervals as sorted disjoint intervals."""
    out: List[List[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(s, e) for s, e in out]


def quantile(values: Sequence[float], q: int) -> float:
    """The q-th percentile (1..99) by ``statistics.quantiles(n=100)``,
    interpolated inside the sample's range."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


class TraceSummary:
    """What the benchmark reads from one profiled segment.

    ``device`` holds the (start, end, name) of every operation the profiler
    saw on the card, in seconds; ``host`` every host operation.  ``wall_s``
    is the segment's length by the host clock and ``units`` the steps or
    calls it held."""

    def __init__(self, device: List[Tuple[float, float, str]],
                 host: List[Tuple[float, float, str]], wall_s: float, units: int):
        self.device = device
        self.host = host
        self.wall_s = wall_s
        self.units = units
        self.busy_s = busy_union((s, e) for s, e, _ in device)
        self.kernel_s: Dict[str, float] = collections.Counter()
        self.kernel_n: Dict[str, int] = collections.Counter()
        for s, e, name in device:
            self.kernel_s[name] += e - s
            self.kernel_n[name] += 1

    @classmethod
    def from_profiler(cls, prof, wall_s: float, units: int) -> "TraceSummary":
        from torch.autograd import DeviceType

        device, host = [], []
        for e in prof.events():
            row = (e.time_range.start / 1e6, e.time_range.end / 1e6, e.name)
            if e.device_type == DeviceType.CUDA:
                device.append(row)
            elif e.device_type == DeviceType.CPU:
                host.append(row)
        return cls(device, host, wall_s, units)

    def matching(self, fragment: str) -> Tuple[float, int]:
        """(seconds, launches) of the device operations whose name holds
        ``fragment``."""
        secs = sum(s for n, s in self.kernel_s.items() if fragment in n)
        count = sum(c for n, c in self.kernel_n.items() if fragment in n)
        return secs, count

    def top_device_ops(self, n: int = 10) -> List[List]:
        return [[name, secs] for name, secs in
                sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The card's idle time between its first and last operation, summed
        by the innermost host operation running at each gap's midpoint
        ("host: python" where none ran)."""
        busy = merged((s, e) for s, e, _ in self.device)
        gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
        host = sorted(self.host)
        starts = [h[0] for h in host]
        by_label: Dict[str, float] = collections.Counter()
        for g0, g1 in gaps:
            mid = 0.5 * (g0 + g1)
            label = _innermost(host, starts, mid)
            by_label[label] += g1 - g0
        return [[label, secs] for label, secs in
                sorted(by_label.items(), key=lambda kv: -kv[1])[:n]]


def _innermost(host, starts, t: float) -> str:
    """The name of the shortest host operation that covers time ``t``."""
    i = bisect.bisect_right(starts, t)
    best: Optional[Tuple[float, str]] = None
    # Host operations nest; the few hundred that start before t and are
    # still running are all among the latest starters.
    for j in range(i - 1, max(i - 400, -1), -1):
        s, e, name = host[j]
        if e >= t and (best is None or e - s < best[0]):
            best = (e - s, name)
    return "host: " + (best[1] if best else "python")


def idle_share(trace: Optional[TraceSummary], wall_per_unit: Optional[float]) -> Optional[float]:
    """1 - (the card's busy time per step or call in the profiled segment)
    / (the wall time per step or call of the untraced window), in percent;
    None without a trace, without device operations in it, or without an
    untraced window.  The untraced wall leaves out the profiler's own cost
    on the host."""
    if trace is None or not trace.device or not trace.units or not wall_per_unit:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.units / wall_per_unit)
