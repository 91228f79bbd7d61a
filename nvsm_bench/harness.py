"""What every cell shares: finding a cell's files by name, the run record,
the checks that decide ``correct``, and the result line.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration and a traffic mix.  The harness reads, by those names:

* ``configs/<config>.json``: the configuration's sizes and precision, whose
  ``work`` names ``work/<work>.py``, its operations and bytes as functions
  of the sizes;
* ``traffic/<traffic>.json``: the mix's parameters, whose ``driver`` names
  ``drivers/<driver>.py``, the code that makes the inputs and drives the
  program;
* ``workloads/<cell>.json``: the cell's correctness sample and limits;
* ``metrics/<metric>.py``, or ``metrics/<metric up to its first dot>.py``:
  the reader of a per-layer metric.

A new configuration, mix, cell or metric is a new file and a new entry.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
from typing import Any, Dict, List, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "cunvsm_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_module(*parts):
    """Import ``nvsm_bench/<parts>`` by its path (metric names hold dots)."""
    path = os.path.join(HERE, *parts)
    name = "nvsm_bench._loaded." + "_".join(parts).replace(".", "_").replace("/", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Context:
    """One run of one cell."""

    bench: dict  # BENCHMARK.json
    cell: dict  # the cell's entry in ``workloads``
    seed: int
    seconds: float
    trace: bool
    device: Any  # torch.device
    start: float  # time.perf_counter() at process start
    config: dict = dataclasses.field(default_factory=dict)
    mix: dict = dataclasses.field(default_factory=dict)
    checks: dict = dataclasses.field(default_factory=dict)
    work: Any = None

    @classmethod
    def load(cls, bench: dict, name: str, **kw) -> "Context":
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
        cell = cells[name]
        ctx = cls(bench=bench, cell=cell, **kw)
        ctx.config = load_json("configs", f"{cell['config']}.json")
        ctx.mix = load_json("traffic", f"{cell['traffic']}.json")
        ctx.checks = load_json("workloads", f"{name}.json")
        ctx.work = load_module("work", f"{ctx.config['work']}.py")
        return ctx

    def driver(self):
        return load_module("drivers", f"{self.mix['driver']}.py")


def metric_reader(name: str):
    """The reader module of per-layer metric ``name``."""
    own = f"{name}.py"
    if os.path.exists(os.path.join(HERE, "metrics", own)):
        return load_module("metrics", own)
    return load_module("metrics", f"{name.split('.', 1)[0]}.py")


@dataclasses.dataclass
class Record:
    """What a driver hands back: the window's numbers, the profiled
    segment's summary, what the readers need, and the checks."""

    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: List[Tuple[str, float, float]]  # (name, reading, limit)
    faults: List[str]
    trace: Any = None  # yardstick.TraceSummary of the profiled segment
    # What the readers need: every driver gives ``unit_flops`` (a step's or
    # a call's model FLOPs) and ``untraced_units`` / ``untraced_s`` (the
    # steps or calls of the untraced window and its wall), or None for them.
    facts: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return not self.faults and all(
            math.isfinite(v) and v <= limit for _, v, limit in self.checks)


def cell_metrics(ctx: Context, rec: Record) -> Tuple[Dict[str, dict], List[str]]:
    """The metrics this run reports, and what it should have and could not:
    the cell's end-to-end metrics with ``--trace 0``, its per-layer metrics
    (each from its reader, left out where the reader finds nothing) with
    ``--trace 1``."""
    name = ctx.cell["name"]
    kind = "per_layer" if ctx.trace else "end_to_end"
    out, missing = {}, []
    for m in ctx.bench[kind]:
        if "workloads" in m and name not in m["workloads"]:
            continue
        if ctx.trace:
            value = metric_reader(m["name"]).read(ctx, rec)
        else:
            value = rec.end_to_end.get(m["name"])
        if value is None:
            missing.append(m["name"])
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out, missing


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that a run may not hold."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def result_line(ctx: Context, rec: Record, device_name: str, chips: int) -> dict:
    metrics, missing = cell_metrics(ctx, rec)
    if missing and not ctx.trace:
        rec.faults.append(f"end-to-end metrics not measured: {missing}")
    device = {"platform": "gpu", "kind": device_name, "count": chips,
              "memory_peak_bytes": int(rec.memory_peak_bytes)}
    line = {"correct": rec.correct, "attempted": int(rec.attempted),
            "failed": int(rec.failed), "metrics": metrics, "device": device}
    if ctx.trace and rec.trace is not None:
        device["busy_s"] = rec.trace.busy_s
        device["window_s"] = rec.trace.wall_s
        line["breakdown"] = {"device_ops": rec.trace.top_device_ops(),
                             "idle_gaps": rec.trace.idle_gaps()}
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rec.checks}
    if rec.faults:
        line["checks"]["faults"] = {"value": len(rec.faults), "limit": 0}
    return line


def check_lines(rec: Record) -> List[str]:
    lines = [f"fault: {f}" for f in rec.faults]
    for n, v, lim in rec.checks:
        verdict = "ok" if math.isfinite(v) and v <= lim else "FAILED"
        lines.append(f"check {n} {v!r} limit {lim!r} {verdict}")
    return lines


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)
