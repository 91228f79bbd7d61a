"""Readings that a cell's correctness limits are set from, many seeds in
one process.

    python3 nvsm_bench/tools/calibrate.py --workload <name> --seeds 1-12 \\
        [--controls 3] [--out FILE.jsonl]

For every seed, the numbers that a run of the cell compares (the program,
as the configuration states it, against the plain reference): these give
the lower reading.  On the first ``--controls`` seeds also the control and
the faults, each held to the same reference, over both epochs that a run
compares: the reference in TF32 (``tf32``); the reference with float8
(e4m3) streams (``fp8_streams``, the control of a configuration with
bfloat16 streams); the fault of half the batch left out of the cost, the
mean taken over the rest (``half_batch``), each put in the program's place.
A step that returns its state unchanged, from the first epoch or from the
second, reads 1 by that epoch's ``change_gap`` and needs no run.

Each line of ``--out`` (and of standard output) is one JSON object.  The
tool runs on a card, as the benchmark does; it is not part of a run.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def seeds(text: str):
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def tf32(on: bool):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def train_lines(ctx, controls: bool):
    import statistics

    from nvsm_bench.drivers import train_epochs as drv
    from nvsm_bench.reference import train as ref

    got = drv.train_window(ctx)
    spec, k, epochs = got["spec"], ctx.mix["steps_per_call"], len(got["after"])

    def follow(spec_=spec, rows=None):
        return ref.follow(got["tokens"], got["seed"], spec_, k, ctx.device, epochs, rows=rows)

    def against(reference, costs, after):
        values, _ = drv.readings(costs, after, reference)
        return values

    t0 = time.perf_counter()
    base = follow()
    lines = [dict(kind="program", **against(base, got["costs"], got["after"]),
                  faults=len(drv.window_faults(got["costs"], got["norms"])),
                  reference_s=time.perf_counter() - t0)]
    if not controls:
        return lines

    def as_program(f):
        return ([statistics.fmean(c) for c in f.costs],
                [{n: t.cpu() for n, t in after.items()} for after in f.after])

    tf32(True)
    lines.append(dict(kind="tf32", **against(base, *as_program(follow()))))
    tf32(False)
    lines.append(dict(kind="half_batch",
                      **against(base, *as_program(follow(rows=spec.batch // 2)))))
    if ctx.config["train"]["stream_dtype"] == "bfloat16":
        fp8 = ref.Spec.from_config(ctx.config, stream_override="float8_e4m3fn")
        lines.append(dict(kind="fp8_streams", **against(base, *as_program(follow(fp8)))))
    return lines


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="a range such as 1-12")
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    from nvsm_bench import harness

    if not torch.cuda.is_available():
        raise SystemExit("calibrate.py: no CUDA device")
    tf32(False)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(args.out, "a") if args.out else contextlib.nullcontext() as out:
        for i, seed in enumerate(seeds(args.seeds)):
            # seconds=0: the window closes at epoch 2, the last one judged.
            ctx = harness.Context.load(bench, args.workload, seed=seed, seconds=0.0,
                                       trace=False, device=torch.device("cuda"),
                                       start=time.perf_counter())
            for line in train_lines(ctx, i < args.controls):
                line = json.dumps(dict(workload=args.workload, seed=seed, **line))
                print(line, flush=True)
                if out is not None:
                    out.write(line + "\n")
                    out.flush()
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
