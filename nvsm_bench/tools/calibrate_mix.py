"""Readings that the Mix 'n Match cell's correctness limits are set from,
many seeds in one process.

    python3 nvsm_bench/tools/calibrate_mix.py --workload mixnmatch.train \\
        --seeds 1-12 [--controls 3] [--out FILE.jsonl]

For every seed, the numbers that a run of the cell compares (the program,
as the configuration states it, against the plain reference
``reference/train_mix.py``, after each of two epochs and after the first
call): these give the lower reading.  On the first
``--controls`` seeds also the controls and the faults, each a run of the
reference put in the program's place and held to the same reference over
both epochs: the similarity objective dropped, the text weight kept
(``no_similarity``); bfloat16 streams where the configuration states
float32 (``bf16_streams``); the first pair batch trained at every step
(``frozen_pairs``); the reference in TF32 (``tf32``).

Each line of ``--out`` (and of standard output) is one JSON object.  The
tool runs on a card, as the benchmark does; it is not part of a run.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
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
    import torch

    from nvsm_bench.drivers import train_epochs as base
    from nvsm_bench.drivers import train_mix_epochs as drv
    from nvsm_bench.reference import train as ref

    got = drv.train_window(ctx)
    t0 = time.perf_counter()
    sound, sound_call = drv.follow(ctx, got), drv.follow(ctx, got, first=True)

    def against(costs, after, call):
        values, _ = drv.readings(costs, after, call, sound, sound_call)
        return values

    lines = [dict(kind="program", **against(got["costs"], got["after"],
                                            drv.first_call(ctx, got)),
                  faults=len(base.window_faults(got["costs"], got["norms"])),
                  reference_s=time.perf_counter() - t0)]
    if not controls:
        return lines

    def as_program(**kw):
        """A run of the reference in the program's place."""
        f, c = drv.follow(ctx, got, **kw), drv.follow(ctx, got, first=True, **kw)
        return ([statistics.fmean(x) for x in f.costs],
                [{n: t.cpu() for n, t in after.items()} for after in f.after],
                (torch.tensor(c.costs[0], dtype=torch.float64),
                 {n: t.cpu() for n, t in c.after[0].items()}))

    bf16 = ref.Spec.from_config(ctx.config, stream_override="bfloat16")
    for kind, kw in (("no_similarity", dict(drop_similarity=True)),
                     ("bf16_streams", dict(spec=bf16)),
                     ("frozen_pairs", dict(frozen_pairs=True))):
        lines.append(dict(kind=kind, **against(*as_program(**kw))))
    tf32(True)
    lines.append(dict(kind="tf32", **against(*as_program())))
    tf32(False)
    return lines


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="mixnmatch.train")
    ap.add_argument("--seeds", required=True, help="a range such as 1-12")
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    from nvsm_bench import harness

    if not torch.cuda.is_available():
        raise SystemExit("calibrate_mix.py: no CUDA device")
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
