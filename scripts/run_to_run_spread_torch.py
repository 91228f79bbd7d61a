#!/usr/bin/env python3
"""How far two single-device runs of one seed drift apart, and why.

    python3 scripts/run_to_run_spread_torch.py [--epochs 1]

Trains the canonical configuration at full width (``chip_smoke.py``'s phase
D: on-device sampling, calls of K = 13 steps, one epoch of 117 steps) twice
from one seed on one CUDA card, in three settings, and prints for each the
largest and the root-mean-square difference of every table between the two
runs, and the share of the entries that differ by more than 5e-6:

* ``default``: bfloat16 streams, PyTorch's default kernels, whose
  ``index_add_`` adds its rows with atomics, in no fixed order;
* ``deterministic``: the same under
  ``torch.use_deterministic_algorithms(True, warn_only=True)``, which makes
  ``index_add_`` add in a fixed order.  If the two runs are then equal to
  the last bit, the order of those additions is the whole of the spread;
* ``float32_streams``: default kernels with float32 streams, which takes the
  bfloat16 roundings out and leaves Adam's amplification of the order alone.

Every run draws the same documents, positions and negatives (one seed), so
whatever differs comes from the arithmetic.  The last line is one JSON
object with every figure.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

# cuBLAS keeps to one order of additions only with a fixed workspace; read
# when its handle is made.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

from chip_smoke import (  # noqa: E402
    CANONICAL, canonical_corpus, canonical_desc_cfg, gpu_name_and_power, load_source, log,
)
from cunvsm_torch.train.trainer import train_model  # noqa: E402


def two_runs(desc, cfg, corpus, device, k):
    """(table differences, relative cost difference, ms/step of each run)."""
    table_differences = load_source(
        "mesh_phase_torch", "scripts", "mesh_phase_torch.py").table_differences
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = train_model(desc, cfg, corpus, device, on_device_sampling=True, steps_per_call=k)
        torch.cuda.synchronize()
        runs.append((result, 1e3 * (time.perf_counter() - t0) / result.steps))
    (a, ms_a), (b, ms_b) = runs
    return dict(
        differences=table_differences(b.params, a.params),
        bitwise_equal=all(torch.equal(x, y) for x, y in zip(a.params, b.params)),
        cost_rel_diff=abs(b.epoch_costs[-1] - a.epoch_costs[-1]) / abs(a.epoch_costs[-1]),
        steps=a.steps, ms_per_step=[ms_a, ms_b],
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=1)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("run_to_run_spread_torch.py: no CUDA device")
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"nvidia-smi: {gpu_name_and_power()}")
    corpus = canonical_corpus(CANONICAL)
    desc, cfg = canonical_desc_cfg(CANONICAL)
    cfg = dataclasses.replace(cfg, num_epochs=args.epochs)
    k = CANONICAL["steps_per_call"]
    out = {"default": two_runs(desc, cfg, corpus, device, k)}
    log("default " + json.dumps(out["default"]))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        out["deterministic"] = two_runs(desc, cfg, corpus, device, k)
    finally:
        torch.use_deterministic_algorithms(False)
    log("deterministic " + json.dumps(out["deterministic"]))
    exact = dataclasses.replace(cfg, stream_dtype="float32", window_sum_dtype="float32")
    out["float32_streams"] = two_runs(desc, exact, corpus, device, k)
    log("float32_streams " + json.dumps(out["float32_streams"]))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
