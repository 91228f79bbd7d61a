#!/usr/bin/env python3
"""What bounds full_adam's segment sum on a card: the kernels of
``cunvsm_torch/csrc/segment_sum.cu`` timed beside variants of their source
that take work away.

    python3 scripts/segment_sum_variants_torch.py [--out FILE]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
Each variant is the source with one substitution, built with the package's
nvcc flags into ``build/variants/``:

* ``base``: the source as it is (held bitwise to the plain version);
* ``onerow``: every entry reads the first gradient row of its descriptor,
  so the gather is served from L1 and L2, not HBM;
* ``noload``: no gradient row and no partial is loaded at all; what is left
  is the sort's reads, the adds, the shuffles and the stores.

The gap between ``base`` and ``onerow`` is the gathered rows' traffic; the
gap between ``onerow`` and ``noload`` their load latency.  Each case is one
table of a benchmark cell: nvsm.train's word and entity tables (bfloat16
streams) and mixnmatch.train's (float32 streams, three entity descriptors).
Beside them: ``index_add_sum`` (the path the kernel replaced), the sorted
rows gathered by ``index_select`` and a ``torch.zeros`` of the table.  Times
are microseconds a call, the median of 5 runs of 20 calls back to back
between two CUDA events; each variant's two passes alone, on one plan.

Last, ``sweep_after``: the Adam sweep of the table (``fused_adam_dense_sweep``)
timed alone by a pair of events right after each accumulation, and after
the same with 128 MB written between them, which leaves nothing of the
accumulation in the L2 (the median of 30 turns).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cunvsm_torch.models.objectives import SparseGrad  # noqa: E402
from cunvsm_torch.ops import adam_sweep, cuda_build, segment_kernels  # noqa: E402

VARIANTS = {
    "base": None,
    "onerow": ("row = grad + static_cast<long long>(local / window) * a.dim;", "row = grad;"),
    "noload": ("if (take && col < dim) load_vec<VEC>(row + col, x[s]);", "(void)take;"),
}
# (rows, dim, bfloat16 streams, [(instances, window, Zipf exponent)]);
# exponent 0 draws uniform rows.
CASES = {
    "nvsm_words": (65536, 300, True, [(51200, 10, 1.07)]),
    "nvsm_entities": (262144, 256, True, [(51200, 1, 0.0), (2048, 1, 0.0)]),
    "mix_words": (65536, 300, False, [(51200, 10, 1.07)]),
    "mix_entities": (65536, 256, False, [(51200, 1, 0.0), (2048, 1, 0.0), (102400, 1, 0.667)]),
}


def build(nvcc, tag, source, out_dir):
    """The variant's library, bound (``segment_kernels.bind``)."""
    if VARIANTS[tag] is not None:
        old, new = VARIANTS[tag]
        if source.count(old) != 1:
            raise SystemExit(f"{tag}: the source no longer holds {old!r} once")
        source = source.replace(old, new)
    src, lib = os.path.join(out_dir, f"segment_sum_{tag}.cu"), os.path.join(out_dir, f"{tag}.so")
    with open(src, "w") as f:
        f.write(source)
    subprocess.run(cuda_build.nvcc_command(nvcc, (src,), lib), check=True)
    return segment_kernels.bind(ctypes.CDLL(os.path.abspath(lib)))


def descriptors(case, device, gen):
    rows, dim, bf16, layout = CASES[case]
    descs = []
    for instances, window, exponent in layout:
        weights = torch.arange(1, rows + 1, dtype=torch.float64, device=device).pow(-exponent)
        ids = torch.multinomial(weights.to(torch.float32), instances * window, replacement=True,
                                generator=gen)
        grad = torch.randn((instances, dim), device=device, generator=gen) * 1e-3
        descs.append(SparseGrad(grad, ids.reshape(instances, window), None))
    return rows, tuple(descs), torch.bfloat16 if bf16 else None


def us_per_call(fn, calls=20, reps=5):
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(1e3 * start.elapsed_time(end) / calls)
    return statistics.median(times)


def sweep_after(rows, descs, stream, device, gen, turns=30):
    """Microseconds of the sweep right after each accumulation, with and
    without the L2 written over between the two."""
    dim = descs[0].grad.shape[1]
    p = torch.rand((rows, dim), device=device, generator=gen) - 0.5
    m, v = torch.zeros_like(p), torch.full_like(p, 1e-6)
    scale = torch.tensor(1e-5, device=device)
    flush = torch.empty(32 * 2**20, device=device)
    accumulate = {"segment_sum": lambda: segment_kernels.segment_sum(rows, descs, stream),
                  "index_add_sum": lambda: segment_kernels.index_add_sum(rows, descs, stream)}
    times = {}
    for _ in range(turns):
        for name, fn in accumulate.items():
            for flushed in (False, True):
                s = fn()
                if flushed:
                    flush.fill_(1.0)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                adam_sweep.fused_adam_dense_sweep(p, m, v, s, scale, lam=1e-7, beta1=0.9,
                                                  beta2=0.999, eps=1e-6)
                end.record()
                end.synchronize()
                key = name + (" + flush" if flushed else "")
                times.setdefault(key, []).append(1e3 * start.elapsed_time(end))
    return {key: statistics.median(t) for key, t in times.items()}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=os.path.join("chiprun_out", "segment_sum_variants.json"))
    parser.add_argument("--seed", type=int, default=7654321)
    args = parser.parse_args(argv)
    device = torch.device("cuda")
    out_dir = os.path.join(os.path.dirname(cuda_build.BUILD_DIR), "variants")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(cuda_build.CSRC, "segment_sum.cu")) as f:
        source = f.read()
    nvcc = cuda_build.find_nvcc()
    libs = {tag: build(nvcc, tag, source, out_dir) for tag in VARIANTS}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    result = {"card": card, "torch": torch.__version__, "us_per_call": {}}
    gen = torch.Generator(device=device).manual_seed(args.seed)
    for case in CASES:
        rows, descs, stream = descriptors(case, device, gen)
        plan = segment_kernels.plan_segments(rows, descs)
        row = {}
        for tag, fn in libs.items():
            segment_kernels._segment_kernel = lambda fn=fn: fn
            run = lambda: segment_kernels._launch(rows, descs, stream, plan)  # noqa: E731
            if tag == "base":
                plain = segment_kernels.segment_sum_plain(rows, descs, stream, plan)
                if not torch.equal(run(), plain):
                    raise SystemExit(f"{case}: the kernel differs from its plain version")
                del plain
            row[tag] = us_per_call(run)
        first = descs[0]
        instances = plan.perm[plan.perm < first.indices.numel()] // first.indices.shape[1]
        row["index_add_sum"] = us_per_call(
            lambda: segment_kernels.index_add_sum(rows, descs, stream))
        row["index_select_gather"] = us_per_call(lambda: first.grad.index_select(0, instances))
        row["zeros"] = us_per_call(lambda: torch.zeros((rows, first.grad.shape[1]), device=device))
        row["plan"] = us_per_call(lambda: segment_kernels.plan_segments(rows, descs))
        result["us_per_call"][case] = row
        print(case, json.dumps({k: round(v, 1) for k, v in row.items()}), flush=True)
        segment_kernels._segment_kernel = lambda: libs["base"]
        after = sweep_after(rows, descs, stream, device, gen)
        result.setdefault("sweep_after", {})[case] = after
        print(case, "sweep after", json.dumps({k: round(v, 1) for k, v in after.items()}),
              flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
