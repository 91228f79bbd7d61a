#!/usr/bin/env python3
"""Where the time of the PyTorch port's canonical training step goes.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 profile_torch_step.py --out DIR              # host-fed steps
    python3 profile_torch_step.py --out DIR --on-device  # on-device sampling
    python3 profile_torch_step.py --out DIR --variant sparse_adam  # on-device

It sets up the canonical configuration at full width, host-fed as in
``chip_smoke.py``'s phase B, or with ``--on-device`` through the on-device
sampler and the multistep runner as in its phase D1 (calls of K = 13
steps).  It takes warm-up steps, times STEPS steps without the profiler
(wall ms/step), then takes as many again under ``torch.profiler``.
``--variant`` profiles one of the text-entity configurations of
``chip_smoke.py``'s phase E (another optimizer, the entity L2 normalizer or
batch-shared negatives) on the on-device path instead.  It
prints the device's busy time per step (the union of the intervals of
every kernel and copy on the card), the device's idle share against the
unprofiled wall time, and the device time per step of each kernel name, and
writes the profiler's table into ``DIR/profile_canonical_step.txt`` (or
``DIR/profile_on_device_step.txt``, ``DIR/profile_on_device_step_VARIANT.txt``).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from chip_smoke import (
    CANONICAL,
    E_CONFIGS,
    canonical_corpus,
    canonical_training,
    gpu_name_and_power,
    log,
    on_device_training,
)

STEPS = 5


def busy_us(intervals):
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="directory for the profiler's table")
    ap.add_argument("--on-device", action="store_true",
                    help="profile the on-device sampling multistep instead of host-fed steps")
    ap.add_argument("--variant", choices=[n for n, (kw, _) in E_CONFIGS.items()
                                          if "text_entity_weight" not in kw],
                    help="a phase E configuration in place of the canonical one (on-device)")
    args = ap.parse_args()
    args.on_device = args.on_device or args.variant is not None
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_step.py: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    log(f"nvidia-smi: {gpu_name_and_power()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    if args.on_device:
        # Calls of K steps along one shuffled epoch (9 calls of 13).
        k = CANONICAL["steps_per_call"]
        multistep, *_ = on_device_training(device, CANONICAL, canonical_corpus(CANONICAL),
                                           args.variant)
        done = [0]

        def run(n):
            multistep(n // k, done[0])
            done[0] += n // k
            return None, 0.0

        steps, warmup = 2 * k, k
        table = f"profile_on_device_step{'_' + args.variant if args.variant else ''}.txt"
    else:
        run, *_ = canonical_training(device, CANONICAL)
        steps, warmup, table = STEPS, CANONICAL["warmup"], "profile_canonical_step.txt"
    run(warmup)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, host_s = run(steps)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / steps

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        profiled_wall_ms = 1e3 * (time.perf_counter() - t0) / steps

    device_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not device_events:
        raise AssertionError("the profiler saw no device activity")
    busy_ms = busy_us((e.time_range.start, e.time_range.end) for e in device_events)
    busy_ms /= 1e3 * steps
    by_name = collections.Counter()
    for e in device_events:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3 / steps

    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, table)
    with open(path, "w") as f:
        f.write(prof.key_averages().table(sort_by="cuda_time_total", row_limit=60))
    log(f"device ms/step by kernel name ({steps} profiled steps):")
    for name, ms in by_name.most_common(30):
        log(f"  {ms:8.4f}  {name[:110]}")
    log(json.dumps(dict(
        path="on_device" if args.on_device else "host_fed", variant=args.variant,
        steps=steps, wall_ms_per_step=wall_ms,
        host_batch_ms_per_step=1e3 * host_s / steps,
        profiled_wall_ms_per_step=profiled_wall_ms,
        device_busy_ms_per_step=busy_ms,
        device_idle_share=1.0 - busy_ms / wall_ms,
        table=path,
    )))


if __name__ == "__main__":
    main()
