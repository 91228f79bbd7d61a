"""Repeat chip_smoke.py's phases F1 and F2 in one process and account for
the device memory between them.

    python3 scripts/repeat_phase_f.py [--repeats 4] [--out build/repeat_phase_f.log]

Each pass runs cunvsm-torch-train at full width (phase F1) and
cunvsm-torch-query on its model (phase F2) as chip_smoke.py does, in a
directory of its own under build/.  Before and after each phase it records
``torch.cuda.memory_allocated``, after F1 the peak since the reset at F1's
start, and after each pass every CUDA tensor the garbage collector can
still reach (shape, dtype, MiB), before and after ``gc.collect()``: a
snapshot or an engine that outlives its phase shows up there.  Needs a
CUDA device; exits with another code than 0 if a phase fails.
"""

import argparse
import gc
import json
import os
import shutil
import sys
import tempfile
import traceback

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch

import chip_smoke


def live_cuda_tensors():
    """[(shape, dtype, MiB)] of the CUDA tensors reachable by the collector,
    one entry per storage."""
    seen, out = set(), []
    for obj in gc.get_objects():
        try:
            if isinstance(obj, torch.Tensor) and obj.is_cuda:
                key = obj.untyped_storage().data_ptr()
                if key not in seen:
                    seen.add(key)
                    out.append((tuple(obj.shape), str(obj.dtype),
                                round(obj.untyped_storage().nbytes() / 2**20, 1)))
        except Exception:  # an object that cannot be inspected is no tensor
            continue
    return sorted(out, key=lambda x: -x[2])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--repeats", type=int, default=4)
    p.add_argument("--out", default=os.path.join(chip_smoke.BUILD, "repeat_phase_f.log"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("repeat_phase_f.py: no CUDA device")
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    out = open(args.out, "w")

    def record(**kw):
        line = json.dumps(kw)
        print(line, flush=True)
        out.write(line + "\n")
        out.flush()

    def mib():
        torch.cuda.synchronize()
        return round(torch.cuda.memory_allocated() / 2**20, 1)

    record(device=torch.cuda.get_device_name(0), nvidia_smi=chip_smoke.gpu_name_and_power())
    sizes = chip_smoke.CANONICAL
    corpus = chip_smoke.canonical_corpus(sizes)
    os.makedirs(chip_smoke.BUILD, exist_ok=True)
    failed = 0
    for i in range(args.repeats):
        tmp = tempfile.mkdtemp(prefix="repeat_f_", dir=chip_smoke.BUILD)
        try:
            before = mib()
            prefix, _ = chip_smoke.phase_f1(device, sizes, corpus, i, tmp)
            record(repeat=i, phase="F1", allocated_before_mib=before, allocated_after_mib=mib(),
                   peak_mib=round(torch.cuda.max_memory_allocated() / 2**20, 1))
            before = mib()
            chip_smoke.phase_f2(device, corpus, prefix, 2, i, tmp)
            record(repeat=i, phase="F2", allocated_before_mib=before, allocated_after_mib=mib())
        except BaseException:
            failed += 1
            record(repeat=i, failed=traceback.format_exc())
        finally:
            shutil.rmtree(tmp)
        record(repeat=i, live_before_collect=live_cuda_tensors()[:12], allocated_mib=mib())
        record(repeat=i, collected=gc.collect(), live_after_collect=live_cuda_tensors()[:12],
               allocated_mib=mib())
    out.close()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
