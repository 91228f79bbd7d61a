"""Run one cell of the port's benchmark once.

    python3 nvsm_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many NVIDIA cards as the
cell asks for.  The cell's inputs and model come from ``--seed``; set-up
warms every shape the cell uses, then the window measures for ``--seconds``
(to the next whole epoch, in a training cell), and the plain reference
judges what the window produced.  With ``--trace 1`` the run also profiles
a fixed part of the window and reports the per-layer metrics.  The last
line of standard output is the result as one JSON object; the numbers
compared with the reference, each with its limit, are the last lines of
standard error and the result's last key.  Without a card the run exits 2
and prints no result.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Build and kernel caches at fixed paths inside the checkout, so that only
# the first run of a checkout builds (``build/`` is ignored by git).
CACHES = {
    "TRITON_CACHE_DIR": ("build", "triton"),
    "TRITON_HOME": ("build", "triton_home"),
    "CUDA_CACHE_PATH": ("build", "nv_compute_cache"),
    "TORCH_EXTENSIONS_DIR": ("build", "torch_extensions"),
}
THREAD_POOLS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, "cunvsm_torch")):
        print(f"run.py: no cunvsm_torch package beside {ROOT}/nvsm_bench", file=sys.stderr)
        return 2
    for var, parts in CACHES.items():
        os.environ[var] = os.path.join(ROOT, *parts)
    # One thread in each CPU thread pool, set before they load: the cells'
    # host work is the Python thread that drives the card, and idle pools
    # only compete with it for the machine's cores.
    for var in THREAD_POOLS:
        os.environ[var] = "1"
    # Bytecode of every module imported from here on (torch's lazy imports
    # in the first step included) is cached under the checkout too: where
    # the installed packages carry no bytecode, compiling it takes seconds
    # of every run's set-up.
    sys.pycache_prefix = os.path.join(ROOT, "build", "pycache")
    sys.dont_write_bytecode = False
    sys.path.insert(0, ROOT)

    import torch

    from nvsm_bench import harness

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(args.workload, 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"run.py: the cell needs {chips} CUDA device(s); found "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    # The configurations state float32 matmuls with TF32 off, which is
    # PyTorch's default; the harness says so rather than trusting it.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    device_name = torch.cuda.get_device_name(0)
    ctx = harness.Context.load(bench, args.workload, seed=args.seed, seconds=args.seconds,
                               trace=bool(args.trace), device=device, start=START)
    rec = ctx.driver().run(ctx)
    # Read once the window has closed: nvidia-smi takes a second or so.
    harness.log(f"card: {power_limit()}; torch {torch.__version__} cuda {torch.version.cuda}")
    line = harness.result_line(ctx, rec, device_name, chips)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"run.py: the run loaded {found}; the port's benchmark may not")
        return 3
    for msg in harness.check_lines(rec):
        harness.log(msg)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
