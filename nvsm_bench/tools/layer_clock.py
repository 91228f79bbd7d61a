"""Each layer's host self time on the host's clock, epoch by epoch, with
and without the profiler.

    python3 nvsm_bench/tools/layer_clock.py --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1> [--out FILE.json]

runs the cell once as ``nvsm_bench/run.py`` does, with every program span
(``cunvsm_torch/spans.py``) timed by ``time.perf_counter`` besides: a
span's self time is its length less its ``cunvsm.`` children's, summed by
layer over each ``cunvsm.trainer.epoch``.  With ``--trace 1`` the second
epoch runs under the benchmark's profiler and the later ones do not, so
one process gives the layers' host time a step in both states, and the
profiled epoch's ``host_ms_per_step.<layer>`` (read from the trace) beside
the same epoch on this clock.  The clock costs each span about 2.5 us
more of the host's time, inside its parent's self time.  The last line of standard output is one JSON object:
the result line of the run, under ``"run"``, and one record an epoch,
under ``"epochs"``.  The tool runs on a card, as the benchmark does; it is
not part of a run.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import io
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
EPOCH_SPAN = "cunvsm.trainer.epoch"


@contextlib.contextmanager
def clocked_spans():
    """Within the block every program span is timed as well as recorded;
    yields the list that gets one record an epoch: ``profiled`` (whether a
    profiler ran as the epoch began), ``wall_s``, ``host_s`` by layer and
    ``counts`` by span name."""
    import torch

    from cunvsm_torch import spans

    plain = spans.span
    epochs = []
    host = collections.Counter()
    counts = collections.Counter()
    stack = []
    clock = time.perf_counter

    class Clocked:
        __slots__ = ("name", "inner", "t0", "child", "profiled")

        def __init__(self, name):
            self.name = name
            self.inner = plain(name)

        def __enter__(self):
            self.profiled = bool(torch.autograd.profiler._is_profiler_enabled)
            self.inner.__enter__()
            self.child = 0.0
            stack.append(self)
            self.t0 = clock()
            return self

        def __exit__(self, *exc):
            took = clock() - self.t0
            stack.pop()
            host[self.name.split(".")[1]] += took - self.child
            counts[self.name] += 1
            if stack:
                stack[-1].child += took
            out = self.inner.__exit__(*exc)
            if self.name == EPOCH_SPAN:
                epochs.append(dict(profiled=self.profiled, wall_s=took, host_s=dict(host),
                                   counts=dict(counts)))
                host.clear()
                counts.clear()
            return out

    patched = [m for name, m in list(sys.modules.items())
               if name.startswith("cunvsm_torch.") and getattr(m, "span", None) is plain]
    for m in patched:
        m.span = Clocked
    try:
        yield epochs
    finally:
        for m in patched:
            m.span = plain


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from nvsm_bench import run

    # The run's settings of the thread pools and caches, before torch and
    # the program's modules load (``run.main`` sets them again).
    for var, parts in run.CACHES.items():
        os.environ[var] = os.path.join(ROOT, *parts)
    for var in run.THREAD_POOLS:
        os.environ[var] = "1"
    import cunvsm_torch.train.trainer  # noqa: F401  (every module with spans)

    out = io.StringIO()
    with clocked_spans() as epochs, contextlib.redirect_stdout(out):
        rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                       "--seconds", str(args.seconds), "--trace", str(args.trace)])
    lines = out.getvalue().strip().splitlines()
    result = dict(run=json.loads(lines[-1]) if rc == 0 and lines else None, epochs=epochs)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f)
    print(json.dumps(result), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
