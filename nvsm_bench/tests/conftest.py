"""The benchmark's own tests: ``python3 -m pytest nvsm_bench/tests -q``.

On the CPU they hold the work counts to the issue's numbers, the inputs to
their seeds, the result line to its contract, the imports to the rules, and
drive every traffic driver at a tiny size, with the program broken in the
ways a check must catch.  Tests marked ``cuda`` need the card (they run the
controls at the cells' own sizes) and skip here.
"""

import json
import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from nvsm_bench import harness  # noqa: E402

# Widths, collection and batch of the tiny CPU cells: the pooled negatives
# (P 512 of 4096 documents) and a K that leaves a remainder call (24 steps
# an epoch in calls of 13) are kept.
TINY = {
    "model": dict(word_repr_size=16, entity_repr_size=8),
    "collection": dict(vocab_size=512, num_docs=4096, doc_len=12),
    "train": dict(batch_size=512),
}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU with CUDA; skips without one")


@pytest.fixture
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.fixture
def tiny(bench):
    """tiny(cell, seed=..., seconds=..., trace=...) -> a CPU Context."""

    def make(cell, seed=5, seconds=0.5, trace=False, bench_=None):
        ctx = harness.Context.load(bench_ or bench, cell, seed=seed, seconds=seconds,
                                   trace=trace, device=torch.device("cpu"),
                                   start=time.perf_counter())
        for part, sizes in TINY.items():
            ctx.config[part].update(sizes)
        return ctx

    return make


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
