"""The Mix 'n Match composite at the published widths on the card: the
benchmark cell ``mixnmatch.train``'s configuration (65,536 products of 100
tokens, 102,863 substitute pairs, batch 51,200, word 300 -> entity 256,
float32 streams, full_adam), trained by ``train_model`` with both streams
sampled on the card for two epochs of 116 steps (nine K = 13 calls and a
remainder call of 12 each), through the benchmark's own driver.

The program's cost and tables after each epoch, and after its first call
trained again, are held to the plain reference
(``nvsm_bench/reference/train_mix.py``) within the cell's limits
(``nvsm_bench/workloads/mixnmatch.train.json``), every step but each call
closure's first replays the CUDA graph, and the kernels launch as the
configuration says: the sweep twice a step, the bfloat16 cast never.
"""

import json
import logging
import os
import time

import pytest
import torch

from cunvsm_torch.ops.adam_sweep import fused_adam_dense_sweep
from cunvsm_torch.ops.cast import cast_table
from cunvsm_torch.train import trainer as ttrainer
from nvsm_bench import harness
from nvsm_bench.drivers import train_epochs as base
from nvsm_bench.drivers import train_mix_epochs as drv

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_epochs_at_the_published_widths_follow_the_reference(cuda, caplog):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    ctx = harness.Context.load(bench, "mixnmatch.train", seed=2**31 + 16, seconds=0.0,
                               trace=False, device=cuda, start=time.perf_counter())
    sweeps, casts = fused_adam_dense_sweep.launches, cast_table.launches
    with caplog.at_level(logging.INFO, logger=ttrainer.__name__):
        got = drv.train_window(ctx)
    steps = 2 * got["steps_epoch"]
    assert got["steps_epoch"] == 116
    assert fused_adam_dense_sweep.launches - sweeps == 2 * steps
    assert cast_table.launches == casts
    lines = [r for r in caplog.records if r.msg.startswith("Epoch %d%s: cost")]
    # Epoch 1: the 13-step closure's first step and the 12-step one's run
    # eagerly; epoch 2 replays every step.
    assert [r.args[5] for r in lines] == [114, 116]
    # 102,863 pairs hold two batches a pass: 58 passes an epoch.
    assert [r.args[6] for r in lines] == [f"; {116 * 51200} similarity pairs, 58 passes begun"] * 2
    values, _ = drv.readings(got["costs"], got["after"], drv.first_call(ctx, got),
                             drv.follow(ctx, got), drv.follow(ctx, got, first=True))
    limits = ctx.checks["limits"]
    assert all(values[n] <= limits[n] for n in limits), values
    assert not base.window_faults(got["costs"], got["norms"])
