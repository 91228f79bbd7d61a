"""The Mix 'n Match cell ``mixnmatch.train``: found by its files, its work
counted by hand, its pairs made from the seed, and its driver end to end at
a tiny size on the CPU, sound and with the program broken as its checks
must catch (the similarity objective dropped, the pair stream frozen); the
controls at the cell's own size on the card."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nvsm_bench import harness, yardstick
from nvsm_bench.drivers import train_mix_epochs as drv

CELL = "mixnmatch.train"
BIG = 2**31 + 4321
# Two pair batches of the tiny batch (512) a pass, 76 pairs dropped.
TINY_PAIRS = 1100


@pytest.fixture
def tiny_mix(tiny):
    def make(**kw):
        ctx = tiny(CELL, **kw)
        ctx.config["similarity"]["num_pairs"] = TINY_PAIRS
        return ctx

    return make


def test_the_cell_is_found_by_its_files(bench):
    ctx = harness.Context.load(bench, CELL, seed=1, seconds=0.0, trace=False,
                               device=torch.device("cpu"), start=0.0)
    assert ctx.cell["config"] == "mixnmatch" and ctx.cell["chips"] == 1
    assert ctx.config["reduced"] == ["doc_len"]
    assert ctx.config["work"] == "text_entity_entity_entity"
    assert (ctx.mix["driver"], ctx.mix["steps_per_call"]) == ("train_mix_epochs", 13)
    assert ctx.driver().run is not None
    assert set(ctx.checks["limits"]) == {f"{n}_e{e}" for e in (1, 2) for n in (
        "loss_gap", "change_gap", "diff_gap")} | {"diff_gap_c1"}
    names = {m["name"] for m in bench["per_layer"] if CELL in m["workloads"]}
    assert names == {"device_idle_share.mix", "mfu.mix", "adam_sweep_roofline.mix",
                     "idle_ms_per_step.similarity", "host_ms_per_step.similarity"}
    e2e = {m["name"] for m in bench["end_to_end"] if CELL in m.get("workloads", [CELL])}
    assert e2e == {"train_pairs_per_s", "setup_s"}
    for name in names:
        assert hasattr(harness.metric_reader(name), "read")


def test_the_work_matches_a_hand_count():
    cfg = harness.load_json("configs", "mixnmatch.json")
    work = harness.load_module("work", "text_entity_entity_entity.py")
    b, d_w, d_e, k = 51200, 300, 256, 10
    text = 3 * (2 * b * d_w * d_e + 2 * b * (k + 1) * d_e)
    assert work.train_step_flops(cfg) == text + 6 * b * d_e == 24_536_678_400
    assert work.sweep_elements(cfg) == 65536 * 300 + 65536 * 256 == 36_438_016
    seconds, by = yardstick.bound(*work.sweep(cfg))
    assert by == "bytes" and seconds == pytest.approx(28 * 36_438_016 / 3.35e12)
    assert work.cast(cfg) is None


def test_the_pairs_come_from_the_seed():
    cfg = harness.load_json("configs", "mixnmatch.json")
    cfg["collection"]["num_docs"] = 512
    cfg["similarity"]["num_pairs"] = 20_000
    cpu = torch.device("cpu")
    ids, weights = drv.substitute_pairs(cfg, BIG, cpu)
    again, _ = drv.substitute_pairs(cfg, BIG, cpu)
    other, _ = drv.substitute_pairs(cfg, BIG + 1, cpu)
    assert ids.dtype == np.int32 and ids.shape == (20_000, 2) and weights.dtype == np.float32
    assert np.array_equal(ids, again) and not np.array_equal(ids, other)
    assert (weights == 1.0).all() and (ids[:, 0] != ids[:, 1]).all()
    assert ids.min() >= 0 and ids.max() < 512
    degree = np.bincount(ids.reshape(-1), minlength=512)
    assert degree[0] > degree[10] > degree[300]  # rank 0 is the most popular


def test_a_sound_run_is_correct(tiny_mix):
    ctx = tiny_mix()
    rec = ctx.driver().run(ctx)
    assert rec.correct, (rec.checks, rec.faults)
    assert rec.attempted == rec.facts["steps_epoch"] * rec.facts["epochs"] > 0
    line = harness.result_line(ctx, rec, "cpu", 1)
    assert set(line["metrics"]) == {"setup_s", "train_pairs_per_s"}
    assert all(v["value"] > 0 for v in line["metrics"].values())


def test_a_traced_run_reports_only_the_cells_per_layer_metrics(tiny_mix):
    ctx = tiny_mix(seconds=2.0, trace=True)
    rec = ctx.driver().run(ctx)
    assert rec.correct and rec.trace is not None
    line = harness.result_line(ctx, rec, "cpu", 1)
    names = {m["name"] for m in ctx.bench["per_layer"] if CELL in m["workloads"]}
    # The CPU has no device trace: the spans' host time is read from the
    # profiled epoch, and `mfu.mix` where an untraced epoch followed it (a
    # loaded machine may close the window first).
    assert set(line["metrics"]) <= names
    assert "host_ms_per_step.similarity" in line["metrics"]
    assert ("mfu.mix" in line["metrics"]) == (rec.facts["epochs"] >= 2)


def _no_similarity(real):
    def table_and_weight(kind, cfg):
        table, _ = real(kind, cfg)
        return table, 0.0

    return table_and_weight


def _frozen(real):
    def next_batch(self):
        self.seek(0)
        return real(self)

    return next_batch


@pytest.mark.parametrize("fault", ["no_similarity", "frozen_pairs"])
def test_broken_training_is_not_correct(tiny_mix, monkeypatch, fault):
    from cunvsm_torch.data import device_sampler
    from cunvsm_torch.train import step

    if fault == "no_similarity":
        # The merge gives the similarity gradient no weight; the reported
        # cost still holds its cost.
        monkeypatch.setattr(step, "_similarity_table_and_weight",
                            _no_similarity(step._similarity_table_and_weight))
    else:
        monkeypatch.setattr(device_sampler.DevicePairStream, "next_batch",
                            _frozen(device_sampler.DevicePairStream.next_batch))
    ctx = tiny_mix(seconds=0.0)
    rec = ctx.driver().run(ctx)
    assert not rec.correct, rec.checks
    assert not harness.result_line(ctx, rec, "cpu", 1)["correct"]


@pytest.mark.cuda
def test_controls_fail_at_the_cells_size(cuda):
    """On the card, at the cell's own size, three seeds: every sound reading
    within the cell's limits; the controls (no similarity objective,
    bfloat16 streams) and the frozen pair stream beyond one of them."""
    out = subprocess.run(
        [sys.executable, os.path.join(harness.HERE, "tools", "calibrate_mix.py"), "--seeds",
         "2147483401-2147483403", "--controls", "3"],
        capture_output=True, text=True, timeout=1800)
    assert out.returncode == 0, out.stderr[-3000:]
    limits = harness.load_json("workloads", f"{CELL}.json")["limits"]
    lines = [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]
    assert len([x for x in lines if x["kind"] == "program"]) == 3
    for line in lines:
        beyond = any(line[n] > limits[n] for n in limits)
        if line["kind"] in ("program", "tf32"):
            assert not beyond, line
        else:
            assert beyond, line
