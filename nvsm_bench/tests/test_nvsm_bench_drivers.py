"""Every traffic driver end to end at a tiny size on the CPU (the chip's
look skipped), sound and with the timed path broken underneath; the
controls at the cells' own sizes on the card."""

import json
import os
import subprocess
import sys

import pytest
import torch

from nvsm_bench import harness

CELLS = ["nvsm.train"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny, cell):
    ctx = tiny(cell)
    rec = ctx.driver().run(ctx)
    assert rec.correct, (rec.checks, rec.faults)
    assert rec.attempted > 0 and rec.failed == 0
    line = harness.result_line(ctx, rec, "cpu", 1)
    e2e = {"setup_s", "train_pairs_per_s"}
    assert set(line["metrics"]) <= e2e and "setup_s" in line["metrics"]
    assert set(rec.end_to_end) >= e2e
    assert all(v["value"] > 0 for v in line["metrics"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_only_per_layer_metrics(tiny, cell):
    # Long enough for an untraced epoch after the profiled one.
    ctx = tiny(cell, seconds=2.0, trace=True)
    rec = ctx.driver().run(ctx)
    assert rec.correct and rec.trace is not None
    line = harness.result_line(ctx, rec, "cpu", 1)
    names = {m["name"] for m in ctx.bench["per_layer"] if cell in m["workloads"]}
    # The CPU has no device trace: only host-clock readers find something.
    assert set(line["metrics"]) <= names and line["metrics"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["device"]["window_s"] > 0


def test_the_window_runs_whole_epochs(tiny):
    ctx = tiny("nvsm.train", seconds=0.0)
    rec = ctx.driver().run(ctx)
    assert rec.facts["epochs"] == 1 and rec.attempted == rec.facts["steps_epoch"] == 24
    # Both epochs are judged: the warm-up and the window's first.
    assert {n for n, _, _ in rec.checks} == {f"{n}_e{e}" for e in (1, 2) for n in
                                             ("loss_gap", "change_gap", "diff_gap")}


def _frozen_apply(self, params, opt_state, grads, lr, lam):
    return params, opt_state


def _frozen_after(steps, real):
    """Optimizer.apply that returns the state unchanged after ``steps``
    updates: a fault that starts once the warm-up is over."""
    count = [0]

    def apply(self, params, opt_state, grads, lr, lam):
        count[0] += 1
        if count[0] > steps:
            return params, opt_state
        return real(self, params, opt_state, grads, lr, lam)

    return apply


def _half_batch(real):
    def cost_and_grads(kind, params, batch, *args, **kw):
        w = batch.weights.clone()
        half = w.shape[0] // 2
        w[half:] = 0.0
        w[:half] *= 2.0
        return real(kind, params, batch._replace(weights=w), *args, **kw)

    return cost_and_grads


@pytest.mark.parametrize("fault", ["state_unchanged", "state_unchanged_after_warmup",
                                   "state_unchanged_late", "half_batch"])
def test_broken_training_is_not_correct(tiny, monkeypatch, fault):
    from cunvsm_torch.optim import updates
    from cunvsm_torch.train import step

    # 24 steps an epoch at the tiny size; "late" freezes from epoch 4 on,
    # past the two epochs that the reference follows.
    if fault == "state_unchanged":
        monkeypatch.setattr(updates.Optimizer, "apply", _frozen_apply)
    elif fault == "state_unchanged_after_warmup":
        monkeypatch.setattr(updates.Optimizer, "apply",
                            _frozen_after(24, updates.Optimizer.apply))
    elif fault == "state_unchanged_late":
        monkeypatch.setattr(updates.Optimizer, "apply",
                            _frozen_after(3 * 24, updates.Optimizer.apply))
    else:
        monkeypatch.setattr(step, "compute_cost_and_grads",
                            _half_batch(step.compute_cost_and_grads))
    ctx = tiny("nvsm.train", seconds=2.0 if fault == "state_unchanged_late" else 0.5)
    rec = ctx.driver().run(ctx)
    if fault == "state_unchanged_late":
        assert rec.facts["epochs"] >= 4
        assert rec.faults and all("did not move" in f for f in rec.faults)
    assert not rec.correct
    assert not harness.result_line(ctx, rec, "cpu", 1)["correct"]


def _calibrate():
    import importlib.util

    path = os.path.join(harness.HERE, "tools", "calibrate.py")
    spec = importlib.util.spec_from_file_location("nvsm_bench_calibrate", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_training_control_is_not_correct(tiny):
    """The control in the program's place at a tiny size: float8 streams for
    the bfloat16-stream configuration fail a limit of the cell, and so does
    half the batch."""
    ctx = tiny("nvsm.train", seconds=0.0)
    lines = {line["kind"]: line for line in _calibrate().train_lines(ctx, controls=True)}
    limits = ctx.checks["limits"]
    program = lines.pop("program")
    assert all(program[n] <= limits[n] for n in limits) and program["faults"] == 0
    assert any(lines["fp8_streams"][n] > limits[n] for n in limits), lines["fp8_streams"]
    assert any(lines["half_batch"][n] > limits[n] for n in limits)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(cuda, bench, cell):
    """On the card, at the cell's own size, three seeds: every sound
    reading within the cell's limits, every control reading (and every
    planted fault of a training cell) beyond one of them."""
    out = subprocess.run(
        [sys.executable, os.path.join(harness.HERE, "tools", "calibrate.py"), "--workload",
         cell, "--seeds", "2147483201-2147483203", "--controls", "3"],
        capture_output=True, text=True, timeout=1800)
    assert out.returncode == 0, out.stderr[-3000:]
    limits = harness.load_json("workloads", f"{cell}.json")["limits"]
    lines = [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]
    assert len([x for x in lines if x["kind"] == "program"]) == 3
    for line in lines:
        beyond = any(line[n] > limits[n] for n in limits)
        if line["kind"] == "program":
            assert not beyond, line
        elif line["kind"] != "tf32":
            assert beyond, line
