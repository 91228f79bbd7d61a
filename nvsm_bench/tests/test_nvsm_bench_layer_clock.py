"""``tools/layer_clock.py``: the program's spans timed on the host's clock,
epoch by epoch, through the training driver at the tiny CPU size."""

import importlib.util
import os

import pytest

from nvsm_bench import harness, layer_spans

_spec = importlib.util.spec_from_file_location(
    "nvsm_bench_layer_clock", os.path.join(harness.HERE, "tools", "layer_clock.py"))
layer_clock = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(layer_clock)


def clocked_run(ctx):
    with layer_clock.clocked_spans() as epochs:
        rec = ctx.driver().run(ctx)
    return rec, epochs


@pytest.mark.parametrize("trace", [False, True])
def test_each_epoch_is_clocked_by_layer_and_the_spans_are_restored(tiny, trace):
    from cunvsm_torch import spans
    from cunvsm_torch.train import step, trainer

    # A window of no seconds: the warm-up and the window's first epoch,
    # profiled with a trace.
    ctx = tiny("nvsm.train", seconds=0.0, trace=trace)
    rec, epochs = clocked_run(ctx)
    assert rec.correct
    steps = rec.facts["steps_epoch"]
    assert [e["profiled"] for e in epochs] == [False, trace]
    for e in epochs:
        assert e["counts"][layer_spans.STEP_SPAN] == steps
        assert e["counts"][layer_clock.EPOCH_SPAN] == 1
        assert set(e["host_s"]) == set(layer_spans.LAYERS)
        assert all(v >= 0 for v in e["host_s"].values())
        # Self times of nested spans add up to the outermost span's length.
        assert sum(e["host_s"].values()) == pytest.approx(e["wall_s"], rel=1e-6)
    assert trainer.span is spans.span and step.span is spans.span


def test_the_profiled_epoch_agrees_with_the_trace(tiny):
    ctx = tiny("nvsm.train", seconds=0.0, trace=True)
    rec, epochs = clocked_run(ctx)
    traced = epochs[1]
    n = traced["counts"][layer_spans.STEP_SPAN]
    for layer in layer_spans.LAYERS:
        from_trace = layer_spans.host_ms_per_step(rec, layer)
        clocked = 1e3 * traced["host_s"][layer] / n
        # The two clocks differ by the profiler's own entry and exit of
        # each span, a few microseconds.
        assert clocked == pytest.approx(from_trace, rel=0.25, abs=0.05), layer
