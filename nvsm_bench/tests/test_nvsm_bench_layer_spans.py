"""The per-layer span metrics (``layer_spans.py`` and its eight readers) on
a hand-built trace of two steps.

Times in ms.  Host: the epoch 0-97 holds one call 10-90, which holds two
steps of sampler batch, step and optimizer update; the first step casts
22-25; a torch operation 30-32 is no program span.  Device: operations at
1-2, 12-13, 23-24, 45-46, 60-95, 98-99, so the card idles 2-12, 13-23,
24-45, 46-60 and 95-98, 58 ms in all.  By the innermost span open at each
instant: trainer 2-10, 95-97 (10); sampler 10-12, 13-20, 50-55 (14); step
20-23, 24-40, 55-60 (24); optimizer 40-45, 46-50 (9); outside 97-98 (1).
"""

import pytest

from nvsm_bench import harness, layer_spans
from nvsm_bench.yardstick import TraceSummary

MS = 1e-3
SPANS = [
    (0, 97, "cunvsm.trainer.epoch"),
    (10, 90, "cunvsm.trainer.call"),
    (10, 20, "cunvsm.sampler.batch"),
    (20, 40, "cunvsm.step.cost_and_grads"),
    (22, 25, "cunvsm.step.cast"),
    (40, 50, "cunvsm.optimizer.apply"),
    (50, 55, "cunvsm.sampler.batch"),
    (55, 70, "cunvsm.step.cost_and_grads"),
    (70, 85, "cunvsm.optimizer.apply"),
]
TORCH_OPS = [(30, 32, "aten::add")]
DEVICE = [(1, 2), (12, 13), (23, 24), (45, 46), (60, 95), (98, 99)]
IDLE = {"trainer": 10, "sampler": 14, "step": 24, "optimizer": 9, "outside": 1}
# Self time: epoch 0-10 and 90-97, call 85-90; the step spans less the cast.
HOST = {"trainer": 22, "sampler": 15, "step": 35, "optimizer": 25}
STEPS = 2


def record(spans=SPANS, device=DEVICE, units=STEPS):
    host = [(s * MS, e * MS, n) for s, e, n in spans + TORCH_OPS]
    dev = [(s * MS, e * MS, "kernel") for s, e in device]
    trace = TraceSummary(dev, host, wall_s=0.1, units=units)
    return harness.Record(end_to_end={}, attempted=units, failed=0, memory_peak_bytes=0,
                          checks=[], faults=[], trace=trace)


def test_idle_by_layer_and_outside_add_up_to_the_traced_idle():
    idle, _ = layer_spans.split(record().trace)
    assert idle == pytest.approx({k: v * MS for k, v in IDLE.items()})
    traced = sum(b - a for a, b in layer_spans.idle_gaps(record().trace.device))
    assert sum(idle.values()) == pytest.approx(traced) == pytest.approx(58 * MS)


def test_an_idle_instant_goes_to_the_innermost_span():
    # One gap, inside the cast inside the step inside the call.
    rec = record(device=[(21, 22), (24, 26)])
    idle, _ = layer_spans.split(rec.trace)
    assert dict(idle) == pytest.approx({"step": 2 * MS, "outside": 0.0})
    pieces = layer_spans.innermost_pieces([h for h in rec.trace.host
                                           if h[2].startswith("cunvsm.")])
    assert [n for s, e, n in pieces if s <= 23 * MS < e] == ["cunvsm.step.cast"]


def test_host_self_time_leaves_out_child_spans():
    _, host = layer_spans.split(record().trace)
    assert host == pytest.approx({k: v * MS for k, v in HOST.items()})
    assert sum(host.values()) == pytest.approx(97 * MS)


def test_a_child_that_outlives_its_parent_is_cut_at_its_end():
    pieces = layer_spans.innermost_pieces([(0, 10, "cunvsm.trainer.call"),
                                           (5, 12, "cunvsm.step.loss")])
    assert pieces == [(0, 5, "cunvsm.trainer.call"), (5, 10, "cunvsm.step.loss")]


@pytest.mark.parametrize("layer", layer_spans.LAYERS)
def test_readers_report_per_step_ms(layer):
    rec = record()
    idle = harness.metric_reader(f"idle_ms_per_step.{layer}").read(None, rec)
    host = harness.metric_reader(f"host_ms_per_step.{layer}").read(None, rec)
    assert idle == pytest.approx(IDLE[layer] / STEPS)
    assert host == pytest.approx(HOST[layer] / STEPS)


@pytest.mark.parametrize("case", ["other_count", "no_program_span"])
def test_spans_that_cannot_be_read_give_none(case, capsys):
    if case == "other_count":
        rec, why = record(units=STEPS + 1), "2 cunvsm.step.cost_and_grads spans against 3"
    else:
        rec, why = record(spans=[]), "no cunvsm. span"
    assert layer_spans.idle_ms_per_step(rec, "step") is None
    assert layer_spans.host_ms_per_step(rec, "step") is None
    assert why in capsys.readouterr().err


def test_without_device_operations_only_host_time_is_read():
    rec = record(device=[])
    assert layer_spans.idle_ms_per_step(rec, "step") is None
    assert layer_spans.host_ms_per_step(rec, "step") == pytest.approx(HOST["step"] / STEPS)
