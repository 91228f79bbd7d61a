"""The port's host spans (``cunvsm_torch/spans.py``).

* With no profiler running, ``span`` hands back one shared no-op context
  and calls nothing of torch;
* under a profiler a span is a host event of plain function scope, never a
  user annotation (which a CUDA trace would mirror as device work);
* a two-epoch ``train_model`` under a CPU profiler records the documented
  spans on every path (on-device, host-fed, and each under a 1x1 mesh):
  one sampler batch, one step, one loss, one backward and one optimizer
  update per step, each nested in its documented parent;
* the profiler changes no cost and no table.
"""

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cunvsm_torch import spans
from cunvsm_torch.parallel import mesh as pmesh
from cunvsm_torch.spans import span
from cunvsm_torch.train.trainer import train_model
from tests.test_torch_trainer import CPU, DESC, assert_same_state, cfg, small_corpus

EPOCHS, K = 2, 2
ON_DEVICE = dict(on_device_sampling=True, steps_per_call=K)
PATHS = {
    "on_device": ON_DEVICE,
    "host_fed": {},
    "mesh_on_device": dict(ON_DEVICE, mesh=pmesh.Mesh(1, 1)),
    "mesh_sharded_corpus": dict(ON_DEVICE, mesh=pmesh.Mesh(1, 1), shard_corpus=True),
    "mesh_host_fed": dict(mesh=pmesh.Mesh(1, 1)),
}
# Each span and the program span it sits in (None: outermost).
PARENT = {
    "cunvsm.trainer.epoch": None,
    "cunvsm.trainer.permute": "cunvsm.trainer.epoch",
    "cunvsm.trainer.wait_batch": "cunvsm.trainer.epoch",
    "cunvsm.trainer.call": "cunvsm.trainer.epoch",
    "cunvsm.trainer.cost_read": "cunvsm.trainer.epoch",
    "cunvsm.sampler.batch": "cunvsm.trainer.call",
    "cunvsm.step.cost_and_grads": "cunvsm.trainer.call",
    "cunvsm.step.cast": "cunvsm.step.cost_and_grads",
    "cunvsm.step.loss": "cunvsm.step.cost_and_grads",
    "cunvsm.step.backward": "cunvsm.step.cost_and_grads",
    "cunvsm.optimizer.apply": "cunvsm.trainer.call",
    "cunvsm.optimizer.accumulate": "cunvsm.optimizer.apply",
    "cunvsm.optimizer.sweep": "cunvsm.optimizer.apply",
    "cunvsm.optimizer.transform": "cunvsm.optimizer.apply",
}


def bf16_cfg():
    # bfloat16 streams, so that every step casts the word table.
    return cfg(EPOCHS, stream_dtype="bfloat16")


def traced(path):
    """(TrainResult, the program's events) of a profiled two-epoch run."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        result = train_model(DESC, bf16_cfg(), small_corpus(), CPU, **PATHS[path])
    return result, [e for e in prof.events() if e.name.startswith("cunvsm.")]


def program_parent(event):
    p = event.cpu_parent
    while p is not None and not p.name.startswith("cunvsm."):
        p = p.cpu_parent
    return None if p is None else p.name


def test_span_without_a_profiler_is_one_shared_no_op(monkeypatch):
    def no_torch(name):
        raise AssertionError(f"span {name!r} called torch with no profiler running")

    monkeypatch.setattr(spans, "_RecordFunctionFast", no_torch)
    assert not torch.autograd.profiler._is_profiler_enabled
    first = span("cunvsm.trainer.epoch")
    assert span("cunvsm.step.cast") is first
    with first:
        with span("cunvsm.step.loss"):
            pass


def test_span_under_a_profiler_is_a_function_scope_host_event():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        outer = span("cunvsm.trainer.call")
        assert outer is not span("cunvsm.trainer.call")
        with outer:
            with span("cunvsm.step.loss"):
                torch.ones(3).sum()
    assert not torch.autograd.profiler._is_profiler_enabled
    events = {e.name: e for e in prof.events() if e.name.startswith("cunvsm.")}
    assert set(events) == {"cunvsm.trainer.call", "cunvsm.step.loss"}
    for e in events.values():
        assert e.device_type == torch.autograd.DeviceType.CPU
        assert not e.is_user_annotation
    assert program_parent(events["cunvsm.step.loss"]) == "cunvsm.trainer.call"
    assert any(e.name == "aten::sum" and program_parent(e) == "cunvsm.step.loss"
               for e in prof.events())


@pytest.mark.parametrize("path", sorted(PATHS))
def test_train_model_records_each_layer_once_a_step(path):
    result, events = traced(path)
    steps = result.steps
    assert steps > 0
    counts = collections.Counter(e.name for e in events)
    per_step = ["cunvsm.step.cost_and_grads", "cunvsm.step.cast", "cunvsm.step.loss",
                "cunvsm.step.backward", "cunvsm.optimizer.apply",
                "cunvsm.optimizer.transform"]
    expected = {name: steps for name in per_step}
    # Both tables are updated by full_adam's accumulation and sweep.
    expected["cunvsm.optimizer.accumulate"] = expected["cunvsm.optimizer.sweep"] = 2 * steps
    for name in ("cunvsm.trainer.epoch", "cunvsm.trainer.cost_read"):
        expected[name] = EPOCHS
    if PATHS[path].get("on_device_sampling"):
        expected["cunvsm.sampler.batch"] = steps
        expected["cunvsm.trainer.permute"] = EPOCHS
        # Calls of K steps, and a remainder call where K does not divide
        # the epoch.
        expected["cunvsm.trainer.call"] = EPOCHS * -(-steps // EPOCHS // K)
    else:
        expected["cunvsm.trainer.call"] = steps
        # One wait a batch, and the one that finds the epoch's end.
        expected["cunvsm.trainer.wait_batch"] = steps + EPOCHS
    assert dict(counts) == expected
    for e in events:
        assert program_parent(e) == PARENT[e.name], e.name


@pytest.mark.parametrize("path", ["on_device", "host_fed"])
def test_no_program_span_is_a_user_annotation(path):
    _, events = traced(path)
    assert events
    assert not [e.name for e in events if e.is_user_annotation]
    assert {e.device_type for e in events} == {torch.autograd.DeviceType.CPU}


@pytest.mark.parametrize("path", ["on_device", "host_fed"])
def test_the_profiler_changes_no_cost_and_no_table(path):
    plain = train_model(DESC, bf16_cfg(), small_corpus(), CPU, **PATHS[path])
    profiled, _ = traced(path)
    assert profiled.epoch_costs == plain.epoch_costs
    assert_same_state(plain, profiled)
