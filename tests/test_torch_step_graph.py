"""When a training step replays a CUDA graph (``train/step.py:StepGraph``).

The graph itself runs only on a card (``tests_card/test_card_graph.py``
holds graphed training bitwise to eager training there).  Here:

* ``graph_signature`` sends a CPU device, a mesh (a composite's too) and
  the bare similarity objectives to the eager path, and tells apart
  batches of other shapes (a composite's pair batch too), absent and
  present injected ids, and other parameter tables;
* on the CPU every path trains eagerly and captures nothing;
* with the capture replaced by a stand-in that has a CUDA graph's
  semantics (a capture runs nothing; static inputs, refreshed at each
  replay; static outputs, overwritten at each replay) and the device taken
  for CUDA: the first call of a signature runs eagerly, the second
  captures, every later one replays, a call of another batch shape runs
  eagerly; training equals eager training bit for bit on the on-device
  path (with a remainder call) and the host-fed path, the epoch log counts
  the replayed steps, and a K-step call stacks one distinct cost per step;
  both composites, on-device and host-fed, capture their (text, pair)
  batches and replay as their eager training; a mesh and a composite under
  a mesh still capture nothing; the capture and each replay are spans
  inside the step's span.
"""

import collections
import contextlib
import logging

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._pytree import tree_leaves

from cunvsm_torch.data import device_sampler as tds
from cunvsm_torch.models.objectives import SimilarityBatch, TextEntityBatch
from cunvsm_torch.models.params import init_params
from cunvsm_torch.optim.updates import Optimizer
from cunvsm_torch.parallel import mesh as pmesh
from cunvsm_torch.train import step as tstep
from cunvsm_torch.train.trainer import train_model
from tests.test_torch_spans import program_parent
from tests.test_torch_trainer import (
    COMPOSITE_WEIGHTS, CPU, DESC, assert_same_state, cfg, similarity_source, small_corpus,
)

CUDA = torch.device("cuda")
EPOCHS, K = 2, 2
CONFIGS = {
    "pooled_bf16": dict(negative_pool_size=4, stream_dtype="bfloat16"),
    "per_instance_f32": dict(negative_pool_size=0),
}
PATHS = {
    "on_device": dict(on_device_sampling=True, steps_per_call=K),
    "host_fed": {},
}


def tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class FakeCapture:
    """``_CapturedStep`` with a CUDA graph's semantics on the CPU: the
    capture draws nothing (the generator's state is put back), the inputs
    are static copies that each replay refreshes, and the outputs are
    static tensors that each replay overwrites in place."""

    captures = 0

    def __init__(self, cost_and_grads, generator, batch, negative_ids, uniform_feature_weights):
        type(self).captures += 1
        self.cost_and_grads = cost_and_grads
        parts = tuple(type(b)(*(None if t is None else t.clone() for t in b))
                      for b in tstep.batch_parts(batch))
        self.inputs = (parts if type(batch) is tuple else parts[0],
                       None if negative_ids is None else negative_ids.clone())
        state = generator.get_state()
        self.outputs = cost_and_grads(*self.inputs)
        generator.set_state(state)

    def replay(self, batch, negative_ids):
        for static, t in zip(tensors(self.inputs), tensors((batch, negative_ids))):
            static.copy_(t)
        for static, t in zip(tensors(self.outputs), tensors(self.cost_and_grads(*self.inputs))):
            static.copy_(t)
        return self.outputs


class NoCapture:
    def __init__(self, *args):
        raise AssertionError("a step that must run eagerly captured a graph")


@pytest.fixture
def fake_graph(monkeypatch):
    """The device taken for CUDA by the engage rule, and the stand-in
    capture; yields the stand-in's class."""
    real = tstep.graph_signature
    monkeypatch.setattr(tstep, "graph_signature",
                        lambda kind, mesh, device, *rest: real(kind, mesh, CUDA, *rest))
    monkeypatch.setattr(FakeCapture, "captures", 0)
    monkeypatch.setattr(tstep, "_CapturedStep", FakeCapture)
    return FakeCapture


def batch(rows=8, window=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    return TextEntityBatch(torch.randint(0, 27, (rows, window), generator=g),
                           torch.ones(rows, window), torch.randint(0, 9, (rows,), generator=g),
                           torch.ones(rows))


def params():
    return init_params(torch.Generator().manual_seed(1), 27, 9, DESC, device=CPU)


def pairs(rows=8):
    return SimilarityBatch(torch.zeros(rows, 2).long(), torch.ones(rows))


SIGNATURE_CASES = {
    "cpu": (tstep.ObjectiveKind.TEXT_ENTITY, None, CPU, batch()),
    "mesh": (tstep.ObjectiveKind.TEXT_ENTITY, pmesh.Mesh(1, 1), CUDA, batch()),
    # A composite under a mesh and on the CPU; the bare similarity
    # objectives anywhere.
    "composite_entity": (tstep.ObjectiveKind.TEXT_ENTITY_ENTITY_ENTITY, pmesh.Mesh(1, 1), CUDA,
                         (batch(), pairs())),
    "composite_word": (tstep.ObjectiveKind.TEXT_ENTITY_TERM_TERM, None, CPU, (batch(), pairs())),
    "entity_entity": (tstep.ObjectiveKind.ENTITY_ENTITY, None, CUDA, pairs()),
    "term_term": (tstep.ObjectiveKind.TERM_TERM, None, CUDA, pairs()),
}


@pytest.mark.parametrize("case", sorted(SIGNATURE_CASES))
def test_graph_signature_sends_the_step_to_the_eager_path(case):
    kind, mesh, device, b = SIGNATURE_CASES[case]
    assert tstep.graph_signature(kind, mesh, device, params(), b) is None


def test_graph_signature_tells_apart_shapes_ids_and_tables():
    p = params()
    te = tstep.ObjectiveKind.TEXT_ENTITY
    base = tstep.graph_signature(te, None, "cuda", p, batch())
    assert base is not None
    assert tstep.graph_signature(te, None, CUDA, p, batch(seed=5)) == base
    others = [
        tstep.graph_signature(te, None, CUDA, p, batch(rows=16)),
        tstep.graph_signature(te, None, CUDA, p, batch(window=5)),
        tstep.graph_signature(te, None, CUDA, p, batch()._replace(weights=torch.ones(8).double())),
        tstep.graph_signature(te, None, CUDA, p, batch(), torch.zeros(4).long()),
        tstep.graph_signature(te, None, CUDA, p, batch()._replace(negatives=torch.zeros(8, 2).long())),
        tstep.graph_signature(te, None, CUDA, params(), batch()),
    ]
    assert base not in others
    assert len(set(others)) == len(others)


@pytest.mark.parametrize("kind", tstep.COMPOSITES)
def test_a_composite_signature_holds_both_batches(kind):
    p = params()
    base = tstep.graph_signature(kind, None, CUDA, p, (batch(), pairs()))
    assert base is not None
    assert tstep.graph_signature(kind, None, CUDA, p, (batch(seed=4), pairs())) == base
    others = [tstep.graph_signature(kind, None, CUDA, p, (batch(), pairs(rows=4))),
              tstep.graph_signature(kind, None, CUDA, p, (batch(rows=16), pairs())),
              tstep.graph_signature(tstep.ObjectiveKind.TEXT_ENTITY, None, CUDA, p, batch())]
    assert base not in others and len(set(others)) == 3


@pytest.mark.parametrize("path", sorted(PATHS))
def test_training_on_the_cpu_captures_nothing(monkeypatch, caplog, path):
    monkeypatch.setattr(tstep, "_CapturedStep", NoCapture)
    with caplog.at_level(logging.INFO, logger="cunvsm_torch.train.trainer"):
        result = train_model(DESC, cfg(EPOCHS, **CONFIGS["pooled_bf16"]), small_corpus(), CPU,
                             **PATHS[path])
    assert result.steps > 0
    assert replayed(caplog) == [0] * EPOCHS


def replayed(caplog):
    """The replayed steps of each epoch's log line."""
    return [r.args[5] for r in caplog.records if r.msg.startswith("Epoch %d%s: cost")]


def test_the_first_call_runs_eagerly_the_second_captures_and_other_shapes_run_eagerly(fake_graph):
    gen = torch.Generator().manual_seed(2)
    c = cfg(1, **CONFIGS["pooled_bf16"])
    step = tstep.make_train_step(DESC, c, CPU, gen, num_entities=9)
    p = params()
    state = Optimizer(c).init(p)
    calls = [(batch(seed=0), 0, 0), (batch(seed=1), 1, 1), (batch(seed=2), 1, 2),
             (batch(rows=16), 1, 2), (batch(seed=3), 1, 3)]
    for b, captures, replays in calls:
        step(p, state, b)
        assert (fake_graph.captures, step.graph.replays) == (captures, replays)


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("path", sorted(PATHS))
def test_graphed_training_equals_eager_training(fake_graph, caplog, monkeypatch, config, path):
    """Two epochs; on the on-device path 19 steps an epoch in calls of 2
    and a remainder call of 1, each call closure with a graph of its own."""
    corpus = small_corpus()
    c = cfg(EPOCHS, **CONFIGS[config])
    with monkeypatch.context() as eager:
        eager.setattr(tstep, "graph_signature", lambda *args: None)
        want = train_model(DESC, c, corpus, CPU, **PATHS[path])
    with caplog.at_level(logging.INFO, logger="cunvsm_torch.train.trainer"):
        got = train_model(DESC, c, corpus, CPU, **PATHS[path])
    assert got.epoch_costs == want.epoch_costs
    assert_same_state(want, got)
    closures = 2 if path == "on_device" else 1
    assert fake_graph.captures == closures
    assert sum(replayed(caplog)) == got.steps - closures
    if path == "on_device":
        # Epoch 1: the K-step closure's first step is eager; the remainder
        # closure's one step a epoch is eager in epoch 1 and captured in 2.
        assert replayed(caplog) == [17, 19]


def two_calls_of_four_steps(c):
    """(the 8 costs of two K = 4 calls from one seed, the runner)."""
    gen = torch.Generator().manual_seed(4)
    dc = tds.prepare_device_corpus(small_corpus(), CPU)
    run = tds.make_device_sampled_multistep(DESC, c, dc, 4, gen, num_entities=9)
    p = params()
    state = Optimizer(c).init(p)
    perm = tds.make_epoch_permuter(dc)[0](gen)
    return torch.cat([run(p, state, perm, 0), run(p, state, perm, 32)]), run


def test_a_multistep_call_stacks_one_distinct_cost_per_step(fake_graph, monkeypatch):
    c = cfg(1, **CONFIGS["pooled_bf16"])
    with monkeypatch.context() as eager:
        eager.setattr(tstep, "graph_signature", lambda *args: None)
        want, _ = two_calls_of_four_steps(c)
    got, run = two_calls_of_four_steps(c)
    assert run.step.graph.replays == 7
    assert torch.equal(got, want)
    assert len(set(got.tolist())) == 8


@pytest.mark.parametrize("what", ["mesh", "composite"])
def test_a_mesh_and_a_composite_capture_nothing(monkeypatch, caplog, what):
    """A mesh step, and a composite step under a mesh (host-fed), run
    eagerly."""
    real = tstep.graph_signature
    monkeypatch.setattr(tstep, "graph_signature",
                        lambda kind, mesh, device, *rest: real(kind, mesh, CUDA, *rest))
    monkeypatch.setattr(tstep, "_CapturedStep", NoCapture)
    corpus = small_corpus()
    if what == "mesh":
        c, kw = cfg(EPOCHS), dict(mesh=pmesh.Mesh(1, 1))
    else:
        c = cfg(EPOCHS, **COMPOSITE_WEIGHTS["entity"])
        kw = dict(similarity_source=similarity_source(corpus, "entity"), mesh=pmesh.Mesh(1, 1))
    with caplog.at_level(logging.INFO, logger="cunvsm_torch.train.trainer"):
        result = train_model(DESC, c, corpus, CPU, **kw)
    assert result.steps > 0
    assert replayed(caplog) == [0] * EPOCHS


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("table", sorted(COMPOSITE_WEIGHTS))
def test_graphed_composite_training_equals_eager_training(fake_graph, caplog, monkeypatch,
                                                         table, path):
    """Both batches of a composite step are the graph's inputs: two epochs
    (19 steps each; on the device in calls of 2 and a remainder of 1)
    replay every step but each closure's first ones and equal eager
    training bit for bit."""
    corpus = small_corpus()
    c = cfg(EPOCHS, **COMPOSITE_WEIGHTS[table], **CONFIGS["pooled_bf16"])
    # A source of its own for each run: the host-fed one draws its passes
    # from a RandomState that it keeps.
    with monkeypatch.context() as eager:
        eager.setattr(tstep, "graph_signature", lambda *args: None)
        want = train_model(DESC, c, corpus, CPU, **PATHS[path],
                           similarity_source=similarity_source(corpus, table))
    with caplog.at_level(logging.INFO, logger="cunvsm_torch.train.trainer"):
        got = train_model(DESC, c, corpus, CPU, **PATHS[path],
                          similarity_source=similarity_source(corpus, table))
    assert got.epoch_costs == want.epoch_costs
    assert_same_state(want, got)
    closures = 2 if path == "on_device" else 1
    assert fake_graph.captures == closures
    assert sum(replayed(caplog)) == got.steps - closures


def test_capture_and_replay_spans_sit_in_the_step_span(fake_graph):
    """Under a profiler: one ``cunvsm.step.capture`` a closure, one
    ``cunvsm.step.replay`` a replayed step, both inside
    ``cunvsm.step.cost_and_grads``, which still opens once a step."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        result = train_model(DESC, cfg(EPOCHS, **CONFIGS["pooled_bf16"]), small_corpus(), CPU,
                             **PATHS["on_device"])
    events = [e for e in prof.events() if e.name.startswith("cunvsm.step.")]
    counts = collections.Counter(e.name for e in events)
    assert counts["cunvsm.step.cost_and_grads"] == result.steps
    assert counts["cunvsm.step.capture"] == 2
    assert counts["cunvsm.step.replay"] == result.steps - 2
    for e in events:
        if e.name in ("cunvsm.step.capture", "cunvsm.step.replay"):
            assert program_parent(e) == "cunvsm.step.cost_and_grads"


class _Graph:
    """A CUDA graph's host side: registers generators and replays nothing."""

    def register_generator_state(self, generator):
        pass

    def replay(self):
        pass


def test_the_launch_counters_count_each_replay_and_not_the_capture(monkeypatch):
    """``_CapturedStep`` around a step that launches the cast once and the
    window mean once: the capture leaves both counters where they were,
    and each replay adds one to each, as the kernels that run."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph", lambda graph, **kw: contextlib.nullcontext())

    def cost_and_grads(b, negative_ids):
        for kernel in tstep._COUNTED:
            kernel.launches += 1
        return b.features.sum()

    counters = [kernel.launches for kernel in tstep._COUNTED]
    assert [k.__name__ for k in tstep._COUNTED] == ["cast_table", "window_mean"]
    captured = tstep._CapturedStep(cost_and_grads, None, batch(), None, True)
    assert [kernel.launches for kernel in tstep._COUNTED] == counters
    for n in (1, 2, 3):
        captured.replay(batch(seed=n), None)
        assert [kernel.launches for kernel in tstep._COUNTED] == [c + n for c in counters]
