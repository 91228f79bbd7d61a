"""The model step replayed from a CUDA graph (``train/step.py:StepGraph``)
against the same training run eagerly, on the card.

Both runs train from one seed under ``torch.use_deterministic_algorithms``
(PyTorch's scatters otherwise add their rows in no fixed order);
the eager run takes the step's own eager path, with ``graph_signature``
answering None as it does for a mesh.  The tables, the optimizer state and
every step's cost are bitwise equal on the on-device path (pooled bfloat16
full_adam as the benchmark trains it, and per-instance float32; K = 13
calls with their reseeds and a remainder call) and on the host-fed path
(non-uniform feature weights, so that each replay refreshes them).  Every
step of a call closure but its first replays.  Both composites, their pairs
sampled on the card too, replay bitwise equal to eager training.  A mesh
step captures nothing.  A profiler started after the capture records the
replayed kernels by name, the CUDA C++ cast among them, and one
``cunvsm.step.replay`` span a replayed step.
"""

import collections
import contextlib
import logging

import numpy as np
import pytest
import torch

from cunvsm_torch.config import AdamConfig, AdamMode, ModelDesc, Nonlinearity, TrainConfig, UpdateMethod
from cunvsm_torch.data import device_sampler as tds
from cunvsm_torch.data.instances import FeatureWeighting, Weighting
from cunvsm_torch.data.sources import SimilaritySource
from cunvsm_torch.data.synth import corpus_from_tokens
from cunvsm_torch.io import checkpoint as tckpt
from cunvsm_torch.models.params import init_params
from cunvsm_torch.ops import cast
from cunvsm_torch.optim.updates import Optimizer
from cunvsm_torch.parallel import distributed, mesh as pmesh
from cunvsm_torch.train import step as tstep
from cunvsm_torch.train import trainer as ttrainer

pytestmark = pytest.mark.cuda

V, DOCS, DOC_LEN, W, B, K, EPOCHS = 4096, 16384, 16, 10, 2048, 13, 2
STEPS_EPOCH = DOCS * (DOC_LEN - W + 1) // B  # 56: four calls of 13 and a remainder of 4
DESC = ModelDesc(word_repr_size=300, entity_repr_size=256, nonlinearity=Nonlinearity.HARD_TANH,
                 batch_normalization=True)
CONFIGS = {
    # nvsm.train's configuration at a small collection: the automatic pool
    # resolves to P = 2048.
    "pooled_bf16": dict(stream_dtype="bfloat16", window_sum_dtype="bfloat16",
                        negative_pool_size=-1),
    "per_instance_f32": dict(negative_pool_size=0),
}


def config(**overrides):
    return TrainConfig(**{
        **dict(num_epochs=EPOCHS, batch_size=B, window_size=W, num_random_entities=10,
               regularization_lambda=1e-2, learning_rate=1e-3, seed=11,
               update_method=UpdateMethod.ADAM,
               adam=AdamConfig(mode=AdamMode.DENSE_UPDATE_DENSE_VARIANCE)),
        **overrides,
    })


def corpus():
    tokens = np.random.RandomState(5).zipf(1.3, DOCS * DOC_LEN) % V
    return corpus_from_tokens(tokens, DOCS, DOC_LEN, V, window_size=W)


@contextlib.contextmanager
def deterministic():
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def recorded(monkeypatch, costs, closures):
    """Every step closure that the trainer makes appends each step's cost
    to ``costs`` and itself to ``closures``."""
    real = tstep.make_train_step

    def make(*args, **kw):
        step = real(*args, **kw)

        def recording(params, opt_state, batch, negative_ids=None):
            cost = step(params, opt_state, batch, negative_ids)
            costs.append(cost)
            return cost

        recording.graph = step.graph
        closures.append(recording)
        return recording

    monkeypatch.setattr(tds, "make_train_step", make)
    monkeypatch.setattr(ttrainer, "make_train_step", make)


def train(monkeypatch, caplog, cfg, graphed, **kw):
    """(TrainResult, per-step costs, step closures, replays by epoch's log);
    the cast's launch counter counts one launch a step under bfloat16
    streams, none under float32, whether the step is replayed or not."""
    costs, closures = [], []
    casts = cast.cast_table.launches
    with monkeypatch.context() as m:
        recorded(m, costs, closures)
        if not graphed:
            m.setattr(tstep, "graph_signature", lambda *args: None)
        caplog.clear()
        with deterministic(), caplog.at_level(logging.INFO, logger=ttrainer.__name__):
            result = ttrainer.train_model(DESC, cfg, corpus(), torch.device("cuda"), **kw)
        torch.cuda.synchronize()
    casts_a_step = 1 if cfg.stream_dtype == "bfloat16" else 0
    assert cast.cast_table.launches - casts == casts_a_step * result.steps
    replays = [r.args[5] for r in caplog.records if r.msg.startswith("Epoch %d%s: cost")]
    return result, torch.stack(costs).cpu(), closures, replays


def assert_bitwise(a, b):
    for x, y in zip(tckpt.state_leaves(a.params, a.opt_state),
                    tckpt.state_leaves(b.params, b.opt_state)):
        assert torch.equal(x, y)
    assert a.epoch_costs == b.epoch_costs


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_graphed_on_device_epochs_equal_eager_ones_bitwise(cuda, monkeypatch, caplog, name):
    cfg = config(**CONFIGS[name])
    kw = dict(on_device_sampling=True, steps_per_call=K)
    eager, eager_costs, eager_steps, eager_replays = train(monkeypatch, caplog, cfg, False, **kw)
    got, costs, steps, replays = train(monkeypatch, caplog, cfg, True, **kw)
    assert got.steps == eager.steps == EPOCHS * STEPS_EPOCH
    assert torch.equal(costs, eager_costs)
    assert len(set(costs.tolist())) == len(costs)
    assert_bitwise(got, eager)
    # The K-step closure and the remainder closure: all but the first step of each.
    assert len(steps) == 2
    assert [s.graph.replays for s in steps] == [EPOCHS * STEPS_EPOCH // K * K - 1,
                                                EPOCHS * (STEPS_EPOCH % K) - 1]
    assert sum(replays) == got.steps - 2 and eager_replays == [0] * EPOCHS
    assert [s.graph.replays for s in eager_steps] == [0, 0]


def test_graphed_host_fed_epochs_equal_eager_ones_bitwise(cuda, monkeypatch, caplog):
    cfg = config(**CONFIGS["per_instance_f32"])
    kw = dict(feature_weighting=FeatureWeighting.SELF_INFORMATION,
              weighting=Weighting.INV_DOC_FREQUENCY)
    eager, eager_costs, _, _ = train(monkeypatch, caplog, cfg, False, **kw)
    got, costs, steps, replays = train(monkeypatch, caplog, cfg, True, **kw)
    assert got.steps == eager.steps > 2
    assert torch.equal(costs, eager_costs)
    assert_bitwise(got, eager)
    assert [s.graph.replays for s in steps] == [got.steps - 1]
    assert sum(replays) == got.steps - 1


class NoCapture:
    def __init__(self, *args):
        raise AssertionError("a step that must run eagerly captured a graph")


def test_a_mesh_step_captures_nothing(cuda, monkeypatch, tmp_path):
    device = torch.device("cuda", 0)
    monkeypatch.setattr(tstep, "_CapturedStep", NoCapture)
    distributed.initialize(f"file://{tmp_path / 'rendezvous'}", 1, 0, backend="nccl",
                           device=device, timeout=120.0)
    try:
        result = ttrainer.train_model(DESC, config(num_epochs=1), corpus(), device,
                                      mesh=pmesh.make_mesh(1, 1), on_device_sampling=True,
                                      steps_per_call=K)
    finally:
        distributed.shutdown()
    assert result.steps == STEPS_EPOCH


@pytest.mark.parametrize("table", ["entity", "word"])
def test_graphed_composite_epochs_equal_eager_ones_bitwise(cuda, monkeypatch, caplog, table):
    """Both composites on the on-device path, the pairs sampled on the card
    too (4 B pairs, 4 steps a pass): the K-step closure and the remainder
    closure each capture once, on their second step, and replay the rest,
    bitwise equal to eager training."""
    rng = np.random.RandomState(9)
    rows = DOCS if table == "entity" else V
    ids = rng.randint(0, rows, (4 * B, 2)).astype(np.int32)
    weights = rng.uniform(0.5, 1.5, 4 * B).astype(np.float32)
    mix = (dict(text_entity_weight=0.9, entity_entity_weight=0.1) if table == "entity"
           else dict(text_entity_weight=0.6, term_term_weight=0.4))
    cfg = config(negative_pool_size=-1, **mix)

    def kw():
        return dict(on_device_sampling=True, steps_per_call=K,
                    similarity_source=SimilaritySource(ids, weights, batch_size=B, seed=9))

    eager, eager_costs, _, eager_replays = train(monkeypatch, caplog, cfg, False, **kw())
    got, costs, steps, replays = train(monkeypatch, caplog, cfg, True, **kw())
    assert got.steps == eager.steps == EPOCHS * STEPS_EPOCH
    assert torch.equal(costs, eager_costs)
    assert_bitwise(got, eager)
    assert [s.graph.replays for s in steps] == [EPOCHS * STEPS_EPOCH // K * K - 1,
                                                EPOCHS * (STEPS_EPOCH % K) - 1]
    assert sum(replays) == got.steps - 2 and eager_replays == [0] * EPOCHS


def profiled_counts(run, params, state, perm, start):
    """(kernels, ``cunvsm.step.`` spans), each by name, that a CUDA
    profiler records over one call."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        run(params, state, perm, start)
        torch.cuda.synchronize()
    events = prof.events()
    return (collections.Counter(e.name for e in events
                                if e.device_type == torch.autograd.DeviceType.CUDA),
            collections.Counter(e.name for e in events if e.name.startswith("cunvsm.step.")))


def test_a_profiler_after_the_capture_records_the_replayed_kernels(cuda, monkeypatch):
    """A first K-step call captures (at its second step); the next call
    runs under a CUDA profiler, which records every kernel that the same
    call records when it runs eagerly, as often, the cast once a step."""
    cfg = config(**CONFIGS["pooled_bf16"])
    dc = tds.prepare_device_corpus(corpus(), cuda)
    counts, spans = {}, {}
    for graphed in (False, True):
        with monkeypatch.context() as m:
            if not graphed:
                m.setattr(tstep, "graph_signature", lambda *args: None)
            gen = torch.Generator(device=cuda).manual_seed(3)
            run = tds.make_device_sampled_multistep(DESC, cfg, dc, K, gen, num_entities=DOCS)
            params = init_params(gen, V, DOCS, DESC, device=cuda)
            state = Optimizer(cfg).init(params)
            perm = tds.make_epoch_permuter(dc)[0](gen)
            run(params, state, perm, 0)
            torch.cuda.synchronize()
            before = cast.cast_table.launches
            counts[graphed], spans[graphed] = profiled_counts(run, params, state, perm, K * B)
            assert cast.cast_table.launches == before + K
            assert run.step.graph.replays == (2 * K - 1 if graphed else 0)
    missing = {name: n - counts[True][name] for name, n in counts[False].items()
               if counts[True][name] < n}
    assert not missing
    assert sum(n for name, n in counts[True].items() if "cast_kernel" in name) == K
    # Each replayed step has its span; the loss and backward ran in the capture.
    assert spans[True] == {"cunvsm.step.cost_and_grads": K, "cunvsm.step.replay": K}
    assert spans[False]["cunvsm.step.loss"] == K and "cunvsm.step.replay" not in spans[False]
