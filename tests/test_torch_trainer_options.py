"""The trainer options of the port that the JAX trainer has:
``compute_initial_cost``, ``profile_dir`` and ``check_gradients``.

* ``compute_initial_cost`` logs the mean of ``make_cost_fn`` over the first
  host epoch, each batch's draws from (seed, INITIAL_COST_STREAM, batch),
  and consumes that epoch of the host source, so training takes the next
  draw (as the JAX trainer's pass does); a resumed run accounts for it as
  an uninterrupted one does;
* ``profile_dir`` writes a Chrome trace of the first trained epoch;
* ``train/gradcheck.py``: every objective kind and negative layout passes
  at float64, with the leaf counts of the JAX package's check on the same
  inputs; a gradient perturbed by 1e-3 raises; ``train_model`` runs the
  check before every host-fed step and trains what it trains without it.
"""

import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cunvsm_tpu.models import objectives as jobj
from cunvsm_tpu.models.params import ModelParams as JModelParams
from cunvsm_tpu.train import gradcheck as jgradcheck
from cunvsm_tpu.train import step as jstep
from cunvsm_torch.config import UPDATE_METHOD_NAMES, AdamConfig, ModelDesc, Nonlinearity, TrainConfig
from cunvsm_torch.data.instances import TextEntitySource
from cunvsm_torch.models import objectives as tobj
from cunvsm_torch.models.params import ModelParams, init_params
from cunvsm_torch.train import gradcheck
from cunvsm_torch.train import step as tstep
from cunvsm_torch.train import trainer as ttrainer
from tests.test_torch_trainer import DESC, cfg, small_corpus
from tests.torch_parity import twin

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _initial_cost_records(caplog):
    return [r for r in caplog.records if r.getMessage().startswith("Initial cost:")]


@pytest.mark.parametrize("on_device", [False, True])
def test_initial_cost_is_the_mean_over_the_first_host_epoch(caplog, on_device):
    corpus = small_corpus()
    c = cfg(1)
    with caplog.at_level(logging.INFO, logger="cunvsm_torch.train.trainer"):
        ttrainer.train_model(DESC, c, corpus, CPU, dtype=torch.float64, compute_initial_cost=True,
                             on_device_sampling=on_device, steps_per_call=2)
    (record,) = _initial_cost_records(caplog)
    logged, batches = record.args[0], record.args[1]

    generator = torch.Generator().manual_seed(c.seed)
    params = init_params(generator, corpus.vocab.size, corpus.num_docs, DESC,
                         dtype=torch.float64, device=CPU)
    kind = tstep.objective_kind_from_config(c)
    cost_fn = tstep.make_cost_fn(DESC, c, kind, CPU, generator)
    source = TextEntitySource(corpus, c.batch_size, seed=c.seed)
    costs = []
    for i, b in enumerate(source.epoch_batches()):
        generator.manual_seed(ttrainer.derived_seed(c.seed, ttrainer.INITIAL_COST_STREAM, i))
        costs.append(float(cost_fn(params, tobj.TextEntityBatch.from_numpy(b, CPU))))
    assert batches == len(costs) == source.batches_per_epoch() > 0
    np.testing.assert_allclose(logged, np.mean(costs), rtol=1e-12)


def test_initial_cost_consumes_the_first_host_epoch(monkeypatch):
    """The pass draws the host source's first epoch; the first trained
    epoch is its second draw."""
    corpus = small_corpus()
    seen = []

    class Recording(TextEntitySource):
        def epoch_batches(self):
            labels = []
            seen.append(labels)
            for b in super().epoch_batches():
                labels.append(b.labels.copy())
                yield b

    monkeypatch.setattr(ttrainer, "TextEntitySource", Recording)
    ttrainer.train_model(DESC, cfg(1), corpus, CPU, compute_initial_cost=True)
    fresh = TextEntitySource(corpus, 8, seed=cfg(1).seed)
    want = [[b.labels for b in fresh.epoch_batches()] for _ in range(2)]
    assert len(seen) == 2
    for got, exp in zip(seen, want):
        np.testing.assert_array_equal(np.concatenate(got), np.concatenate(exp))


def test_initial_cost_resume_equals_uninterrupted(tmp_path):
    corpus = small_corpus()
    kw = dict(compute_initial_cost=True)
    straight = ttrainer.train_model(DESC, cfg(3), corpus, CPU, **kw)
    prefix = str(tmp_path / "m")
    first = ttrainer.train_model(DESC, cfg(2), corpus, CPU, output_prefix=prefix, **kw)
    resumed = ttrainer.train_model(DESC, cfg(3), corpus, CPU, output_prefix=prefix,
                                   resume=True, **kw)
    assert first.epoch_costs + resumed.epoch_costs == straight.epoch_costs
    for a, b in zip(straight.params, resumed.params):
        assert torch.equal(a, b)


@pytest.mark.parametrize("on_device", [False, True])
def test_profile_dir_writes_a_trace_of_the_first_epoch(tmp_path, on_device):
    trace_dir = tmp_path / "trace"
    plain = ttrainer.train_model(DESC, cfg(2), small_corpus(), CPU, on_device_sampling=on_device)
    profiled = ttrainer.train_model(DESC, cfg(2), small_corpus(), CPU, on_device_sampling=on_device,
                                    profile_dir=str(trace_dir))
    assert os.listdir(trace_dir) == ["trace.json"]
    with open(trace_dir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    assert profiled.epoch_costs == plain.epoch_costs


# -- gradient checks -----------------------------------------------------------

NUM_WORDS, NUM_ENTITIES, D_W, D_E = 7, 5, 3, 4
BATCH, WINDOW, NUM_NEG = 4, 2, 2
TE_DESC = ModelDesc(word_repr_size=D_W, entity_repr_size=D_E,
                    nonlinearity=Nonlinearity.TANH, batch_normalization=True)
K = tstep.ObjectiveKind
GRAD_CASES = {
    "text_entity_factored": (K.TEXT_ENTITY, "full_adam", dict(negative_pool_size=0), {}),
    "text_entity_expanded": (K.TEXT_ENTITY, "adagrad", {}, {}),
    "text_entity_entity_l2": (K.TEXT_ENTITY, "full_adam", {}, dict(l2_normalize_entity_reprs=True)),
    "text_entity_pooled": (K.TEXT_ENTITY, "sgd", dict(negative_pool_size=4), {}),
    "text_entity_shared": (K.TEXT_ENTITY, "full_adam", dict(shared_negatives=True), {}),
    "entity_entity": (K.ENTITY_ENTITY, "sgd", {}, {}),
    "term_term": (K.TERM_TERM, "dense_adam", {}, {}),
    "composite_entity": (K.TEXT_ENTITY_ENTITY_ENTITY, "full_adam",
                         dict(text_entity_weight=0.7, entity_entity_weight=0.3), {}),
    "composite_term": (K.TEXT_ENTITY_TERM_TERM, "sgd",
                       dict(text_entity_weight=0.6, term_term_weight=0.4), {}),
}


def _grad_case(name, seed=1):
    kind, method_name, cfg_kw, desc_kw = GRAD_CASES[name]
    method, mode = UPDATE_METHOD_NAMES[method_name]
    c = TrainConfig(batch_size=BATCH, window_size=WINDOW, num_random_entities=NUM_NEG,
                    update_method=method, adam=AdamConfig(mode=mode) if mode else AdamConfig(),
                    **cfg_kw)
    desc = ModelDesc(**{**TE_DESC.__dict__, **desc_kw})
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(NUM_WORDS, D_W), rng.randn(NUM_ENTITIES, D_E), rng.randn(D_W, D_E),
              rng.randn(D_E)]
    te = dict(features=rng.randint(0, NUM_WORDS, (BATCH, WINDOW)),
              feature_weights=rng.rand(BATCH, WINDOW) + 0.5,
              labels=rng.randint(0, NUM_ENTITIES, BATCH), weights=rng.rand(BATCH) + 0.5)
    rows = NUM_ENTITIES if kind in (K.ENTITY_ENTITY, K.TEXT_ENTITY_ENTITY_ENTITY) else NUM_WORDS
    sim = dict(ids=rng.randint(0, rows, (BATCH, 2)), weights=rng.rand(BATCH) + 0.5)

    def batches(package):
        if package == "jax":
            t = jobj.TextEntityBatch(**{k: jnp.asarray(v) for k, v in te.items()})
            s = jobj.SimilarityBatch(jnp.asarray(sim["ids"]), jnp.asarray(sim["weights"]))
        else:
            t = tobj.TextEntityBatch(**{k: torch.from_numpy(np.asarray(v)) for k, v in te.items()})
            s = tobj.SimilarityBatch(torch.from_numpy(sim["ids"]), torch.from_numpy(sim["weights"]))
        if kind == K.TEXT_ENTITY:
            return t
        if kind in (K.ENTITY_ENTITY, K.TERM_TERM):
            return s
        return (t, s)

    return kind, desc, c, arrays, batches


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_check_gradients_passes_with_jax_leaf_counts(case):
    kind, desc, c, arrays, batches = _grad_case(case)
    params = ModelParams(*(torch.from_numpy(a.copy()) for a in arrays))
    generator = torch.Generator().manual_seed(5)
    state = generator.get_state()
    n, err = gradcheck.check_gradients(kind, params, batches("torch"), generator, CPU, desc, c)
    assert torch.equal(generator.get_state(), state)  # the step then draws what it would
    jn, _ = jgradcheck.check_gradients(
        jstep.ObjectiveKind(kind.value), JModelParams(*(jnp.asarray(a) for a in arrays)),
        batches("jax"), jax.random.PRNGKey(5), twin(desc), twin(c))
    assert n == jn == sum(a.size for a in arrays)
    assert err < 1e-4


@pytest.mark.parametrize("leaf", ["word_reprs", "transform_w"])
def test_check_gradients_raises_on_a_perturbed_gradient(monkeypatch, leaf):
    kind, desc, c, arrays, batches = _grad_case("text_entity_factored")
    params = ModelParams(*(torch.from_numpy(a.copy()) for a in arrays))
    densify = gradcheck.densify_grads

    def perturbed(p, grads):
        dense = densify(p, grads)
        bad = getattr(dense, leaf).clone()
        bad.view(-1)[bad.numel() // 2] += 1e-3
        return dense._replace(**{leaf: bad})

    monkeypatch.setattr(gradcheck, "densify_grads", perturbed)
    with pytest.raises(AssertionError, match=f"gradient mismatch at leaf "
                                             f"{ModelParams._fields.index(leaf)}"):
        gradcheck.check_gradients(kind, params, batches("torch"), torch.Generator(), CPU, desc, c)


@pytest.mark.parametrize("path", ["host_fed", "composite"])
def test_train_model_checks_every_step(monkeypatch, path):
    """check_gradients=True runs the check before each host-fed step at
    float64 and leaves the training unchanged."""
    from cunvsm_torch.data.sources import SimilaritySource

    corpus = small_corpus(docs_per_topic=2, doc_len=10)
    kw = {}
    c = cfg(1, batch=4)
    if path == "composite":
        rng = np.random.RandomState(0)
        ids = rng.randint(0, corpus.num_docs, (16, 2)).astype(np.int32)
        kw["similarity_source"] = SimilaritySource(ids, np.ones(16, np.float32), 4, seed=1)
        c = cfg(1, batch=4, text_entity_weight=0.5, entity_entity_weight=0.5)
    desc = ModelDesc(word_repr_size=3, entity_repr_size=2)
    calls = []
    check = gradcheck.check_gradients

    def counting(*args, **kwargs):
        calls.append(check(*args, **kwargs))
        return calls[-1]

    monkeypatch.setattr(gradcheck, "check_gradients", counting)
    plain = ttrainer.train_model(desc, c, corpus, CPU, dtype=torch.float64, **kw)
    if path == "composite":
        kw["similarity_source"] = SimilaritySource(ids, np.ones(16, np.float32), 4, seed=1)
    checked = ttrainer.train_model(desc, c, corpus, CPU, dtype=torch.float64,
                                   check_gradients=True, **kw)
    assert len(calls) == checked.steps == plain.steps > 0
    assert checked.epoch_costs == plain.epoch_costs
    for a, b in zip(plain.params, checked.params):
        assert torch.equal(a, b)
