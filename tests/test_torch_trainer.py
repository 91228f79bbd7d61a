"""The port's trainer: resume, checkpoints, on-device epochs and guards.

* 2 + 2 resumed epochs equal an uninterrupted 4, bit for bit, on the
  host-fed and on the on-device path (the cases of
  tests/test_train_integration.py:142-211), with full_adam and with every
  other optimizer, and for both composites fed by a similarity source
  (tests/test_train_integration.py:248): the similarity stream is zipped in
  lockstep and fast-forwarded past the batches trained;
* an output prefix writes ``_meta`` (the JAX package's bytes for the same
  corpus), the sidecars, one ``.hdf5`` per dumped epoch (read back equal to
  the returned tables) and the resume file; the callback sees its epoch's
  file;
* on-device epochs train every full batch once: a K that does not divide
  the epoch adds one remainder call, a K larger than the epoch is clamped;
* a composite sampled on the device trains each step as the host-fed
  step fed the same batches and draws, bit for bit, and under a mesh it is
  refused (a mesh trains it host-fed);
* the JAX trainer's guards raise ValueError (compute_initial_cost,
  profile_dir and check_gradients have their own tests in
  tests/test_torch_trainer_options.py; the mesh options in
  tests/test_torch_parallel.py and tests/test_torch_sharded_corpus.py).
"""

import logging
import os

import numpy as np
import pytest
import torch

from cunvsm_torch.config import (
    UPDATE_METHOD_NAMES,
    AdamConfig,
    AdamMode,
    DataConfig,
    ModelDesc,
    TrainConfig,
    UpdateMethod,
)
from cunvsm_torch.data import device_sampler as tds
from cunvsm_torch.data.corpus import build_corpus
from cunvsm_torch.data.instances import FeatureWeighting, TextEntitySource
from cunvsm_torch.data.sources import Prefetcher, SimilaritySource
from cunvsm_torch.io import checkpoint as tckpt
from cunvsm_torch.models.objectives import SimilarityBatch, TextEntityBatch
from cunvsm_torch.models.params import init_params
from cunvsm_torch.optim.updates import Optimizer
from cunvsm_torch.train import step as tstep
from cunvsm_torch.train.trainer import derived_seed, train_model
from tests.test_torch_slice import synthetic_corpus

torch.set_num_threads(1)
CPU = torch.device("cpu")
DESC = ModelDesc(word_repr_size=8, entity_repr_size=6)


def small_corpus(docs_per_topic=3, doc_len=20):
    docs, _ = synthetic_corpus(num_docs_per_topic=docs_per_topic, doc_len=doc_len)
    return build_corpus(
        docs,
        DataConfig(max_vocabulary_size=0, min_document_frequency=0, max_document_frequency=0),
        window_size=4,
    )


def cfg(n, batch=8, **kw):
    return TrainConfig(**{
        **dict(num_epochs=n, batch_size=batch, window_size=4, num_random_entities=2,
               learning_rate=0.01, seed=3, update_method=UpdateMethod.ADAM,
               adam=AdamConfig(mode=AdamMode.DENSE_UPDATE_DENSE_VARIANCE)),
        **kw,
    })


def assert_same_state(a, b):
    for x, y in zip(tckpt.state_leaves(a.params, a.opt_state),
                    tckpt.state_leaves(b.params, b.opt_state)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("path", ["host_fed", "on_device"])
def test_resume_equals_uninterrupted(tmp_path, path):
    """2 + 2 epochs with resume give the tables, moments and step counters
    of an uninterrupted 4-epoch run, bit for bit: the batch stream and the
    generator's reseeds continue where they left off."""
    corpus = small_corpus()
    kw = dict(on_device_sampling=True, steps_per_call=2) if path == "on_device" else {}
    straight = train_model(DESC, cfg(4), corpus, CPU, **kw)
    prefix = str(tmp_path / "m")
    first = train_model(DESC, cfg(2), corpus, CPU, output_prefix=prefix, **kw)
    resumed = train_model(DESC, cfg(4), corpus, CPU, output_prefix=prefix, resume=True, **kw)
    assert resumed.steps == first.steps == straight.steps // 2 > 0
    assert first.epoch_costs + resumed.epoch_costs == straight.epoch_costs
    assert_same_state(straight, resumed)
    assert int(resumed.opt_state.entity.t) == straight.steps + 1


def test_resume_without_a_resume_file_trains_from_scratch(tmp_path):
    corpus = small_corpus()
    a = train_model(DESC, cfg(1), corpus, CPU, output_prefix=str(tmp_path / "m"), resume=True)
    b = train_model(DESC, cfg(1), corpus, CPU)
    assert_same_state(a, b)


@pytest.mark.parametrize("on_device", [False, True])
def test_checkpoint_files(tmp_path, on_device):
    jckpt = pytest.importorskip("cunvsm_tpu.io.checkpoint")
    corpus = small_corpus()
    prefix = str(tmp_path / "m")
    seen = []

    def callback(epoch, params, cost):
        # The writer has finished this epoch's file before the callback.
        same = None
        if os.path.exists(tckpt.checkpoint_path(prefix, epoch)):
            loaded = tckpt.load_model_hdf5(prefix, epoch, CPU)
            same = all(torch.equal(a, b) for a, b in zip(params, loaded))
        seen.append((epoch, same, cost))

    result = train_model(DESC, cfg(3), corpus, CPU, output_prefix=prefix,
                         dump_initial_model=True, checkpoint_every=2,
                         epoch_callback=callback, on_device_sampling=on_device)
    files = sorted(os.listdir(tmp_path))
    assert files == ["m_0.hdf5", "m_2.hdf5", "m_3.hdf5", "m_docnos.txt", "m_meta",
                     "m_resume.npz", "m_vocab.txt"]
    assert [s[:2] for s in seen] == [(1, None), (2, True), (3, True)]
    assert [s[2] for s in seen] == result.epoch_costs
    loaded = tckpt.load_model_hdf5(prefix, 3, CPU)
    for a, b in zip(result.params, loaded):
        assert torch.equal(a, b)
    want = jckpt.build_metadata(
        corpus.vocab.index_term_ids, corpus.vocab.term_freq, corpus.num_docs,
        corpus.vocab.total_terms, corpus.vocab.include_oov,
    ).SerializeToString()
    with open(f"{prefix}_meta", "rb") as f:
        assert f.read() == want
    assert tckpt.load_strings(f"{prefix}_docnos.txt") == corpus.docnos
    with np.load(f"{prefix}_resume.npz") as data:
        assert int(data["__epoch__"]) == 3
        assert int(data["extra_total_batches"]) == result.steps
        assert len([k for k in data.files if k.startswith("leaf_")]) == 4 + 3 + 3 + 5


def test_dump_every_writes_intra_epoch_models(tmp_path):
    corpus = small_corpus()
    per_epoch = TextEntitySource(corpus, 8).batches_per_epoch()
    train_model(DESC, cfg(2), corpus, CPU, output_prefix=str(tmp_path / "m"), dump_every=per_epoch)
    names = sorted(f for f in os.listdir(tmp_path) if f.endswith(".hdf5"))
    assert names == sorted([f"m_1_{per_epoch}.hdf5", f"m_2_{2 * per_epoch}.hdf5",
                            "m_1.hdf5", "m_2.hdf5"])


K_CHOICES = {
    "3": lambda n: 3, "epoch": lambda n: n, "past_the_epoch": lambda n: n + 10, "1": lambda n: 1,
}


@pytest.mark.parametrize("k_choice", sorted(K_CHOICES))
def test_on_device_epoch_accounting(k_choice, caplog):
    """Every full batch trains once per epoch: steps_epoch // K calls of K
    steps and one remainder call (with a warning), K clamped to the epoch."""
    corpus = small_corpus(docs_per_topic=4)
    steps_epoch = TextEntitySource(corpus, 8).batches_per_epoch()
    assert steps_epoch % 3  # K = 3 leaves a remainder
    k = K_CHOICES[k_choice](steps_epoch)
    with caplog.at_level(logging.WARNING, logger="cunvsm_torch.train.trainer"):
        result = train_model(DESC, cfg(2), corpus, CPU, on_device_sampling=True, steps_per_call=k)
    assert result.steps == 2 * steps_epoch
    assert int(result.opt_state.word.t) == result.steps + 1
    assert ("remainder" in caplog.text) == (k == 3)
    assert all(np.isfinite(result.epoch_costs)) and result.batches_per_sec > 0


def test_on_device_weighted_corpus_trains():
    corpus = small_corpus()
    result = train_model(DESC, cfg(2, uniform_feature_weights=False), corpus, CPU,
                         on_device_sampling=True, steps_per_call=3,
                         feature_weighting=FeatureWeighting.SELF_INFORMATION)
    assert all(np.isfinite(result.epoch_costs)) and result.steps > 0


def test_prefetch_depth_does_not_change_the_result():
    corpus = small_corpus()
    a = train_model(DESC, cfg(2), corpus, CPU, prefetch_depth=0)
    b = train_model(DESC, cfg(2), corpus, CPU, prefetch_depth=3, log_every=2)
    assert a.epoch_costs == b.epoch_costs
    assert_same_state(a, b)


def test_skip_epochs_matches_jax():
    """The host stream after skip_epochs(n) is the JAX package's."""
    from cunvsm_tpu.data.instances import TextEntitySource as JSource

    corpus = small_corpus()
    port, jax_source = TextEntitySource(corpus, 8, seed=5), JSource(corpus, 8, seed=5)
    port.skip_epochs(2)
    jax_source.skip_epochs(2)
    for a, b in zip(port.epoch_batches(), jax_source.epoch_batches()):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_prefetcher_yields_in_order_and_raises_the_producer_error():
    assert list(Prefetcher(iter(range(25)), depth=2)) == list(range(25))

    def failing():
        yield 1
        raise KeyError("producer")

    it = Prefetcher(failing(), depth=1)
    assert next(it) == 1
    with pytest.raises(KeyError, match="producer"):
        next(it)


def test_derived_seeds_differ_by_stream_and_counter():
    seeds = {derived_seed(3, s, c) for s in (1, 2) for c in range(50)}
    assert len(seeds) == 100 and all(0 <= s < 2**63 for s in seeds)
    assert derived_seed(3, 1, 7) == derived_seed(3, 1, 7) != derived_seed(4, 1, 7)


@pytest.mark.parametrize("kwargs,config,match", [
    (dict(checkpoint_every=0), {}, "checkpoint_every"),
    (dict(on_device_sampling=True), dict(reference_rng=True), "pick one"),
    (dict(on_device_sampling=True), dict(no_shuffle=True), "stochastic-only"),
    (dict(on_device_sampling=True, check_gradients=True), {}, "incompatible"),
    (dict(steps_per_call=2, check_gradients=True), {}, "steps_per_call=1"),
    (dict(stratify_data_groups=2), {}, "requires on_device_sampling"),
    (dict(on_device_sampling=True, shard_corpus=True), {}, "requires a mesh"),
    (dict(), dict(entity_entity_weight=0.5), "similarity source"),
    (dict(on_device_sampling=True, similarity_source=object(), mesh=object()),
     dict(term_term_weight=0.5), "only the text-entity objective"),
])
def test_jax_guards_raise_value_error(kwargs, config, match):
    with pytest.raises(ValueError, match=match):
        train_model(DESC, cfg(1, **config), small_corpus(), CPU, **kwargs)


def optimizer_cfg(name, n):
    method, mode = UPDATE_METHOD_NAMES[name]
    return cfg(n, learning_rate=0.05, update_method=method,
               adam=AdamConfig(mode=mode) if mode else AdamConfig())


@pytest.mark.parametrize("path", ["host_fed", "on_device"])
@pytest.mark.parametrize("name", ["adagrad", "dense_adam", "sgd", "sparse_adam"])
def test_every_optimizer_resumes_exactly(tmp_path, name, path):
    """The multistep, the resume file (the JAX leaf order; SGD has no
    state leaves) and the reseeds work unchanged for every optimizer."""
    corpus = small_corpus()
    kw = dict(on_device_sampling=True, steps_per_call=2) if path == "on_device" else {}
    straight = train_model(DESC, optimizer_cfg(name, 4), corpus, CPU, **kw)
    prefix = str(tmp_path / "m")
    train_model(DESC, optimizer_cfg(name, 2), corpus, CPU, output_prefix=prefix, **kw)
    resumed = train_model(DESC, optimizer_cfg(name, 4), corpus, CPU, output_prefix=prefix,
                          resume=True, **kw)
    assert all(np.isfinite(straight.epoch_costs))
    assert straight.epoch_costs[2:] == resumed.epoch_costs
    assert_same_state(straight, resumed)
    with np.load(prefix + "_resume.npz") as data:
        leaves = len([k for k in data.files if k.startswith("leaf_")])
    assert leaves == len(tckpt.state_leaves(resumed.params, resumed.opt_state))
    assert leaves == {"sgd": 4, "adagrad": 8, "sparse_adam": 15, "dense_adam": 15}[name]


def similarity_source(corpus, table, seed=9):
    rng = np.random.RandomState(seed)
    rows = corpus.num_docs if table == "entity" else corpus.vocab.size
    ids = rng.randint(0, rows, (20, 2)).astype(np.int32)
    return SimilaritySource(ids, rng.uniform(0.5, 1.5, 20).astype(np.float32), batch_size=8,
                            seed=seed)


COMPOSITE_WEIGHTS = {
    "entity": dict(text_entity_weight=0.7, entity_entity_weight=0.3),
    "word": dict(text_entity_weight=0.6, term_term_weight=0.4),
}


@pytest.mark.parametrize("table", ["entity", "word"])
def test_composite_resume_equals_uninterrupted(tmp_path, table):
    """The similarity stream (20 pairs, 2 batches per pass, so it wraps
    within an epoch) is zipped with the text batches; a resumed run
    fast-forwards it past the batches already trained and so equals an
    uninterrupted one bit for bit."""
    corpus = small_corpus()
    kw = COMPOSITE_WEIGHTS[table]
    straight = train_model(DESC, cfg(4, **kw), corpus, CPU,
                           similarity_source=similarity_source(corpus, table))
    prefix = str(tmp_path / "m")
    train_model(DESC, cfg(2, **kw), corpus, CPU, output_prefix=prefix,
                similarity_source=similarity_source(corpus, table))
    resumed = train_model(DESC, cfg(4, **kw), corpus, CPU, output_prefix=prefix, resume=True,
                          similarity_source=similarity_source(corpus, table))
    assert all(np.isfinite(straight.epoch_costs))
    assert straight.epoch_costs[2:] == resumed.epoch_costs
    assert_same_state(straight, resumed)
    # Without the fast-forward the resumed run would see the stream's
    # first batches again and train other tables.
    other = train_model(DESC, cfg(4, **kw), corpus, CPU,
                        similarity_source=similarity_source(corpus, table, seed=10))
    assert not torch.equal(other.params.entity_reprs, straight.params.entity_reprs)


def test_composite_trains_with_steps_per_call_and_logs_the_layout(caplog):
    corpus = small_corpus()
    with caplog.at_level(logging.INFO, logger="cunvsm_torch.train.trainer"):
        result = train_model(DESC, cfg(2, **COMPOSITE_WEIGHTS["word"]), corpus, CPU,
                             similarity_source=similarity_source(corpus, "word"),
                             steps_per_call=3)
    assert all(np.isfinite(result.epoch_costs))
    assert result.steps == 2 * TextEntitySource(corpus, 8).batches_per_epoch()
    assert "Negative sampling: per-instance (k=2)" in caplog.text

def recording_steps(monkeypatch):
    """Every step closure the trainer makes records each step's (global
    index, pair batch, the trainer generator's state before the step,
    text batch)."""
    seen = []
    real = tstep.make_train_step

    def make(desc, cfg_, device, generator, *args, **kw):
        step = real(desc, cfg_, device, generator, *args, **kw)

        def recording(params, opt_state, batch, negative_ids=None):
            te, sim = batch
            seen.append((len(seen), sim, generator.get_state(),
                         TextEntityBatch(*(None if t is None else t.clone() for t in te))))
            return step(params, opt_state, batch, negative_ids)

        recording.graph = step.graph
        return recording

    monkeypatch.setattr(tds, "make_train_step", make)
    return seen


def similarity_arrays(corpus, table, seed=9):
    """The ids and weights of ``similarity_source``."""
    source = similarity_source(corpus, table, seed)
    return source.ids, source.weights


@pytest.mark.parametrize("table", ["entity", "word"])
def test_on_device_composite_trains_each_step_as_the_host_fed_step(monkeypatch, table):
    """Two epochs of ``train_model`` on the device; then the host-fed step
    closure, from the same initial tables, fed each recorded text and pair
    batch with the trainer's generator set to the state it had before that
    step (the negatives are drawn inside the step): every cost and the
    final state equal bit for bit."""
    corpus = small_corpus()
    c = cfg(2, **COMPOSITE_WEIGHTS[table], negative_pool_size=4)
    ids, weights = similarity_arrays(corpus, table)
    source = SimilaritySource(ids, weights, batch_size=8, seed=9)
    costs = []
    with monkeypatch.context() as m:
        seen = recording_steps(m)
        real = tds.make_train_step

        def make(*args, **kw):
            step = real(*args, **kw)

            def costing(params, opt_state, batch, negative_ids=None):
                costs.append(step(params, opt_state, batch, negative_ids))
                return costs[-1]

            costing.graph = step.graph
            return costing

        m.setattr(tds, "make_train_step", make)
        got = train_model(DESC, c, corpus, CPU, on_device_sampling=True, steps_per_call=3,
                          similarity_source=source)
    gen = torch.Generator().manual_seed(c.seed)
    params = init_params(gen, corpus.vocab.size, corpus.num_docs, DESC, device=CPU)
    state = Optimizer(c).init(params)
    host_step = tstep.make_train_step(DESC, c, CPU, gen, num_entities=corpus.num_docs)
    for (_, sim, gen_state, te), cost in zip(seen, costs):
        gen.set_state(gen_state)
        want = host_step(params, state, (te, SimilarityBatch(sim.ids.clone(), sim.weights)))
        assert torch.equal(want, cost)
    assert len(seen) == got.steps == 38
    for a, b in zip(tuple(params) + tuple(x for s in state for x in s),
                    tuple(got.params) + tuple(x for s in got.opt_state for x in s)):
        assert torch.equal(a, b)
