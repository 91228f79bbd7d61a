"""Reference-RNG replay in the port against the JAX package.

* the port's ``data/stdrng.py`` copy gives the libstdc++ goldens of
  tests/test_stdrng.py and the JAX twin's values on random seeds, and its
  vectorized Glorot draw equals the scalar one bit for bit;
* ``TextEntitySource(reference_rng=True)`` yields JAX's positions, labels
  and negatives for 3 epochs, after ``draw_next_epoch`` and after
  ``skip_epochs`` too, and the goldens of tests/test_reference_rng.py;
* ``reference_init_params`` is bitwise JAX's (and the g++ goldens);
* the whole trainers, ``train_model(reference_rng=True)`` in both packages,
  float64, 3 epochs, agree to rtol 1e-9 on every epoch cost and table for
  sgd, adagrad, full_adam (factored per-instance) and full_adam with the
  entity L2 normalizer (expanded); 2 + 1 resumed epochs equal 3 bitwise;
* both packages refuse the same guarded combinations.
"""

import numpy as np
import pytest
import torch

import cunvsm_tpu.config as jconfig
from cunvsm_tpu.data import corpus as jcorpus
from cunvsm_tpu.data import instances as jinst
from cunvsm_tpu.data import stdrng as jrng
from cunvsm_tpu.models import params as jparams
from cunvsm_tpu.train import trainer as jtrainer
from cunvsm_torch.config import AdamConfig, DataConfig, ModelDesc, TrainConfig, UPDATE_METHOD_NAMES
from cunvsm_torch.data import corpus as tcorpus
from cunvsm_torch.data import instances as tinst
from cunvsm_torch.data import stdrng as trng
from cunvsm_torch.models import params as tparams
from cunvsm_torch.train import trainer as ttrainer
from tests import test_reference_rng as gold_ref
from tests import test_stdrng as gold
from tests.test_torch_slice import synthetic_corpus
from tests.torch_parity import twin

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


# -- stdrng ------------------------------------------------------------------


GOLDEN_CASES = {
    "raw": (lambda m: [[g() for _ in range(8)] for g in (m.MinstdRand0(1), m.MinstdRand0(12345))],
            [gold.RAW_SEED1, gold.RAW_SEED12345]),
    "uniform_int": (lambda m: [
        f(g) for g in [m.MinstdRand0(1)] for _ in range(4)
        for f in (lambda g: m.uniform_int(g, 0, 9), lambda g: m.uniform_int(g, 0, 0),
                  lambda g: m.uniform_int(g, 0, 261143), lambda g: m.uniform_int(g, 5, 7),
                  lambda g: m.uniform_int(g, 0, 2147483645))
    ], gold.UNIFORM_INTS_SEED1),
    "shuffle_paired": (lambda m: [_shuffled(m, n, 7) for n in (10, 13)],
                       [gold.SHUFFLE10_SEED7, gold.SHUFFLE13_SEED7]),
    "shuffle_per_element": (lambda m: _shuffled(m, 50000, 7)[:8], gold.SHUFFLE50000_SEED7_HEAD),
    "canonical": (lambda m: _bits([m.generate_canonical_f32(g) for g in [m.MinstdRand0(3)]
                                   for _ in range(8)]).tolist(), gold.CANONICAL_F32_BITS_SEED3),
    "labels": (lambda m: [x for row in m.reference_negative_labels(m.MinstdRand0(1), [0, 1, 2, 3],
                                                                   100, 3) for x in row],
               gold.LABELS_SEED1_E100_K3),
}


def _shuffled(m, n, seed):
    v = list(range(n))
    m.std_shuffle(v, m.MinstdRand0(seed))
    return v


@pytest.mark.parametrize("case", sorted(GOLDEN_CASES))
def test_stdrng_copy_gives_the_libstdcxx_goldens(case):
    fn, want = GOLDEN_CASES[case]
    assert fn(trng) == want == fn(jrng)


@pytest.mark.parametrize("seed", [1, 977, 31337, 2**31 - 5])
def test_stdrng_copy_matches_jax_on_random_seeds(seed):
    rng = np.random.RandomState(seed % 1000)
    assert trng.MinstdRand0(seed).state == jrng.MinstdRand0(seed).state
    hi = [int(h) for h in rng.randint(0, 2**31 - 3, 20)] + [0, 1, 2, 2147483645]
    gt, gj = trng.MinstdRand0(seed), jrng.MinstdRand0(seed)
    assert [trng.uniform_int(gt, 0, h) for h in hi] == [jrng.uniform_int(gj, 0, h) for h in hi]
    for n in (2, 7, 64, 1000):
        assert _shuffled(trng, n, seed) == _shuffled(jrng, n, seed)
    gt, gj = trng.MinstdRand0(seed), jrng.MinstdRand0(seed)
    np.testing.assert_array_equal(_bits(trng.glorot_uniform_f32(gt, 7, 11)),
                                  _bits(jrng.glorot_uniform_f32(gj, 7, 11)))
    assert gt.state == gj.state
    np.testing.assert_array_equal(trng._lcg_block(seed % (2**31 - 1) or 1, 333),
                                  jrng._lcg_block(seed % (2**31 - 1) or 1, 333))
    np.testing.assert_array_equal(trng.shuffle_draw_pasts(999), jrng.shuffle_draw_pasts(999))
    assert trng.past_threshold(48) == jrng.past_threshold(48)
    pasts = rng.randint(1, 2**31 - 3, 5000)
    gt, gj = trng.MinstdRand0(seed), jrng.MinstdRand0(seed)
    trng.fast_forward_uniform_draws(gt, pasts)
    jrng.fast_forward_uniform_draws(gj, pasts)
    assert gt.state == gj.state
    labels = list(range(9))
    assert (trng.reference_negative_labels(trng.MinstdRand0(seed), labels, 48, 3)
            == jrng.reference_negative_labels(jrng.MinstdRand0(seed), labels, 48, 3))


@pytest.mark.parametrize("rows,cols", [(1, 1), (3, 40), (300, 65), (256, 9)])
def test_vectorized_glorot_equals_the_scalar_draws(rows, cols):
    for seed in (1, 3, 2**31 - 2):
        a, b = jrng.MinstdRand0(seed), trng.MinstdRand0(seed)
        want = _bits(jrng.glorot_uniform_f32(a, rows, cols))
        np.testing.assert_array_equal(_bits(trng.glorot_uniform_f32(b, rows, cols)), want)
        assert a.state == b.state


# -- the instance source ---------------------------------------------------


def _corpora(docs_per_topic=3, doc_len=20, window=4):
    docs, _ = synthetic_corpus(num_docs_per_topic=docs_per_topic, doc_len=doc_len)
    kw = dict(max_vocabulary_size=0, min_document_frequency=0, max_document_frequency=0)
    return (jcorpus.build_corpus(docs, jconfig.DataConfig(**kw), window_size=window),
            tcorpus.build_corpus(docs, DataConfig(**kw), window_size=window))


def _sources(batch=8, k=3, seed=7):
    jc, tc = _corpora()
    kw = dict(batch_size=batch, seed=seed, reference_rng=True, num_negative=k)
    return jinst.TextEntitySource(jc, **kw), tinst.TextEntitySource(tc, **kw)


def _assert_same_epoch(js, ts):
    jb, tb = list(js.epoch_batches()), list(ts.epoch_batches())
    assert len(jb) == len(tb) > 0
    for a, b in zip(jb, tb):
        assert b.negatives is not None and b.negatives.shape == a.negatives.shape
        for f in tinst.TextEntityBatchNp._fields:
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
    assert js.std_rng.state == ts.std_rng.state


@pytest.mark.parametrize("pre_drawn", [False, True])
def test_source_matches_jax_for_three_epochs(pre_drawn):
    js, ts = _sources()
    if pre_drawn:
        js.draw_next_epoch()
        ts.draw_next_epoch()
        assert js.std_rng.state == ts.std_rng.state
    for _ in range(3):
        _assert_same_epoch(js, ts)


@pytest.mark.parametrize("skip,pre_drawn", [(1, False), (2, False), (2, True)])
def test_source_matches_jax_after_skip_epochs(skip, pre_drawn):
    js, ts = _sources()
    consumed = _sources()[1]
    for s in (js, ts, consumed):
        if pre_drawn:
            s.draw_next_epoch()
    for _ in range(skip):
        list(consumed.epoch_batches())
    js.skip_epochs(skip)
    ts.skip_epochs(skip)
    assert ts.std_rng.state == js.std_rng.state == consumed.std_rng.state
    for _ in range(2):
        _assert_same_epoch(js, ts)


def test_source_gives_the_reference_goldens():
    docs = [(f"doc{d}", " ".join(f"w{d}x{j}" for j in range(n)))
            for d, n in enumerate(gold_ref.LENGTHS)]
    corpus = tcorpus.build_corpus(
        docs, DataConfig(max_vocabulary_size=0, min_document_frequency=0,
                         max_document_frequency=0), window_size=gold_ref.WINDOW)
    src = tinst.TextEntitySource(corpus, batch_size=gold_ref.BATCH, seed=1,
                                 reference_rng=True, num_negative=gold_ref.NEG)
    labels, negatives, positions = [], [], []
    for batch in src.epoch_batches():
        labels += batch.labels.tolist()
        negatives += batch.negatives.ravel().tolist()
        positions += [int(corpus.vocab.terms[int(r[0])].split("x")[1]) for r in batch.features]
    assert labels == gold_ref.GOLD_LABELS
    assert positions == gold_ref.GOLD_POSITIONS
    assert negatives == gold_ref.GOLD_NEGATIVES


@pytest.mark.parametrize("kw,match", [
    (dict(shuffle=False), "stochastic generator"),
    (dict(pad_remainder=True), "pad_remainder"),
])
def test_source_guards_match_jax(kw, match):
    jc, tc = _corpora()
    for module, corpus in ((jinst, jc), (tinst, tc)):
        with pytest.raises(ValueError, match=match):
            module.TextEntitySource(corpus, 8, reference_rng=True, **kw)


# -- reference_init_params -------------------------------------------------


@pytest.mark.parametrize("dims", [(3, 2), (12, 8), (30, 7)])
def test_reference_init_params_bitwise_jax(dims):
    js, ts = _sources()
    js.draw_next_epoch()
    ts.draw_next_epoch()
    corpus = ts.corpus
    desc = ModelDesc(word_repr_size=dims[0], entity_repr_size=dims[1])
    want = jparams.reference_init_params(js.std_rng, corpus.vocab.size, corpus.num_docs, twin(desc))
    got = tparams.reference_init_params(ts.std_rng, corpus.vocab.size, corpus.num_docs, desc,
                                        device=CPU)
    for a, b in zip(want, got):
        assert b.dtype == torch.float32 and tuple(b.shape) == a.shape
        np.testing.assert_array_equal(_bits(b.numpy()), _bits(a))
    assert js.std_rng.state == ts.std_rng.state
    _assert_same_epoch(js, ts)  # the negatives continue from the same state


def test_reference_init_params_gives_the_gplusplus_goldens():
    docs = [(f"doc{d}", " ".join(f"w{d}x{j}" for j in range(n)))
            for d, n in enumerate(gold_ref.LENGTHS)]
    corpus = tcorpus.build_corpus(
        docs, DataConfig(max_vocabulary_size=0, min_document_frequency=0,
                         max_document_frequency=0), window_size=gold_ref.WINDOW)
    desc = ModelDesc(word_repr_size=gold_ref.GOLD_INIT_D_W, entity_repr_size=gold_ref.GOLD_INIT_D_E)
    cfg = TrainConfig(num_epochs=0, batch_size=gold_ref.BATCH, window_size=gold_ref.WINDOW,
                      num_random_entities=gold_ref.NEG, reference_rng=True, seed=1)
    params = ttrainer.train_model(desc, cfg, corpus, CPU).params
    word = _bits(params.word_reprs.numpy()).ravel().tolist()
    assert word[:8] == gold_ref.GOLD_WORD_BITS_HEAD and word[-4:] == gold_ref.GOLD_WORD_BITS_TAIL
    assert _bits(params.entity_reprs.numpy()).ravel().tolist() == gold_ref.GOLD_ENTITY_BITS
    assert _bits(params.transform_w.numpy()).ravel().tolist() == gold_ref.GOLD_TRANSFORM_BITS
    assert not params.transform_b.any()


# -- the whole trainers ------------------------------------------------------

TRAINER_CASES = {
    "sgd": ("sgd", False),
    "adagrad": ("adagrad", False),
    "full_adam": ("full_adam", False),
    "full_adam_entity_l2": ("full_adam", True),
}


def _trainer_config(name, n, **kw):
    method, mode = UPDATE_METHOD_NAMES[name]
    return TrainConfig(**{**dict(
        num_epochs=n, batch_size=8, window_size=4, num_random_entities=3, learning_rate=0.05,
        seed=11, update_method=method, adam=AdamConfig(mode=mode) if mode else AdamConfig(),
        reference_rng=True), **kw})


@pytest.mark.parametrize("case", sorted(TRAINER_CASES))
def test_whole_trainer_matches_jax(case):
    """train_model(reference_rng=True) in both packages, float64, 3 epochs:
    the same host stream drives both, so no draw is injected."""
    import jax.numpy as jnp

    name, entity_l2 = TRAINER_CASES[case]
    jc, tc = _corpora()
    desc = ModelDesc(word_repr_size=8, entity_repr_size=6, l2_normalize_entity_reprs=entity_l2)
    cfg = _trainer_config(name, 3)
    want = jtrainer.train_model(twin(desc), twin(cfg), jc, dtype=jnp.float64)
    got = ttrainer.train_model(desc, cfg, tc, CPU, dtype=torch.float64)
    assert len(got.epoch_costs) == 3
    np.testing.assert_allclose(got.epoch_costs, want.epoch_costs, rtol=1e-9)
    for a, b in zip(want.params, got.params):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-9, atol=1e-12)
    assert not np.allclose(got.params.entity_reprs.numpy(),
                           ttrainer.train_model(desc, _trainer_config(name, 0), tc, CPU,
                                                dtype=torch.float64).params.entity_reprs.numpy())


@pytest.mark.parametrize("name", ["adagrad", "full_adam"])
def test_resumed_reference_run_equals_uninterrupted(tmp_path, name):
    _, corpus = _corpora()
    desc = ModelDesc(word_repr_size=8, entity_repr_size=6)
    straight = ttrainer.train_model(desc, _trainer_config(name, 3), corpus, CPU)
    prefix = str(tmp_path / "m")
    first = ttrainer.train_model(desc, _trainer_config(name, 2), corpus, CPU, output_prefix=prefix)
    resumed = ttrainer.train_model(desc, _trainer_config(name, 3), corpus, CPU,
                                   output_prefix=prefix, resume=True)
    assert first.epoch_costs + resumed.epoch_costs == straight.epoch_costs
    for a, b in zip(straight.params, resumed.params):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kwargs,config,match", [
    (dict(on_device_sampling=True), {}, "pick one"),
    (dict(compute_initial_cost=True), {}, "initial-cost"),
    ({}, dict(negative_pool_size=64), "per-instance negative sampling"),
    ({}, dict(shared_negatives=True), "per-instance negative sampling"),
    ({}, dict(no_shuffle=True), "stochastic generator"),
])
def test_both_trainers_refuse_the_same_combinations(kwargs, config, match):
    jc, tc = _corpora()
    desc = ModelDesc(word_repr_size=8, entity_repr_size=6)
    cfg = _trainer_config("full_adam", 1, **config)
    with pytest.raises(ValueError, match=match):
        jtrainer.train_model(twin(desc), twin(cfg), jc, **kwargs)
    with pytest.raises(ValueError, match=match):
        ttrainer.train_model(desc, cfg, tc, CPU, **kwargs)
