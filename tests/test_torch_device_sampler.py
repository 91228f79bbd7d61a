"""The port's on-device sampler against the JAX package's.

On one corpus of documents of uneven length (some shorter than the window,
so not eligible): the epoch's pointer multiset equals JAX's; the batch
fetch on the same documents and the same uniforms is bitwise JAX's under
every weighting; the window clamp holds at the largest float32 below 1 and
at 1 itself; the permuter keeps the multiset and reshuffles per seed; and K
epoch-exact steps with injected draws match K JAX steps (sample_batch +
objective + Optimizer.apply) on the same draws to rtol 1e-9 / atol 1e-12
in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cunvsm_tpu.data import device_sampler as jds
from cunvsm_tpu.data import instances as jinst
from cunvsm_tpu.optim import updates as jupd
from cunvsm_torch.data import device_sampler as tds
from cunvsm_torch.data.corpus import Corpus
from cunvsm_torch.data.instances import FeatureWeighting, TextEntitySource, Weighting
from cunvsm_torch.data.vocab import Vocabulary
from cunvsm_torch.optim import updates as tupd
from cunvsm_torch.train import step as tstep
from tests.torch_parity import (
    B, DESCS, K, V, W, both_params, jax_train_step, numpy_params, to_np, train_config, twin,
)

torch.set_num_threads(1)

WEIGHTINGS = {
    "uniform": (Weighting.UNIFORM, FeatureWeighting.UNIFORM),
    "inv_doc_frequency": (Weighting.INV_DOC_FREQUENCY, FeatureWeighting.UNIFORM),
    "self_information": (Weighting.UNIFORM, FeatureWeighting.SELF_INFORMATION),
}


def uneven_corpus(num_docs=48, seed=0, max_len=20):
    """num_docs documents of 1..max_len-1 tokens over V words; the docs
    shorter than the window W are not eligible."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(1, max_len, num_docs)
    tokens = rng.randint(0, V, int(lengths.sum())).astype(np.int32)
    freq = np.bincount(tokens, minlength=V).astype(np.int64)
    vocab = Vocabulary(
        terms=[f"t{i}" for i in range(V)], term_to_id={f"t{i}": i for i in range(V)},
        term_freq=freq, total_terms=int(freq.sum()), include_oov=False,
        index_term_ids=np.arange(V, dtype=np.int64),
    )
    return Corpus(
        vocab=vocab, tokens=tokens,
        doc_offsets=np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64),
        index_lengths=lengths.astype(np.int64),
        docnos=[f"d{i}" for i in range(num_docs)], window_size=W,
    )


def both_corpora(corpus, weighting="uniform"):
    """(JAX DeviceCorpus, port DeviceCorpus) of one corpus; the JAX reader
    takes the port's Corpus, whose fields are its own."""
    w, fw = WEIGHTINGS[weighting]
    return (
        jds.prepare_device_corpus(
            corpus, weighting=jinst.Weighting(w.value),
            feature_weighting=jinst.FeatureWeighting(fw.value),
        ),
        tds.prepare_device_corpus(corpus, "cpu", weighting=w, feature_weighting=fw),
    )


def jax_uniforms(key):
    """The uniforms JAX's sample_batch draws from ``key``."""
    return jax.random.uniform(jax.random.split(key)[1], (B,))


def test_epoch_doc_pointers_match_jax():
    corpus = uneven_corpus()
    jdc, tdc = both_corpora(corpus)
    got = tds.epoch_doc_pointers(tdc).numpy()
    np.testing.assert_array_equal(got, np.asarray(jds.epoch_doc_pointers(jdc)))
    lengths = np.diff(corpus.doc_offsets)
    eligible = np.flatnonzero(lengths >= W)
    assert 0 < len(eligible) < len(lengths)  # the corpus has ineligible docs
    assert np.array_equal(np.unique(got), eligible)
    assert np.all(np.bincount(got)[eligible] == tdc.samples_per_doc)
    assert len(got) == TextEntitySource(corpus, B).instances_per_epoch()


@pytest.mark.parametrize("weighting", sorted(WEIGHTINGS))
def test_sample_batch_matches_jax(weighting):
    """The same documents and uniforms give JAX's batch bit for bit."""
    corpus = uneven_corpus()
    jdc, tdc = both_corpora(corpus, weighting)
    ptrs = np.asarray(jds.epoch_doc_pointers(jdc))
    rng = np.random.RandomState(1)
    for i in range(3):
        docs = rng.permutation(ptrs)[:B]
        key = jax.random.PRNGKey(i)
        jb = jds.sample_batch(jdc, key, B, docs=jnp.asarray(docs))
        u = torch.from_numpy(np.array(jax_uniforms(key)))
        tb = tds.sample_batch(tdc, B, docs=torch.from_numpy(docs).long(), uniforms=u)
        np.testing.assert_array_equal(tb.features.numpy(), np.asarray(jb.features))
        np.testing.assert_array_equal(tb.labels.numpy(), np.asarray(jb.labels))
        for t, j in ((tb.feature_weights, jb.feature_weights), (tb.weights, jb.weights)):
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    if weighting != "uniform":
        assert not np.all(tb.weights.numpy() * tb.feature_weights.numpy().mean(1) == 1)


def _last_windows(corpus, docs):
    ends = corpus.doc_offsets[docs + 1]
    return corpus.tokens[ends[:, None] - W + np.arange(W)[None, :]]


@pytest.mark.parametrize("u", [np.nextafter(np.float32(1), np.float32(0)), np.float32(1.0)])
def test_window_clamp(u):
    """At the largest float32 below 1, and at 1 (where floor(u * n) = n and
    only the clamp keeps the window inside), every window is its
    document's last."""
    corpus = uneven_corpus()
    _, tdc = both_corpora(corpus)
    docs = tdc.eligible[:B] if tdc.eligible.shape[0] >= B else tdc.eligible.repeat(2)[:B]
    tb = tds.sample_batch(tdc, B, docs=docs, uniforms=torch.full((B,), float(u)))
    np.testing.assert_array_equal(tb.features.numpy(), _last_windows(corpus, docs.numpy()))
    n = np.diff(corpus.doc_offsets)[docs.numpy()] - W + 1
    assert np.all(np.minimum(np.floor(u * n.astype(np.float32)), n - 1) == n - 1)


def test_windows_lie_inside_their_documents():
    corpus = uneven_corpus(seed=3)
    _, tdc = both_corpora(corpus)
    gen = torch.Generator().manual_seed(5)
    for _ in range(4):
        b = tds.sample_batch(tdc, B, gen)
        for feats, doc in zip(b.features.numpy(), b.labels.numpy()):
            toks = corpus.tokens[corpus.doc_offsets[doc]:corpus.doc_offsets[doc + 1]]
            assert len(toks) >= W
            assert any(np.array_equal(toks[p:p + W], feats) for p in range(len(toks) - W + 1))


def test_sample_batch_draws_reproduce_from_the_generator():
    _, tdc = both_corpora(uneven_corpus())
    a = tds.sample_batch(tdc, B, torch.Generator().manual_seed(9))
    b = tds.sample_batch(tdc, B, torch.Generator().manual_seed(9))
    c = tds.sample_batch(tdc, B, torch.Generator().manual_seed(10))
    assert a.negatives is b.negatives is None
    assert all(torch.equal(x, y) for x, y in zip(a[:4], b[:4]))
    assert not torch.equal(a.features, c.features)


def test_permuter_keeps_the_multiset_and_reshuffles():
    _, tdc = both_corpora(uneven_corpus())
    permute, n = tds.make_epoch_permuter(tdc)
    ptrs = tds.epoch_doc_pointers(tdc)
    assert n == ptrs.shape[0]
    perms = [permute(torch.Generator().manual_seed(s)) for s in (0, 1, 0)]
    for p in perms:
        assert torch.equal(torch.sort(p).values, torch.sort(ptrs).values)
    assert torch.equal(perms[0], perms[2])
    assert not torch.equal(perms[0], perms[1])
    assert not torch.equal(perms[0], ptrs)


@pytest.mark.parametrize("n,cursor", [(100, 0), (100, 64), (100, 90), (20, 0), (20, 15)])
def test_perm_slice_matches_jax(n, cursor):
    """A contiguous slice (its start clamped as lax.dynamic_slice clamps
    it), or the modular wrap when the array is shorter than a batch."""
    perm = np.random.RandomState(n).permutation(1000)[:n].astype(np.int32)
    got = tds._perm_slice(torch.from_numpy(perm).long(), cursor, B)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jds._perm_slice(jnp.asarray(perm), cursor, B)))


@pytest.mark.parametrize("case", ["nvsm_pooled", "nvsm_per_instance", "lse_weighted"])
def test_multistep_matches_jax_steps(case):
    """K epoch-exact steps of the port's multistep runner with injected
    draws against K JAX steps (sample_batch + objective + apply) on the
    same pointers, uniforms and negatives."""
    pooled = case == "nvsm_pooled"
    desc = DESCS["lse" if case == "lse_weighted" else "nvsm"]
    weighting = "self_information" if case == "lse_weighted" else "uniform"
    cfg = train_config(
        negative_pool_size=8 if pooled else 0, uniform_feature_weights=weighting == "uniform",
    )
    corpus = uneven_corpus(num_docs=60, seed=4)
    jdc, tdc = both_corpora(corpus, weighting)
    num_entities = corpus.num_docs
    pool, stride = tstep.resolve_negative_sampling(cfg, desc, B, num_entities)
    assert (pool > 0) == pooled
    np_params = numpy_params(21)._replace(entity_reprs=np.random.RandomState(22).uniform(
        -0.5, 0.5, (num_entities, desc.entity_repr_size)))
    jp, tp = both_params(np_params)
    jstate, tstate = jupd.Optimizer(twin(cfg)).init(jp), tupd.Optimizer(cfg).init(tp)

    steps = 3
    perm = np.random.RandomState(23).permutation(np.asarray(jds.epoch_doc_pointers(jdc)))
    assert len(perm) >= (steps + 1) * B
    start = B  # the second call of an epoch
    rng = np.random.RandomState(24)
    draws, jcosts = [], []
    for i in range(steps):
        key = jax.random.PRNGKey(100 + i)
        docs = perm[start + i * B:start + (i + 1) * B]
        jb = jds.sample_batch(jdc, key, B, docs=jnp.asarray(docs))
        ids = (rng.randint(0, num_entities, pool) if pooled
               else rng.randint(0, num_entities, (B, K))).astype(np.int32)
        jp, jstate, jcost = jax_train_step(jp, jstate, jb, ids, pooled, desc, cfg, stride)
        jcosts.append(float(jcost))
        draws.append(tds.StepDraws(
            torch.from_numpy(np.array(jax_uniforms(key))), torch.from_numpy(ids).long()
        ))
    run = tds.make_device_sampled_multistep(
        desc, cfg, tdc, steps, torch.Generator(), num_entities=num_entities,
    )
    tcosts = run(tp, tstate, torch.from_numpy(perm).long(), start, draws=draws)
    assert tcosts.shape == (steps,) and tcosts.dtype == torch.float64
    np.testing.assert_allclose(tcosts.numpy(), jcosts, rtol=1e-9)
    for j, t in zip(jp, tp):
        np.testing.assert_allclose(to_np(t), np.asarray(j), rtol=1e-9, atol=1e-12)
    for js, ts in zip(jstate, tstate):
        for j, t in zip(js, ts):
            np.testing.assert_allclose(to_np(t), np.asarray(j), rtol=1e-9, atol=1e-12)
    assert int(tstate.word.t) == steps + 1


def test_iid_multistep_draws_eligible_documents_and_trains(monkeypatch):
    """``sample_batch`` alone draws eligible documents i.i.d.; the runner's
    K = 4 epoch-exact steps train the next slices of the shuffled pointers
    (eligible labels), move the tables and advance t, and the runner
    refuses the wrong count of draws and a missing ``doc_perm``."""
    corpus = uneven_corpus(num_docs=60, seed=6)
    _, tdc = both_corpora(corpus)
    gen = torch.Generator().manual_seed(2)
    labels = tds.sample_batch(tdc, 4 * B, gen).labels
    assert set(labels.tolist()) <= set(tdc.eligible.tolist())
    desc, cfg = DESCS["nvsm"], train_config(uniform_feature_weights=True)
    _, tp = both_params(numpy_params(25)._replace(
        entity_reprs=np.zeros((corpus.num_docs, desc.entity_repr_size))))
    before = tp.word_reprs.clone()
    state = tupd.Optimizer(cfg).init(tp)
    trained = []

    def recording_step(*args, **kwargs):
        step = tstep.make_train_step(*args, **kwargs)

        def recorded(params, opt_state, batch, negative_ids=None):
            trained.append(batch.labels)
            return step(params, opt_state, batch, negative_ids=negative_ids)

        return recorded

    monkeypatch.setattr(tds, "make_train_step", recording_step)
    run = tds.make_device_sampled_multistep(desc, cfg, tdc, 4, gen, num_entities=corpus.num_docs)
    perm = tds.make_epoch_permuter(tdc)[0](gen)
    assert perm.shape[0] >= 5 * B
    costs = run(tp, state, perm, B)
    assert costs.shape == (4,) and torch.isfinite(costs).all()
    for i, got in enumerate(trained):
        assert torch.equal(got, perm[(1 + i) * B:(2 + i) * B])
    assert len(trained) == 4 and set(torch.cat(trained).tolist()) <= set(tdc.eligible.tolist())
    assert not torch.equal(before, tp.word_reprs) and int(state.word.t) == 5
    with pytest.raises(ValueError, match="draws"):
        run(tp, state, perm, draws=[])
    with pytest.raises(ValueError, match="shuffled pointers"):
        run(tp, state)


@pytest.mark.parametrize("weights", [dict(entity_entity_weight=0.5), dict(term_term_weight=0.5)])
def test_multistep_refuses_composite_objectives(weights):
    """A composite refused without its similarity pair stream; with one
    (``DevicePairStream``) each of K = 2 epoch-exact steps trains the text
    batch it samples with the stream's next pair batch, and costs and
    tables equal, bit for bit, the host-fed step's fed those batches and
    the same injected draws."""
    corpus = uneven_corpus(num_docs=60, seed=6)
    _, tdc = both_corpora(corpus)
    desc, c = DESCS["nvsm"], train_config(**weights)
    with pytest.raises(ValueError, match="needs a similarity pair stream"):
        tds.make_device_sampled_multistep(desc, c, tdc, 2, torch.Generator())
    rows = corpus.num_docs if "entity_entity_weight" in weights else V
    rng = np.random.RandomState(3)
    ids, pair_w = rng.randint(0, rows, (3 * B, 2)), rng.uniform(0.5, 1.5, 3 * B)
    entity_rows = (corpus.num_docs, desc.entity_repr_size)
    np_params = numpy_params(25)._replace(
        entity_reprs=np.random.RandomState(4).uniform(-0.5, 0.5, entity_rows))
    gen = torch.Generator().manual_seed(2)
    perm = tds.make_epoch_permuter(tdc)[0](gen)
    draws = [tds.StepDraws(torch.rand(B, generator=gen),
                           torch.randint(0, corpus.num_docs, (B, K), generator=gen))
             for _ in range(2)]
    _, tp = both_params(np_params)
    state = tupd.Optimizer(c).init(tp)
    run = tds.make_device_sampled_multistep(
        desc, c, tdc, 2, gen, num_entities=corpus.num_docs,
        pairs=tds.DevicePairStream(ids, pair_w, B, 7, "cpu"),
    )
    costs = run(tp, state, perm, B, draws=draws)
    assert (run.pairs.trained, run.pairs.passes) == (2 * B, 1)
    _, hp = both_params(np_params)
    host_state = tupd.Optimizer(c).init(hp)
    host_step = tstep.make_train_step(desc, c, "cpu", gen, num_entities=corpus.num_docs)
    pairs = tds.DevicePairStream(ids, pair_w, B, 7, "cpu")
    for i, d in enumerate(draws):
        te = tds.sample_batch(tdc, B, docs=perm[(1 + i) * B:(2 + i) * B], uniforms=d.uniforms)
        cost = host_step(hp, host_state, (te, pairs.next_batch()), negative_ids=d.negative_ids)
        assert torch.equal(cost, costs[i])
    for a, b in zip(hp, tp):
        assert torch.equal(a, b)


