"""The Mix 'n Match composites on the on-device path
(``data/device_sampler.py:DevicePairStream`` and the multistep runner,
``train/trainer.py``), on the CPU.

* The first steps of both composites, sampled on the device with injected
  text draws, against the plain reference (``tests/plain_mixnmatch.py``) fed
  the batches that the documented formulas give, in float64: every step's
  cost and every table and moment after each call;
* the pair stream's draws against their formula (pass p is
  ``randperm(n)`` from a generator reseeded from (seed, PAIR_STREAM, p),
  the remainder dropped): a pass boundary inside a call, across calls, at
  an epoch's end and after a resume, and the shorter last batch kept under
  ``drop_remainder=False``;
* the on-device composite step against the host-fed composite step fed the
  same batches and draws: equal bit for bit;
* the new spans (``cunvsm.similarity.permute`` once a pass begun,
  ``cunvsm.similarity.batch`` and ``cunvsm.step.similarity`` once a step)
  with their parents, the epoch log line's pairs and passes, and 2 + 2
  resumed on-device epochs equal to 4.
"""

import collections
import logging

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cunvsm_torch.config import Nonlinearity
from cunvsm_torch.data import device_sampler as tds
from cunvsm_torch.data.device_sampler import PAIR_STREAM, derived_seed
from cunvsm_torch.data.sources import SimilaritySource
from cunvsm_torch.models.objectives import SimilarityBatch
from cunvsm_torch.models.params import init_params
from cunvsm_torch.optim.updates import Optimizer
from cunvsm_torch.train import step as tstep
from cunvsm_torch.train.trainer import train_model
from tests import plain_mixnmatch as plain
from tests.test_torch_spans import program_parent
from tests.test_torch_trainer import (
    CPU, COMPOSITE_WEIGHTS, assert_same_state, cfg, recording_steps, small_corpus,
)
from tests.test_torch_trainer import DESC as TRAINER_DESC

DESC = TRAINER_DESC.__class__(word_repr_size=8, entity_repr_size=6,
                              nonlinearity=Nonlinearity.HARD_TANH, batch_normalization=True)
B, K, N_PAIRS, LAM = 8, 3, 20, 0.05  # 20 pairs: two batches of 8 a pass, 4 dropped
LAYOUTS = {"per_instance": dict(negative_pool_size=0), "pooled": dict(negative_pool_size=4)}


def composite_cfg(table, n=1, **kw):
    return cfg(n, regularization_lambda=LAM, **COMPOSITE_WEIGHTS[table], **kw)


def pair_arrays(corpus, table, n=N_PAIRS, seed=9):
    rng = np.random.RandomState(seed)
    rows = corpus.num_docs if table == "entity" else corpus.vocab.size
    return (rng.randint(0, rows, (n, 2)).astype(np.int32),
            rng.uniform(0.5, 1.5, n).astype(np.float32))


def formula_pairs(ids, weights, seed, step, batch=B, drop_remainder=True):
    """Global step ``step``'s pair batch by the documented formula."""
    n = len(ids)
    per_pass = n // batch if drop_remainder else -(-n // batch)
    p, j = divmod(step, per_pass)
    gen = torch.Generator().manual_seed(derived_seed(seed, PAIR_STREAM, p))
    sel = torch.randperm(n, generator=gen)[j * batch:(j + 1) * batch]
    return torch.as_tensor(ids).long()[sel], torch.as_tensor(weights)[sel]


def formula_features(corpus, docs, uniforms, window):
    """The windows that ``uniforms`` place in ``docs``: the start is
    min(floor(u * max_pos), max_pos - 1), max_pos = len - W + 1, in
    float32."""
    lengths = torch.as_tensor(corpus.doc_lengths.astype(np.int64))[docs]
    max_pos = lengths - window + 1
    pos = torch.minimum(torch.floor(uniforms * max_pos.float()).long(), max_pos - 1)
    base = torch.as_tensor(corpus.doc_offsets.astype(np.int64))[docs] + pos
    tokens = torch.as_tensor(corpus.tokens.astype(np.int64))
    return tokens[base[:, None] + torch.arange(window)[None, :]]


def runner_setup(table, layout, seed=5):
    corpus = small_corpus()
    c = composite_cfg(table, **LAYOUTS[layout])
    dc = tds.prepare_device_corpus(corpus, CPU)
    ids, weights = pair_arrays(corpus, table)
    pairs = tds.DevicePairStream(ids, weights, B, seed, CPU)
    gen = torch.Generator().manual_seed(seed)
    run = tds.make_device_sampled_multistep(DESC, c, dc, K, gen, num_entities=corpus.num_docs,
                                            pairs=pairs)
    params = init_params(torch.Generator().manual_seed(1), corpus.vocab.size, corpus.num_docs,
                         DESC, dtype=torch.float64, device=CPU)
    perm = tds.make_epoch_permuter(dc)[0](gen)
    return corpus, c, ids, weights, run, params, perm


def injected_draws(corpus, layout, calls, seed=7):
    """K ``StepDraws`` a call: float32 uniforms and the negatives (a pool of
    4 or [B, k] per instance)."""
    g = torch.Generator().manual_seed(seed)
    k = 2
    shape = (4,) if layout == "pooled" else (B, k)
    return [[tds.StepDraws(torch.rand(B, generator=g),
                           torch.randint(0, corpus.num_docs, shape, generator=g))
             for _ in range(K)] for _ in range(calls)]


def per_instance_negatives(c, ids):
    """[B, k] negatives of a step's draw: a pool unrolled by the rolled
    pool's slots (r + j * stride) % P with r = b // (B / P)."""
    if ids.ndim == 2:
        return ids
    p = ids.shape[0]
    _, stride = tstep.resolve_negative_sampling(c, DESC, B)
    r = torch.arange(B) // (B // p)
    return ids[(r[:, None] + stride * torch.arange(2)[None, :]) % p]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("table", ["entity", "word"])
def test_first_steps_follow_the_plain_reference(table, layout):
    """Two calls of K = 3 steps (a pass boundary inside the first call and
    one inside the second).  Tolerance: float64 on both sides, sums in
    another order (``index_add_``, autograd's accumulation, the merge), so
    the two differ by rounding of about 1e-15 relative per operation;
    after six Adam steps, whose first divides by sqrt(v) with v of the
    gradient's own size, rtol 1e-9 leaves a margin of thousands."""
    corpus, c, ids, weights, run, params, perm = runner_setup(table, layout)
    state = Optimizer(c).init(params)
    tables = {n: getattr(params, n).clone() for n in plain.LEAVES}
    spec = plain.Spec(table, c.text_entity_weight,
                      c.entity_entity_weight or c.term_term_weight, LAM, c.learning_rate)
    opt = plain.Adam(tables, spec)
    draws = injected_draws(corpus, layout, calls=2)
    for call in range(2):
        costs = run(params, state, perm, call * K * B, draws=draws[call])
        for i, d in enumerate(draws[call]):
            t = call * K + i
            docs = perm[t * B:(t + 1) * B]
            text = (formula_features(corpus, docs, d.uniforms, c.window_size), docs,
                    per_instance_negatives(c, d.negative_ids), torch.ones(B))
            want = plain.step(tables, opt, text, formula_pairs(ids, weights, 5, t), spec)
            np.testing.assert_allclose(float(costs[i]), want, rtol=1e-9)
        for n in plain.LEAVES:
            np.testing.assert_allclose(getattr(params, n).numpy(), tables[n].numpy(),
                                       rtol=1e-9, atol=1e-12, err_msg=n)
        for n, got in (("word_reprs", state.word), ("entity_reprs", state.entity)):
            np.testing.assert_allclose(got.m.numpy(), opt.m[n].numpy(), rtol=1e-9, atol=1e-12)
            np.testing.assert_allclose(got.v.numpy(), opt.v[n].numpy(), rtol=1e-9, atol=1e-15)
    assert run.pairs.trained == 2 * K * B and run.pairs.passes == 3


def test_pair_batches_follow_their_formula_across_passes_and_seeks():
    corpus = small_corpus()
    ids, weights = pair_arrays(corpus, "entity")
    stream = tds.DevicePairStream(ids, weights, B, 11, CPU)
    assert stream.per_pass == 2
    for t in range(7):
        got = stream.next_batch()
        want = formula_pairs(ids, weights, 11, t)
        assert torch.equal(got.ids, want[0]) and torch.equal(got.weights, want[1])
        assert got.ids.dtype == torch.int64 and got.weights.dtype == torch.float32
    assert (stream.trained, stream.passes) == (7 * B, 4)
    # The pairs of one pass are distinct rows of the array: a permutation.
    first = torch.cat([formula_pairs(ids, weights, 11, t)[0] for t in (0, 1)])
    rows = {tuple(r) for r in first.tolist()}
    assert len(first) == 2 * B and rows <= {tuple(r) for r in ids.tolist()}
    # A seek back into pass 0 draws its permutation again, the same one.
    stream.seek(1)
    assert torch.equal(stream.next_batch().ids, formula_pairs(ids, weights, 11, 1)[0])
    assert stream.passes == 5
    # Another seed, another order.
    other = tds.DevicePairStream(ids, weights, B, 12, CPU).next_batch()
    assert not torch.equal(other.ids, formula_pairs(ids, weights, 11, 0)[0])


def test_the_remainder_is_kept_only_when_asked():
    corpus = small_corpus()
    ids, weights = pair_arrays(corpus, "word")
    stream = tds.DevicePairStream(ids, weights, B, 3, CPU, drop_remainder=False)
    assert stream.per_pass == 3
    sizes = [stream.next_batch().ids.shape[0] for _ in range(4)]
    assert sizes == [B, B, N_PAIRS - 2 * B, B]
    want = formula_pairs(ids, weights, 3, 2, drop_remainder=False)[0]
    stream.seek(2)
    assert torch.equal(stream.next_batch().ids, want)
    with pytest.raises(ValueError, match="hold no batch"):
        tds.DevicePairStream(ids[:B - 1], weights[:B - 1], B, 3, CPU)
    with pytest.raises(ValueError, match="weights"):
        tds.DevicePairStream(ids, weights[:3], B, 3, CPU)


@pytest.mark.parametrize("table", ["entity", "word"])
def test_train_model_draws_the_pairs_of_the_formula_and_resumes_them(tmp_path, monkeypatch,
                                                                     caplog, table):
    """19 steps an epoch in calls of 2 and a remainder of 1, passes of 2
    steps: in odd epochs passes begin at calls' starts and the last one
    spans the epoch's end, in even epochs they begin inside calls.  A run
    resumed after epoch 2 takes the pairs of the uninterrupted run's steps
    38 on, and equals it bit for bit."""
    corpus = small_corpus()
    c = composite_cfg(table, 4)
    ids, weights = pair_arrays(corpus, table)
    source = SimilaritySource(ids, weights, batch_size=B, seed=9)
    kw = dict(on_device_sampling=True, steps_per_call=2, similarity_source=source)
    with monkeypatch.context() as m:
        seen = recording_steps(m)
        with caplog.at_level(logging.INFO, logger="cunvsm_torch.train.trainer"):
            straight = train_model(DESC, c, corpus, CPU, **kw)
    assert straight.steps == 4 * 19 == len(seen)
    for t, sim, _, _ in seen:
        want_ids, want_w = formula_pairs(ids, weights, c.seed, t)
        assert torch.equal(sim.ids, want_ids) and torch.equal(sim.weights, want_w), t
    lines = [r for r in caplog.records if r.msg.startswith("Epoch %d%s: cost")]
    # Passes begin at steps 0, 2, ..., 18 (10), 20, ..., 36 (9), ...
    assert [r.args[6] for r in lines] == [
        f"; {19 * B} similarity pairs, {n} passes begun" for n in (10, 9, 10, 9)]
    prefix = str(tmp_path / "m")
    train_model(DESC, composite_cfg(table, 2), corpus, CPU, output_prefix=prefix, **kw)
    with monkeypatch.context() as m:
        resumed_seen = recording_steps(m)
        resumed = train_model(DESC, c, corpus, CPU, output_prefix=prefix, resume=True, **kw)
    assert len(resumed_seen) == 38
    assert all(torch.equal(a[1].ids, b[1].ids) for a, b in zip(resumed_seen, seen[38:]))
    assert straight.epoch_costs[2:] == resumed.epoch_costs
    assert_same_state(straight, resumed)


@pytest.mark.parametrize("table", ["entity", "word"])
def test_on_device_steps_equal_host_fed_steps_fed_the_same_batches(table):
    """Two calls of K = 3 pooled steps with injected draws; then the
    host-fed step closure, from the same tables, fed each step's text batch
    (sampled from the same pointers and uniforms), the pair batch of the
    formula and the same pool: every cost and the final state equal bit for
    bit."""
    corpus, c, ids, weights, run, params, perm = runner_setup(table, "pooled")
    host = params.__class__(*(t.clone() for t in params))
    state, host_state = Optimizer(c).init(params), Optimizer(c).init(host)
    dc = tds.prepare_device_corpus(corpus, CPU)
    host_step = tstep.make_train_step(DESC, c, CPU, torch.Generator(),
                                      num_entities=corpus.num_docs)
    draws = injected_draws(corpus, "pooled", calls=2)
    for call in range(2):
        costs = run(params, state, perm, call * K * B, draws=draws[call])
        for i, d in enumerate(draws[call]):
            t = call * K + i
            te = tds.sample_batch(dc, B, docs=perm[t * B:(t + 1) * B], uniforms=d.uniforms)
            sim = SimilarityBatch(*formula_pairs(ids, weights, 5, t))
            cost = host_step(host, host_state, (te, sim), negative_ids=d.negative_ids)
            assert torch.equal(cost, costs[i])
    for a, b in zip(tuple(host) + tuple(x for s in host_state for x in s),
                    tuple(params) + tuple(x for s in state for x in s)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("path", ["on_device", "host_fed"])
def test_similarity_spans_counts_and_parents(path):
    corpus = small_corpus()
    ids, weights = pair_arrays(corpus, "entity")
    kw = dict(similarity_source=SimilaritySource(ids, weights, batch_size=B, seed=9))
    if path == "on_device":
        kw.update(on_device_sampling=True, steps_per_call=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        result = train_model(DESC, composite_cfg("entity", 2), corpus, CPU, **kw)
    events = [e for e in prof.events() if e.name.startswith("cunvsm.")]
    counts = collections.Counter(e.name for e in events)
    assert counts["cunvsm.step.similarity"] == counts["cunvsm.step.loss"] == result.steps == 38
    parents = {e.name: program_parent(e) for e in events
               if e.name.startswith(("cunvsm.similarity.", "cunvsm.step.similarity"))}
    assert parents.pop("cunvsm.step.similarity") == "cunvsm.step.cost_and_grads"
    if path == "on_device":
        # Passes begin at steps 0, 2, ..., 36.
        assert counts["cunvsm.similarity.permute"] == 19
        assert counts["cunvsm.similarity.batch"] == counts["cunvsm.sampler.batch"] == 38
        assert parents == {"cunvsm.similarity.permute": "cunvsm.trainer.call",
                           "cunvsm.similarity.batch": "cunvsm.trainer.call"}
    else:
        assert not parents


def test_a_composite_alone_is_refused_by_the_runner_without_pairs_and_text_with_them():
    corpus = small_corpus()
    dc = tds.prepare_device_corpus(corpus, CPU)
    ids, weights = pair_arrays(corpus, "entity")
    pairs = tds.DevicePairStream(ids, weights, B, 1, CPU)
    with pytest.raises(ValueError, match="needs a similarity pair stream"):
        tds.make_device_sampled_multistep(DESC, composite_cfg("entity"), dc, 2,
                                          torch.Generator())
    with pytest.raises(ValueError, match="only a composite"):
        tds.make_device_sampled_multistep(DESC, cfg(1), dc, 2, torch.Generator(), pairs=pairs)
