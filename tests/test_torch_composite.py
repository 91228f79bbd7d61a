"""The similarity objectives and the "Mix 'n Match" composites against the
JAX package, float64 on CPU.

* TEXT_ENTITY_ENTITY_ENTITY and TEXT_ENTITY_TERM_TERM at unequal mixture
  weights: three steps of both packages' ``make_train_step`` (the port fed
  the negatives JAX draws) from a non-zero state, for every optimizer that
  takes two descriptors of one table (sgd, dense_adam, full_adam) and on the
  rolled-pool and batch-shared layouts: costs, tables and state to rtol
  1e-10 / atol 1e-12;
* ENTITY_ENTITY and TERM_TERM alone, every optimizer, the same tolerance;
* Adagrad and sparse Adam refuse a composite in both packages (the second
  descriptor of one table);
* the reported cost (the mean of the constituents) and the optimized cost
  (sum_i w_i c_i / sum_i w_i) against JAX's to rtol 1e-12, and the merged
  ascent gradients against central finite differences of the optimized
  cost (step 1e-6, rtol 1e-6 / atol 1e-9 at float64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cunvsm_tpu.models import objectives as jobj
from cunvsm_tpu.train import step as jstep
from cunvsm_torch.config import UPDATE_METHOD_NAMES, ModelDesc, Nonlinearity
from cunvsm_torch.models import objectives as tobj
from cunvsm_torch.optim import updates as tupd
from cunvsm_torch.train import step as tstep
from tests.torch_parity import (
    B, D_E, D_W, DESCS, N, V, assert_same_training, both_batches,
    both_params, jax_draws, numpy_batch, numpy_params, optimizer_config, run_both_steps,
    train_config, twin,
)

torch.set_num_threads(1)

COMPOSITES = {
    "entity_entity": (jstep.ObjectiveKind.TEXT_ENTITY_ENTITY_ENTITY,
                      dict(text_entity_weight=0.7, entity_entity_weight=0.3), N),
    "term_term": (jstep.ObjectiveKind.TEXT_ENTITY_TERM_TERM,
                  dict(text_entity_weight=0.6, term_term_weight=0.4), V),
}


def sim_batches(seed, rows):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, rows, (B, 2)).astype(np.int32)
    w = rng.uniform(0.5, 1.5, B)
    return (jobj.SimilarityBatch(jnp.asarray(ids), jnp.asarray(w)),
            tobj.SimilarityBatch(torch.from_numpy(ids).long(), torch.from_numpy(w)))


def composite_batches(seed, rows, n=3, weighted=False):
    out = []
    for i in range(n):
        jte, tte = both_batches(numpy_batch(seed + i, weighted=weighted))
        jsim, tsim = sim_batches(seed + 50 + i, rows)
        out.append(((jte, jsim), (tte, tsim)))
    return out


def test_objective_kind_matches_jax():
    for kw in ({}, dict(entity_entity_weight=0.5), dict(term_term_weight=0.2),
               dict(text_entity_weight=0.0, term_term_weight=1.0)):
        cfg = train_config(**kw)
        assert tstep.objective_kind_from_config(cfg).value == \
            jstep.objective_kind_from_config(twin(cfg)).value
    assert [k.value for k in tstep.ObjectiveKind] == [k.value for k in jstep.ObjectiveKind]
    with pytest.raises(ValueError):
        tstep.objective_kind_from_config(train_config(entity_entity_weight=1.0,
                                                      term_term_weight=1.0))


@pytest.mark.parametrize("name", ["sgd", "dense_adam", "full_adam"])
@pytest.mark.parametrize("composite", sorted(COMPOSITES))
def test_composite_steps_match_jax(composite, name):
    kind, weights, rows = COMPOSITES[composite]
    cfg = optimizer_config(name, uniform_feature_weights=True, **weights)
    result = run_both_steps(DESCS["nvsm"], cfg, composite_batches(60, rows), numpy_params(61),
                            state_seed=62)
    assert_same_training(result, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("layout", [dict(negative_pool_size=8), dict(shared_negatives=True)])
@pytest.mark.parametrize("composite", sorted(COMPOSITES))
def test_composite_negative_layouts_match_jax(composite, layout):
    kind, weights, rows = COMPOSITES[composite]
    cfg = optimizer_config("full_adam", **weights, **layout)
    result = run_both_steps(DESCS["lse"], cfg, composite_batches(63, rows, weighted=True),
                            numpy_params(64), state_seed=65)
    assert_same_training(result, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("name", sorted(UPDATE_METHOD_NAMES))
@pytest.mark.parametrize("table", ["entity", "word"])
def test_similarity_steps_match_jax(table, name):
    kind = jstep.ObjectiveKind.ENTITY_ENTITY if table == "entity" else jstep.ObjectiveKind.TERM_TERM
    rows = N if table == "entity" else V
    batches = [sim_batches(66 + i, rows) for i in range(3)]
    result = run_both_steps(DESCS["nvsm"], optimizer_config(name), batches, numpy_params(67),
                            kind=kind, state_seed=68)
    assert_same_training(result, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("name", ["adagrad", "sparse_adam"])
@pytest.mark.parametrize("composite", sorted(COMPOSITES))
def test_sparse_modes_refuse_composites_in_both_packages(composite, name):
    kind, weights, rows = COMPOSITES[composite]
    cfg = optimizer_config(name, **weights)
    ((jb, tb),) = composite_batches(69, rows, n=1)
    jp, tp = both_params(numpy_params(70))
    jrun = jstep.make_train_step(twin(DESCS["nvsm"]), twin(cfg), jit=False)
    with pytest.raises(AssertionError, match="multiple gradients"):
        jrun(jp, jstep.Optimizer(twin(cfg)).init(jp), jb, jax.random.PRNGKey(0))
    trun = tstep.make_train_step(DESCS["nvsm"], cfg, "cpu", torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="multiple gradients"):
        trun(tp, tupd.Optimizer(cfg).init(tp), tb)


@pytest.mark.parametrize("composite", sorted(COMPOSITES))
def test_reported_and_optimized_costs_match_jax(composite):
    kind, weights, rows = COMPOSITES[composite]
    cfg = optimizer_config("full_adam", **weights)
    desc = DESCS["nvsm"]
    jp, tp = both_params(numpy_params(71))
    ((jb, tb),) = composite_batches(72, rows, n=1, weighted=True)
    key = jax.random.PRNGKey(5)
    ids = jax_draws(twin(cfg), twin(desc), key, jb[0].labels)
    tkind = tstep.ObjectiveKind(kind.value)
    for jmake, tmake in ((jstep.make_cost_fn, tstep.make_cost_fn),
                         (jstep.make_optimized_cost_fn, tstep.make_optimized_cost_fn)):
        j = jmake(twin(desc), twin(cfg), kind)(jp, jb, key)
        t = tmake(desc, cfg, tkind, "cpu")(tp, tb, negative_ids=ids)
        np.testing.assert_allclose(float(t), float(j), rtol=1e-12)
    # The two differ at unequal weights: the mean against w-weighted.
    reported = float(tstep.make_cost_fn(desc, cfg, tkind, "cpu")(tp, tb, negative_ids=ids))
    optimized = float(
        tstep.make_optimized_cost_fn(desc, cfg, tkind, "cpu")(tp, tb, negative_ids=ids))
    te, _ = tstep._text_entity_grads(tp, tb[0], None, "cpu", desc, cfg, negative_ids=ids)
    table = "entity" if composite == "entity_entity" else "word"
    sim, _ = tstep._similarity_grads(tp, tb[1], desc, table)
    w_te, w_sim = list(weights.values())
    np.testing.assert_allclose(reported, 0.5 * (float(te) + float(sim)), rtol=1e-14)
    np.testing.assert_allclose(optimized, (w_te * float(te) + w_sim * float(sim)) / (w_te + w_sim),
                               rtol=1e-14)
    assert abs(reported - optimized) > 1e-3


FD_DESC = ModelDesc(word_repr_size=D_W, entity_repr_size=D_E, nonlinearity=Nonlinearity.TANH,
                    batch_normalization=True)


@pytest.mark.parametrize("composite", sorted(COMPOSITES))
def test_optimized_cost_finite_differences_equal_merged_gradients(composite):
    """At unequal weights the merged ascent gradients are minus the
    gradient of the optimized cost, not of the reported one: central
    differences on 30 entries of each table."""
    kind, weights, rows = COMPOSITES[composite]
    cfg = optimizer_config("full_adam", **weights)
    tkind = tstep.ObjectiveKind(kind.value)
    _, tp = both_params(numpy_params(73, scale=0.3))
    ((_, tb),) = composite_batches(74, rows, n=1, weighted=True)
    ids = torch.from_numpy(np.random.RandomState(75).randint(0, N, (B, 3))).long()
    _, grads = tstep.compute_cost_and_grads(tkind, tp, tb, None, "cpu", FD_DESC, cfg,
                                            negative_ids=ids)
    analytic = [
        tupd._sorted_segment_accumulate(V, grads.word),
        tupd._sorted_segment_accumulate(N, grads.entity),
        grads.transform_w, grads.transform_b,
    ]
    cost = tstep.make_optimized_cost_fn(FD_DESC, cfg, tkind, "cpu")
    rng = np.random.RandomState(76)
    h = 1e-6
    for table, want in zip(tp, analytic):
        flat, want = table.view(-1), want.reshape(-1)
        touched = torch.nonzero(want).reshape(-1).numpy()
        picks = np.concatenate([rng.choice(touched, 20), rng.randint(0, flat.numel(), 10)])
        for i in picks:
            keep = float(flat[i])
            flat[i] = keep + h
            up = float(cost(tp, tb, negative_ids=ids))
            flat[i] = keep - h
            down = float(cost(tp, tb, negative_ids=ids))
            flat[i] = keep
            np.testing.assert_allclose(-(up - down) / (2 * h), float(want[i]), rtol=1e-6, atol=1e-9)
