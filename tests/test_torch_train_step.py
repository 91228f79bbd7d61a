"""The port's training step against the JAX package.

Three steps of the JAX package (objective + Optimizer.apply, fed fixed
ids) against three steps of the port's ``make_train_step`` with the same
ids injected: all four tables, m, v and t agree to rtol 1e-9 / atol 1e-12
in float64 (the segment sums add in another order).  Every optimizer runs
three steps of both packages' ``make_train_step`` from a non-zero state on
the layout its configuration resolves to (rolled pool, factored or
expanded per-instance), as do the entity L2 normalizer and batch-shared
negatives, at rtol 1e-10 / atol 1e-12.  Under bfloat16 streams the two
frameworks round the window sums at different places, so one step is held
to rtol 2e-2 on the cost and 2e-2 of the max-abs on the dense
accumulations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cunvsm_tpu.models import objectives as jobj
from cunvsm_tpu.optim import updates as jupd
from cunvsm_tpu.train import step as jstep
from cunvsm_torch.config import (
    UPDATE_METHOD_NAMES,
    AdamConfig,
    AdamMode,
    ModelDesc,
    Nonlinearity,
    UpdateMethod,
)
from cunvsm_torch.optim import updates as tupd
from cunvsm_torch.train import step as tstep
from tests.torch_parity import (
    B, D_E, D_W, DESCS, K, N, assert_same_training, both_batches, both_params, jax_train_step,
    numpy_batch, numpy_params, optimizer_config, run_both_steps, to_np, train_config, twin,
)

torch.set_num_threads(1)


def _draw_ids(rng, pooled, pool):
    if pooled:
        return rng.randint(0, N, pool).astype(np.int32)
    return rng.randint(0, N, (B, K)).astype(np.int32)


@pytest.mark.parametrize("desc_name", ["nvsm", "lse"])
@pytest.mark.parametrize("pooled", [False, True])
def test_three_steps_match_jax(desc_name, pooled):
    desc = DESCS[desc_name]
    cfg = train_config(
        negative_pool_size=8 if pooled else 0,
        uniform_feature_weights=desc_name == "nvsm",
    )
    pool, stride = tstep.resolve_negative_sampling(cfg, desc, B, N)
    assert (pool > 0) == pooled
    assert (pool, stride) == jstep.resolve_negative_sampling(twin(cfg), twin(desc), B, N)
    jp, tp = both_params(numpy_params(11))
    jstate = jupd.Optimizer(twin(cfg)).init(jp)
    tstate = tupd.Optimizer(cfg).init(tp)
    step = tstep.make_train_step(desc, cfg, "cpu", torch.Generator().manual_seed(0))
    rng = np.random.RandomState(12)
    for i in range(3):
        jb, tb = both_batches(numpy_batch(20 + i, weighted=desc_name == "lse"))
        ids = _draw_ids(rng, pooled, pool)
        jp, jstate, jcost = jax_train_step(jp, jstate, jb, ids, pooled, desc, cfg, stride)
        tcost = step(tp, tstate, tb, negative_ids=torch.from_numpy(ids).long())
        np.testing.assert_allclose(float(tcost), float(jcost), rtol=1e-9)
    for j, t in zip(jp, tp):
        np.testing.assert_allclose(to_np(t), np.asarray(j), rtol=1e-9, atol=1e-12)
    for js, ts in zip(jstate, tstate):
        for j, t in zip(js, ts):
            if np.asarray(j).dtype.kind == "i":
                np.testing.assert_array_equal(to_np(t), np.asarray(j))
                assert int(t) == 4  # t starts at 1, three steps
            else:
                np.testing.assert_allclose(to_np(t), np.asarray(j), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("pooled", [False, True])
def test_bf16_streams_one_step_near_jax(pooled):
    desc = DESCS["nvsm"]
    cfg = train_config(
        negative_pool_size=8 if pooled else 0, stream_dtype="bfloat16",
        window_sum_dtype="bfloat16", uniform_feature_weights=True,
    )
    pool, stride = tstep.resolve_negative_sampling(cfg, desc, B, N)
    jp, tp = both_params(numpy_params(13, dtype=np.float32))
    jb, tb = both_batches(numpy_batch(14, dtype=np.float32))
    ids = _draw_ids(np.random.RandomState(15), pooled, pool)
    kw = dict(stream_dtype="bfloat16", uniform_feature_weights=True,
              window_sum_dtype="bfloat16")
    tkw = dict(stream_dtype=torch.bfloat16, uniform_feature_weights=True,
               window_sum_dtype=torch.bfloat16)
    tids = torch.from_numpy(ids).long()
    if pooled:
        jcost, _, jg = jobj.text_entity_cost_and_grads_pooled(
            jp, jb, jnp.asarray(ids), K, twin(desc), pool_stride=stride, **kw)
        tcost, _, tg = tstep.obj.text_entity_cost_and_grads_pooled(
            tp, tb, tids, K, desc, pool_stride=stride, **tkw)
    else:
        eids = np.concatenate([np.asarray(jb.labels)[:, None], ids], axis=1)
        jcost, _, jg = jobj.text_entity_cost_and_grads(
            jp, jb, jnp.asarray(eids), twin(desc), factored_entity_grads=True, **kw)
        tcost, _, tg = tstep.obj.text_entity_cost_and_grads(
            tp, tb, torch.cat([tb.labels[:, None], tids], 1), desc,
            factored_entity_grads=True, **tkw)
    assert tcost.dtype == torch.float32
    np.testing.assert_allclose(float(tcost), float(jcost), rtol=2e-2)
    for rows, jd, td in ((64, jg.word, tg.word), (N, jg.entity, tg.entity)):
        j = np.asarray(jupd._sorted_segment_accumulate(rows, jd, "bfloat16"))
        t = to_np(tupd._sorted_segment_accumulate(rows, td, torch.bfloat16))
        assert t.dtype == np.float32
        np.testing.assert_allclose(t, j, rtol=0, atol=2e-2 * np.abs(j).max())


@pytest.mark.parametrize("stream", [None, "bfloat16"])
def test_accumulation_matches_jax_on_same_descriptors(stream):
    """Duplicates accumulate; under a stream dtype rows and weights round
    before the product and widen before the sum."""
    rng = np.random.RandomState(16)
    grads = [rng.randn(B, 6).astype(np.float32), rng.randn(5, 6).astype(np.float32)]
    idx = [rng.randint(0, 9, (B, 3)).astype(np.int32), rng.randint(0, 9, (5, 1)).astype(np.int32)]
    wts = [rng.randn(B, 3).astype(np.float32), None]
    jd = tuple(jobj.SparseGrad(jnp.asarray(g), jnp.asarray(i), None if w is None else jnp.asarray(w))
               for g, i, w in zip(grads, idx, wts))
    td = tuple(tupd.SparseGrad(torch.from_numpy(g), torch.from_numpy(i).long(),
                               None if w is None else torch.from_numpy(w))
               for g, i, w in zip(grads, idx, wts))
    j = np.asarray(jupd._sorted_segment_accumulate(9, jd, stream))
    t = tupd._sorted_segment_accumulate(9, td, None if stream is None else torch.bfloat16).numpy()
    # float32 sums of the same (bf16-rounded) terms in another order.
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)


def test_bias_correction_matches_jax():
    for t in (1, 2, 10, 1000):
        j = jupd._adam_bias_correction(0.9, 0.999, jnp.asarray(t, jnp.int32), jnp.float64)
        p = tupd._adam_bias_correction(0.9, 0.999, torch.tensor(t, dtype=torch.int32), torch.float64)
        np.testing.assert_allclose(float(p), float(j), rtol=1e-15)


def test_opt_state_round_trips_through_numpy():
    jp, _ = both_params(numpy_params(17))
    cfg = train_config()
    jstate = jupd.Optimizer(twin(cfg)).init(jp)
    tstate = tupd.opt_state_from_numpy(jstate)
    assert tstate.word.t.dtype == torch.int32 and int(tstate.word.t) == 1
    back = tupd.opt_state_to_numpy(tstate)
    for js, bs in zip(jstate, back):
        for j, b in zip(js, bs):
            np.testing.assert_array_equal(b, np.asarray(j))


OPTIMIZERS = sorted(UPDATE_METHOD_NAMES)


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_every_optimizer_is_accepted(name):
    """``Optimizer(cfg)`` takes every method and mode; its state has the
    JAX package's types, shapes, dtypes and values."""
    cfg = optimizer_config(name)
    jp, tp = both_params(numpy_params(17))
    jstate = jupd.Optimizer(twin(cfg)).init(jp)
    tstate = tupd.Optimizer(cfg).init(tp)
    assert [type(s).__name__ for s in tstate] == [type(s).__name__ for s in jstate]
    for js, ts in zip(jstate, tstate):
        assert ts._fields == js._fields
        for j, t in zip(js, ts):
            assert to_np(t).dtype == np.asarray(j).dtype
            np.testing.assert_array_equal(to_np(t), np.asarray(j))


def _batches(seed, weighted, n=3):
    return [both_batches(numpy_batch(seed + i, weighted=weighted)) for i in range(n)]


@pytest.mark.parametrize("desc_name", ["nvsm", "lse"])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_every_optimizer_three_steps_match_jax(name, desc_name):
    """SGD takes the rolled pool (nvsm) or the factored per-instance path
    (lse); full_adam the factored per-instance path; Adagrad and sparse or
    dense-update Adam the expanded per-instance path."""
    desc = DESCS[desc_name]
    pool = 8 if name == "sgd" and desc_name == "nvsm" else 0
    cfg = optimizer_config(name, negative_pool_size=pool,
                           uniform_feature_weights=desc_name == "nvsm")
    assert tstep.resolve_negative_sampling(cfg, desc, B, N)[0] == pool
    result = run_both_steps(desc, cfg, _batches(40, desc_name == "lse"), numpy_params(41),
                            state_seed=42)
    assert_same_training(result, rtol=1e-10, atol=1e-12)


ENTITY_L2 = ModelDesc(word_repr_size=D_W, entity_repr_size=D_E, nonlinearity=Nonlinearity.TANH,
                      batch_normalization=True, l2_normalize_entity_reprs=True)


@pytest.mark.parametrize("name", ["full_adam", "sgd", "sparse_adam"])
def test_entity_l2_normalizer_steps_match_jax(name):
    """The normalizer forces the expanded per-instance layout, even for an
    accumulate-only optimizer and with the pool on auto."""
    cfg = optimizer_config(name, negative_pool_size=-1)
    result = run_both_steps(ENTITY_L2, cfg, _batches(43, True), numpy_params(44), state_seed=45)
    assert_same_training(result, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("name", ["full_adam", "sgd"])
@pytest.mark.parametrize("desc_name", ["nvsm", "lse"])
def test_shared_negatives_steps_match_jax(name, desc_name):
    cfg = optimizer_config(name, shared_negatives=True,
                           uniform_feature_weights=desc_name == "nvsm")
    result = run_both_steps(DESCS[desc_name], cfg, _batches(46, desc_name == "lse"),
                            numpy_params(47), state_seed=48)
    assert_same_training(result, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("overrides,desc,match", [
    (dict(shared_negatives=True, negative_pool_size=8), DESCS["nvsm"], "mutually exclusive"),
    (dict(shared_negatives=True, update_method=UpdateMethod.ADAGRAD), DESCS["nvsm"],
     "accumulate-only"),
    (dict(negative_pool_size=8, adam=AdamConfig(mode=AdamMode.SPARSE)), DESCS["nvsm"],
     "accumulate-only"),
    (dict(shared_negatives=True), ENTITY_L2, "l2_normalize_entity_reprs"),
])
def test_both_packages_refuse_the_same_negative_layouts(overrides, desc, match):
    cfg = train_config(**overrides)
    jp, tp = both_params(numpy_params(50))
    jb, tb = _batches(49, False, n=1)[0]
    with pytest.raises(ValueError, match=match):
        tstep.make_train_step(desc, cfg, "cpu", torch.Generator().manual_seed(0))(
            tp, tupd.Optimizer(cfg).init(tp), tb)
    with pytest.raises(ValueError, match=match):
        jstep.make_train_step(twin(desc), twin(cfg), jit=False)(
            jp, jupd.Optimizer(twin(cfg)).init(jp), jb, jax.random.PRNGKey(0))


def test_reference_rng_names_its_roadmap_item():
    """ROADMAP item 5 is ported: under reference_rng the step scores the
    batch's host-drawn negatives, as the JAX step does, with no generator;
    three steps of both packages agree to rtol 1e-10."""
    desc, cfg = DESCS["nvsm"], train_config(reference_rng=True)
    jrun = jstep.make_train_step(twin(desc), twin(cfg), jit=False)
    trun = tstep.make_train_step(desc, cfg, "cpu", None)
    jparams, tparams = both_params(numpy_params(61))
    jstate, tstate = jupd.Optimizer(twin(cfg)).init(jparams), tupd.Optimizer(cfg).init(tparams)
    rng = np.random.RandomState(62)
    for i in range(3):
        jb, tb = both_batches(numpy_batch(63 + i))
        negatives = rng.randint(0, N, (B, K)).astype(np.int32)
        jb = jb._replace(negatives=jnp.asarray(negatives))
        tb = tb._replace(negatives=torch.from_numpy(negatives).long())
        jparams, jstate, jc = jrun(jparams, jstate, jb, jax.random.PRNGKey(i))
        np.testing.assert_allclose(float(trun(tparams, tstate, tb)), float(jc), rtol=1e-10)
    for j, t in zip(jparams, tparams):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-10, atol=1e-13)


def test_sampled_step_draws_in_range_and_trains():
    """Without injected ids the step draws from its generator; the cost
    stays finite and the tables move."""
    desc = DESCS["nvsm"]
    for pool_size in (0, 8):
        cfg = train_config(negative_pool_size=pool_size, uniform_feature_weights=True)
        _, tp = both_params(numpy_params(18))
        before = tp.entity_reprs.clone()
        state = tupd.Optimizer(cfg).init(tp)
        step = tstep.make_train_step(desc, cfg, "cpu", torch.Generator().manual_seed(1))
        _, tb = both_batches(numpy_batch(19))
        for _ in range(2):
            assert torch.isfinite(step(tp, state, tb))
        assert not torch.equal(before, tp.entity_reprs)
