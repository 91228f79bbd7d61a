"""The port's objectives against the JAX package, float64 on CPU.

Both packages score the same entity / pool / shared ids and similarity
pairs on the same inputs: the factored and the expanded per-instance
layouts (with and without the entity L2 normalizer and feature weights),
the rolled pool, batch-shared negatives, both similarity tables and the
weighted merge.  Cost, similarity probabilities, every SparseGrad field and
the transform gradients agree to rtol 1e-10 (the two differ only in the
order of float64 sums).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cunvsm_tpu.models import objectives as jobj
from cunvsm_torch.config import ModelDesc, Nonlinearity
from cunvsm_torch.models import objectives as tobj
from tests.torch_parity import (
    B, D_E, D_W, DESCS, K, N, both_batches, both_params, numpy_batch, numpy_params, to_np,
    twin,
)

torch.set_num_threads(1)

RTOL, ATOL = 1e-10, 1e-13


def assert_close(a, b):
    np.testing.assert_allclose(to_np(a), to_np(b), rtol=RTOL, atol=ATOL)


def assert_same_grads(jres, tres):
    jcost, jprobs, jg = jres
    tcost, tprobs, tg = tres
    assert_close(jcost, tcost)
    assert_close(jprobs, tprobs)
    assert len(jg.word) == len(tg.word) and len(jg.entity) == len(tg.entity)
    for jd, td in zip(jg.word + jg.entity, tg.word + tg.entity):
        assert_close(jd.grad, td.grad)
        np.testing.assert_array_equal(to_np(jd.indices), to_np(td.indices))
        assert (jd.weights is None) == (td.weights is None)
        if jd.weights is not None:
            assert_close(jd.weights, td.weights)
    assert_close(jg.transform_w, tg.transform_w)
    assert_close(jg.transform_b, tg.transform_b)


@pytest.mark.parametrize("desc_name", sorted(DESCS))
@pytest.mark.parametrize("uniform", [True, False])
def test_factored_per_instance_matches_jax(desc_name, uniform):
    desc = DESCS[desc_name]
    jp, tp = both_params(numpy_params(1))
    jb, tb = both_batches(numpy_batch(2, weighted=not uniform))
    rng = np.random.RandomState(3)
    ids = np.concatenate(
        [np.asarray(jb.labels)[:, None], rng.randint(0, N, (B, K))], axis=1
    ).astype(np.int32)
    jres = jobj.text_entity_cost_and_grads(
        jp, jb, jnp.asarray(ids), twin(desc), factored_entity_grads=True,
        uniform_feature_weights=uniform,
    )
    tres = tobj.text_entity_cost_and_grads(
        tp, tb, torch.from_numpy(ids).long(), desc, factored_entity_grads=True,
        uniform_feature_weights=uniform,
    )
    assert_same_grads(jres, tres)


@pytest.mark.parametrize("desc_name", sorted(DESCS))
@pytest.mark.parametrize("pool,stride", [(8, 3), (16, 1), (4, 1)])
def test_pooled_matches_jax(desc_name, pool, stride):
    desc = DESCS[desc_name]
    jp, tp = both_params(numpy_params(4))
    jb, tb = both_batches(numpy_batch(5, weighted=desc_name == "lse"))
    pool_ids = np.random.RandomState(6).randint(0, N, pool).astype(np.int32)
    jres = jobj.text_entity_cost_and_grads_pooled(
        jp, jb, jnp.asarray(pool_ids), K, twin(desc),
        uniform_feature_weights=desc_name != "lse", pool_stride=stride,
    )
    tres = tobj.text_entity_cost_and_grads_pooled(
        tp, tb, torch.from_numpy(pool_ids).long(), K, desc,
        uniform_feature_weights=desc_name != "lse", pool_stride=stride,
    )
    assert_same_grads(jres, tres)


def test_rolled_pool_ids_match_jax():
    pool_ids = np.random.RandomState(7).randint(0, N, 8).astype(np.int32)
    j = jobj.rolled_pool_negative_ids(jnp.asarray(pool_ids), B, K, stride=3)
    t = tobj.rolled_pool_negative_ids(torch.from_numpy(pool_ids).long(), B, K, stride=3)
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("stream", [None, "bfloat16"])
def test_gather_phrase_reprs_matches_jax(weighted, stream):
    np_params = numpy_params(8, dtype=np.float32)
    jb, tb = both_batches(numpy_batch(9, dtype=np.float32, weighted=weighted))
    table = np_params.word_reprs
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    if stream:
        jt, tt = jt.astype(jnp.bfloat16), tt.to(torch.bfloat16)
    j = jobj.gather_phrase_reprs(jt, jb.features, jb.feature_weights if weighted else None)
    t = tobj.gather_phrase_reprs(tt, tb.features, tb.feature_weights if weighted else None)
    assert t.dtype == torch.float32
    # float32 window sums in another order: a few ulp.
    np.testing.assert_allclose(to_np(j), to_np(t), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("window", [1, 10])
def test_gather_phrase_reprs_bfloat16_window_sums_match_the_benchmark_formula(window):
    """A bfloat16 table with bfloat16 window sums: the benchmark reference's
    phrase, rounded(rounded(sum) / W) with the sum in float32
    (``nvsm_bench/reference/train.py:loss``), within one bfloat16 ulp; both
    sum in float32, perhaps in other orders."""
    rng = np.random.RandomState(12)
    table = torch.from_numpy(rng.standard_normal((64, 300)).astype(np.float32))
    table = table.to(torch.bfloat16)
    features = torch.from_numpy(rng.randint(0, 64, (37, window)))
    got = tobj.gather_phrase_reprs(table, features, None, torch.bfloat16)
    summed = table.float()[features].sum(dim=1)
    want = (summed.to(torch.bfloat16).float() / window).to(torch.bfloat16).float()
    assert got.dtype == torch.float32
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=2.0 ** -126))) - 7)
    assert torch.all((got - want).abs() <= ulp)
    # Over a window of 10 the roundings are there to see; over 1 there are none.
    assert torch.equal(want, summed / window) == (window == 1)


@pytest.mark.parametrize("bias_negative_samples", [False, True])
@pytest.mark.parametrize("k", [1, 3, 10])
def test_nce_instance_weights_match_jax(bias_negative_samples, k):
    desc = ModelDesc(bias_negative_samples=bias_negative_samples)
    w = np.random.RandomState(10).uniform(0.5, 1.5, B)
    j = jobj.nce_instance_weights(jnp.asarray(w), k, twin(desc))
    t = tobj.nce_instance_weights(torch.from_numpy(w), k, desc)
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


def test_entity_l2_normalizer_is_not_silently_factored():
    """Asked for the factored layout with the entity L2 normalizer on, both
    packages return the expanded one (objectives.py:331 of the JAX package)."""
    desc = ModelDesc(word_repr_size=D_W, entity_repr_size=D_E, l2_normalize_entity_reprs=True)
    jp, tp = both_params(numpy_params(1))
    jb, tb = both_batches(numpy_batch(2))
    ids = _entity_ids(jb, 3)
    jres = jobj.text_entity_cost_and_grads(
        jp, jb, jnp.asarray(ids), twin(desc), factored_entity_grads=True)
    tres = tobj.text_entity_cost_and_grads(
        tp, tb, torch.from_numpy(ids).long(), desc, factored_entity_grads=True)
    assert tres[2].entity[0].indices.shape == (B * (K + 1), 1)
    assert_same_grads(jres, tres)


def _entity_ids(jb, seed):
    rng = np.random.RandomState(seed)
    return np.concatenate(
        [np.asarray(jb.labels)[:, None], rng.randint(0, N, (B, K))], axis=1
    ).astype(np.int32)


EXPANDED_DESCS = dict(
    DESCS,
    entity_l2=ModelDesc(word_repr_size=D_W, entity_repr_size=D_E,
                        nonlinearity=Nonlinearity.TANH, l2_normalize_entity_reprs=True),
    both_l2_bn=ModelDesc(word_repr_size=D_W, entity_repr_size=D_E, batch_normalization=True,
                         l2_normalize_phrase_reprs=True, l2_normalize_entity_reprs=True),
)


@pytest.mark.parametrize("desc_name", sorted(EXPANDED_DESCS))
@pytest.mark.parametrize("uniform", [True, False])
def test_expanded_per_instance_matches_jax(desc_name, uniform):
    """The expanded entity layout: one row per (instance, slot), window 1."""
    desc = EXPANDED_DESCS[desc_name]
    jp, tp = both_params(numpy_params(21))
    jb, tb = both_batches(numpy_batch(22, weighted=not uniform))
    ids = _entity_ids(jb, 23)
    jres = jobj.text_entity_cost_and_grads(
        jp, jb, jnp.asarray(ids), twin(desc), uniform_feature_weights=uniform)
    tres = tobj.text_entity_cost_and_grads(
        tp, tb, torch.from_numpy(ids).long(), desc, uniform_feature_weights=uniform)
    assert tres[2].entity[0].grad.shape == (B * (K + 1), D_E)
    assert_same_grads(jres, tres)


@pytest.mark.parametrize("desc_name", sorted(EXPANDED_DESCS))
def test_text_entity_cost_matches_jax(desc_name):
    desc = EXPANDED_DESCS[desc_name]
    jp, tp = both_params(numpy_params(24))
    jb, tb = both_batches(numpy_batch(25, weighted=True))
    ids = _entity_ids(jb, 26)
    jc, jprobs = jobj.text_entity_cost(jp, jb, jnp.asarray(ids), twin(desc))
    tc, tprobs = tobj.text_entity_cost(tp, tb, torch.from_numpy(ids).long(), desc)
    assert_close(jc, tc)
    assert_close(jprobs, tprobs)


@pytest.mark.parametrize("desc_name", sorted(DESCS))
@pytest.mark.parametrize("uniform", [True, False])
def test_shared_negatives_match_jax(desc_name, uniform):
    desc = DESCS[desc_name]
    jp, tp = both_params(numpy_params(27))
    jb, tb = both_batches(numpy_batch(28, weighted=not uniform))
    neg = np.random.RandomState(29).randint(0, N, K).astype(np.int32)
    jres = jobj.text_entity_cost_and_grads_shared(
        jp, jb, jnp.asarray(neg), twin(desc), uniform_feature_weights=uniform)
    tres = tobj.text_entity_cost_and_grads_shared(
        tp, tb, torch.from_numpy(neg).long(), desc, uniform_feature_weights=uniform)
    assert_same_grads(jres, tres)


def test_shared_negatives_refuse_the_entity_l2_normalizer():
    desc = EXPANDED_DESCS["entity_l2"]
    jp, tp = both_params(numpy_params(1))
    jb, tb = both_batches(numpy_batch(2))
    with pytest.raises(ValueError, match="l2_normalize_entity_reprs"):
        jobj.text_entity_cost_and_grads_shared(jp, jb, jnp.zeros(K, jnp.int32), twin(desc))
    with pytest.raises(ValueError, match="l2_normalize_entity_reprs"):
        tobj.text_entity_cost_and_grads_shared(tp, tb, torch.zeros(K, dtype=torch.long), desc)


def _similarity_batches(seed, rows):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, rows, (B, 2)).astype(np.int32)
    ids[0, 1] = ids[0, 0]  # a pair of one object with itself
    w = rng.uniform(0.5, 1.5, B)
    return (jobj.SimilarityBatch(jnp.asarray(ids), jnp.asarray(w)),
            tobj.SimilarityBatch(torch.from_numpy(ids).long(), torch.from_numpy(w)))


@pytest.mark.parametrize("table", ["word", "entity"])
@pytest.mark.parametrize("desc_name", ["nvsm", "unclipped"])
def test_similarity_matches_jax(table, desc_name):
    desc = DESCS[desc_name]
    np_params = numpy_params(30)
    arr = np_params.word_reprs if table == "word" else np_params.entity_reprs
    jb, tb = _similarity_batches(31, arr.shape[0])
    jc, jprobs, jd = jobj.similarity_cost_and_grads(jnp.asarray(arr), jb, twin(desc))
    tc, tprobs, td = tobj.similarity_cost_and_grads(torch.from_numpy(arr), tb, desc)
    assert_close(jc, tc)
    assert_close(jprobs, tprobs)
    assert_close(jd.grad, td.grad)
    np.testing.assert_array_equal(to_np(jd.indices), to_np(td.indices))
    assert jd.weights is None and td.weights is None
    jl = jobj.similarity_loss(jnp.asarray(arr)[jb.ids], jb.weights, twin(desc), 7.0)
    tl = tobj.similarity_loss(torch.from_numpy(arr)[tb.ids], tb.weights, desc, 7.0)
    for a, b in zip(jl, tl):
        assert_close(a, b)


def test_merge_ascent_grads_matches_jax():
    """Unequal weights; one constituent has no transform gradients and
    descriptors of one table only, as a similarity objective has."""
    jp, tp = both_params(numpy_params(32))
    jb, tb = both_batches(numpy_batch(33, weighted=True))
    ids = _entity_ids(jb, 34)
    desc = DESCS["nvsm"]
    _, _, jte = jobj.text_entity_cost_and_grads(jp, jb, jnp.asarray(ids), twin(desc))
    _, _, tte = tobj.text_entity_cost_and_grads(tp, tb, torch.from_numpy(ids).long(), desc)
    jsb, tsb = _similarity_batches(35, N)
    _, _, jsim = jobj.similarity_cost_and_grads(jp.entity_reprs, jsb, twin(desc))
    _, _, tsim = tobj.similarity_cost_and_grads(tp.entity_reprs, tsb, desc)
    jm = jobj.merge_ascent_grads(((jte, 0.7), (jobj.AscentGrads((), (jsim,), None, None), 0.2)))
    tm = tobj.merge_ascent_grads(((tte, 0.7), (tobj.AscentGrads((), (tsim,), None, None), 0.2)))
    assert len(tm.word) == 1 and len(tm.entity) == 2
    assert_same_grads((0.0, 0.0, jm), (0.0, 0.0, tm))
    np.testing.assert_allclose(to_np(tm.transform_w), to_np(tte.transform_w) * 0.7 / 0.9, rtol=1e-15)
    scaled = tobj.scale_sparse(tsim, 0.5)
    np.testing.assert_array_equal(scaled.grad.numpy(), tsim.grad.numpy() * 0.5)
    assert scaled.indices is tsim.indices
