"""The port's TEXT_ENTITY objective against the JAX package, float64 on CPU.

Both packages score the same entity / pool ids on the same inputs; cost,
similarity probabilities, every SparseGrad field and the transform
gradients agree to rtol 1e-10 (the two differ only in the order of float64
sums).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cunvsm_tpu.models import objectives as jobj
from cunvsm_torch.config import ModelDesc
from cunvsm_torch.models import objectives as tobj
from tests.torch_parity import (
    B, DESCS, K, N, both_batches, both_params, numpy_batch, numpy_params, to_np,
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
        tp, tb, torch.from_numpy(ids).long(), desc,
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


@pytest.mark.parametrize("bias_negative_samples", [False, True])
@pytest.mark.parametrize("k", [1, 3, 10])
def test_nce_instance_weights_match_jax(bias_negative_samples, k):
    desc = ModelDesc(bias_negative_samples=bias_negative_samples)
    w = np.random.RandomState(10).uniform(0.5, 1.5, B)
    j = jobj.nce_instance_weights(jnp.asarray(w), k, twin(desc))
    t = tobj.nce_instance_weights(torch.from_numpy(w), k, desc)
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


def test_entity_l2_normalizer_is_not_silently_factored():
    desc = ModelDesc(l2_normalize_entity_reprs=True)
    _, tp = both_params(numpy_params(1))
    _, tb = both_batches(numpy_batch(2))
    ids = torch.zeros((B, K + 1), dtype=torch.long)
    with pytest.raises(NotImplementedError):
        tobj.text_entity_cost_and_grads(tp, tb, ids, desc)
