"""Training steps on the card (float32, the kernels) against the same
steps of the port in float64 on the CPU (the plain versions)."""

import numpy as np
import pytest
import torch

from cunvsm_torch.config import UPDATE_METHOD_NAMES
from cunvsm_torch.models import objectives as tobj
from cunvsm_torch.models.params import ModelParams, params_from_numpy
from cunvsm_torch.optim import updates as tupd
from tests_card.card_parity import (
    DESCS, ENTITY_L2, N, V, assert_card_steps_match_cpu, negative_ids, numpy_params,
    optimizer_config, port_batch, similarity_batch, to_np,
)

NUM_WORDS, NUM_ENTITIES, D_W, D_E = 6, 4, 3, 2
OPTIMIZERS = sorted(UPDATE_METHOD_NAMES)
COMPOSITES = {
    "entity_entity": (dict(text_entity_weight=0.7, entity_entity_weight=0.3), N),
    "term_term": (dict(text_entity_weight=0.6, term_term_weight=0.4), V),
}


def small_params(seed):
    rng = np.random.RandomState(seed)
    return ModelParams(rng.randn(NUM_WORDS, D_W), rng.randn(NUM_ENTITIES, D_E),
                       rng.randn(D_W, D_E), rng.randn(D_E))


def small_grads(seed, device, dtype, window=2, num_instances=3):
    """Word descriptor with weights and duplicate indices within and
    across windows; entity descriptor weight-free, window 1."""
    rng = np.random.RandomState(seed + 50)

    def tensor(x):
        return torch.from_numpy(x).to(device, dtype)

    def index(x):
        return torch.from_numpy(x).long().to(device)

    return tobj.AscentGrads(
        word=(tobj.SparseGrad(tensor(rng.randn(num_instances, D_W)),
                              index(rng.randint(0, NUM_WORDS, (num_instances, window))),
                              tensor(rng.rand(num_instances, window) + 0.5)),),
        entity=(tobj.SparseGrad(tensor(rng.randn(num_instances, D_E)),
                                index(rng.randint(0, NUM_ENTITIES, (num_instances, 1))), None),),
        transform_w=tensor(rng.randn(D_W, D_E)),
        transform_b=tensor(rng.randn(D_E)),
    )


def nonzero_state(state, seed):
    """Every float leaf drawn from U(0.01, 0.5), every step counter 5."""
    rng = np.random.RandomState(seed)
    return type(state)(*(
        type(s)(*(
            rng.uniform(0.01, 0.5, tuple(t.shape)) if t.dtype.is_floating_point
            else np.full(tuple(t.shape), 5, np.int32)
            for t in s
        ))
        for s in state
    ))


@pytest.mark.cuda
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_three_steps_on_card_match_cpu(cuda, name):
    """Three float32 updates on the card (the sweep kernel under full_adam)
    against the same updates in float64 on the CPU, from the same non-zero
    state: duplicate indices add in no fixed order on the card, so rtol
    1e-5 / atol 1e-5 rather than bitwise."""
    cfg = optimizer_config(name, learning_rate=0.5, regularization_lambda=0.1)
    start = nonzero_state(tupd.Optimizer(cfg).init(params_from_numpy(small_params(13))), 14)
    results = []
    for device, dtype in ((cuda, torch.float32), (torch.device("cpu"), torch.float64)):
        tp = params_from_numpy(small_params(13), device, dtype)
        state = tupd.opt_state_from_numpy(start, device, dtype)
        for step in range(3):
            tupd.Optimizer(cfg).apply(tp, state, small_grads(20 + step, device, dtype), 0.5, 0.1)
        results.append(([to_np(t) for t in tp], tupd.opt_state_to_numpy(state)))
    (gp, gs), (cp, cs) = results
    for g, c in zip(gp, cp):
        np.testing.assert_allclose(g, c, rtol=1e-5, atol=1e-5)
    for g_sub, c_sub in zip(gs, cs):
        for g, c in zip(g_sub, c_sub):
            np.testing.assert_allclose(g.astype(np.float64), c, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["entity_l2", "shared"])
def test_full_adam_layouts_on_card_match_cpu(cuda, layout):
    """The expanded layout under the entity L2 normalizer and the
    batch-shared GEMM layout, with the sweep kernel on the card."""
    if layout == "entity_l2":
        desc, cfg = ENTITY_L2, optimizer_config("full_adam")
    else:
        desc, cfg = DESCS["lse"], optimizer_config("full_adam", shared_negatives=True)
    batches = [port_batch(51 + i, weighted=True) for i in range(3)]
    ids = [negative_ids(i, desc, cfg) for i in range(3)]
    assert_card_steps_match_cpu(cuda, desc, cfg, batches, ids, numpy_params(52))


@pytest.mark.cuda
@pytest.mark.parametrize("composite", sorted(COMPOSITES))
def test_composite_steps_on_card_match_cpu(cuda, composite):
    """full_adam on the rolled pool: the sweep and, under the default
    float32 streams, no cast."""
    weights, rows = COMPOSITES[composite]
    cfg = optimizer_config("full_adam", negative_pool_size=8, **weights)
    batches = [(port_batch(77 + i, weighted=True), similarity_batch(127 + i, rows))
               for i in range(3)]
    ids = [negative_ids(i, DESCS["lse"], cfg) for i in range(3)]
    assert_card_steps_match_cpu(cuda, DESCS["lse"], cfg, batches, ids, numpy_params(78))
