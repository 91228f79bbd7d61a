"""Shared set-up of the card-only tests: the sizes, configurations and
seeded inputs of tests/torch_parity.py, without the JAX side."""

import numpy as np
import torch

from cunvsm_torch.config import (
    AdamConfig,
    AdamMode,
    ModelDesc,
    Nonlinearity,
    UPDATE_METHOD_NAMES,
    TrainConfig,
    UpdateMethod,
)
from cunvsm_torch.models import objectives as tobj
from cunvsm_torch.models.params import ModelParams, params_from_numpy
from cunvsm_torch.optim import updates as tupd
from cunvsm_torch.train import step as tstep

V, N, D_W, D_E, B, W, K = 64, 48, 12, 8, 32, 4, 3

DESCS = {
    "nvsm": ModelDesc(
        word_repr_size=D_W, entity_repr_size=D_E,
        nonlinearity=Nonlinearity.HARD_TANH, batch_normalization=True,
    ),
    "lse": ModelDesc(
        word_repr_size=D_W, entity_repr_size=D_E,
        nonlinearity=Nonlinearity.TANH, bias_negative_samples=True,
        l2_normalize_phrase_reprs=True,
    ),
}
ENTITY_L2 = ModelDesc(word_repr_size=D_W, entity_repr_size=D_E, nonlinearity=Nonlinearity.TANH,
                      batch_normalization=True, l2_normalize_entity_reprs=True)


def train_config(**overrides) -> TrainConfig:
    kw = dict(
        batch_size=B, window_size=W, num_random_entities=K,
        update_method=UpdateMethod.ADAM,
        adam=AdamConfig(mode=AdamMode.DENSE_UPDATE_DENSE_VARIANCE),
        learning_rate=1e-2, regularization_lambda=1e-2,
    )
    kw.update(overrides)
    return TrainConfig(**kw)


def optimizer_config(name, **overrides) -> TrainConfig:
    method, mode = UPDATE_METHOD_NAMES[name]
    return train_config(update_method=method, adam=AdamConfig(mode=mode) if mode else AdamConfig(),
                        **overrides)


def numpy_params(seed, scale=0.5, shapes=((V, D_W), (N, D_E), (D_W, D_E))):
    rng = np.random.RandomState(seed)
    return ModelParams(
        *(rng.uniform(-scale, scale, s) for s in shapes),
        rng.uniform(-0.1, 0.1, (shapes[2][1],)),
    )


def port_batch(seed, weighted=False):
    rng = np.random.RandomState(seed)
    fw = rng.uniform(0.5, 1.5, (B, W)) if weighted else np.ones((B, W))
    w = rng.uniform(0.5, 1.5, B) if weighted else np.ones(B)
    return tobj.TextEntityBatch(
        features=torch.from_numpy(rng.randint(0, V, (B, W))).long(),
        feature_weights=torch.from_numpy(fw),
        labels=torch.from_numpy(rng.randint(0, N, B)).long(),
        weights=torch.from_numpy(w),
    )


def similarity_batch(seed, rows):
    rng = np.random.RandomState(seed)
    return tobj.SimilarityBatch(torch.from_numpy(rng.randint(0, rows, (B, 2))).long(),
                                torch.from_numpy(rng.uniform(0.5, 1.5, B)))


def negative_ids(seed, desc, cfg):
    """Seeded negative ids in the form the step takes as ``negative_ids``:
    the [P] pool, the [k] shared draw, or [B, k] per instance."""
    rng = np.random.RandomState(seed)
    pool, _ = tstep.resolve_negative_sampling(cfg, desc, B, N)
    shape = (pool,) if pool else (K,) if cfg.shared_negatives else (B, K)
    return torch.from_numpy(rng.randint(0, N, shape)).long()


def to_np(t):
    return t.detach().double().cpu().numpy()


def batch_to(batch, device, dtype):
    if not hasattr(batch, "_fields"):
        return tuple(batch_to(b, device, dtype) for b in batch)
    return type(batch)(*(
        t if t is None else t.to(device, dtype) if t.dtype.is_floating_point else t.to(device)
        for t in batch
    ))


def assert_card_steps_match_cpu(card, desc, cfg, batches, ids, np_params):
    """Three steps of ``make_train_step`` in float32 on the card (the
    kernels) against the same steps in float64 on the CPU (the plain
    versions), the same ``ids`` injected: costs to rtol 1e-5, tables to
    atol 1e-4 (float32 rounding over three steps; duplicate ids add in no
    fixed order on the card)."""
    results = []
    for device, dtype in ((card, torch.float32), (torch.device("cpu"), torch.float64)):
        params = params_from_numpy(np_params, device, dtype)
        state = tupd.Optimizer(cfg).init(params)
        step = tstep.make_train_step(desc, cfg, device, None)
        costs = [float(step(params, state, batch_to(b, device, dtype), negative_ids=i.to(device)))
                 for b, i in zip(batches, ids)]
        results.append((np.array(costs), [to_np(t) for t in params]))
    (gc, gp), (cc, cp) = results
    np.testing.assert_allclose(gc, cc, rtol=1e-5)
    for g, c, before in zip(gp, cp, np_params):
        assert not np.array_equal(c, before)
        np.testing.assert_allclose(g, c, rtol=0, atol=1e-4)
