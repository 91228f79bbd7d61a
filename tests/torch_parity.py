"""Shared set-up for the differential tests of the PyTorch port.

The same inputs, made with numpy from a seed, go to the JAX package and to
``cunvsm_torch``; tests/conftest.py runs the JAX side on the CPU with x64,
and the port runs float64 on the CPU through its kernels' plain versions.
"""

import dataclasses
import enum

import jax.numpy as jnp
import numpy as np
import torch

import cunvsm_tpu.config as jconfig
from cunvsm_tpu.models import objectives as jobj
from cunvsm_tpu.models.params import ModelParams as JModelParams
from cunvsm_tpu.optim import updates as jupd
from cunvsm_tpu.train import step as jstep
from cunvsm_torch.config import (
    AdamConfig,
    AdamMode,
    ModelDesc,
    Nonlinearity,
    TrainConfig,
    UpdateMethod,
)
from cunvsm_torch.models import objectives as tobj
from cunvsm_torch.models.params import params_from_numpy

# Two to four dimensions short of the canonical configuration.
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
    "unclipped": ModelDesc(
        word_repr_size=D_W, entity_repr_size=D_E,
        nonlinearity=Nonlinearity.HARD_TANH, clip_sigmoid=False,
    ),
}


def train_config(**overrides) -> TrainConfig:
    kw = dict(
        batch_size=B, window_size=W, num_random_entities=K,
        update_method=UpdateMethod.ADAM,
        adam=AdamConfig(mode=AdamMode.DENSE_UPDATE_DENSE_VARIANCE),
        learning_rate=1e-2, regularization_lambda=1e-2,
    )
    kw.update(overrides)
    return TrainConfig(**kw)


def twin(obj):
    """The JAX package's counterpart of a port config object."""
    if dataclasses.is_dataclass(obj):
        cls = getattr(jconfig, type(obj).__name__)
        return cls(**{f.name: twin(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if isinstance(obj, enum.Enum):
        return getattr(jconfig, type(obj).__name__)(obj.value)
    return obj


def numpy_params(seed, dtype=np.float64, scale=0.5):
    rng = np.random.RandomState(seed)
    return JModelParams(
        word_reprs=rng.uniform(-scale, scale, (V, D_W)).astype(dtype),
        entity_reprs=rng.uniform(-scale, scale, (N, D_E)).astype(dtype),
        transform_w=rng.uniform(-scale, scale, (D_W, D_E)).astype(dtype),
        transform_b=rng.uniform(-0.1, 0.1, (D_E,)).astype(dtype),
    )


def both_params(np_params):
    """(JAX ModelParams, port ModelParams) holding copies of the arrays."""
    return (
        JModelParams(*(jnp.asarray(x) for x in np_params)),
        params_from_numpy(np_params),
    )


def numpy_batch(seed, dtype=np.float64, weighted=False):
    rng = np.random.RandomState(seed)
    fw = rng.uniform(0.5, 1.5, (B, W)) if weighted else np.ones((B, W))
    w = rng.uniform(0.5, 1.5, B) if weighted else np.ones(B)
    return dict(
        features=rng.randint(0, V, (B, W)).astype(np.int32),
        feature_weights=fw.astype(dtype),
        labels=rng.randint(0, N, B).astype(np.int32),
        weights=w.astype(dtype),
    )


def both_batches(np_batch):
    jb = jobj.TextEntityBatch(**{k: jnp.asarray(v) for k, v in np_batch.items()})
    tb = tobj.TextEntityBatch(
        features=torch.from_numpy(np_batch["features"]).long(),
        feature_weights=torch.from_numpy(np_batch["feature_weights"]),
        labels=torch.from_numpy(np_batch["labels"]).long(),
        weights=torch.from_numpy(np_batch["weights"]),
    )
    return jb, tb


def to_np(x):
    """A numpy array from a torch tensor or a jax array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def jax_train_step(jparams, jstate, jbatch, ids, pooled, desc, cfg, stride):
    """One JAX step (objective + Optimizer.apply) on the given negative
    ids: the [P] pool when ``pooled``, else [B, k] per instance."""
    jdesc, jcfg = twin(desc), twin(cfg)
    kw = dict(
        stream_dtype=jcfg.resolved_stream_dtype(),
        uniform_feature_weights=jcfg.uniform_feature_weights,
        window_sum_dtype=jcfg.resolved_window_sum_dtype(),
    )
    if pooled:
        cost, _, grads = jobj.text_entity_cost_and_grads_pooled(
            jparams, jbatch, jnp.asarray(ids), jcfg.num_random_entities, jdesc,
            pool_stride=stride, **kw
        )
    else:
        entity_ids = jnp.concatenate([jbatch.labels[:, None], jnp.asarray(ids)], axis=1)
        cost, _, grads = jobj.text_entity_cost_and_grads(
            jparams, jbatch, entity_ids, jdesc, factored_entity_grads=True, **kw
        )
    lam = jstep.scaled_regularization_lambda(jcfg, jstep.ObjectiveKind.TEXT_ENTITY)
    jparams, jstate = jupd.Optimizer(jcfg).apply(
        jparams, jstate, grads, jcfg.resolved_learning_rate(), lam
    )
    return jparams, jstate, cost
