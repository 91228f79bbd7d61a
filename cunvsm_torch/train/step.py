"""The TEXT_ENTITY training step: forward, backward and full_adam update.

Port of the TEXT_ENTITY path of ``cunvsm_tpu/train/step.py``.  The
negative-sampling resolution (``resolve_negative_sampling`` and its
constants) is copied unchanged, so both packages pick the same layout for
the same configuration.  The composite objectives, batch-shared negatives
and reference-RNG replay are not part of this package yet (ROADMAP.md
queue 1).
"""

from __future__ import annotations

from typing import Optional

import torch

from cunvsm_torch.config import AdamMode, ModelDesc, TrainConfig, UpdateMethod
from cunvsm_torch.models import objectives as obj
from cunvsm_torch.models.params import ModelParams
from cunvsm_torch.optim.updates import Optimizer, OptState


def _accumulate_only_optimizer(cfg: TrainConfig) -> bool:
    """True when the optimizer consumes entity descriptors only through
    dense accumulation (SGD scatter / full_adam segment-sum) — the factored
    rank-1 entity-gradient layout is exact there; the window-averaged
    statistics of Adagrad and sparse/dense-update Adam need the expanded
    per-update layout."""
    if cfg.update_method == UpdateMethod.SGD:
        return True
    return (
        cfg.update_method == UpdateMethod.ADAM
        and cfg.adam.mode == AdamMode.DENSE_UPDATE_DENSE_VARIANCE
    )


_AUTO_POOL_CANDIDATES = (2048, 1024, 512, 256, 128, 64)
# Auto-resolution is scale-aware: the rolled pool is selected only when it
# covers at most this fraction of the entity collection.  Measured quality
# at three collection scales (PERFORMANCE.md): at ~3% coverage (P=2048,
# 64k docs) pooled BEATS per-instance (+0.0097 MAP, t=+11.0), at 12.5%
# coverage (P=2048, 16k docs, round 5: 5+5 seeds,
# results/collection_scale_r5_16k.jsonl) it still wins (+0.0030, t=+3.4),
# as it does at ~20% coverage (P=12800 on 64k: +0.0034, t=+3.2); at
# >=100% coverage (P=2048, 1398-doc Cranfield) it loses a small but real
# -0.0044 (t~2.2).  The crossover therefore sits between 20% and 100%
# coverage; 0.25 keeps every measured winning regime pooled and resolves
# small collections to the reference-exact per-instance path (shrinking
# the pool instead measurably hurts at small scale — P=1024 gives up
# ~0.5% on Cranfield).
_AUTO_POOL_MAX_COVERAGE = 0.25


def resolve_negative_sampling(cfg: TrainConfig, desc: ModelDesc,
                              batch_size: int,
                              num_entities: Optional[int] = None):
    """Resolve (pool_size, pool_stride) for a concrete batch size.

    ``negative_pool_size=-1`` (the default) selects the TPU-native
    rolled-pool layout automatically — the largest candidate pool dividing
    the batch — whenever the mode's requirements hold (accumulate-only
    optimizer, no entity L2 normalization, no shared negatives) AND, when
    ``num_entities`` (the real entity-collection size) is known, the pool
    covers at most ``_AUTO_POOL_MAX_COVERAGE`` of the collection; the
    per-example loss is exactly the reference's either way, so the auto
    choice only changes the execution layout and the cross-instance
    correlation of the draws (quality table in PERFORMANCE.md).  Returns
    (0, 1) for per-instance sampling."""
    k = cfg.num_random_entities
    p = cfg.negative_pool_size
    if cfg.reference_rng:
        # Reference-RNG replay feeds host-drawn per-instance negatives;
        # pooled/shared layouts sample differently by construction.
        if cfg.shared_negatives or p > 0:
            raise ValueError(
                "reference_rng requires per-instance negative sampling "
                "(negative_pool_size 0 or -1, no shared_negatives)"
            )
        return 0, 1
    if p == -1:
        if (
            cfg.shared_negatives
            or not _accumulate_only_optimizer(cfg)
            or desc.l2_normalize_entity_reprs
        ):
            return 0, 1
        p = next(
            (c for c in _AUTO_POOL_CANDIDATES
             if batch_size % c == 0 and c >= k),
            0,
        )
        if (
            p
            and num_entities is not None
            and p > _AUTO_POOL_MAX_COVERAGE * num_entities
        ):
            return 0, 1
    if p <= 0:
        return 0, 1
    # Validate the explicit pool configuration up front: the stride search
    # below can never produce k distinct residues mod p when p < k (it
    # would spin forever), and the pooled objective itself requires the
    # batch divisible by the pool — surface both as clear errors here at
    # step-build time instead of deep inside the traced objective.
    if p < k:
        raise ValueError(
            f"negative_pool_size {p} < num_random_entities {k}: the pool "
            "must hold at least one slot per negative"
        )
    if batch_size % p != 0:
        raise ValueError(
            f"batch size {batch_size} not divisible by negative_pool_size {p}"
        )
    s = cfg.negative_pool_stride
    if s == 0:
        # About P // k, rounded up to odd (coprime with power-of-two
        # pools), adjusted until the k slots are distinct mod P.
        s = max(p // max(k, 1), 1)
        if s % 2 == 0:
            s += 1
        s %= p
        if s == 0:
            s = 1
        while len({(j * s) % p for j in range(k)}) != k:
            s += 2
    return p, s


def _dtype(name: Optional[str]) -> Optional[torch.dtype]:
    return None if name is None else getattr(torch, name)


def _text_entity_grads(
    params: ModelParams, batch: obj.TextEntityBatch, generator, device, desc,
    cfg, num_entities=None, negative_ids=None,
):
    """(cost, AscentGrads).  ``negative_ids`` replaces the draw from
    ``generator``: the [P] pool ids under the rolled-pool layout, the
    [B, k] per-instance negatives otherwise."""
    if cfg.shared_negatives:
        raise NotImplementedError(
            "batch-shared negatives are not ported yet (ROADMAP.md queue 1)"
        )
    num_entities = num_entities or params.num_entities
    pool, pool_stride = resolve_negative_sampling(
        cfg, desc, batch.features.shape[0], num_entities=num_entities
    )
    common = dict(
        stream_dtype=_dtype(cfg.resolved_stream_dtype()),
        uniform_feature_weights=cfg.uniform_feature_weights,
        window_sum_dtype=_dtype(cfg.resolved_window_sum_dtype()),
    )
    if pool:
        pool_ids = negative_ids
        if pool_ids is None:
            pool_ids = obj.sample_negative_pool(generator, num_entities, pool, device)
        cost, _, grads = obj.text_entity_cost_and_grads_pooled(
            params, batch, pool_ids, cfg.num_random_entities, desc,
            pool_stride=pool_stride, **common,
        )
        return cost, grads
    if negative_ids is None:
        entity_ids = obj.sample_negative_entities(
            generator, batch.labels, num_entities, cfg.num_random_entities
        )
    else:
        entity_ids = torch.cat([batch.labels[:, None], negative_ids], dim=1)
    cost, _, grads = obj.text_entity_cost_and_grads(
        params, batch, entity_ids, desc, **common
    )
    return cost, grads


def scaled_regularization_lambda(cfg: TrainConfig) -> float:
    """lambda / batch_size (intermediate_results.cu:126-129)."""
    return cfg.regularization_lambda / cfg.batch_size


def make_train_step(
    desc: ModelDesc,
    cfg: TrainConfig,
    device,
    generator: torch.Generator,
    num_entities: Optional[int] = None,
):
    """Build ``step(params, opt_state, batch, negative_ids=None) -> cost``.

    The step updates ``params`` and ``opt_state`` in place; that replaces
    the JAX package's buffer donation.  ``generator`` (on ``device``) draws
    the negatives unless ``negative_ids`` gives them (see
    ``_text_entity_grads``).  ``num_entities`` bounds the negative draws
    when the entity table is larger than the collection.  The returned cost
    is a 0-d tensor on ``device``; reading it waits for the step.
    """
    if cfg.entity_entity_weight != 0.0 or cfg.term_term_weight != 0.0:
        raise NotImplementedError(
            "composite objectives are not ported yet (ROADMAP.md queue 1)"
        )
    if cfg.reference_rng:
        raise NotImplementedError(
            "reference_rng replay is not ported yet (ROADMAP.md queue 1)"
        )
    optimizer = Optimizer(cfg)
    lr = cfg.resolved_learning_rate()
    lam = scaled_regularization_lambda(cfg)

    def step(params: ModelParams, opt_state: OptState, batch, negative_ids=None):
        cost, grads = _text_entity_grads(
            params, batch, generator, device, desc, cfg, num_entities,
            negative_ids,
        )
        optimizer.apply(params, opt_state, grads, lr, lam)
        return cost

    return step
