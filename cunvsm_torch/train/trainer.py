"""Host-fed epoch loop for the TEXT_ENTITY objective.

A lean port of the host-fed path of ``cunvsm_tpu/train/trainer.py``: batches
come from ``data.instances.TextEntitySource`` on the host, each step runs on
``device``, and the per-step costs stay on the device until one read per
epoch.  HDF5 checkpoints, resume, on-device sampling and multi-device
training are not part of this package yet (ROADMAP queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from cunvsm_torch.config import ModelDesc, TrainConfig
from cunvsm_torch.data.corpus import Corpus
from cunvsm_torch.data.instances import FeatureWeighting, TextEntitySource, Weighting
from cunvsm_torch.models.objectives import TextEntityBatch
from cunvsm_torch.models.params import ModelParams, init_params
from cunvsm_torch.optim.updates import Optimizer, OptState
from cunvsm_torch.train.step import make_train_step


@dataclasses.dataclass
class TrainResult:
    params: ModelParams
    opt_state: OptState
    epoch_costs: List[float]
    steps: int


def train_model(
    desc: ModelDesc,
    cfg: TrainConfig,
    corpus: Corpus,
    device,
    feature_weighting: FeatureWeighting = FeatureWeighting.UNIFORM,
    weighting: Weighting = Weighting.AUTOMATIC,
    dtype=torch.float32,
) -> TrainResult:
    """Train a model over ``corpus`` for ``cfg.num_epochs`` epochs.

    Parameters are Glorot-initialized from a generator on ``device`` seeded
    with ``cfg.seed``, which then draws the negatives; the host batch order
    comes from ``cfg.seed`` as in the JAX package."""
    # UNIFORM feature weighting means every batch's feature_weights are all
    # ones: promise that statically so the step skips the multiply.
    if feature_weighting == FeatureWeighting.UNIFORM:
        cfg = dataclasses.replace(cfg, uniform_feature_weights=True)
    elif cfg.uniform_feature_weights:
        raise ValueError("uniform_feature_weights requires UNIFORM feature weighting")
    source = TextEntitySource(
        corpus,
        batch_size=cfg.batch_size,
        shuffle=not cfg.no_shuffle,
        weighting=weighting,
        feature_weighting=feature_weighting,
        seed=cfg.seed,
    )
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    params = init_params(
        generator, corpus.vocab.size, corpus.num_docs, desc, dtype=dtype, device=device
    )
    opt_state = Optimizer(cfg).init(params)
    step = make_train_step(desc, cfg, device, generator, num_entities=corpus.num_docs)

    epoch_costs: List[float] = []
    steps = 0
    for _ in range(cfg.num_epochs):
        costs = [
            step(params, opt_state, TextEntityBatch.from_numpy(b, device, dtype))
            for b in source.epoch_batches()
        ]
        steps += len(costs)
        # One host read per epoch.
        epoch_costs.append(float(torch.stack(costs).mean()) if costs else 0.0)
    return TrainResult(params, opt_state, epoch_costs, steps)
