"""Finite-difference gradient checking (GradientCheckFn, gradient_check.cu).

Port of ``cunvsm_tpu/train/gradcheck.py``: central finite differences over
*every* scalar parameter, compared against the analytic ascent gradients of
``compute_cost_and_grads``, densified through the sparse descriptors'
scatter semantics.  The JAX package replays the negative samples by
passing the same PRNG key to every evaluation; here every evaluation
starts from the same state of the step's ``torch.Generator`` (the
RNG-state snapshot of model.cu:154-174), so the analytic gradients and
each ± evaluation score the same draws.  The generator is left in the
state it had before the check, so the training step that follows draws
what it would have drawn without the check.

Under a mesh (``mesh=``, a ``parallel.mesh.Mesh``; every rank calls the
check with its shards and its rows of the batch) the analytic gradients are
the mesh step's, put together into full tables on every rank: the word
gradient summed over the data axis, the entity descriptors (global on every
rank) scattered into the whole padded table, the padded rows cut off.  The
central differences are of the global cost: the single-device cost of the
fetched tables on the global batch (gathered over the data axis), which
every rank evaluates alike, as the JAX trainer checks the step of its
global arrays.  ``num_checked`` counts the full, unpadded tables.

Run on the CPU in float64 for float64 fidelity.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from cunvsm_torch.config import ModelDesc, TrainConfig
from cunvsm_torch.models.objectives import AscentGrads
from cunvsm_torch.models.params import ModelParams
from cunvsm_torch.optim.updates import _scatter_add
from cunvsm_torch.parallel.mesh import fetch_params
from cunvsm_torch.train.step import (
    ObjectiveKind,
    compute_cost_and_grads,
    make_optimized_cost_fn,
)


def densify_grads(params: ModelParams, grads: AscentGrads, mesh=None,
                  num_entities: Optional[int] = None) -> ModelParams:
    """Scatter sparse descriptors into dense per-table ascent gradients.
    Under a ``mesh`` (``params`` the rank's shards) the tables are the full
    ones, the same on every rank, with ``num_entities`` entity rows."""

    def dense(table, descs, rows):
        out = table.new_zeros((rows, *table.shape[1:]))
        for desc in descs:
            _scatter_add(out, desc, 1.0)
        return out

    word = dense(params.word_reprs, grads.word, params.word_reprs.shape[0])
    entity_rows = params.entity_reprs.shape[0] * (1 if mesh is None else mesh.model)
    entity = dense(params.entity_reprs, grads.entity, entity_rows)
    if mesh is not None:
        # A data group's word descriptors are its batch rows'; the entity
        # descriptors index global rows and are the same on every rank.
        word = mesh.all_reduce(word, "data", "gradcheck_word")
        entity = entity[:num_entities]
    return ModelParams(
        word_reprs=word,
        entity_reprs=entity,
        transform_w=(
            grads.transform_w if grads.transform_w is not None
            else torch.zeros_like(params.transform_w)
        ),
        transform_b=(
            grads.transform_b if grads.transform_b is not None
            else torch.zeros_like(params.transform_b)
        ),
    )


def _global_batch(mesh, batch):
    """The global batch from the data groups' rows, on every rank: each
    field gathered over the data axis (the rows' order is the data index's,
    as ``parallel.mesh.local_batch`` cut them)."""
    if isinstance(batch, tuple) and not hasattr(batch, "_fields"):
        return tuple(_global_batch(mesh, b) for b in batch)
    return type(batch)(*(
        None if t is None else mesh.all_gather(t, "data", "gradcheck_batch") for t in batch
    ))


def check_gradients(
    kind: ObjectiveKind,
    params: ModelParams,
    batch,
    generator: Optional[torch.Generator],
    device,
    desc: ModelDesc,
    cfg: TrainConfig,
    epsilon: float = 1e-6,
    rtol: float = 1e-4,
    atol: float = 1e-8,
    num_entities: Optional[int] = None,
    mesh=None,
) -> Tuple[int, float]:
    """Central-difference check of every parameter.

    Returns (num_checked, max_relative_error); raises AssertionError on
    disagreement.  The analytic gradients are *ascent* gradients while the
    cost function is the descent objective, so the expected relation is
    analytic = -(dcost/dtheta).  ``mesh``: see the module doc (every rank
    calls the check; ``num_entities``, the real entity count, is required).
    """
    state = generator.get_state() if generator is not None else None

    def replay():
        if state is not None:
            generator.set_state(state)

    cost_fn = make_optimized_cost_fn(desc, cfg, kind, device, generator)
    replay()
    _, grads = compute_cost_and_grads(
        kind, params, batch, generator, device, desc, cfg, num_entities, mesh=mesh
    )
    if mesh is not None:
        if not num_entities:
            raise ValueError("a check under a mesh needs num_entities, the real entity count")
        dense = densify_grads(params, grads, mesh, num_entities)
        params = fetch_params(mesh, params, num_entities)
        batch = _global_batch(mesh, batch)
    else:
        dense = densify_grads(params, grads)

    num_checked = 0
    max_rel_err = 0.0
    for leaf_idx, (p_leaf, g_leaf) in enumerate(zip(params, dense)):
        n = p_leaf.numel()
        numeric_descent = np.empty(n, np.float64)
        for i in range(n):
            costs = []
            for sign in (1.0, -1.0):
                leaf = p_leaf.clone()
                leaf.view(-1)[i] += sign * epsilon
                leaves = list(params)
                leaves[leaf_idx] = leaf
                replay()
                costs.append(float(cost_fn(ModelParams(*leaves), batch)))
            numeric_descent[i] = (costs[0] - costs[1]) / (2.0 * epsilon)
        expected = -numeric_descent  # ascent convention
        analytic = g_leaf.detach().cpu().to(torch.float64).numpy().reshape(-1)

        denom = np.maximum(np.maximum(np.abs(expected), np.abs(analytic)), 1e-12)
        rel_err = np.abs(expected - analytic) / denom
        ok = (np.abs(expected - analytic) <= atol) | (rel_err <= rtol)
        if not np.all(ok):
            i = int(np.argmax(np.where(ok, -np.inf, rel_err)))
            raise AssertionError(
                f"gradient mismatch at leaf {leaf_idx} flat idx {i}: "
                f"finite-diff(ascent)={expected[i]:.10g} "
                f"analytic={analytic[i]:.10g} rel_err={rel_err[i]:.3g}"
            )
        max_rel_err = max(max_rel_err, float(rel_err.max()))
        num_checked += n
    replay()
    return num_checked, max_rel_err
