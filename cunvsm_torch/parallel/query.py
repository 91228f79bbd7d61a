"""Sharded query serving: the document-score product and a distributed
top-k merge.

Port of ``cunvsm_tpu/parallel/query.py``.  The L2-normalized document
matrix is sharded by rows over the mesh's model axis; every rank scores its
rows against the (replicated) projected queries and takes a local top-k,
and the global ranking is the top-k of the gathered candidates.  Each shard
contributes exactly min(k, shard rows) (score, global document id) pairs
per query to one all-gather of [Q, shards * k] scores and one of ids
(``topk_scores``, ``topk_ids`` in ``distributed.collective_log``): the full
[Q, D] score matrix never crosses ranks.  The ranks of the data axis hold
the same rows and compute the same ranking.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from cunvsm_torch.parallel.mesh import MODEL_AXIS, Mesh, pad_entities
from cunvsm_torch.parallel.mesh import shard_rows as cut_rows


def score_rows(q_norm: torch.Tensor, entity_norm: torch.Tensor) -> torch.Tensor:
    """[Q, D] float32 cosines of normalized queries (already in the
    matrix's dtype) against normalized document rows.  A bfloat16 matrix is
    read at half width and the products are summed in float32: on the card
    by ``torch.mm(..., out_dtype=torch.float32)``, on the CPU by widening
    both operands first (the product of two bfloat16 values is exact in
    float32)."""
    if entity_norm.dtype != torch.bfloat16:
        return q_norm @ entity_norm.T
    if entity_norm.is_cuda:
        return torch.mm(q_norm, entity_norm.T, out_dtype=torch.float32)
    return q_norm.to(torch.float32) @ entity_norm.to(torch.float32).T


def make_sharded_scorer(
    mesh: Mesh, entity_norm: torch.Tensor, top_k: int, num_docs: Optional[int] = None
):
    """A scorer over the row-sharded normalized document matrix.

    Returns ``(scorer, entity_shard)``; ``scorer(projected_queries)`` ->
    (scores [Q, k], document indices [Q, k]), global indices, best first,
    the same on every rank (a collective: every rank must call it).

    ``entity_norm`` is the full [num_docs, d] matrix (the same on every
    rank), of which this rank keeps its rows, or this rank's shard
    (``mesh.shard_rows``, or what a previous call returned); ``num_docs``,
    the true document count, must be passed with a shard, and masks the
    zero rows that pad the last shard.
    """
    n_shards = mesh.shape[MODEL_AXIS]
    if num_docs is None:
        num_docs = entity_norm.shape[0]
    k = min(top_k, num_docs)
    padded = pad_entities(num_docs, n_shards)
    shard_rows = padded // n_shards
    if entity_norm.shape[0] not in (num_docs, shard_rows):
        raise ValueError(
            f"entity matrix has {entity_norm.shape[0]} rows; expected "
            f"{num_docs} (the whole matrix) or {shard_rows} (this rank's "
            f"shard of {n_shards})"
        )
    if entity_norm.shape[0] != shard_rows:
        entity_norm = cut_rows(mesh, entity_norm, padded)
    local_k = min(k, shard_rows)
    first_row = mesh.model_index * shard_rows

    def scorer(q_norm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        # Local scoring and local top-k: [Q, shard_rows] stays on the rank.
        values, local_idx = torch.topk(score_rows(q_norm, entity_norm), local_k, dim=1)
        global_idx = local_idx + first_row
        # Mask the row padding so that it can never enter the merge.
        values = values.masked_fill(global_idx >= num_docs, float("-inf"))
        # The only traffic between shards: k candidates per shard per query.
        all_values = mesh.all_gather(values, MODEL_AXIS, "topk_scores", dim=1)
        all_idx = mesh.all_gather(global_idx, MODEL_AXIS, "topk_ids", dim=1)
        merged_values, merge_pos = torch.topk(all_values, k, dim=1)
        return merged_values, torch.gather(all_idx, 1, merge_pos)

    return scorer, entity_norm
