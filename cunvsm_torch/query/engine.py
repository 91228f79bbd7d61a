"""Query engine: rank documents by cosine similarity to projected queries.

Port of the single-device path of ``cunvsm_tpu/query/engine.py``.  The JAX
package ranks outside any Pallas kernel (one matmul and ``lax.top_k``), so
here it is ``torch.matmul`` and ``torch.topk`` over the L2-normalized
entity rows, in float32.

Query-side math (py/nvsm/base.py): the query representation is the
weighted *mean* of its in-vocabulary word vectors (normalized by the weight
sum, unlike training's division by the window); optional self-information
weights -log(tf/total); the projection is q @ W + bias_coefficient * b,
then the optional tanh; scores are cosine similarities.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cunvsm_torch.models.params import ModelParams


def _project_queries(query_reprs, transform_w, transform_b_scaled, nonlinearity):
    projected = query_reprs @ transform_w + transform_b_scaled[None, :]
    if nonlinearity == "tanh":
        projected = torch.tanh(projected)
    norms = torch.linalg.vector_norm(projected, dim=1, keepdim=True)
    return projected / torch.clamp(norms, min=1e-30)


def _rank_kernel(
    query_reprs: torch.Tensor,  # [Q, d_w]
    transform_w: torch.Tensor,
    transform_b_scaled: torch.Tensor,
    entity_norm: torch.Tensor,  # [D, d_e], rows L2-normalized, float32
    top_k: int,
    nonlinearity: Optional[str],
):
    """(scores, indices), each [Q, top_k], best first."""
    projected = _project_queries(
        query_reprs, transform_w, transform_b_scaled, nonlinearity
    )
    scores = projected.to(entity_norm.dtype) @ entity_norm.T  # [Q, D] cosines
    return torch.topk(scores, top_k, dim=1)


class QueryEngine:
    def __init__(
        self,
        params: ModelParams,
        terms: Sequence[str],
        docnos: Sequence[str],
        term_frequencies: Optional[np.ndarray] = None,
        total_terms: Optional[int] = None,
        nonlinearity: Optional[str] = "tanh",
        bias_coefficient: float = 0.0,
        self_information: bool = False,
        l2norm_phrase: bool = False,
    ):
        self.term_to_id: Dict[str, int] = {t: i for i, t in enumerate(terms) if t}
        self.docnos = list(docnos)
        self.term_frequencies = term_frequencies
        self.total_terms = total_terms
        self.nonlinearity = nonlinearity
        self.self_information = self_information
        self.l2norm_phrase = l2norm_phrase
        # Snapshots, like the JAX engine's immutable arrays: training that
        # goes on in place does not change a built engine.
        self.transform_w = params.transform_w.detach().clone()
        self._word_reprs_np = params.word_reprs.detach().cpu().numpy()
        self._bias_scaled = bias_coefficient * params.transform_b
        entity = params.entity_reprs.to(torch.float32)
        norms = torch.linalg.vector_norm(entity, dim=1, keepdim=True)
        self._entity_norm = entity / torch.clamp(norms, min=1e-30)

    def query_representation(
        self, query_terms: Sequence[str], strict: bool = False
    ) -> Optional[np.ndarray]:
        """Weighted mean of in-vocabulary term vectors (base.py:274-309)."""
        ids = [self.term_to_id[t] for t in query_terms if t in self.term_to_id]
        if not ids or (strict and len(ids) < len(query_terms)):
            return None
        vecs = self._word_reprs_np[ids]
        if self.self_information:
            if self.term_frequencies is None or not self.total_terms:
                raise ValueError("self_information needs term frequencies")
            w = -np.log(
                self.term_frequencies[ids].astype(np.float64) / self.total_terms
            )
            repr_ = np.average(vecs, axis=0, weights=w)
        else:
            repr_ = vecs.mean(axis=0)
        if self.l2norm_phrase:
            repr_ = repr_ / max(np.linalg.norm(repr_), 1e-30)
        return repr_

    def rank(
        self, queries: Dict[str, Sequence[str]], top_k: int = 1000
    ) -> Dict[str, List[Tuple[str, float]]]:
        """Rank all queries in one device call.

        Returns {query_id: [(docno, cosine_score), ...]} sorted descending;
        queries with no in-vocabulary terms are omitted (base.py:297-303).
        """
        qids: List[str] = []
        reprs: List[np.ndarray] = []
        for qid, terms in queries.items():
            r = self.query_representation(terms)
            if r is None:
                continue
            qids.append(qid)
            reprs.append(r)
        if not qids:
            return {}
        k = min(top_k, len(self.docnos))
        q = torch.as_tensor(
            np.stack(reprs), dtype=self.transform_w.dtype,
            device=self.transform_w.device,
        )
        scores, indices = _rank_kernel(
            q, self.transform_w, self._bias_scaled, self._entity_norm, k,
            self.nonlinearity,
        )
        scores = scores.cpu().numpy()
        indices = indices.cpu().numpy()
        return {
            qid: [
                (self.docnos[indices[i, j]], float(scores[i, j])) for j in range(k)
            ]
            for i, qid in enumerate(qids)
        }
