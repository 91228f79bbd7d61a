"""Query engine: rank documents by cosine similarity to projected queries.

Port of the single-device path of ``cunvsm_tpu/query/engine.py``.  The JAX
package ranks outside any Pallas kernel (one matmul and ``lax.top_k``), so
here it is ``torch.matmul`` and ``torch.topk`` over the L2-normalized
entity rows.  With ``score_dtype=torch.bfloat16`` the normalized matrix is
kept in bfloat16 and the queries are rounded to bfloat16, but the scores
are float32, as JAX's ``preferred_element_type=float32`` gives them, so a
bfloat16 result never rounds the scores and reorders near-ties.  On the card
the product reads the bfloat16 operands and writes float32
(``torch.mm(..., out_dtype=torch.float32)``, float32 accumulation); on the
CPU both operands are widened first (the product of two bfloat16 values is
exact in float32).

Query-side math (py/nvsm/base.py): the query representation is the
weighted *mean* of its in-vocabulary word vectors (normalized by the weight
sum, unlike training's division by the window); optional self-information
weights -log(tf/total); the projection is q @ W + bias_coefficient * b,
then the optional tanh; scores are cosine similarities.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cunvsm_torch.io import checkpoint as ckpt
from cunvsm_torch.models.params import ModelParams
from cunvsm_torch.parallel.mesh import pad_entities, shard_rows
from cunvsm_torch.parallel.query import make_sharded_scorer, score_rows


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
    entity_norm: torch.Tensor,  # [D, d_e], rows L2-normalized
    top_k: int,
    nonlinearity: Optional[str],
):
    """(scores, indices), each [Q, top_k], best first; float32 scores
    whatever the dtype of ``entity_norm``."""
    projected = _project_queries(
        query_reprs, transform_w, transform_b_scaled, nonlinearity
    )
    scores = score_rows(projected.to(entity_norm.dtype), entity_norm)  # [Q, D] cosines
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
        score_dtype: Optional[torch.dtype] = None,
        mesh=None,
    ):
        """``score_dtype=torch.bfloat16`` stores the normalized document
        matrix in bfloat16 (half the bytes the ranking reads); the scores
        stay float32 (see the module doc).

        ``mesh`` (a ``parallel.mesh.Mesh``) shards the normalized document
        matrix by rows over the model axis for ``rank``: ``params`` are the
        full tables, the same on every rank, each rank keeps its rows, and
        ``rank`` becomes a collective that every rank must call with the
        same queries.  A scorer is cached per ``top_k`` and the shard is
        cut once."""
        self.term_to_id: Dict[str, int] = {t: i for i, t in enumerate(terms) if t}
        self.docnos = list(docnos)
        self._docno_to_id: Dict[str, int] = {d: i for i, d in enumerate(self.docnos)}
        self.term_frequencies = term_frequencies
        self.total_terms = total_terms
        self.nonlinearity = nonlinearity
        self.self_information = self_information
        self.l2norm_phrase = l2norm_phrase
        # Snapshots, like the JAX engine's immutable arrays: training that
        # goes on in place does not change a built engine.
        # (A CPU tensor's ``.numpy()`` shares its memory, hence the copy.)
        self.transform_w = params.transform_w.detach().clone()
        self.transform_b = params.transform_b.detach().clone()
        self._word_reprs_np = params.word_reprs.detach().cpu().numpy().copy()
        self._bias_scaled = bias_coefficient * self.transform_b
        entity = params.entity_reprs.to(torch.float32)
        norms = torch.linalg.vector_norm(entity, dim=1, keepdim=True)
        self._entity_norm = (entity / torch.clamp(norms, min=1e-30)).to(
            score_dtype or torch.float32
        )
        self.mesh = mesh
        if mesh is not None:
            # Only this rank's rows are kept, zero-padded to an equal share.
            self._entity_norm = shard_rows(
                mesh, self._entity_norm, pad_entities(len(self.docnos), mesh.model)
            )
        self._sharded_scorers: Dict[int, object] = {}

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
        if self.mesh is not None:
            scores, indices = self._rank_sharded(q, k)
        else:
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

    def _rank_sharded(self, q: torch.Tensor, k: int):
        """Project on every rank, score and merge over the sharded matrix."""
        if k not in self._sharded_scorers:
            # ``_entity_norm`` is this rank's shard: the true document
            # count keeps its padding masked.
            self._sharded_scorers[k], _ = make_sharded_scorer(
                self.mesh, self._entity_norm, k, num_docs=len(self.docnos)
            )
        projected = _project_queries(
            q, self.transform_w, self._bias_scaled, self.nonlinearity
        )
        return self._sharded_scorers[k](projected.to(self._entity_norm.dtype))

    def score_documents(
        self, query_terms: Sequence[str], docnos: Sequence[str]
    ) -> Optional[List[Tuple[str, float]]]:
        """Cosine scores restricted to a document subset, best first (the
        brute-force path of qrel-restricted ranking, base.py:406-424);
        None for a query without in-vocabulary terms."""
        r = self.query_representation(query_terms)
        if r is None:
            return None
        ids = [self._docno_to_id[d] for d in docnos if d in self._docno_to_id]
        if not ids:
            return []
        proj = np.asarray(self.infer(r))
        proj = proj / max(np.linalg.norm(proj), 1e-30)
        # Quantized as rank() quantizes the queries, so that the subset
        # scores are rank()'s scores.
        proj = torch.from_numpy(proj).to(self._entity_norm.dtype).to(torch.float32).numpy()
        rows = torch.as_tensor(ids, device=self._entity_norm.device)
        if self.mesh is None:
            sub = self._entity_norm[rows]
        else:
            # The rows come from their owners (a collective).
            sub = self.mesh.gather_rows(self._entity_norm, rows, "document_rows")
        sub = sub.to(torch.float32).cpu().numpy()
        scores = sub @ proj
        order = np.argsort(-scores)
        return [(self.docnos[ids[i]], float(scores[i])) for i in order]

    def infer(self, query_repr: np.ndarray) -> np.ndarray:
        """Project a query representation into entity space
        (base.py:311-323)."""
        out = query_repr @ self.transform_w.cpu().numpy() + self._bias_scaled.cpu().numpy()
        if self.nonlinearity == "tanh":
            out = np.tanh(out)
        return out

    def related_terms(self, term: str, k: int = 10) -> List[Tuple[str, float]]:
        """Nearest terms by cosine in word space (base.py related_terms)."""
        if term not in self.term_to_id:
            return []
        ids = {i: t for t, i in self.term_to_id.items()}
        w = self._word_reprs_np
        q = w[self.term_to_id[term]]
        scores = (w @ q) / (
            np.linalg.norm(w, axis=1) * max(np.linalg.norm(q), 1e-30) + 1e-30
        )
        order = np.argsort(-scores)
        out = []
        for i in order:
            if i == self.term_to_id[term] or i not in ids:
                continue
            out.append((ids[int(i)], float(scores[i])))
            if len(out) == k:
                break
        return out

    def term_similarity(self, a: str, b: str) -> Optional[float]:
        if a not in self.term_to_id or b not in self.term_to_id:
            return None
        va = self._word_reprs_np[self.term_to_id[a]]
        vb = self._word_reprs_np[self.term_to_id[b]]
        return float(va @ vb / (np.linalg.norm(va) * np.linalg.norm(vb) + 1e-30))


class TermBruteforcer:
    """Inverse n-gram lookup: which term combinations project nearest to a
    given document-space vector (py/nvsm/base.py:106-162).

    Cardinality 1 covers the whole vocabulary, like the reference's brute
    force over every 1-gram: the word table goes through the transform in
    one [V, d_w] product on the engine's device, and a lookup is one
    [N, d_e] x [d_e] product and ``torch.topk`` there.  Cardinality >= 2
    grows combinatorially, so those combinations draw from a term universe
    capped at ``max_terms`` by collection frequency.  ``chip_smoke.py``
    (phase G3) prints the build and lookup times at V 65536, 300 -> 256
    with the card's name and power limit.
    """

    def __init__(
        self,
        engine: QueryEngine,
        max_ngram_cardinality: int = 1,
        max_terms: int = 4096,
    ):
        self.engine = engine
        w = engine._word_reprs_np
        # Full-vocabulary 1-grams, in model-id order.
        id_to_term = {i: t for t, i in engine.term_to_id.items()}
        vocab_ids = sorted(id_to_term)
        self.ngrams: List[tuple] = [(id_to_term[i],) for i in vocab_ids]
        reprs = [w[np.asarray(vocab_ids, dtype=np.int64)]]
        if max_ngram_cardinality >= 2:
            # Cap the cardinality>=2 term universe by collection frequency
            # (the terms a user would expect an inverse lookup to cover),
            # falling back to alphabetical order without frequencies.
            if engine.term_frequencies is not None:
                ranked = sorted(
                    engine.term_to_id,
                    key=lambda t: (
                        -int(engine.term_frequencies[engine.term_to_id[t]]),
                        t,
                    ),
                )
            else:
                ranked = sorted(engine.term_to_id)
            terms = ranked[:max_terms]
            term_ids = np.asarray([engine.term_to_id[t] for t in terms], dtype=np.int64)
            for k in range(2, max_ngram_cardinality + 1):
                # itertools.combinations' order; the mean of each
                # combination's rows, taken for all of them at once.
                combos = np.asarray(
                    list(itertools.combinations(range(len(terms)), k)), dtype=np.int64
                ).reshape(-1, k)
                if not len(combos):
                    continue
                self.ngrams.extend(tuple(terms[j] for j in c) for c in combos.tolist())
                reprs.append(w[term_ids[combos]].mean(axis=1))
        all_reprs = torch.as_tensor(
            np.concatenate(reprs, axis=0),
            dtype=engine.transform_w.dtype, device=engine.transform_w.device,
        )
        # One projection of every n-gram representation; the normalized
        # [N, d_e] table stays on the engine's device for the lookups.
        self._projected_norm = _project_queries(
            all_reprs, engine.transform_w, engine._bias_scaled, engine.nonlinearity
        )

    def nearest_ngrams(self, target: np.ndarray, k: int = 10):
        """Top-k n-grams whose projections are cosine-nearest to ``target``
        (a document-space vector, e.g. a document representation)."""
        t = np.asarray(target, dtype=np.float32)
        t = t / max(float(np.linalg.norm(t)), 1e-30)
        table = self._projected_norm
        scores, idx = torch.topk(
            table @ torch.as_tensor(t, dtype=table.dtype, device=table.device),
            min(k, len(self.ngrams)),
        )
        return [
            (self.ngrams[int(i)], float(s))
            for i, s in zip(idx.cpu().numpy(), scores.cpu().numpy())
        ]


def load_query_engine(prefix: str, epoch, device, **kwargs) -> QueryEngine:
    """A QueryEngine on ``device`` from ``<prefix>_<epoch>.hdf5``, the
    ``_meta`` term frequencies and the vocabulary and docno sidecars;
    ``mesh=`` and the other keywords go to ``QueryEngine``."""
    params = ckpt.load_model_hdf5(prefix, epoch, device)
    meta = ckpt.load_meta(prefix)
    terms = ckpt.load_strings(f"{prefix}_vocab.txt")
    docnos = ckpt.load_strings(f"{prefix}_docnos.txt")
    freqs = np.zeros(len(terms), dtype=np.int64)
    for t in meta.term:
        freqs[t.model_term_id] = t.term_frequency
    return QueryEngine(
        params, terms, docnos, term_frequencies=freqs, total_terms=meta.total_terms, **kwargs
    )
