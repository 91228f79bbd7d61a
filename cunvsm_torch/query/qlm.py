"""Query-likelihood lexical retrieval with PRF: the framework's own QLM side.

Copied from ``cunvsm_tpu.query.qlm`` (numpy and scipy), over this
package's ``Corpus``; the query CLI's exact-match prefilter uses
``build_qlm_index`` and ``tfidf_rank``.


The reference pipelines (rank-cranfield-collection.sh:83-95) generate their
lexical runs with external Indri tooling (`--smoothing_method jm|dirichlet`,
`--prf`); this module provides the equivalent ranker natively over the packed
corpus so the full index -> QLM + NVSM -> fusion pipeline runs standalone.

Scoring:
  * Jelinek-Mercer:  log p(t|d) = log((1-l) * tf/|d| + l * cf_t/|C|)
  * Dirichlet:       log p(t|d) = log((tf + mu * cf_t/|C|) / (|d| + mu))
  * PRF: RM3-style relevance model — estimate P(t|R) from the top fb_docs
    documents weighted by their query likelihood, keep fb_terms terms,
    interpolate with the original query (weight ``orig_weight``), re-rank.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse

from cunvsm_torch.data.corpus import Corpus


@dataclasses.dataclass
class QLMIndex:
    """Document-term count matrix over the packed corpus vocabulary."""

    doc_term: scipy.sparse.csr_matrix  # [num_docs, vocab] counts
    doc_lengths: np.ndarray  # [num_docs] in-vocab lengths
    collection_prob: np.ndarray  # [vocab] cf_t / |C|
    docnos: List[str]
    term_to_id: Dict[str, int]
    _doc_term_csc: Optional[scipy.sparse.csc_matrix] = None

    @property
    def avg_doc_length(self) -> float:
        return float(self.doc_lengths.mean())

    @property
    def doc_term_csc(self) -> scipy.sparse.csc_matrix:
        """Column-major view for per-term posting access (built lazily)."""
        if self._doc_term_csc is None:
            self._doc_term_csc = self.doc_term.tocsc()
        return self._doc_term_csc

    def postings(self, tid: int):
        """(doc_rows, term_frequencies) of one term — never densified."""
        csc = self.doc_term_csc
        lo, hi = csc.indptr[tid], csc.indptr[tid + 1]
        return csc.indices[lo:hi], csc.data[lo:hi]


def build_qlm_index(corpus: Corpus) -> QLMIndex:
    num_docs = corpus.num_docs
    vocab = corpus.vocab.size
    doc_ids = np.repeat(
        np.arange(num_docs, dtype=np.int64), corpus.doc_lengths
    )
    mat = scipy.sparse.coo_matrix(
        (
            np.ones(len(corpus.tokens), dtype=np.float64),
            (doc_ids, corpus.tokens.astype(np.int64)),
        ),
        shape=(num_docs, vocab),
    ).tocsr()
    cf = np.asarray(mat.sum(axis=0)).ravel()
    total = max(cf.sum(), 1.0)
    return QLMIndex(
        doc_term=mat,
        doc_lengths=np.asarray(mat.sum(axis=1)).ravel(),
        collection_prob=cf / total,
        docnos=list(corpus.docnos),
        term_to_id=dict(corpus.vocab.term_to_id),
    )


def _score_query_vector(
    index: QLMIndex,
    query_weights: Dict[int, float],
    smoothing: str,
    param: float,
) -> np.ndarray:
    """log-likelihood scores of every document for a weighted term vector.

    Decomposed for collection scale: a document with tf = 0 scores the
    smoothing background, which is closed-form (constant for JM; constant
    minus a shared log(|d| + mu) for Dirichlet), so only the *postings* of
    each query term are touched — no [num_docs] column is ever densified
    (the round-1 scaler's bottleneck at Robust04 scale).

      JM:        correction(t, d) = log(1 + (1-l) tf / (|d| l pc_t))
      Dirichlet: correction(t, d) = log(1 + tf / (mu pc_t))
    """
    num_docs = len(index.docnos)
    lengths = np.maximum(index.doc_lengths, 1.0)
    live = {t: w for t, w in query_weights.items()
            if index.collection_prob[t] > 0.0}
    if not live:
        return np.zeros(num_docs)

    if smoothing == "jm":
        base = sum(
            w * math.log(param * index.collection_prob[t])
            for t, w in live.items()
        )
        scores = np.full(num_docs, base)
        for tid, qw in live.items():
            rows, tf = index.postings(tid)
            pc = index.collection_prob[tid]
            scores[rows] += qw * np.log1p(
                (1.0 - param) * tf / (lengths[rows] * param * pc)
            )
    elif smoothing == "dirichlet":
        base = sum(
            w * math.log(param * index.collection_prob[t])
            for t, w in live.items()
        )
        total_w = sum(live.values())
        scores = base - total_w * np.log(index.doc_lengths + param)
        for tid, qw in live.items():
            rows, tf = index.postings(tid)
            pc = index.collection_prob[tid]
            scores[rows] += qw * np.log1p(tf / (param * pc))
    else:
        raise ValueError(f"unknown smoothing {smoothing}")
    return scores


def _query_term_weights(
    index: QLMIndex, terms: Sequence[str]
) -> Dict[int, float]:
    weights: Dict[int, float] = {}
    for t in terms:
        tid = index.term_to_id.get(t)
        if tid is not None:
            weights[tid] = weights.get(tid, 0.0) + 1.0
    return weights


def tfidf_rank(
    index: QLMIndex,
    query_terms: Sequence[str],
    top_k: int = 1000,
) -> List[Tuple[str, float]]:
    """TFIDF exact-match ranking (the pyndri TFIDFQueryEnvironment role used
    by --rerank_exact_matching_documents, py/query.py:186-205).

    Standard ltc-style scoring: tf * idf with idf = log(N / df); documents
    with no matching terms never appear.
    """
    qw = _query_term_weights(index, query_terms)
    if not qw:
        return []
    num_docs = len(index.docnos)
    scores = np.zeros(num_docs)
    matched = np.zeros(num_docs, dtype=bool)
    lengths = np.maximum(index.doc_lengths, 1.0)
    for tid, q_tf in qw.items():
        rows, tf = index.postings(tid)
        df = float(len(rows))
        if df == 0:
            continue
        idf = np.log(num_docs / df)
        scores[rows] += q_tf * idf * tf / lengths[rows]
        matched[rows] = True
    scores = np.where(matched, scores, -np.inf)
    order = _top_k_order(scores, top_k)
    return [
        (index.docnos[int(i)], float(scores[int(i)]))
        for i in order
        if matched[int(i)]
    ]


def _top_k_order(scores: np.ndarray, top_k: int) -> np.ndarray:
    """Descending order of the top_k scores (argpartition, not a full
    sort — O(N + k log k) at collection scale)."""
    k = min(top_k, len(scores))
    if k == len(scores):
        return np.argsort(-scores)
    cand = np.argpartition(-scores, k)[:k]
    return cand[np.argsort(-scores[cand])]


def qlm_rank(
    index: QLMIndex,
    queries: Dict[str, Sequence[str]],
    smoothing: str = "jm",
    param: Optional[float] = None,
    top_k: int = 1000,
    prf: bool = False,
    fb_docs: int = 10,
    fb_terms: int = 10,
    orig_weight: float = 0.5,
    prf_posterior: str = "rm1",
) -> Dict[str, List[Tuple[str, float]]]:
    """Rank all queries; param defaults: JM lambda=0.5, Dirichlet mu=avg len
    (the reference's 'auto' settings, TUTORIAL.md:55-58).

    ``prf_posterior`` selects the feedback-document posterior of the
    relevance model:

    * ``"rm1"`` (default): P(D) ∝ exp(sum_t qw_t log p(t|D)) — the query
      LIKELIHOOD, Lavrenko RM1's document weight.
    * ``"indri"``: P(D) ∝ exp(score / |q|) — a reconstruction of Indri's
      RMExpander (the lexical partner the reference's pipelines fuse
      against, rank-cranfield-collection.sh via PyndriQuery --prf): Indri
      exponentiates the retrieval engine's returned score, which for a
      #combine query is the MEAN of the per-term log probabilities, i.e.
      the geometric-mean likelihood — a flatter posterior over the
      feedback documents than RM1's product.  Everything else (tf/|D|
      gram weights, top-fbTerms truncation, #weight interpolation with
      the original query at fbOrigWeight) is identical.  Measured on
      Cranfield the reconstruction lands near Indri's published numbers
      (JM+PRF 0.4174 vs TUTORIAL.md 0.4163) — close, not bit-identical
      (the Indri binary is unavailable in this environment); see
      results/prf_variants_r5.json for the full variant study.
    """
    if param is None:
        param = 0.5 if smoothing == "jm" else index.avg_doc_length
    if prf_posterior not in ("rm1", "indri"):
        raise ValueError(f"unknown prf_posterior {prf_posterior!r}")

    run: Dict[str, List[Tuple[str, float]]] = {}
    for qid, terms in queries.items():
        qw = _query_term_weights(index, terms)
        if not qw:
            continue
        total_qw = sum(qw.values())
        scores = _score_query_vector(index, qw, smoothing, param)

        if prf:
            # Relevance model from the top fb_docs documents.
            order = _top_k_order(scores, fb_docs)
            doc_ll = scores[order]
            if prf_posterior == "indri":
                doc_ll = doc_ll / total_qw  # exp(#combine) geometric mean
            post = np.exp(doc_ll - doc_ll.max())
            post /= post.sum()
            rm = np.zeros(index.doc_term.shape[1])
            for w, d in zip(post, order):
                row = index.doc_term.getrow(int(d))
                length = max(index.doc_lengths[int(d)], 1.0)
                rm[row.indices] += w * row.data / length
            top_terms = np.argsort(-rm)[:fb_terms]
            rm_weights = {
                int(t): float(rm[t]) for t in top_terms if rm[t] > 0
            }
            total_rm = sum(rm_weights.values())
            # RM3 interpolation of normalized query and expansion models.
            expanded: Dict[int, float] = {}
            for t, w in qw.items():
                expanded[t] = orig_weight * w / total_qw
            for t, w in rm_weights.items():
                expanded[t] = expanded.get(t, 0.0) + (
                    (1.0 - orig_weight) * w / total_rm
                )
            scores = _score_query_vector(index, expanded, smoothing, param)

        order = _top_k_order(scores, top_k)
        run[qid] = [(index.docnos[int(i)], float(scores[int(i)])) for i in order]
    return run


# A-priori PRF hyperparameter grid for supervised per-fold selection
# (query/fusion.fuse_cross_validated_grid): a symmetric lattice around the
# Indri-style defaults fb_docs=10 / fb_terms=10 / orig_weight=0.5 the
# reference's pipelines use (rank-cranfield-collection.sh --prf).  The grid
# is fixed up front; WHICH cell is used is decided per CV fold on train
# queries only, so including it in a pipeline is supervised model selection,
# not test-set tuning.
PRF_GRID: Tuple[Tuple[int, int, float], ...] = tuple(
    (fb_docs, fb_terms, orig_weight)
    for fb_docs in (5, 10, 20)
    for fb_terms in (5, 10, 20, 50)
    for orig_weight in (0.3, 0.5, 0.7)
)


def prf_variant_runs(
    index: QLMIndex,
    queries: Dict[str, Sequence[str]],
    smoothing: str = "jm",
    param: Optional[float] = None,
    top_k: int = 1000,
    prf_posterior: str = "rm1",
    grid: Sequence[Tuple[int, int, float]] = PRF_GRID,
) -> Dict[str, Dict[str, List[Tuple[str, float]]]]:
    """One PRF run per grid cell, keyed ``prf_d{fb_docs}_t{fb_terms}_w{w}``.

    The runs are query-model artifacts (independent of any trained model),
    so a caller fusing many NVSM seeds computes them once.
    """
    return {
        f"prf_d{fb_docs}_t{fb_terms}_w{orig_weight:g}": qlm_rank(
            index, queries, smoothing=smoothing, param=param, top_k=top_k,
            prf=True, fb_docs=fb_docs, fb_terms=fb_terms,
            orig_weight=orig_weight, prf_posterior=prf_posterior,
        )
        for fb_docs, fb_terms, orig_weight in grid
    }
