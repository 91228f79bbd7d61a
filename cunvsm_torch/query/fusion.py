"""Run fusion: QLM + NVSM ensembles (py/combine_runs.py rebuild).

Semantics replicated from the reference:

* per-query score normalization: standardize / minmax / none
  (combine_runs.py:37-70);
* combined score of a document = the *mean* of the weighted normalized
  scores across the runs that retrieved it (combine_runs.py:15-34 — note:
  a document present in only one run is averaged over one element);
* supervised mode: k-fold cross-validation over queries, grid-searching
  alpha in [0, 1) per fold on the train split and applying the fold-best
  alpha to the test split (combine_runs.py:135-178);
* unsupervised mode: fixed alpha over the union of query ids
  (combine_runs.py:179-188).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from cunvsm_torch.io.trec import Qrels, Run
from cunvsm_torch.query.metrics import average_precision


def _standardize(scores: np.ndarray) -> Callable[[float], float]:
    mean, std = float(np.mean(scores)), float(np.std(scores))
    return lambda s: (s - mean) / std if std else 0.0


def _minmax(scores: np.ndarray) -> Callable[[float], float]:
    lo, hi = float(np.min(scores)), float(np.max(scores))
    return lambda s: (s - lo) / (hi - lo) if hi > lo else 0.0


def _identity(scores: np.ndarray) -> Callable[[float], float]:
    return lambda s: s


SCORE_NORMALIZERS = {
    "standardize": _standardize,
    "minmax": _minmax,
    "none": _identity,
}


def compute_combined_run(
    runs: Sequence[Run],
    weights: Sequence[float],
    query_ids: Sequence[str],
    normalizer: str = "standardize",
) -> Run:
    norm_factory = SCORE_NORMALIZERS[normalizer]
    combined: Run = {}
    for qid in query_ids:
        scores_per_doc: Dict[str, List[float]] = {}
        for run, weight in zip(runs, weights):
            ranking = dict(run.get(qid, []))
            if not ranking:
                continue
            norm = norm_factory(np.asarray(list(ranking.values())))
            for docno, score in ranking.items():
                scores_per_doc.setdefault(docno, []).append(
                    weight * norm(score)
                )
        combined[qid] = sorted(
            (
                (docno, float(np.mean(vals)))
                for docno, vals in scores_per_doc.items()
            ),
            key=lambda x: -x[1],
        )
    return combined


def fuse_fixed_alpha(
    run_a: Run, run_b: Run, alpha: float, normalizer: str = "standardize"
) -> Run:
    """Unsupervised fusion: combined = mean(alpha*norm(a), (1-alpha)*norm(b))."""
    query_ids = sorted(set(run_a) | set(run_b))
    return compute_combined_run(
        [run_a, run_b], [alpha, 1.0 - alpha], query_ids, normalizer
    )


def fuse_cross_validated(
    run_a: Run,
    run_b: Run,
    qrels: Qrels,
    num_folds: int = 20,
    alpha_stepsize: float = 0.05,
    normalizer: str = "standardize",
    seed: int = 0,
) -> Run:
    """Supervised fusion: per-fold grid search of alpha on MAP."""
    rng = np.random.RandomState(seed)
    query_ids = list(qrels.keys())
    rng.shuffle(query_ids)
    num_folds = min(num_folds, len(query_ids))
    folds = np.array_split(np.arange(len(query_ids)), num_folds)

    def mean_ap(run: Run, qids: Sequence[str]) -> float:
        vals = [
            average_precision(run.get(q, []), qrels[q])
            for q in qids
            if q in qrels
        ]
        vals = [v for v in vals if v is not None]
        return sum(vals) / len(vals) if vals else 0.0

    out: Run = {}
    for fold_idx, test_idx in enumerate(folds):
        test_set = set(int(i) for i in test_idx)
        train_qids = [
            q for i, q in enumerate(query_ids) if i not in test_set
        ]
        test_qids = [q for i, q in enumerate(query_ids) if i in test_set]

        best = (-math.inf, 0.0)
        for alpha in np.arange(0.0, 1.0, alpha_stepsize):
            combined = compute_combined_run(
                [run_a, run_b], [alpha, 1.0 - alpha], train_qids, normalizer
            )
            best = max(best, (mean_ap(combined, train_qids), float(alpha)))

        _, best_alpha = best
        test_combined = compute_combined_run(
            [run_a, run_b],
            [best_alpha, 1.0 - best_alpha],
            test_qids,
            normalizer,
        )
        out.update(test_combined)
    return out


def _ap_grid(
    run_a: Run,
    lexical_runs: Sequence[Run],
    qrels: Qrels,
    query_ids: Sequence[str],
    alphas: np.ndarray,
    normalizer: str,
) -> Tuple[np.ndarray, np.ndarray]:
    """AP of ``fuse(run_a, lexical_runs[v], alphas[j])`` per query.

    Returns ``(ap, valid)`` with ``ap[i, v, j]`` the average precision of
    ``query_ids[i]`` under the (variant v, alpha j) fusion and ``valid[i]``
    False for queries with no relevant documents or no retrieved documents.
    Exactly matches ``average_precision(compute_combined_run(...))`` — the
    per-query AP is independent of any fold split, so it is computed once
    and the k-fold search becomes row/column means (the same factorization
    as scripts/fusion_study.cv_map_fast, generalized over variants).
    """
    norm_factory = SCORE_NORMALIZERS[normalizer]
    ap = np.zeros((len(query_ids), len(lexical_runs), len(alphas)))
    valid = np.zeros(len(query_ids), bool)
    for i, qid in enumerate(query_ids):
        rels = qrels.get(qid, {})
        num_rel = sum(1 for r in rels.values() if r > 0)
        ra = dict(run_a.get(qid, []))
        if ra:
            norm_a = norm_factory(np.asarray(list(ra.values())))
            na = {d: norm_a(s) for d, s in ra.items()}
        else:
            na = {}
        any_docs = False
        for v, run_b in enumerate(lexical_runs):
            rb = dict(run_b.get(qid, []))
            # compute_combined_run insertion order: run_a's docs first.
            docs = list(dict.fromkeys(list(ra) + list(rb)))
            if not docs or num_rel == 0:
                continue
            any_docs = True
            if rb:
                norm_b = norm_factory(np.asarray(list(rb.values())))
                nb = {d: norm_b(s) for d, s in rb.items()}
            else:
                nb = {}
            a = np.array([na.get(d, np.nan) for d in docs])
            b = np.array([nb.get(d, np.nan) for d in docs])
            in_a, in_b = ~np.isnan(a), ~np.isnan(b)
            denom = in_a.astype(float) + in_b.astype(float)
            a0, b0 = np.where(in_a, a, 0.0), np.where(in_b, b, 0.0)
            rel = np.array([rels.get(d, 0) > 0 for d in docs])
            # scores[j, d] for every alpha at once; stable argsort matches
            # the library's stable sort on -score.
            scores = (
                np.outer(alphas, a0) + np.outer(1.0 - alphas, b0)
            ) / denom[None, :]
            order = np.argsort(-scores, axis=1, kind="stable")
            rel_sorted = rel[order]
            hits = np.cumsum(rel_sorted, axis=1)
            ranks = np.arange(1, len(docs) + 1)[None, :]
            ap[i, v] = np.sum(
                np.where(rel_sorted, hits / ranks, 0.0), axis=1
            ) / num_rel
        valid[i] = any_docs and num_rel > 0
    return ap, valid


def fuse_cross_validated_grid(
    run_a: Run,
    lexical_runs: Dict[str, Run],
    qrels: Qrels,
    num_folds: int = 20,
    alpha_stepsize: float = 0.05,
    normalizer: str = "standardize",
    seed: int = 0,
) -> Tuple[Run, List[Dict[str, object]]]:
    """Supervised fusion with per-fold lexical-variant selection.

    The reference's combine_runs protocol cross-validates only the mixing
    weight alpha (combine_runs.py:135-178) against a FIXED lexical run; this
    extends the same k-fold grid search to jointly select WHICH lexical run
    (e.g. a PRF hyperparameter variant) and alpha on each fold's train
    queries, then scores the fold's test queries with the selection.  All
    hyperparameters are chosen on train folds only — the test queries of a
    fold never influence their own (variant, alpha) choice — so the
    resulting MAP is an honest estimate, unlike picking PRF settings on
    test MAP.  Fold assignment, normalization, score combination, and the
    largest-alpha tie-break match ``fuse_cross_validated`` exactly; variant
    ties break toward the lexicographically largest name.

    Returns the fused run plus a per-fold selection record.
    """
    rng = np.random.RandomState(seed)
    query_ids = list(qrels.keys())
    rng.shuffle(query_ids)
    num_folds = min(num_folds, len(query_ids))
    folds = np.array_split(np.arange(len(query_ids)), num_folds)

    names = sorted(lexical_runs)
    runs_b = [lexical_runs[n] for n in names]
    alphas = np.arange(0.0, 1.0, alpha_stepsize)
    ap, valid = _ap_grid(run_a, runs_b, qrels, query_ids, alphas, normalizer)

    out: Run = {}
    selections: List[Dict[str, object]] = []
    for fold_idx, test_idx in enumerate(folds):
        test_mask = np.zeros(len(query_ids), bool)
        test_mask[test_idx] = True
        train = valid & ~test_mask
        if train.any():
            means = ap[train].mean(axis=0)  # [num_variants, num_alphas]
            best = (-math.inf, -math.inf, "")
            for v, name in enumerate(names):
                for j, alpha in enumerate(alphas):
                    best = max(best, (means[v, j], float(alpha), name))
            _, best_alpha, best_name = best
        else:
            best_alpha, best_name = 0.0, names[0]
        test_qids = [query_ids[int(i)] for i in test_idx]
        out.update(
            compute_combined_run(
                [run_a, lexical_runs[best_name]],
                [best_alpha, 1.0 - best_alpha],
                test_qids,
                normalizer,
            )
        )
        selections.append(
            {"fold": fold_idx, "lexical": best_name, "alpha": best_alpha}
        )
    return out, selections
