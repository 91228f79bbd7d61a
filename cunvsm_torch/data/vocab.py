"""Vocabulary construction with the reference's filtering rules.

Replicates IndriSource's term-id mapping (data_indri.cpp:735-869):

* drop the null term, digit-only terms (unless ``include_digits``),
  blacklisted terms, and terms whose *corpus-wide* document frequency falls
  outside [min_document_frequency, max_document_frequency];
* keep the top ``max_vocabulary_size`` remaining terms by collection
  frequency (min-heap semantics, data_indri.cpp:791-809);
* when training on a document subset, final term frequencies are recomputed
  over that subset and zero-frequency terms dropped (data_indri.cpp:592-618,
  838-846);
* assign model term ids in ascending (collection_frequency, index_term_id)
  order (min-heap pop order, data_indri.cpp:825-856);
* model id 0 is the OOV token iff ``include_oov`` (frequency recorded as 1,
  data_indri.cpp:812-822).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cunvsm_torch.config import DataConfig
from cunvsm_torch.data.text import is_number


@dataclasses.dataclass
class Vocabulary:
    # model term id -> term string ('' for the OOV slot).
    terms: List[str]
    # term string -> model term id (OOV slot not included).
    term_to_id: Dict[str, int]
    # model term id -> collection frequency (over the kept documents).
    term_freq: np.ndarray
    # Sum of term_freq over real terms (data_indri.cpp:860-868).
    total_terms: int
    include_oov: bool
    # model term id -> "index term id" (first-occurrence rank in the corpus,
    # standing in for Indri's internal TERMID; used in checkpoint metadata).
    index_term_ids: np.ndarray

    @property
    def size(self) -> int:
        return len(self.terms)

    def self_information(self) -> np.ndarray:
        """Per-term -log(tf / total) weights (data.h:464-488)."""
        tf = np.maximum(self.term_freq.astype(np.float64), 1.0)
        return -np.log(tf / float(self.total_terms))


def build_vocabulary(
    all_doc_tokens: Sequence[Sequence[str]],
    cfg: DataConfig,
    kept_docs: Optional[Sequence[int]] = None,
    term_blacklist: Optional[frozenset] = None,
) -> Vocabulary:
    """Build the model vocabulary.

    ``all_doc_tokens``: every document in the corpus (document-frequency
    filters are corpus-wide, like Indri's vocabulary iterator).
    ``kept_docs``: indices of documents that will actually be trained on;
    final collection frequencies are restricted to them.
    """
    index_id: Dict[str, int] = {}
    df: Dict[str, int] = {}
    cf: Dict[str, int] = {}
    for tokens in all_doc_tokens:
        seen = set()
        for t in tokens:
            if t not in index_id:
                index_id[t] = len(index_id) + 1  # Indri term ids start at 1.
            cf[t] = cf.get(t, 0) + 1
            if t not in seen:
                seen.add(t)
                df[t] = df.get(t, 0) + 1

    num_docs = len(all_doc_tokens)
    max_df = cfg.max_document_frequency
    if 0 < max_df <= 1.0:
        # Relative cutoff resolved against the corpus size (main.cu:665-677).
        max_df = int(np.ceil(num_docs * max_df))
    max_df = int(max_df)

    candidates: List[Tuple[int, int, str]] = []
    for term, freq in cf.items():
        if not cfg.include_digits and is_number(term):
            continue
        if term_blacklist and term in term_blacklist:
            continue
        d = df[term]
        if cfg.min_document_frequency > 0 and d < cfg.min_document_frequency:
            continue
        if max_df > 0 and d > max_df:
            continue
        candidates.append((freq, index_id[term], term))

    # Top-K by collection frequency, ids assigned in min-heap pop order.
    candidates.sort()
    if cfg.max_vocabulary_size and len(candidates) > cfg.max_vocabulary_size:
        candidates = candidates[-cfg.max_vocabulary_size:]

    # Recompute frequencies over the kept-document subset if restricted.
    subset_cf = None
    if kept_docs is not None and len(kept_docs) != num_docs:
        subset_cf = {}
        for d_idx in kept_docs:
            for t in all_doc_tokens[d_idx]:
                subset_cf[t] = subset_cf.get(t, 0) + 1

    terms: List[str] = []
    index_ids: List[int] = []
    freqs: List[int] = []
    if cfg.include_oov:
        terms.append("")
        index_ids.append(0)
        freqs.append(1)
    for freq, iid, term in candidates:
        if subset_cf is not None:
            freq = subset_cf.get(term, 0)
            if freq == 0:
                continue  # data_indri.cpp:843-845
        terms.append(term)
        index_ids.append(iid)
        freqs.append(freq)

    term_to_id = {t: i for i, t in enumerate(terms) if t}
    total = sum(f for t, f in zip(terms, freqs) if t)
    return Vocabulary(
        terms=terms,
        term_to_id=term_to_id,
        term_freq=np.asarray(freqs, dtype=np.int64),
        total_terms=int(total),
        include_oov=cfg.include_oov,
        index_term_ids=np.asarray(index_ids, dtype=np.int64),
    )
