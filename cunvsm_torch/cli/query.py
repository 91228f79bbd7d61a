"""cunvsm-torch-query: TREC run generation with the PyTorch port, the flag
surface and output of ``cunvsm-query`` (``cunvsm_tpu/cli/query.py``, the
rebuild of cuNVSMQuery / py/query.py).

All queries are ranked in one batched matmul and top-k on the device
(``query/engine.py``).  ``--device`` (default ``cuda``) takes the place of
the JAX package's ``--platform``.  ``--mesh DATAxMODEL`` shards the
normalized document matrix by rows over the model axis: one process per
device, launched like the train command (``--distributed`` under torchrun,
or the ``--coordinator_address`` triple), every process with the same
flags; each ranks its rows and the per-shard top-k candidates are merged
(``parallel/query.py``).  The primary alone writes the run.  ``--strict``
is parsed and, as in the JAX package's command, has no effect.

Usage:
    python -m cunvsm_torch.cli.query --topics topics.txt \\
        --model <prefix> --epoch N [--linear] [--top_k K|all|qrels] run_out
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import torch

from cunvsm_torch.cli.train import (
    add_device_flag,
    add_distributed_flags,
    join_process_group,
    mesh_from_flag,
)
from cunvsm_torch.config import DataConfig
from cunvsm_torch.data.corpus import Corpus, load_corpus
from cunvsm_torch.data.stemming import QueryStemmer, load_query_stemmer
from cunvsm_torch.data.text import load_stopwords, tokenize
from cunvsm_torch.io.trec import read_qrels, read_topics, write_run
from cunvsm_torch.query.engine import load_query_engine
from cunvsm_torch.query.qlm import build_qlm_index, tfidf_rank
from cunvsm_torch.parallel import distributed

RUN_NAME = "cunvsm_torch"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--loglevel", default="INFO")
    add_device_flag(p)
    p.add_argument("--topics", nargs="+", required=True)
    p.add_argument("--model", required=True, help="checkpoint prefix")
    p.add_argument("--epoch", required=True)
    p.add_argument("--linear", action="store_true", default=False,
                   help="no output nonlinearity (the NVSM query preset, "
                        "functions.sh:269-271)")
    p.add_argument("--self_information", action="store_true", default=False)
    p.add_argument("--l2norm_phrase", action="store_true", default=False)
    p.add_argument("--mesh", default=None,
                   help="Shard the document matrix for serving, as "
                        "'DATAxMODEL' (e.g. 1x4): each process scores its "
                        "rows and the top-k candidates are merged.")
    add_distributed_flags(p)
    p.add_argument("--score_dtype", choices=["float32", "bfloat16"], default="float32",
                   help="Document-matrix dtype for scoring; bfloat16 halves "
                        "the bytes the ranking reads, with float32 scores.")
    p.add_argument("--bias_coefficient", type=float, default=0.0)
    p.add_argument("--strict", action="store_true", default=False)
    p.add_argument("--rerank_exact_matching_documents", action="store_true", default=False,
                   help="Restrict each query's candidates to its top-1000 "
                        "TFIDF exact matches (py/query.py:186-205); "
                        "requires --corpus.")
    p.add_argument("--corpus", default=None,
                   help="Corpus path for the exact-match prefilter "
                        "(trectext/jsonl/packed .npz).")
    p.add_argument("--top_k", default=None,
                   help="int, 'all', or a qrels file restricting the "
                        "candidate documents per query")
    p.add_argument("--num_queries", type=int, default=None)
    p.add_argument("--stopwords", default=None)
    p.add_argument("--stemmer", default="auto",
                   help="Query-term stemmer: 'auto' (default) applies the "
                        "stemmer recorded in the checkpoint's "
                        "<prefix>_stemmer.txt sidecar, 'none' disables, or "
                        "'krovetz'/'porter' forces one (data/stemming.py).")
    p.add_argument("run_out")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = join_process_group(args)
    try:
        return _query(args, device)
    finally:
        distributed.shutdown()


def _write_run(run, path: str) -> None:
    """The primary alone writes; every rank holds the same run."""
    if distributed.is_primary():
        write_run(run, path, name=RUN_NAME)
        logging.info("Run with %d rankings written to %s.", len(run), path)


def _query(args, device) -> int:
    logging.basicConfig(level=args.loglevel if distributed.is_primary() else "WARNING")

    engine = load_query_engine(
        args.model,
        args.epoch,
        device,
        nonlinearity=None if args.linear else "tanh",
        bias_coefficient=args.bias_coefficient,
        self_information=args.self_information,
        l2norm_phrase=args.l2norm_phrase,
        score_dtype=torch.bfloat16 if args.score_dtype == "bfloat16" else None,
        mesh=mesh_from_flag(args.mesh),
    )
    logging.info("Loaded model: %d terms, %d documents.",
                 len(engine.term_to_id), len(engine.docnos))

    stopwords = load_stopwords(args.stopwords)
    # With several topic files the reference writes one run per file,
    # suffixed with the file's basename (query.py:170-173).
    per_file = len(args.topics) > 1
    topics = {}
    for path in args.topics:
        file_topics = read_topics(path)
        if args.num_queries is not None:
            file_topics = dict(list(file_topics.items())[: args.num_queries])
        if per_file:
            suffix = os.path.basename(path)
            file_topics = {(qid, suffix): text for qid, text in file_topics.items()}
        topics.update(file_topics)
    logging.info("Loaded %d topics.", len(topics))

    # Stemmed repositories hold stemmed vocabulary strings: apply the
    # recorded indexing-time stemmer to the query tokens.
    if args.stemmer == "auto":
        stemmer = load_query_stemmer(args.model, engine.term_to_id)
    elif args.stemmer == "none":
        stemmer = QueryStemmer(None)
    else:
        stemmer = QueryStemmer(args.stemmer, engine.term_to_id)
    if stemmer.name:
        logging.info("Query stemming: %s.", stemmer.name)

    tokenized = {
        qid: stemmer.stem_tokens(tokenize(text, stopwords))
        for qid, text in topics.items()
    }

    # top_k modes: int | 'all' | qrels-file document sets (query.py:118-139).
    qrel_sets = None
    if args.top_k is None:
        top_k = 1000
    elif args.top_k == "all":
        top_k = len(engine.docnos)
    else:
        try:
            top_k = int(args.top_k)
        except ValueError:
            qrel_sets = read_qrels(args.top_k)
            top_k = None

    if args.rerank_exact_matching_documents:
        # TFIDF prefilter over the corpus: each query's candidate set is its
        # top-1000 exact-matching documents (query.py:186-205).
        if not args.corpus:
            print("--rerank_exact_matching_documents requires --corpus", file=sys.stderr)
            return 1
        if args.corpus.endswith(".npz"):
            # The prefilter does not depend on the packed corpus's window.
            corpus = Corpus.load(args.corpus)
        else:
            corpus = load_corpus(
                DataConfig(corpus_path=args.corpus, max_vocabulary_size=0,
                           min_document_frequency=0, max_document_frequency=0),
                window_size=1,
                stopword_path=args.stopwords,
            )
        qlm_index = build_qlm_index(corpus)
        qrel_sets = {
            qid: {d: 1 for d, _ in tfidf_rank(qlm_index, terms, 1000)}
            for qid, terms in tokenized.items()
        }

    if qrel_sets is None:
        run = engine.rank(tokenized, top_k=top_k)
    else:
        run = {}
        for qid, terms in tokenized.items():
            key = qid[0] if isinstance(qid, tuple) else qid
            # The exact-match prefilter keys by the tokenized-dict key; a
            # qrels file keys by the plain topic id.
            docnos = list(qrel_sets.get(qid) or qrel_sets.get(key, {}))
            if not docnos:
                continue
            scored = engine.score_documents(terms, docnos)
            if scored is not None:
                run[qid] = scored

    if per_file:
        for path in args.topics:
            suffix = os.path.basename(path)
            sub_run = {
                qid[0]: ranked for qid, ranked in run.items()
                if isinstance(qid, tuple) and qid[1] == suffix
            }
            _write_run(sub_run, f"{args.run_out}-{suffix}")
    else:
        _write_run(run, args.run_out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
