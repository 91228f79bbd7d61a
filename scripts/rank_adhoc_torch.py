#!/usr/bin/env python3
"""TREC ad-hoc evaluation protocol over validation/test topic splits, on
the PyTorch port (``cunvsm_torch``): the TOIS 2018 §3.3 Robust04 protocol
of ``scripts/rank_adhoc.py``, with its flags, semantics and output files.

Trains NVSM, ranks every validated epoch's tables on the validation
topics, selects the best epoch by validation MAP, and reports test MAP at
that epoch, plus the QLM (Jelinek-Mercer and Dirichlet, with pseudo
relevance feedback) test MAPs and their alpha = 0.5 fusions with NVSM.

    python3 scripts/rank_adhoc_torch.py --corpus robust04.trectext \\
        --topics topics.txt --qrels qrels.txt --splits <adhoc-splits dir> \\
        --workdir robust04_run [--num_epochs 100] [--device cpu]
    torchrun --nproc_per_node 4 scripts/rank_adhoc_torch.py ... \\
        --distributed --mesh 2x2 [--on_device_sampling --shard_corpus]

The corpus is a TRECTEXT file, a packed ``.npz`` or an Indri repository
(several indexes too).  ``--device`` (default ``cuda``) takes the place of
``--platform``; a run without a card fails unless it is given ``--device
cpu``.  A mesh run is one process per device, started with the launch
flags of ``cunvsm-torch-train`` (``--distributed`` under torchrun, or
``--coordinator_address/--num_processes/--process_id``).

Validation runs every ``--eval_every`` epochs (and at the last) inside the
trainer's epoch callback, once that epoch's checkpoint is on disk; under a
mesh every rank first fetches the full tables from the shards (a
collective) and computes the same MAP, so every rank selects the same best
epoch.  The primary alone appends to ``validation_curve.jsonl`` in the
workdir, which a ``--resume`` run keeps (the best epoch may come from
before a crash) and a fresh run removes.  ``--fail_after_epoch N`` raises
after epoch N's validation on every rank, so no rank is left waiting for
another.  ``results.json`` (written by the primary) has the keys of the
JAX script's.
"""

import argparse
import json
import logging
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from cunvsm_torch.cli.train import (  # noqa: E402
    add_device_flag,
    add_distributed_flags,
    join_process_group,
    mesh_from_flag,
)
from cunvsm_torch.config import (  # noqa: E402
    AdamConfig,
    AdamMode,
    DataConfig,
    ModelDesc,
    Nonlinearity,
    TrainConfig,
    UpdateMethod,
)
from cunvsm_torch.data.corpus import load_corpus  # noqa: E402
from cunvsm_torch.data.stemming import QueryStemmer  # noqa: E402
from cunvsm_torch.data.text import lemur_stopwords, load_stopwords, tokenize  # noqa: E402
from cunvsm_torch.io.trec import read_qrels, read_topics, write_run  # noqa: E402
from cunvsm_torch.parallel import distributed  # noqa: E402
from cunvsm_torch.parallel.mesh import fetch_params  # noqa: E402
from cunvsm_torch.query.engine import QueryEngine, load_query_engine  # noqa: E402
from cunvsm_torch.query.fusion import fuse_fixed_alpha  # noqa: E402
from cunvsm_torch.query.metrics import evaluate_run  # noqa: E402
from cunvsm_torch.query.qlm import build_qlm_index, qlm_rank  # noqa: E402
from cunvsm_torch.train.trainer import train_model  # noqa: E402

WINDOW = 10


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    p.add_argument("--corpus", required=True)
    p.add_argument("--topics", required=True)
    p.add_argument("--qrels", required=True)
    p.add_argument("--splits", required=True,
                   help="directory with 'validation' and 'test' topic-id lists")
    p.add_argument("--workdir", required=True)
    p.add_argument("--num_epochs", type=int, default=100)
    p.add_argument("--eval_every", type=int, default=5,
                   help="validate every N epochs")
    p.add_argument("--word_repr_size", type=int, default=300)
    p.add_argument("--entity_repr_size", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=51200)
    p.add_argument("--stopwords", default=None)
    p.add_argument("--stream_dtype", default="float32", choices=("float32", "bfloat16"))
    p.add_argument("--window_sum_dtype", default="float32", choices=("float32", "bfloat16"))
    p.add_argument("--negative_pool_size", type=int, default=-1)
    p.add_argument("--negative_pool_stride", type=int, default=0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--mesh", default=None,
                   help="train under a 'DATAxMODEL' mesh (e.g. 2x2), one process "
                        "per device; entity table and optimizer state shard "
                        "over the model axis")
    p.add_argument("--shard_corpus", action="store_true",
                   help="with a mesh + --on_device_sampling: shard the device "
                        "corpus over the data axis")
    p.add_argument("--on_device_sampling", action="store_true",
                   help="sample batches on the device (the collection-scale "
                        "fast path)")
    p.add_argument("--steps_per_call", type=int, default=1,
                   help="steps per call of the on-device sampler")
    p.add_argument("--checkpoint_every", type=int, default=1,
                   help="dump model/resume state every N epochs (collection-"
                        "scale snapshots are large; validation epochs must "
                        "stay on the dump cadence)")
    p.add_argument("--resume", action="store_true",
                   help="continue a crashed/interrupted run from the last "
                        "dumped epoch in --workdir")
    p.add_argument("--fail_after_epoch", type=int, default=0,
                   help="rehearsal hook: raise after this epoch completes to "
                        "exercise crash + --resume recovery")
    add_distributed_flags(p)
    add_device_flag(p)
    return p


def read_ids(path):
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def read_curve(path):
    """[(epoch, map)] sorted by epoch; the last write of an epoch wins."""
    curve = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            curve[rec["epoch"]] = rec["map"]
    return sorted(curve.items())


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    # Epoch selection loads the best validated epoch's checkpoint; an
    # evaluated epoch whose model was never dumped would fail only after the
    # whole run.
    if args.eval_every % args.checkpoint_every:
        p.error(
            f"--eval_every {args.eval_every} must be a multiple of "
            f"--checkpoint_every {args.checkpoint_every}: the best "
            f"validation epoch's checkpoint must exist for the final "
            f"test-set ranking"
        )
    device = join_process_group(args)
    try:
        return _run(args, device)
    finally:
        distributed.shutdown()


def _run(args, device) -> int:
    primary = distributed.is_primary()
    logging.basicConfig(level="INFO" if primary else "WARNING",
                        format="%(asctime)s %(message)s")
    os.makedirs(args.workdir, exist_ok=True)
    stopwords = load_stopwords(args.stopwords) if args.stopwords else lemur_stopwords()

    validation_ids = set(read_ids(os.path.join(args.splits, "validation")))
    test_ids = set(read_ids(os.path.join(args.splits, "test")))
    topics = read_topics(args.topics)
    qrels = read_qrels(args.qrels)
    val_qrels = {q: r for q, r in qrels.items() if q in validation_ids}
    test_qrels = {q: r for q, r in qrels.items() if q in test_ids}

    data_cfg = DataConfig(
        corpus_path=args.corpus,
        max_vocabulary_size=65536,
        min_document_frequency=0,
        max_document_frequency=0.5,
    )
    corpus = load_corpus(data_cfg, WINDOW, args.stopwords)
    logging.info("Corpus: %d docs, %d terms.", corpus.num_docs, corpus.vocab.size)

    # A stemmed Indri repository holds stemmed vocabulary strings: topic
    # tokens go through the indexing-time stemmer it records.
    stemmer = QueryStemmer(corpus.stemmer, corpus.vocab.term_to_id, on_unknown="warn")
    if stemmer.name:
        logging.info("Query stemming: %s.", stemmer.name)
    queries = {q: stemmer.stem_tokens(tokenize(t, stopwords)) for q, t in topics.items()}
    val_queries = {q: t for q, t in queries.items() if q in validation_ids}
    test_queries = {q: t for q, t in queries.items() if q in test_ids}
    logging.info("%d validation / %d test topics.", len(val_queries), len(test_queries))

    desc = ModelDesc(
        word_repr_size=args.word_repr_size,
        entity_repr_size=args.entity_repr_size,
        nonlinearity=Nonlinearity.HARD_TANH,
        batch_normalization=True,
    )
    cfg = TrainConfig(
        num_epochs=args.num_epochs,
        batch_size=args.batch_size,
        window_size=WINDOW,
        num_random_entities=10,
        learning_rate=1e-3,
        regularization_lambda=1e-2,
        update_method=UpdateMethod.ADAM,
        adam=AdamConfig(mode=AdamMode.DENSE_UPDATE_DENSE_VARIANCE),
        seed=args.seed,
        stream_dtype=args.stream_dtype,
        window_sum_dtype=args.window_sum_dtype,
        negative_pool_size=args.negative_pool_size,
        negative_pool_stride=args.negative_pool_stride,
    )
    prefix = os.path.join(args.workdir, "nvsm")
    curve_path = os.path.join(args.workdir, "validation_curve.jsonl")
    if not args.resume and primary and os.path.exists(curve_path):
        # The curve is append-only so that --resume selects over the epochs
        # before a crash; a fresh run in a reused workdir must not inherit
        # another run's points.
        os.remove(curve_path)
    mesh = mesh_from_flag(args.mesh)
    t_start = time.time()

    def validate(epoch, params, cost):
        if epoch % args.eval_every and epoch != cfg.num_epochs:
            return
        start = time.perf_counter()
        if mesh is not None:
            # The rank holds its shards: every rank fetches the full tables
            # and computes the same MAP.
            params = fetch_params(mesh, params, corpus.num_docs)
        engine = QueryEngine(params, corpus.vocab.terms, corpus.docnos,
                             nonlinearity=None)  # NVSM is queried --linear
        run = engine.rank(val_queries, top_k=1000)
        m = evaluate_run(run, val_qrels, measures=("map",))["map"]
        if primary:
            with open(curve_path, "a") as f:
                f.write(json.dumps({"epoch": epoch, "map": m}) + "\n")
        logging.info("Epoch %d validation MAP = %.4f (%.2fs)", epoch, m,
                     time.perf_counter() - start)
        if args.fail_after_epoch and epoch >= args.fail_after_epoch:
            raise RuntimeError(f"rehearsal: simulated crash after epoch {epoch}")

    train_model(
        desc, cfg, corpus, device, output_prefix=prefix, epoch_callback=validate,
        mesh=mesh,
        on_device_sampling=args.on_device_sampling,
        shard_corpus=args.shard_corpus,
        steps_per_call=args.steps_per_call,
        checkpoint_every=args.checkpoint_every,
        resume=args.resume,
    )

    # Every rank reads the primary's curve: train_model returns on no rank
    # before the primary's last point is written.
    validation_curve = read_curve(curve_path)
    best_epoch, best_val = max(validation_curve, key=lambda x: x[1])
    logging.info("Best epoch %d (validation MAP %.4f).", best_epoch, best_val)

    engine = load_query_engine(prefix, best_epoch, device, nonlinearity=None)
    nvsm_run = engine.rank(test_queries, top_k=1000)
    if primary:
        write_run(nvsm_run, os.path.join(args.workdir, "nvsm_test.run"), "nvsm")
    results = {
        "best_epoch": best_epoch,
        "validation_map": best_val,
        "validation_curve": validation_curve,
        "nvsm_test_map": evaluate_run(nvsm_run, test_qrels, measures=("map",))["map"],
        "wall_clock_s": round(time.time() - t_start, 1),
        "num_docs": corpus.num_docs,
        "resumed": bool(args.resume),
    }

    qlm_index = build_qlm_index(corpus)
    for name, smoothing, prf in [
        ("qlm_jm_prf", "jm", True),
        ("qlm_dirichlet_prf", "dirichlet", True),
    ]:
        qlm_run = qlm_rank(qlm_index, test_queries, smoothing=smoothing, prf=prf)
        results[f"{name}_test_map"] = evaluate_run(qlm_run, test_qrels, measures=("map",))["map"]
        fused = fuse_fixed_alpha(nvsm_run, qlm_run, 0.5)
        results[f"nvsm+{name}_test_map"] = evaluate_run(fused, test_qrels, measures=("map",))["map"]

    if primary:
        print(json.dumps(results, indent=2, sort_keys=True))
        with open(os.path.join(args.workdir, "results.json"), "w") as f:
            json.dump(results, f, indent=2, sort_keys=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
