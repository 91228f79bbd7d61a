#!/usr/bin/env python3
"""Multi-seed Cranfield NVSM quality campaign on the PyTorch port
(``cunvsm_torch``): ``scripts/quality_seeds.py`` with its configurations,
flags and output lines.

Trains the canonical NVSM configuration (functions.sh:263-271,369-400:
d 300 -> 256, batch 51200, window 10, 10 negatives, hard_tanh + batch
normalization, full_adam, bfloat16 streams and window sums) across the
seeds of one sampling configuration, ranks the Cranfield topics with the
linear query preset, and appends one JSON line per (config, seed) with the
standalone MAP and the MAPs of its alpha = 0.5 standardize fusion with
QLM-Dirichlet + PRF and QLM-JM + PRF.  ``scripts/quality_stats.py`` reads
the lines.

    python3 scripts/quality_seeds_torch.py --data_dir <cranfield dir> \\
        --out quality.jsonl --config pool2048_s205 --seeds 1,2,3,4,5,6,7,8 \\
        [--dump_runs runs/] [--device cpu]

``--data_dir`` holds ``cranfield.trectext``, ``cranfield.topics`` and
``cranfield.qrel``; the script says so and exits 1 when they are not there.
``--device`` (default ``cuda``) takes the place of ``--platform``; a run
without a card fails unless it is given ``--device cpu``.
"""

import argparse
import json
import logging
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402

from cunvsm_torch.cli.train import add_device_flag, resolve_device  # noqa: E402
from cunvsm_torch.config import (  # noqa: E402
    AdamConfig,
    AdamMode,
    DataConfig,
    ModelDesc,
    Nonlinearity,
    TrainConfig,
    UpdateMethod,
)
from cunvsm_torch.data.corpus import build_corpus  # noqa: E402
from cunvsm_torch.data.text import iter_trectext, lemur_stopwords, tokenize  # noqa: E402
from cunvsm_torch.io.trec import read_qrels, read_topics, write_run  # noqa: E402
from cunvsm_torch.query.engine import QueryEngine  # noqa: E402
from cunvsm_torch.query.fusion import fuse_fixed_alpha  # noqa: E402
from cunvsm_torch.query.metrics import evaluate_run  # noqa: E402
from cunvsm_torch.query.qlm import build_qlm_index, qlm_rank  # noqa: E402
from cunvsm_torch.train.trainer import train_model  # noqa: E402

DATA_FILES = ("cranfield.trectext", "cranfield.topics", "cranfield.qrel")
CONFIGS = {
    # name -> TrainConfig overrides (all on bf16 streams + bf16 window sums)
    "auto": dict(),  # the literal shipped default (scale-aware resolution)
    "perinst": dict(negative_pool_size=0),
    "pool2048": dict(negative_pool_size=2048),
    "pool2048_s205": dict(negative_pool_size=2048, negative_pool_stride=205),
    "pool5120": dict(negative_pool_size=5120),
    "pool5120_s511": dict(negative_pool_size=5120, negative_pool_stride=511),
    "pool10240": dict(negative_pool_size=10240),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    p.add_argument("--data_dir", default=None,
                   help="directory with cranfield.trectext, cranfield.topics and "
                        "cranfield.qrel")
    p.add_argument("--out", required=True)
    p.add_argument("--config", required=True, choices=sorted(CONFIGS))
    p.add_argument("--seeds", default="1,2,3,4,5,6,7,8")
    p.add_argument("--num_epochs", type=int, default=100)
    p.add_argument("--dump_runs", default=None,
                   help="directory to write per-seed NVSM TREC runs into "
                        "(offline fusion experiments without retraining)")
    add_device_flag(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level="INFO", format="%(asctime)s %(message)s")
    missing = [name for name in DATA_FILES
               if not args.data_dir or not os.path.isfile(os.path.join(args.data_dir, name))]
    if missing:
        print(f"quality_seeds_torch.py: --data_dir {args.data_dir} does not hold "
              f"{', '.join(missing)} (the reference's Cranfield collection)", file=sys.stderr)
        return 1
    device = resolve_device(args.device)

    stopwords = lemur_stopwords()
    data_cfg = DataConfig(max_vocabulary_size=65536, min_document_frequency=0,
                          max_document_frequency=0.5)
    docs = list(iter_trectext(os.path.join(args.data_dir, "cranfield.trectext")))
    corpus = build_corpus(docs, data_cfg, 10, stopwords=stopwords)
    topics = read_topics(os.path.join(args.data_dir, "cranfield.topics"))
    queries = {q: tokenize(t, stopwords) for q, t in topics.items()}
    qrels = read_qrels(os.path.join(args.data_dir, "cranfield.qrel"))

    qlm_index = build_qlm_index(corpus)
    qlm_runs = {
        "dirichlet_prf": qlm_rank(qlm_index, queries, smoothing="dirichlet", prf=True),
        # The reference's TUTORIAL headline cell (NVSM + QLM-JM + PRF,
        # 0.4345 at its single seed, TUTORIAL.md:98).
        "jm_prf": qlm_rank(qlm_index, queries, smoothing="jm", prf=True),
    }

    desc = ModelDesc(word_repr_size=300, entity_repr_size=256,
                     nonlinearity=Nonlinearity.HARD_TANH, batch_normalization=True)
    overrides = CONFIGS[args.config]
    freqs = np.asarray(corpus.vocab.term_freq, dtype=np.int64)

    for seed in [int(s) for s in args.seeds.split(",")]:
        cfg = TrainConfig(
            num_epochs=args.num_epochs, batch_size=51200, window_size=10,
            num_random_entities=10, regularization_lambda=1e-2,
            learning_rate=1e-3, update_method=UpdateMethod.ADAM,
            adam=AdamConfig(mode=AdamMode.DENSE_UPDATE_DENSE_VARIANCE),
            seed=seed, stream_dtype="bfloat16", window_sum_dtype="bfloat16",
            **overrides,
        )
        start = time.time()
        result = train_model(desc, cfg, corpus, device)
        engine = QueryEngine(
            result.params, corpus.vocab.terms, corpus.docnos,
            term_frequencies=freqs, total_terms=corpus.vocab.total_terms,
            nonlinearity=None,  # --linear, the NVSM query preset
        )
        run = engine.rank(queries, top_k=1000)
        if args.dump_runs:
            os.makedirs(args.dump_runs, exist_ok=True)
            write_run(run, os.path.join(args.dump_runs, f"nvsm_{args.config}_s{seed}.run"),
                      "nvsm")
        m = evaluate_run(run, qrels, measures=("map",))["map"]
        line = {
            "config": args.config, "seed": seed,
            "map": round(m, 4),
            "minutes": round((time.time() - start) / 60.0, 1),
        }
        for name, qlm_run in qlm_runs.items():
            fused = fuse_fixed_alpha(run, qlm_run, alpha=0.5, normalizer="standardize")
            line[f"fusion_{name}_map"] = round(
                evaluate_run(fused, qrels, measures=("map",))["map"], 4)
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
        logging.info("RESULT %s", json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
