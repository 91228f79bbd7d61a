"""Collection-scale quality study on the PyTorch port (``cunvsm_torch``).

The port's runner of ``scripts/collection_scale_study.py``: the same
synthetic mixture-of-topics corpus (``make_corpus`` is that script's, built
on ``cunvsm_torch.data.synth``), the same training run and the same
evaluation, on one CUDA device.  It answers whether the port trains to the
JAX package's quality: per-instance negatives against the rolled pool, by
MAP of held-out topical queries against planted relevance (all documents of
the query's topic).

Corpus: T topics over a 32k vocabulary.  Each topic owns a head of ~60
topic words (Zipf-weighted); a document draws ~70% of its ~120 tokens from
its topic head and 30% from a global Zipf background.  Queries sample 4
distinct head words of a topic.  Everything is generated from a fixed
numpy seed, independent of the training seed.

Run: 300 -> 256, hard_tanh + batch normalization, full_adam, batch 51200,
window 10, 10 negatives, lambda 1e-2, lr 1e-3, bfloat16 stream and window
sum, on-device sampling in calls of ``--steps_per_call`` steps, 30 epochs;
ranking with bfloat16 scores and no query-side nonlinearity.  One JSON
line per (config, seed) is appended to --out, with the device's name and
power limit.

Usage:
  python scripts/collection_scale_study_torch.py --out results/cs.jsonl \
      --config pool2048_s205 --seeds 1,2,3,4,5 --num_docs 16384 [--device cuda]
"""

import argparse
import json
import logging
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import torch

from cunvsm_torch.config import (
    AdamConfig, AdamMode, ModelDesc, Nonlinearity, TrainConfig, UpdateMethod,
)
from cunvsm_torch.query.engine import QueryEngine
from cunvsm_torch.query.metrics import evaluate_run
from cunvsm_torch.train.trainer import train_model

CONFIGS = {
    "perinst": dict(negative_pool_size=0),
    "pool2048_s205": dict(negative_pool_size=2048, negative_pool_stride=205),
    # The sharded-corpus epoch shuffle (8 data groups) simulated on one
    # device (``train_model(stratify_data_groups=8)``).
    "pool2048_s205_strat8": dict(
        negative_pool_size=2048, negative_pool_stride=205, _stratify=8
    ),
}

VOCAB = 32768
TOPICS = 256
DOC_LEN = 120
TOPIC_HEAD = 60
TOPIC_FRACTION = 0.7
NUM_QUERIES = 512
QUERY_TERMS = 4
BATCH_SIZE = 51200


def make_corpus(num_docs: int, gen_seed: int = 12345):

    rng = np.random.RandomState(gen_seed)
    # Global Zipf background over the full vocabulary.
    bg_p = 1.0 / np.arange(1, VOCAB + 1) ** 1.07
    bg_p /= bg_p.sum()
    # Topic heads: distinct word subsets with Zipfy in-topic weights.
    heads = np.stack([
        rng.choice(VOCAB, TOPIC_HEAD, replace=False, p=bg_p)
        for _ in range(TOPICS)
    ])  # [T, TOPIC_HEAD]
    head_p = 1.0 / np.arange(1, TOPIC_HEAD + 1) ** 0.9
    head_p /= head_p.sum()

    doc_topics = rng.randint(0, TOPICS, num_docs)
    n_topic = int(DOC_LEN * TOPIC_FRACTION)
    n_bg = DOC_LEN - n_topic
    topic_slots = heads[doc_topics][
        np.arange(num_docs)[:, None],
        rng.choice(TOPIC_HEAD, (num_docs, n_topic), p=head_p),
    ]
    bg_slots = rng.choice(VOCAB, (num_docs, n_bg), p=bg_p)
    docs = np.concatenate([topic_slots, bg_slots], axis=1)
    # Shuffle token positions within each document.
    perm = np.argsort(rng.rand(num_docs, DOC_LEN), axis=1)
    docs = np.take_along_axis(docs, perm, axis=1).astype(np.int32)

    from cunvsm_torch.data.synth import corpus_from_tokens

    corpus = corpus_from_tokens(docs.reshape(-1), num_docs, DOC_LEN, VOCAB)

    # Held-out queries: 4 distinct head words of a topic; relevance = all
    # documents of that topic.
    q_topics = rng.randint(0, TOPICS, NUM_QUERIES)
    q_words = heads[q_topics][
        np.arange(NUM_QUERIES)[:, None],
        np.stack([
            rng.choice(TOPIC_HEAD, QUERY_TERMS, replace=False, p=head_p)
            for _ in range(NUM_QUERIES)
        ]),
    ]
    queries = {
        str(qi): [f"t{w}" for w in q_words[qi]]
        for qi in range(NUM_QUERIES)
    }
    qrels = {
        str(qi): {
            f"d{d}": 1 for d in np.flatnonzero(doc_topics == q_topics[qi])
        }
        for qi in range(NUM_QUERIES)
    }
    return corpus, queries, qrels


def study_desc() -> ModelDesc:
    return ModelDesc(
        word_repr_size=300, entity_repr_size=256,
        nonlinearity=Nonlinearity.HARD_TANH, batch_normalization=True,
    )


def study_config(config: str, seed: int, num_epochs: int = 30) -> TrainConfig:
    overrides = dict(CONFIGS[config])
    overrides.pop("_stratify", 0)  # a trainer option: see run_seed
    return TrainConfig(
        num_epochs=num_epochs, batch_size=BATCH_SIZE, window_size=10,
        num_random_entities=10, regularization_lambda=1e-2,
        learning_rate=1e-3, update_method=UpdateMethod.ADAM,
        adam=AdamConfig(mode=AdamMode.DENSE_UPDATE_DENSE_VARIANCE),
        seed=seed, stream_dtype="bfloat16",
        window_sum_dtype="bfloat16",
        **overrides,
    )


def run_seed(corpus, queries, qrels, config, seed, device, num_epochs=30,
             steps_per_call=16, desc=None, cfg=None):
    """Train one seed of ``config`` on ``device`` and rank the held-out
    queries; returns the result line (MAP, wall seconds of the whole seed,
    ms/step and pairs/s of the training epochs, the epoch costs' ends)."""
    desc = desc or study_desc()
    cfg = cfg or study_config(config, seed, num_epochs)
    start = time.time()
    result = train_model(
        desc, cfg, corpus, device,
        on_device_sampling=True,
        steps_per_call=steps_per_call,
        stratify_data_groups=CONFIGS[config].get("_stratify", 0),
    )
    engine = QueryEngine(
        result.params, corpus.vocab.terms, corpus.docnos,
        term_frequencies=corpus.vocab.term_freq,
        total_terms=corpus.vocab.total_terms,
        nonlinearity=None,
        score_dtype=torch.bfloat16,
    )
    run = engine.rank(queries, top_k=1000)
    m = evaluate_run(run, qrels, measures=("map",))["map"]
    return {
        "config": config, "seed": seed,
        "num_docs": corpus.num_docs, "epochs": cfg.num_epochs,
        "map": round(m, 4),
        "steps": result.steps,
        "ms_per_step": round(1000.0 / result.batches_per_sec, 3),
        "pairs_per_sec": round(cfg.batch_size * result.batches_per_sec),
        "first_epoch_cost": round(result.epoch_costs[0], 4),
        "last_epoch_cost": round(result.epoch_costs[-1], 4),
        "seconds": round(time.time() - start, 1),
    }


def device_line(device) -> dict:
    """The device's name and, for a CUDA device, its power limit as
    ``nvidia-smi`` prints them."""
    if torch.device(device).type != "cuda":
        return {"device": str(device)}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi[0] if smi else None}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--config", required=True, choices=sorted(CONFIGS))
    p.add_argument("--seeds", default="1,2,3,4,5")
    p.add_argument("--num_docs", type=int, default=65536)
    p.add_argument("--num_epochs", type=int, default=30)
    p.add_argument("--steps_per_call", type=int, default=16)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda); without a CUDA device "
                        "the run fails unless given --device cpu.")
    args = p.parse_args(argv)

    logging.basicConfig(level="INFO", format="%(asctime)s %(message)s")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available")

    corpus, queries, qrels = make_corpus(args.num_docs)
    logging.info(
        "Synthetic corpus: %d docs, %d tokens, %d queries.",
        corpus.num_docs, len(corpus.tokens), len(queries),
    )
    where = device_line(device)
    for seed in [int(s) for s in args.seeds.split(",")]:
        line = run_seed(corpus, queries, qrels, args.config, seed, device,
                        args.num_epochs, args.steps_per_call)
        line.update(where)
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
        logging.info("RESULT %s", json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
