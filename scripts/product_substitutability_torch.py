#!/usr/bin/env python3
"""Mix 'n Match product-substitutability pipeline (CIKM 2018 protocol) on
the PyTorch port (``cunvsm_torch``): ``scripts/product_substitutability.py``
with its flags, semantics and output files.

Given a product corpus (each document = a product's description + reviews,
TRECTEXT with the product id as DOCNO), a substitutes file of ``id1 id2
weight`` lines, and under ``--resources`` the evaluation files
``product_list``, ``topics``, ``qrel_validation`` and ``qrel_test`` (the
reference's resources/product-substitutability/<category>/):

1. trains NVSM with the document/document similarity objective mixed in
   (``--entity_similarity_weight``, the TEXT_ENTITY_ENTITY_ENTITY
   composite), the substitutes file read into a ``SimilaritySource``;
2. ranks the validation topics every ``--eval_every`` epochs (and at the
   last) and selects the best epoch by validation MAP;
3. reports that epoch's test MAP and nDCG@10, optionally beside a
   text-only baseline (``--train_text_only_baseline``) and split into
   text-visible and text-invisible products (``--planted_split``).

    python3 scripts/product_substitutability_torch.py \\
        --corpus electronics.trectext --substitutes substitutes \\
        --resources <product-substitutability>/electronics \\
        --workdir electronics_run --entity_similarity_weight 0.1 [--device cpu]

``--device`` (default ``cuda``) takes the place of ``--platform``; a run
without a card fails unless it is given ``--device cpu``.

The product text is licensed data; :func:`write_synthetic_fixture` writes a
fixture of the same layout from a seed, whose substitutes link each
topic's relevant products, part of which carry no topic word in their text.
"""

import argparse
import json
import logging
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

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
from cunvsm_torch.data.corpus import load_corpus  # noqa: E402
from cunvsm_torch.data.sources import SimilaritySource, load_similarities  # noqa: E402
from cunvsm_torch.data.text import lemur_stopwords, tokenize  # noqa: E402
from cunvsm_torch.io.trec import read_qrels, read_topics, write_run  # noqa: E402
from cunvsm_torch.query.engine import QueryEngine  # noqa: E402
from cunvsm_torch.query.metrics import evaluate_run  # noqa: E402
from cunvsm_torch.train.trainer import train_model  # noqa: E402

WINDOW = 10


def write_synthetic_fixture(root: str, num_products: int, num_topics: int,
                            relevant_per_topic: int = 8, doc_len: int = 48,
                            salt_fraction: float = 0.6, seed: int = 0) -> dict:
    """A synthetic fixture under ``root``: ``corpus.trectext`` (product ids
    ``p<i>`` as DOCNOs, background words ``bg<w>``), ``substitutes`` and
    ``salted_products.txt``, and under ``root/resources`` the files this
    script reads.  Each topic has 4 words ``t<topic>w<j>`` and
    ``relevant_per_topic`` relevant products of its own; a relevant product
    carries 10 of its topic's words with probability ``salt_fraction``,
    and every relevant product is linked by substitutes to the next two of
    its topic (plus one random pair per product).  Topics split in half
    into validation and test.  Returns the paths."""
    import numpy as np

    rng = np.random.RandomState(seed)
    products = [f"p{i}" for i in range(num_products)]
    relevant = rng.permutation(num_products)[: num_topics * relevant_per_topic]
    relevant = relevant.reshape(num_topics, relevant_per_topic)
    salted = rng.rand(num_topics, relevant_per_topic) < salt_fraction
    words = {}
    for t in range(num_topics):
        for i, s in zip(relevant[t], salted[t]):
            if s:
                words[int(i)] = [f"t{t}w{j}" for j in rng.randint(0, 4, 10)]
    res = os.path.join(root, "resources")
    os.makedirs(res, exist_ok=True)
    corpus = os.path.join(root, "corpus.trectext")
    with open(corpus, "w") as f:
        for i, prod in enumerate(products):
            body = [f"bg{w}" for w in rng.randint(0, 30000, doc_len)]
            for pos, w in zip(rng.choice(doc_len, 10, replace=False), words.get(i, [])):
                body[pos] = w
            f.write(f"<DOC>\n<DOCNO>{prod}</DOCNO>\n<TEXT>\n{' '.join(body)}\n</TEXT>\n</DOC>\n")
    with open(os.path.join(root, "substitutes"), "w") as f:
        for t in range(num_topics):
            for j, i in enumerate(relevant[t]):
                for step in (1, 2):
                    other = relevant[t][(j + step) % relevant_per_topic]
                    f.write(f"{products[i]} {products[other]} 1.0\n")
        for a, b in rng.randint(0, num_products, (num_products, 2)):
            f.write(f"{products[a]} {products[b]} 1.0\n")
    with open(os.path.join(root, "salted_products.txt"), "w") as f:
        f.write("".join(f"{products[i]}\n" for i in sorted(words)))
    with open(os.path.join(res, "product_list"), "w") as f:
        f.write("".join(f"{prod}\n" for prod in products))
    with open(os.path.join(res, "topics"), "w") as f:
        f.write("".join(f"{t} " + " ".join(f"t{t}w{j}" for j in range(4)) + "\n"
                        for t in range(num_topics)))
    for name, part in (("qrel_validation", 0), ("qrel_test", 1)):
        with open(os.path.join(res, name), "w") as f:
            f.write("".join(f"{t} 0 {products[i]} 1\n"
                            for t in range(part, num_topics, 2) for i in relevant[t]))
    return dict(corpus=corpus, substitutes=os.path.join(root, "substitutes"), resources=res,
                planted_split=os.path.join(root, "salted_products.txt"))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    p.add_argument("--corpus", required=True)
    p.add_argument("--substitutes", required=True)
    p.add_argument("--resources", required=True,
                   help="directory with product_list, topics, qrel_test, "
                        "qrel_validation")
    p.add_argument("--workdir", required=True)
    p.add_argument("--entity_similarity_weight", type=float, default=0.1)
    p.add_argument("--num_epochs", type=int, default=100)
    p.add_argument("--eval_every", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=51200)
    p.add_argument("--word_repr_size", type=int, default=300)
    p.add_argument("--entity_repr_size", type=int, default=256)
    p.add_argument("--train_text_only_baseline", action="store_true")
    p.add_argument("--planted_split", default=None,
                   help="salted_products.txt of a synthetic fixture: adds "
                        "text-visible/-invisible test metrics to the report")
    add_device_flag(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    logging.basicConfig(level="INFO", format="%(asctime)s %(message)s")
    os.makedirs(args.workdir, exist_ok=True)

    stopwords = lemur_stopwords()
    # The corpus is stopped like the queries (the reference indexes with a
    # stoplist, functions.sh:344-350); load_corpus takes a file path.
    stopword_path = os.path.join(args.workdir, "stopwords.txt")
    with open(stopword_path, "w") as f:
        f.write("\n".join(sorted(stopwords)) + "\n")

    with open(os.path.join(args.resources, "product_list")) as f:
        product_list = [line.strip() for line in f if line.strip()]
    topics = read_topics(os.path.join(args.resources, "topics"))
    queries = {q: tokenize(t, stopwords) for q, t in topics.items()}
    qrel_val = read_qrels(os.path.join(args.resources, "qrel_validation"))
    qrel_test = read_qrels(os.path.join(args.resources, "qrel_test"))

    data_cfg = DataConfig(
        corpus_path=args.corpus,
        max_vocabulary_size=65536,
        min_document_frequency=2,
        max_document_frequency=0.5,
        document_list=None,
    )
    corpus = load_corpus(data_cfg, WINDOW, stopword_path)
    logging.info("Corpus: %d products (%d listed), %d terms.", corpus.num_docs,
                 len(product_list), corpus.vocab.size)

    ids, weights = load_similarities(args.substitutes, corpus.docno_to_id())
    logging.info("Loaded %d substitute pairs.", len(ids))

    desc = ModelDesc(
        word_repr_size=args.word_repr_size,
        entity_repr_size=args.entity_repr_size,
        nonlinearity=Nonlinearity.HARD_TANH,
        batch_normalization=True,
    )

    planted_visible = None
    if args.planted_split:
        with open(args.planted_split) as f:
            planted_visible = {line.strip() for line in f if line.strip()}

    def run_training(sim_weight, tag):
        cfg = TrainConfig(
            num_epochs=args.num_epochs,
            batch_size=args.batch_size,
            window_size=WINDOW,
            num_random_entities=10,
            learning_rate=1e-3,
            regularization_lambda=1e-2,
            update_method=UpdateMethod.ADAM,
            adam=AdamConfig(mode=AdamMode.DENSE_UPDATE_DENSE_VARIANCE),
            text_entity_weight=1.0 - sim_weight,
            entity_entity_weight=sim_weight,
            seed=1,
        )
        sim_source = (
            SimilaritySource(ids, weights, cfg.batch_size, seed=1) if sim_weight > 0 else None
        )
        curve = []

        def validate(epoch, params, cost):
            if epoch % args.eval_every and epoch != cfg.num_epochs:
                return
            engine = QueryEngine(params, corpus.vocab.terms, corpus.docnos, nonlinearity=None)
            run = engine.rank(queries, top_k=1000)
            m = evaluate_run(run, qrel_val, measures=("map",))["map"]
            curve.append((epoch, m, run))
            logging.info("[%s] epoch %d validation MAP=%.4f", tag, epoch, m)

        train_model(desc, cfg, corpus, device, similarity_source=sim_source,
                    epoch_callback=validate)
        best_epoch, best_val, _ = max(curve, key=lambda x: x[1])
        # The validation callback kept each evaluated epoch's full run; the
        # best epoch's is scored on the test qrels.
        best_run = next(r for e, m, r in curve if e == best_epoch)
        test_metrics = evaluate_run(best_run, qrel_test, measures=("map", "ndcg_10"))
        write_run(best_run, os.path.join(args.workdir, f"{tag}.run"), tag)
        out = {
            "best_epoch": best_epoch,
            "validation_map": best_val,
            "test_map": test_metrics["map"],
            "test_ndcg_10": test_metrics["ndcg_10"],
        }
        if planted_visible is not None:
            # Split the test qrels into text-visible (salted) and
            # text-invisible products: only the similarity stream can
            # surface the latter.
            for name, keep in (
                ("text_visible", lambda prod: prod in planted_visible),
                ("text_invisible", lambda prod: prod not in planted_visible),
            ):
                sub = {q: {prod: r for prod, r in d.items() if keep(prod)}
                       for q, d in qrel_test.items()}
                sub = {q: d for q, d in sub.items() if d}
                m = evaluate_run(best_run, sub, measures=("map", "recall_1000"))
                out[f"test_{name}"] = {k: round(v, 4) for k, v in m.items()}
        return out

    results = {"mix_n_match": run_training(args.entity_similarity_weight, "mix_n_match")}
    if args.train_text_only_baseline:
        results["text_only"] = run_training(0.0, "text_only")

    print(json.dumps(results, indent=2, sort_keys=True))
    with open(os.path.join(args.workdir, "results.json"), "w") as f:
        json.dump(results, f, indent=2, sort_keys=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
