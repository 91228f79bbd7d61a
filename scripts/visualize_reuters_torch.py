#!/usr/bin/env python3
"""Reuters-21578 end-to-end visualization on the PyTorch port
(``cunvsm_torch``): ``scripts/visualize_reuters.py`` (the
visualize-reuters-collection.sh rebuild) with its flags, pipeline and
output files.

SGML -> TRECTEXT + topic classes -> NVSM training (hard_tanh + batch
normalization, full_adam, window 10, 10 negatives, seed 1) -> per epoch, a
cosine class silhouette of the document embeddings and a t-SNE plot
colored by topic.

    python3 scripts/visualize_reuters_torch.py --sgm /path/to/*.sgm \\
        --workdir reuters_run [--num_epochs 15] [--device cpu]

``--device`` (default ``cuda``) takes the place of ``--platform``; a run
without a card fails unless it is given ``--device cpu``.

``metrics.json`` in the workdir holds the number of labeled documents, the
number of classes and the silhouette curve, as the JAX script writes it.
The silhouette is computed here with numpy (``cosine_silhouette``: the
function of ``sklearn.metrics.silhouette_score(metric="cosine",
sample_size=2048, random_state=0)``), so the curve needs no scikit-learn.
The plots (``<workdir>/plots/epoch_<N>.png``, through
``cunvsm_torch.cli.visualize``) need scikit-learn and matplotlib, and the
animation (``<workdir>/training.gif``) Pillow: where one is missing the
script logs so once, draws nothing, and still writes ``metrics.json``.
"""

import argparse
import glob
import json
import logging
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402

from cunvsm_torch.cli import extract_reuters, visualize  # noqa: E402
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
from cunvsm_torch.train.trainer import train_model  # noqa: E402

WINDOW = 10
# The silhouette's subsample: the full score is O(n^2) pairwise distances,
# GBs and minutes per epoch at Reuters scale for a trend line.
SILHOUETTE_SAMPLE = 2048


def cosine_silhouette(emb, labels, sample_size=SILHOUETTE_SAMPLE, seed=0):
    """The mean silhouette of ``emb`` [n, d] under ``labels`` with cosine
    distances, as ``sklearn.metrics.silhouette_score(emb, labels,
    metric="cosine", sample_size=..., random_state=seed)`` computes it, or
    None outside ``2 <= n_labels <= n - 1`` (checked before sampling).

    Rows are sampled by ``RandomState(seed).permutation(n)[:sample_size]``
    when n > sample_size.  Distances are 1 - cos clipped to [0, 2] with a
    zero diagonal; a is the mean distance to the own class over n_c - 1, b
    the least mean distance to another class, s = (b - a) / max(a, b), and
    0 for a class of one."""
    labels = np.asarray(labels)
    n = len(labels)
    if not 2 <= len(np.unique(labels)) <= n - 1:
        return None
    if n > sample_size:
        rows = np.random.RandomState(seed).permutation(n)[:sample_size]
        emb, labels = emb[rows], labels[rows]
    _, codes = np.unique(labels, return_inverse=True)
    freqs = np.bincount(codes)
    # sklearn's normalize: a norm of (almost) zero leaves the row as it is.
    norms = np.sqrt(np.einsum("ij,ij->i", emb, emb))
    norms[norms < 10 * np.finfo(norms.dtype).eps] = 1.0
    unit = emb / norms[:, None]
    dist = np.clip(1.0 - unit @ unit.T, 0.0, 2.0)
    np.fill_diagonal(dist, 0.0)
    # [n, classes] sums of distances to every class.
    sums = dist.astype(np.float64) @ (codes[:, None] == np.arange(len(freqs))[None, :])
    own = (np.arange(len(codes)), codes)
    intra = sums[own].copy()
    sums[own] = np.inf
    inter = (sums / freqs).min(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        intra /= freqs[codes] - 1
        s = (inter - intra) / np.maximum(intra, inter)
    return float(np.mean(np.nan_to_num(s)))


def missing_plot_library():
    """None where the t-SNE plots can be drawn, else why not."""
    try:
        import matplotlib  # noqa: F401
        import sklearn.manifold  # noqa: F401
    except ImportError as exc:
        return str(exc)
    return None


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    p.add_argument("--sgm", nargs="+", required=True)
    p.add_argument("--workdir", required=True)
    p.add_argument("--num_epochs", type=int, default=15)
    p.add_argument("--word_repr_size", type=int, default=300)
    p.add_argument("--entity_repr_size", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=4096)
    add_device_flag(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level="INFO")
    device = resolve_device(args.device)

    os.makedirs(args.workdir, exist_ok=True)
    plots = os.path.join(args.workdir, "plots")
    os.makedirs(plots, exist_ok=True)
    prefix = os.path.join(args.workdir, "reuters")
    classes = os.path.join(args.workdir, "classes.txt")

    sgm_files = []
    for pattern in args.sgm:
        sgm_files.extend(sorted(glob.glob(pattern)))
    rc = extract_reuters.main(sgm_files + ["--trectext_out_prefix", prefix,
                                           "--document_classification_out", classes])
    if rc != 0:
        return rc

    data_cfg = DataConfig(
        corpus_path=f"{prefix}_0.trectext",
        max_vocabulary_size=65536,
        min_document_frequency=2,
        max_document_frequency=0.5,
    )
    corpus = load_corpus(data_cfg, WINDOW)
    logging.info("Corpus: %d docs, %d terms.", corpus.num_docs, corpus.vocab.size)

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
        seed=1,
    )
    model_prefix = os.path.join(args.workdir, "model")

    label_by_docno = {}
    with open(classes) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 2:
                label_by_docno[parts[0]] = parts[1]
    labeled_rows = [i for i, d in enumerate(corpus.docnos) if d in label_by_docno]
    labels = [label_by_docno[corpus.docnos[i]] for i in labeled_rows]
    silhouette_curve = []
    cannot_plot = missing_plot_library()
    if cannot_plot:
        logging.warning("No t-SNE plots: scikit-learn and matplotlib are needed (%s); "
                        "metrics.json is still written.", cannot_plot)

    def class_silhouette(params):
        emb = params.entity_reprs.detach().cpu().numpy()[labeled_rows]
        emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
        return cosine_silhouette(emb, labels)

    def plot_epoch(epoch, params, cost):
        s = class_silhouette(params)
        if s is not None:
            silhouette_curve.append((epoch, round(s, 4)))
            logging.info("Epoch %d class silhouette (cosine) = %.4f", epoch, s)
        if cannot_plot:
            return
        visualize.main([
            "--model", model_prefix,
            "--epoch", str(epoch),
            "--object_classification", classes,
            "--filter_unclassified",
            "--plot_out", os.path.join(plots, f"epoch_{epoch:03d}.png"),
            "--device", str(device),
        ])

    train_model(desc, cfg, corpus, device, output_prefix=model_prefix,
                epoch_callback=plot_epoch)
    logging.info("Plots in %s.", plots)

    with open(os.path.join(args.workdir, "metrics.json"), "w") as f:
        json.dump({
            "num_labeled_docs": len(labeled_rows),
            "num_classes": len(set(labels)),
            "class_silhouette_cosine_by_epoch": silhouette_curve,
        }, f, indent=2)

    gif = os.path.join(args.workdir, "training.gif")
    if stitch_gif(sorted(glob.glob(os.path.join(plots, "epoch_*.png"))), gif):
        logging.info("Training animation written to %s.", gif)
    return 0


def stitch_gif(frames, out_path, duration_ms=400):
    """Assemble per-epoch plots into an animated GIF
    (visualize-reuters-collection.sh:150, through Pillow in place of
    imagemagick).  Returns False when Pillow or frames are missing."""
    if not frames:
        return False
    try:
        from PIL import Image
    except ImportError:
        logging.warning("Pillow unavailable; stitch %d frames manually "
                        "(e.g. convert -delay 40 plots/epoch_*.png training.gif).", len(frames))
        return False
    images = [Image.open(f).convert("P", palette=Image.ADAPTIVE) for f in frames]
    images[0].save(out_path, save_all=True, append_images=images[1:], duration=duration_ms,
                   loop=0)
    return True


if __name__ == "__main__":
    sys.exit(main())
