"""cunvsm-torch-train: the training CLI of the PyTorch port, with the flag
surface of ``cunvsm-train`` (``cunvsm_tpu/cli/train.py``, itself
cuNVSMTrainModel's, cpp/main.cu:15-76): a raw corpus path (trectext, jsonl,
a directory of them, or a packed ``.npz``) in place of the Indri
repository.

``--device`` (default ``cuda``) takes the place of the JAX package's
``--platform``; without a CUDA device the command fails unless it is given
``--device cpu``.

A mesh run (``--mesh DATAxMODEL``) is one process per device, every process
started with the same flags: under ``torchrun`` with bare ``--distributed``
(the rendezvous and the ranks come from the environment), or by hand with
``--coordinator_address host:port --num_processes N --process_id I``.  Rank
i runs on ``cuda:<local rank>`` unless ``--device`` names a device index or
the CPU; the backend follows the device (NCCL for CUDA, gloo for the CPU).
The primary process alone writes files and logs below WARNING.

Usage:
    python -m cunvsm_torch.cli.train [flags] <corpus_path> [similarity_path]
    torchrun --nproc_per_node 4 -m cunvsm_torch.cli.train --distributed \
        --mesh 2x2 [flags] <corpus_path>
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import torch

from cunvsm_torch.config import (
    AdamConfig,
    DataConfig,
    ModelDesc,
    Nonlinearity,
    TrainConfig,
    UPDATE_METHOD_NAMES,
)
from cunvsm_torch.data.corpus import load_corpus
from cunvsm_torch.data.instances import FeatureWeighting, Weighting
from cunvsm_torch.data.sources import SimilaritySource, load_similarities
from cunvsm_torch.parallel import distributed
from cunvsm_torch.parallel.mesh import make_mesh, parse_mesh_shape
from cunvsm_torch.train.trainer import train_model

NONLINEARITIES = {
    "tanh": Nonlinearity.TANH,
    "hard_tanh": Nonlinearity.HARD_TANH,
}


def add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda); without a CUDA "
                        "device the command fails unless given --device cpu.")


def resolve_device(name: str) -> torch.device:
    """``torch.device(name)``; a CUDA device that is not there raises
    ``SystemExit`` with a message rather than falling back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available; "
                         "pass --device cpu to run on the CPU")
    return device


def add_distributed_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--distributed", action="store_true",
                   help="Multi-process run, one process per device, with the "
                        "rendezvous and the ranks from the environment "
                        "(torchrun).")
    p.add_argument("--coordinator_address", default=None,
                   help="host:port of process 0 (manual multi-process "
                        "launch; implies --distributed).")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)


def join_process_group(args) -> torch.device:
    """This process's device; with ``--distributed`` or the manual triple
    the process group is joined first, and a bare ``cuda`` device becomes
    ``cuda:<local rank>`` (``LOCAL_RANK`` under torchrun, else the process
    id modulo the visible devices).  The backend follows the device: NCCL
    for CUDA, gloo for the CPU."""
    device = resolve_device(args.device)
    manual = args.coordinator_address is not None
    if not (args.distributed or manual):
        return device
    if device.type == "cuda" and device.index is None:
        local = args.process_id if manual else os.environ.get("LOCAL_RANK", os.environ.get("RANK"))
        device = torch.device("cuda", int(local or 0) % torch.cuda.device_count())
    distributed.initialize(
        args.coordinator_address, args.num_processes, args.process_id,
        backend="nccl" if device.type == "cuda" else "gloo", device=device,
    )
    return device


def mesh_from_flag(text):
    """The mesh of ``--mesh`` over the joined process group, or None."""
    return make_mesh(*parse_mesh_shape(text)) if text else None


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    p.add_argument("corpus_path")
    p.add_argument("similarity_path", nargs="?", default=None)

    p.add_argument("--num_epochs", type=int, default=100000)
    p.add_argument("--document_cutoff", type=int, default=0)
    p.add_argument("--document_list", default=None)
    p.add_argument("--term_blacklist", default=None)
    p.add_argument("--stopwords", default=None,
                   help="Stopword list applied at tokenization (the role "
                        "IndriBuildIndex's stoplist plays); the special "
                        "value 'lemur' selects the vendored Lemur "
                        "stoplist.dft the reference pipelines index with.")

    p.add_argument("--word_repr_size", type=int, default=4)
    p.add_argument("--entity_repr_size", type=int, default=4)
    p.add_argument("--batch_size", type=int, default=1024)
    p.add_argument("--window_size", type=int, default=8)
    p.add_argument("--num_random_entities", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--regularization_lambda", type=float, default=0.01)
    p.add_argument("--learning_rate", type=float, default=0.0)
    p.add_argument("--update_method", required=True, choices=sorted(UPDATE_METHOD_NAMES))
    p.add_argument("--weighting", default="auto",
                   choices=["auto", "uniform", "inv_doc_frequency"])
    p.add_argument("--feature_weighting", default="uniform",
                   choices=["uniform", "self_information"])
    p.add_argument("--bias_negative_samples", action="store_true")
    p.add_argument("--nonlinearity", required=True, choices=sorted(NONLINEARITIES))
    p.add_argument("--l2_phrase_normalization", action="store_true")
    p.add_argument("--l2_entity_normalization", action="store_true")
    p.add_argument("--batch_normalization", action="store_true")
    p.add_argument("--max_vocabulary_size", type=int, default=60000)
    p.add_argument("--min_document_frequency", type=int, default=2)
    p.add_argument("--max_document_frequency", type=float, default=0.5)
    p.add_argument("--include_oov", action="store_true")
    p.add_argument("--compute_initial_cost", action="store_true")
    p.add_argument("--no_shuffle", action="store_true")
    p.add_argument("--dump_initial_model", action="store_true")
    p.add_argument("--dump_every", type=int, default=0)
    p.add_argument("--resume", action="store_true",
                   help="Resume from <output>_resume.npz (extension; the "
                        "reference restarts from scratch).")
    p.add_argument("--entity_similarity_weight", type=float, default=0.0)
    p.add_argument("--term_similarity_weight", type=float, default=0.0)
    p.add_argument("--check_gradients", action="store_true",
                   help="Verify every batch's gradients by finite "
                        "differences before updating (slow; float64 "
                        "fidelity needs a float64 run, main.cu:414-425).")
    p.add_argument("--profile_dir", default=None,
                   help="Write a torch.profiler Chrome trace of the second "
                        "trained epoch (the only one of a one-epoch run), "
                        "with the package's cunvsm.* spans, into this "
                        "directory.")
    p.add_argument("--log_every", type=int, default=0,
                   help="Per-batch cost/progress logging interval.")
    p.add_argument("--steps_per_call", type=int, default=1,
                   help="Steps per call of the on-device sampler (and per "
                        "reseed of the host-fed path's generator).")
    p.add_argument("--mesh", default=None,
                   help="Multi-device mesh as 'DATAxMODEL' (e.g. 2x2): the "
                        "batch is split over DATA, the entity table and its "
                        "optimizer state over MODEL; DATA*MODEL processes.")
    p.add_argument("--shard_corpus", action="store_true",
                   help="With --mesh and --on_device_sampling: shard the "
                        "device corpus over the data axis (each data group "
                        "holds and shuffles its own documents).")
    p.add_argument("--checkpoint_every", type=int, default=1,
                   help="Dump the per-epoch model/resume state every Nth "
                        "epoch (the final epoch always dumps).")
    add_distributed_flags(p)
    p.add_argument("--stream_dtype", default="float32", choices=("float32", "bfloat16"),
                   help="bfloat16 runs the gather / gradient-accumulation "
                        "streams at half width with float32 masters.")
    p.add_argument("--accum_dtype", default="float32", choices=("float32", "bfloat16"),
                   help="Accumulator width of the full_adam dense segment "
                        "accumulation (bfloat16: half-precision partial "
                        "sums).")
    p.add_argument("--shared_negatives", action="store_true",
                   help="Batch-shared negative sampling (requires sgd or "
                        "full_adam).")
    p.add_argument("--negative_pool_size", type=int, default=-1,
                   help="Rolled-pool negative sampling: per-step pool of P "
                        "uniform negatives, instance b uses cyclic slots "
                        "(b %% P)+j (requires sgd or full_adam and batch %% "
                        "P == 0).  -1 (default) auto-selects a pool when "
                        "eligible; pass 0 for the reference-exact "
                        "per-instance sampler.")
    p.add_argument("--negative_pool_stride", type=int, default=0,
                   help="Slot stride of the rolled-pool windows "
                        "(TrainConfig.negative_pool_stride).")
    p.add_argument("--window_sum_dtype", default="float32", choices=("float32", "bfloat16"),
                   help="Accumulator of the forward window average; "
                        "bfloat16 requires --stream_dtype bfloat16.")
    p.add_argument("--on_device_sampling", action="store_true",
                   help="Keep the packed corpus on the device and sample "
                        "batches there (stochastic training only; a "
                        "composite samples its similarity pairs there too, "
                        "on one device; fastest path).")
    p.add_argument("--reference_rng", action="store_true",
                   help="Replay the CUDA reference's host minstd_rand0 "
                        "stream bit-for-bit for instance order, Glorot init "
                        "and negative labels (forces per-instance sampling, "
                        "host-fed path only).")
    p.add_argument("--output", required=True)
    p.add_argument("--loglevel", default="INFO")
    add_device_flag(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = join_process_group(args)
    try:
        return _train(args, device)
    finally:
        distributed.shutdown()


def _train(args, device) -> int:
    logging.basicConfig(
        level=args.loglevel if distributed.is_primary() else "WARNING",
        format="%(asctime)s %(name)s %(levelname)s: %(message)s",
    )

    if args.seed <= 0:
        # CHECK_GT(FLAGS_seed, 0) (main.cu:708).
        print("Please specify a positive --seed value.", file=sys.stderr)
        return 1

    method, adam_mode = UPDATE_METHOD_NAMES[args.update_method]
    desc = ModelDesc(
        word_repr_size=args.word_repr_size,
        entity_repr_size=args.entity_repr_size,
        batch_normalization=args.batch_normalization,
        nonlinearity=NONLINEARITIES[args.nonlinearity],
        clip_sigmoid=True,  # always set by the CLI (main.cu:645)
        bias_negative_samples=args.bias_negative_samples,
        l2_normalize_phrase_reprs=args.l2_phrase_normalization,
        l2_normalize_entity_reprs=args.l2_entity_normalization,
    )
    cfg = TrainConfig(
        num_epochs=args.num_epochs,
        batch_size=args.batch_size,
        window_size=args.window_size,
        num_random_entities=args.num_random_entities,
        regularization_lambda=args.regularization_lambda,
        learning_rate=args.learning_rate,
        update_method=method,
        adam=AdamConfig(mode=adam_mode) if adam_mode else AdamConfig(),
        no_shuffle=args.no_shuffle,
        text_entity_weight=(
            1.0 - args.entity_similarity_weight - args.term_similarity_weight
        ),
        entity_entity_weight=args.entity_similarity_weight,
        term_term_weight=args.term_similarity_weight,
        seed=args.seed,
        stream_dtype=args.stream_dtype,
        accum_dtype=args.accum_dtype,
        shared_negatives=args.shared_negatives,
        negative_pool_size=args.negative_pool_size,
        negative_pool_stride=args.negative_pool_stride,
        window_sum_dtype=args.window_sum_dtype,
        reference_rng=args.reference_rng,
    )
    data_cfg = DataConfig(
        corpus_path=args.corpus_path,
        max_vocabulary_size=args.max_vocabulary_size,
        min_document_frequency=args.min_document_frequency,
        max_document_frequency=args.max_document_frequency,
        include_oov=args.include_oov,
        documents_cutoff=args.document_cutoff,
        document_list=args.document_list,
        term_blacklist=args.term_blacklist,
        similarity_path=args.similarity_path,
    )

    logging.info("Model descriptor: %s", desc)
    logging.info("Training configuration: %s", cfg)
    logging.info("Data configuration: %s", data_cfg)
    logging.info("Device: %s", device)

    corpus = load_corpus(data_cfg, cfg.window_size, args.stopwords)
    logging.info(
        "Corpus: %d documents, %d terms (%d occurrences).",
        corpus.num_docs, corpus.vocab.size, corpus.vocab.total_terms,
    )

    similarity_source = None
    if args.similarity_path:
        if args.entity_similarity_weight > 0:
            identifiers = corpus.docno_to_id()
        else:
            identifiers = dict(corpus.vocab.term_to_id)
        ids, weights = load_similarities(args.similarity_path, identifiers)
        logging.info("Loaded %d similarity pairs.", len(ids))
        similarity_source = SimilaritySource(ids, weights, cfg.batch_size, seed=cfg.seed)

    result = train_model(
        desc,
        cfg,
        corpus,
        device,
        output_prefix=args.output,
        similarity_source=similarity_source,
        feature_weighting=FeatureWeighting(args.feature_weighting),
        weighting=Weighting(args.weighting),
        compute_initial_cost=args.compute_initial_cost,
        dump_initial_model=args.dump_initial_model,
        dump_every=args.dump_every,
        resume=args.resume,
        check_gradients=args.check_gradients,
        profile_dir=args.profile_dir,
        log_every=args.log_every,
        steps_per_call=args.steps_per_call,
        mesh=mesh_from_flag(args.mesh),
        on_device_sampling=args.on_device_sampling,
        shard_corpus=args.shard_corpus,
        checkpoint_every=args.checkpoint_every,
    )
    logging.info(
        "Finished: %d epochs, %.1f batches/s overall.",
        len(result.epoch_costs), result.batches_per_sec,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
