#!/usr/bin/env python3
"""Measured steady-state end-to-end training throughput at collection
scale, on the PyTorch port (``cunvsm_torch``): ``scripts/e2e_throughput.py``
with its corpus, configuration, flags and output keys.

The whole training loop, timed the way the reference logs it (epoch wall
clock and batches/s, cpp/main.cu:598-612): a collection-scale synthetic
corpus (262,144 documents, canonical NVSM hyperparameters with bfloat16
streams and window sums), on-device epoch-exact sampling, K steps per
call, the async checkpoint writer, for enough epochs that the first
epoch's one-time costs (kernel builds, warm-up) amortize.

Corpus: Zipf-distributed tokens over the canonical 65,536-term vocabulary
(``cunvsm_torch.data.synth.zipf_corpus``, generator seed 4242), fixed
document length ``--doc_len`` (default 120: 111 sampled windows per
document per epoch, 568 steps of 51,200 pairs per epoch at the canonical
batch).

Writes one JSON object to ``--out`` (and stdout) with:
  * the wall clock of every epoch but the first, from one epoch callback
    to the next, and the first (kernel builds and warm-up included);
  * steady-state pairs/s = pairs per epoch / median of epochs 2.. ;
  * the writer's drain after the last epoch and the whole run's wall;
  * ``device``: the card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them, or
    ``cpu`` (the JAX script's ``platform``).

One difference from the JAX script: the port's trainer waits for the async
writer before the epoch callback of an epoch it dumps, on the on-device
path too (the JAX trainer waits there only on its host-fed path), so a dump
epoch's wall here includes the writer's drain.

    python3 scripts/e2e_throughput_torch.py --out e2e.json [--workdir DIR]
    torchrun --nproc_per_node 4 scripts/e2e_throughput_torch.py --out e2e.json \\
        --distributed --mesh 2x2 [--shard_corpus]
    python3 scripts/e2e_throughput_torch.py --device cpu --num_docs 2048 \\
        --batch_size 512 --epochs 3 --steps_per_call 4 --word_repr_size 16 \\
        --entity_repr_size 16 --out e2e.json

``--device`` (default ``cuda``) takes the place of ``--platform``; a run
without a card fails unless it is given ``--device cpu``.  A mesh run is
one process per device, started with the launch flags of
``cunvsm-torch-train``; the primary alone writes ``--out``.  The model
files go under ``--workdir`` (default: a new temporary directory, removed
at the end).
"""

import argparse
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
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
    ModelDesc,
    Nonlinearity,
    TrainConfig,
    UpdateMethod,
)
from cunvsm_torch.data.synth import zipf_corpus  # noqa: E402
from cunvsm_torch.parallel import distributed  # noqa: E402
from cunvsm_torch.train.trainer import train_model  # noqa: E402

VOCAB = 65536


def make_corpus(num_docs: int, doc_len: int, gen_seed: int = 4242):
    return zipf_corpus(num_docs, doc_len, VOCAB, seed=gen_seed)


def device_description(device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[device.index or 0]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    ap.add_argument("--out", required=True)
    ap.add_argument("--num_docs", type=int, default=262144)
    ap.add_argument("--doc_len", type=int, default=120)
    ap.add_argument("--batch_size", type=int, default=51200)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--steps_per_call", type=int, default=8)
    ap.add_argument("--checkpoint_every", type=int, default=5,
                    help="epoch-checkpoint cadence; 0 disables checkpointing entirely")
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL (e.g. 2x2): the sharded path over a mesh, one "
                         "process per device")
    ap.add_argument("--shard_corpus", action="store_true",
                    help="with --mesh: shard the device corpus over the data axis "
                         "(each device holds only its document group's tokens)")
    ap.add_argument("--word_repr_size", type=int, default=300)
    ap.add_argument("--entity_repr_size", type=int, default=256)
    ap.add_argument("--workdir", default=None,
                    help="directory of the model files (default: a temporary one, "
                         "removed at the end)")
    add_distributed_flags(ap)
    add_device_flag(ap)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level="INFO", format="%(asctime)s %(message)s")
    device = join_process_group(args)
    try:
        return _run(args, device)
    finally:
        distributed.shutdown()


def _run(args, device) -> int:
    corpus = make_corpus(args.num_docs, args.doc_len)
    logging.info("Corpus: %d docs x %d tokens = %d total tokens.",
                 args.num_docs, args.doc_len, len(corpus.tokens))
    desc = ModelDesc(
        word_repr_size=args.word_repr_size,
        entity_repr_size=args.entity_repr_size,
        nonlinearity=Nonlinearity.HARD_TANH, batch_normalization=True,
    )
    cfg = TrainConfig(
        num_epochs=args.epochs, batch_size=args.batch_size, window_size=10,
        num_random_entities=10, regularization_lambda=1e-2,
        learning_rate=1e-3, update_method=UpdateMethod.ADAM,
        adam=AdamConfig(mode=AdamMode.DENSE_UPDATE_DENSE_VARIANCE),
        seed=1, stream_dtype="bfloat16", window_sum_dtype="bfloat16",
    )

    epoch_wall = []
    last = [None]

    def cb(epoch, params, cost):
        # The trainer calls back after its one host read of the epoch's
        # cost, so the epoch's device work has ended here.
        now = time.time()
        if last[0] is not None:
            epoch_wall.append(round(now - last[0], 2))
        last[0] = now

    own_workdir = args.checkpoint_every and args.workdir is None
    workdir = tempfile.mkdtemp(prefix="e2e_") if own_workdir else args.workdir
    prefix = os.path.join(workdir, "model") if args.checkpoint_every else None
    if prefix and distributed.is_primary():
        os.makedirs(workdir, exist_ok=True)
    samples_per_doc = max(args.doc_len - 10 + 1, 1)  # ceil(avg - w + 1)
    # The trainer trains EVERY epoch step (a non-dividing steps_per_call
    # runs the remainder as one extra call), so pairs/s counts the full
    # epoch.
    steps_per_epoch = max(args.num_docs * samples_per_doc // args.batch_size, 1)
    pairs_per_epoch = steps_per_epoch * args.batch_size

    try:
        start = time.time()
        last[0] = start
        result = train_model(
            desc, cfg, corpus, device,
            output_prefix=prefix,
            on_device_sampling=True,
            steps_per_call=args.steps_per_call,
            checkpoint_every=args.checkpoint_every or 10**9,
            epoch_callback=cb,
            mesh=mesh_from_flag(args.mesh),
            shard_corpus=args.shard_corpus,
        )
        loop_done = time.time()
    finally:
        if own_workdir:
            shutil.rmtree(workdir, ignore_errors=True)
    # train_model's finally has drained the async writer by the time it
    # returns: the post-loop tail (writer drain) is the time from the last
    # epoch callback to the return.
    drain_s = loop_done - last[0]
    total_s = loop_done - start

    steady = sorted(epoch_wall[1:]) if len(epoch_wall) > 1 else epoch_wall
    steady_epoch_s = steady[len(steady) // 2] if steady else None
    out = {
        "metric": "e2e_train_pairs_per_sec_steady_state",
        "value": round(pairs_per_epoch / steady_epoch_s, 1) if steady_epoch_s else None,
        "unit": "pairs/s",
        "num_docs": args.num_docs,
        "batch_size": args.batch_size,
        "steps_per_call": args.steps_per_call,
        "steps_per_epoch": steps_per_epoch,
        "pairs_per_epoch": pairs_per_epoch,
        "epochs": args.epochs,
        "epoch_wall_s": epoch_wall,
        "epoch1_incl_compile_s": epoch_wall[0] if epoch_wall else None,
        "steady_epoch_s": steady_epoch_s,
        "checkpoint_every": args.checkpoint_every,
        "writer_drain_s": round(drain_s, 1),
        "total_wall_s": round(total_s, 1),
        "final_cost": result.epoch_costs[-1] if result.epoch_costs else None,
        "device": device_description(device),
        "mesh": args.mesh,
        "shard_corpus": args.shard_corpus,
    }
    if distributed.is_primary():  # one writer under multi-process
        with open(args.out, "w") as f:
            f.write(json.dumps(out) + "\n")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
