#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``cunvsm_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py [--seed N]     # about nine minutes

It builds the kernels from the sources in the checkout: the sweep with
Triton (its cache goes under build/triton), the cast and the segment sum
with nvcc (into build/cuda), and the C++ corpus reader with g++ (into
build/native), and runs the port's main path:

  A  each kernel against its plain PyTorch version at the shapes of the
     main path, bitwise (sweep: m', v' and p' on [65536, 300] and
     [262144, 256] float32; cast: [65536, 300], an operand of edge values
     and random bit patterns with NaN checked as NaN, a slice that starts
     one element in, and 5 elements; segment sum: full_adam's accumulation
     of the word table, [65536, 300] from 51,200 x 10 Zipf 1.07 ids, and of
     the entity table, [262144, 256] from 51,200 labels and 2,048 pool
     rows, under bfloat16 streams, bitwise to the plain version on the same
     plan and within n * 2^-24 * mass of a float64 sum), with the time of
     each (CUDA events: the median of 40 single calls, and 20 calls back to
     back between one pair of events, divided by 20);
  B0 three steps of a small configuration on the card (float32, kernels)
     against the same steps on the CPU in float64 (plain versions);
  B  the canonical NVSM configuration of bench.py at full width (V 65536,
     N 262144, d 300->256, B 51200, W 10, k 10, hard_tanh + BN, full_adam,
     bfloat16 streams, pool auto = 2048 / stride 205) for 23 steps from a
     Zipf corpus of 262144 documents x 32 tokens through TextEntitySource;
     every cost finite, the sweep launched twice, the cast once and the
     segment sum twice per step, ``index_add_`` never (``read_launches``:
     every phase below holds the four counts to its rule);
  C  train_model on the three-topic corpus of
     tests/test_train_integration.py (cost falls below 0.6x, MAP > 0.8),
     then top-1000 rankings of 100 random queries over the phase-B tables;
  D  the same configuration through on-device sampling, on phase B's
     corpus: D1 one whole epoch (117 steps, calls of K = 13) of the
     epoch-exact multistep (under torch.cuda.set_sync_debug_mode("error"),
     so no op of it may wait for the device), after checking the device
     permutation against the epoch's pointers and one batch's windows
     against the corpus; D2 train_model(on_device_sampling=True) for 2
     epochs into HDF5 checkpoints under build/, the last read back
     bitwise, then a resumed third epoch.  Every cost finite, the sweep
     launched twice and the cast once per step;
  E0 three small steps of each of eight more configurations on the card
     (float32, kernels) against the same steps on the CPU (float64, plain
     versions), fed the same draws: sgd, adagrad, sparse_adam and
     dense_adam; full_adam with the entity L2 normalizer; full_adam with
     batch-shared negatives; the two "Mix 'n Match" composites
     (TEXT_ENTITY_ENTITY_ENTITY, TEXT_ENTITY_TERM_TERM) under full_adam;
  E  the same eight at phase B's full width on phase B's corpus: the six
     text-entity ones through on-device sampling, one warm-up call and one
     timed call of K = 13 steps under set_sync_debug_mode("error"); the two
     composites through train_model(similarity_source=...) on the host-fed
     path for 2 epochs, fed a similarity file of one pair per document made
     from --seed and read back with load_similarities.  Each prints
     ms/step, pairs/s, peak MiB, its first and last cost (all finite) and
     its negative layout, and asserts its launches per step: the sweep and
     the segment sum 2 under full_adam and 0 otherwise, the cast 1 where
     the factored, pooled or shared path runs under bfloat16 streams and 0
     on the expanded per-instance path;
  F  the command-line entry points, in process: F1 cunvsm-torch-train
     (``cunvsm_torch.cli.train.main``) on phase B's corpus saved as a
     packed .npz, with the canonical flags, on-device sampling in calls of
     K = 13, 2 epochs and the initial cost (which must exceed the last
     epoch's), its files read back by the port, 2 sweeps and 1 cast per
     trained step with the initial-cost pass counted apart; F2
     cunvsm-torch-query (``cunvsm_torch.cli.query.main``) on F1's model
     for 100 topics made from --seed out of the vocabulary: top-1000 with
     float32 and with bfloat16 scores (every document in the bfloat16
     run's top 10 scores, in float32, within 2^-7 of the float32 run's
     document at that rank, which is as far as rounding both operands to
     bfloat16 can move two cosines; the bfloat16 engine's float32 scores
     within 1e-5 of float32 sums of its bfloat16 products), then a qrels
     file of 50
     documents per topic as --top_k, its scores held to
     ``QueryEngine.score_documents``; F3
     --reference_rng through cunvsm-torch-train on the three-topic corpus
     written as TRECTEXT, on the card and on the CPU (the same host
     stream: tables within 1e-5 relative and 1e-4 absolute), and the
     card's model ranked through cunvsm-torch-query at MAP > 0.8;
  G  the tools and the last single-device modules: G1 the 16,384-document
     corpus of scripts/collection_scale_study_torch.py (120 tokens each,
     V 32768) written as a synthetic Indri repository under build/ with
     tests/indri_fixture.py, read by the Python reader and by the C++
     reader (every array, the vocabulary and the docnos equal; both times
     and the g++ build's printed), then cunvsm-torch-train on the
     repository (canonical flags, on-device sampling, 2 epochs: 2 sweeps
     and 1 cast per step, a falling cost, the ``_meta`` ids the
     repository's) and cunvsm-torch-query on the model; G2 one seed each
     of the study's ``perinst`` and ``pool2048_s205`` configurations, 30
     epochs, MAP over 512 held-out queries at least 0.92 (the JAX package's
     five-seed means are 0.9342 and 0.9373); G3 on F1's model: the ``nvsm``
     compat API against ``QueryEngine``, ``TermBruteforcer`` (65,536
     1-grams and 2,016 2-grams) against a float64 computation of the same
     cosines up to ties at 1e-5, cunvsm-torch-combine-runs over F2's two
     runs against ``fuse_fixed_alpha``, cunvsm-torch-dump-vocabulary and
     cunvsm-torch-visualize's projector files read back; G4
     ``accum_dtype="bfloat16"``: the bfloat16 accumulator at the canonical
     shape against the float32 one, within n * 2^-8 of the mass summed into
     a row of n updates (and two runs of it against each other, within
     twice that: ``index_add_`` adds in no fixed order), then
     one warm-up and one timed call of K = 13 with each accumulator from
     the same draws, the costs within G4_COST_RTOL;
  H  the mesh path (``cunvsm_torch/parallel``), on the one card, with the
     word reduce in float32 so that only the order of the sums differs from
     one device: H1 a process group of one rank with NCCL on cuda:0 and a
     1x1 mesh: ``train_model(mesh=, on_device_sampling=True)`` for one epoch
     (117 steps in calls of K = 13) through the sharded multistep, held to
     the single-device ``train_model`` run of the same seed.  Wherever a
     sum of the step adds in no fixed order, 117 Adam steps amplify its last
     bit (``scripts/run_to_run_spread_torch.py``), so each side trains the
     epoch twice: with the default kernels (the time, 2 sweeps and 1 cast per
     step, every collective printed with its calls and bytes, the epoch
     cost within H_COST_RTOL) and under
     ``torch.use_deterministic_algorithms``, where every table entry is
     held to H_TABLE_ATOL; then two calls of K = 13 with the default
     kernels, bfloat16 and float32 streams, held to the mesh script's
     LIMITS; H2 ``scripts/mesh_phase_torch.py``: four
     processes on the one card as a 2x2 mesh.  NCCL refuses two ranks on one
     device, so the group is gloo, asked for by name, and every buffer is
     staged through the host (the log says so): the times say nothing of
     four cards.  One warm-up and one timed call of K = 13, costs and
     fetched tables against the same two calls on one device from the same
     draws (costs within 1e-5, tables by root-mean-square, share and largest
     difference, with bfloat16 and with float32 streams: the script's
     LIMITS), each rank's entity sweep over its [131072, 256] shard, 2 sweeps
     and 1 cast per step on every rank, the same calls with the bfloat16
     word reduce (half the bytes), one padded step with N = 262143, one
     epoch of ``train_model(mesh=, shard_corpus=True)`` into a model file
     on the documents cut to 12 tokens (15 steps) against one device that
     plays the data groups, the model file bitwise the fetched tables, and
     100 queries, top 1000, through ``QueryEngine(mesh=)`` in two shards
     with float32 and bfloat16 scores against the single-device engine.  A
     rank that fails fails the script; a rank that hangs is killed at a
     deadline;
  I  the evaluation pipelines, called in process (PHASE_I): I1
     ``scripts/rank_adhoc_torch.py`` on a four-index Indri repository of
     65,536 documents from ``scripts/make_adhoc_fixture.py`` (made in a
     process of its own while phases B-H run), canonical width with
     bfloat16 streams, on-device sampling in calls of K = 13, 4 epochs,
     validation and a dump every 2: a first run that must raise the
     simulated crash after epoch 2, then ``--resume``, which must start at
     epoch 3; the curve holds epochs 2 and 4, results.json every key, the
     NVSM test MAP at least I_MIN_NVSM_MAP, 2 sweeps and 1 cast per step,
     ms/step per epoch and each stage's wall time printed; I2 the same two
     runs on a 1x1 mesh over an NCCL group of one rank (resume under a
     mesh), held to I1 on the resumed epoch, the curve's epochs and the QLM
     MAPs; I3 ``scripts/rank_cranfield_torch.py`` on a synthetic collection
     of Cranfield's size (1,398 documents, 225 topics, made from --seed):
     LSE (host-fed, batch 4096) and NVSM (batch 51200) at full width for 3
     epochs with bfloat16 streams, the grid-CV fusion off, the QLM MAPs
     equal to the same call on the CPU, then NVSM on a 1x1 mesh (the
     host-fed mesh trainer); I4 ``scripts/product_substitutability_torch.py``
     on a synthetic product fixture (65,536 products, 2,048 topics) at full
     width: the TEXT_ENTITY_ENTITY_ENTITY composite at weight 0.1 for 2
     epochs, costs finite, the selected epoch one that was validated, 2
     sweeps and no cast per step (float32 streams).  Its time is printed
     beside its budget, I_BUDGET_S;
  J  the last scripts of the JAX package, called in process (PHASE_J): J1
     ``scripts/visualize_reuters_torch.py`` on synthetic SGML of
     Reuters-21578's size (21,578 articles, a tenth without a topic, the
     others in 10 topic classes, 64 words each, made from --seed) at the
     script's widths (d 300 -> 256, batch 4096, full_adam with float32
     streams: 2 sweeps and no cast per step) for 3 epochs: the cosine class
     silhouette must rise from epoch 1 to 3; the t-SNE plots are skipped
     and logged where scikit-learn or matplotlib is missing; J2
     ``scripts/quality_seeds_torch.py --config auto`` on I3's Cranfield
     shape, seeds 1 and 2, 3 epochs, the runs dumped: its lines read back
     by the unchanged ``scripts/quality_stats.py``, every MAP in [0, 1],
     every dumped run read back with at most 1000 documents a topic; J3
     ``scripts/fusion_study_torch.py`` over J2's runs, its default cells;
     J4 ``scripts/e2e_throughput_torch.py`` on 65,536 Zipf documents x 120
     tokens, canonical width, 3 epochs of 142 steps in calls of K = 8, a
     dump every 2 epochs: its output line printed, the model files of
     epochs 2 and 3 read back; J5 ``scripts/bench_query_torch.py`` at its
     defaults (262,144 documents, top 1000), its lines printed.  J1, J2 and
     J4 hold their launches per step to the rule of their configuration
     (``expected_launches``).  Its time is printed beside its budget,
     J_BUDGET_S.

Without a CUDA device it exits with an error before printing any result.
The last line of its output is one JSON object with "ok" and the device;
the line before it lists each kernel with its launches (in all and by
phase; for the segment sum also its fallbacks to ``index_add_``), error,
times, the least time the card could take for the same
work (``bound_ms``: the bytes it must move over 3.35 TB/s, or its float32
operations over 67 TFLOP/s, whichever is larger; ``bound_by`` says which)
and the time of one PyTorch call computing the same function
(``library_ms``; null where there is none).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import json
import logging
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from cunvsm_torch.cli import combine_runs as combine_runs_cli
from cunvsm_torch.cli import dump_vocabulary as dump_vocabulary_cli
from cunvsm_torch.cli import query as query_cli
from cunvsm_torch.cli import train as train_cli
from cunvsm_torch.cli import visualize as visualize_cli
from cunvsm_torch.compat import nvsm as nvsm_compat
from cunvsm_torch.config import (
    AdamConfig,
    AdamMode,
    DataConfig,
    ModelDesc,
    Nonlinearity,
    TrainConfig,
    UpdateMethod,
)
from cunvsm_torch.data import device_sampler, native
from cunvsm_torch.data.corpus import build_corpus, load_corpus
from cunvsm_torch.data.indri import IndriIndex
from cunvsm_torch.data.instances import TextEntitySource
from cunvsm_torch.data.sources import SimilaritySource, load_similarities
from cunvsm_torch.data.synth import zipf_corpus
from cunvsm_torch.data.text import tokenize
from cunvsm_torch.io import checkpoint
from cunvsm_torch.io.trec import read_run
from cunvsm_torch.models.objectives import SimilarityBatch, SparseGrad, TextEntityBatch
from cunvsm_torch.models.params import init_params, params_from_numpy, params_to_numpy
from cunvsm_torch.ops import adam_sweep, cast, cuda_build, segment_kernels
from cunvsm_torch.optim.updates import Optimizer, _sorted_segment_accumulate
from cunvsm_torch.parallel import distributed
from cunvsm_torch.parallel import mesh as pmesh
from cunvsm_torch.query.engine import (QueryEngine, TermBruteforcer, _project_queries,
                                       _rank_kernel, load_query_engine)
from cunvsm_torch.query.fusion import fuse_fixed_alpha
from cunvsm_torch.query.metrics import evaluate_run
from cunvsm_torch.train.step import (
    ObjectiveKind,
    make_train_step,
    objective_kind_from_config,
    resolve_negative_sampling,
)
from cunvsm_torch.train.trainer import negative_layout, train_model

# The canonical configuration (bench.py), the size of phase B and the
# steps per call of phase D (a divisor of the epoch's 117 steps).
CANONICAL = dict(
    num_words=65536, num_entities=262144, doc_len=32, word_dim=300,
    entity_dim=256, batch=51200, window=10, negatives=10, warmup=3, steps=20,
    steps_per_call=13,
)
ROOT = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(ROOT, "build")
SWEEP_HYPER = dict(lam=0.01 / 51200, beta1=0.9, beta2=0.999, eps=1e-6)
# The card's peaks (NVIDIA's H100 SXM data sheet, at 700 W): HBM bytes/s
# and float32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Float32 operations per element: the sweep's agg = s - lam*p (2), m' (3),
# v' (4) and p' = p + scale*m'/(sqrt(v')+eps) (5); the cast's rounding (1).
SWEEP_OPS, CAST_OPS = 14, 1


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> list:
    """Per-call times of ``fn`` on the card, in ms (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def back_to_back_ms(fn, calls: int = 20, reps: int = 10) -> list:
    """ms per call of ``calls`` calls back to back between one pair of CUDA
    events, ``reps`` times.  Unlike a pair of events around one call of a
    kernel of tens of microseconds, this leaves the host's launch latency
    out, as long as the host enqueues faster than the device runs."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return times


def paired_ms(kernel_fn, plain_fn) -> dict:
    """Times of the kernel and its plain version, measured in turns plain,
    kernel, kernel, plain: ``ms`` and ``plain_ms`` are medians of the
    back-to-back figures, ``*_per_call`` medians of single calls."""
    runs = {"kernel": ([], []), "plain": ([], [])}
    for side in ("plain", "kernel", "kernel", "plain"):
        fn = kernel_fn if side == "kernel" else plain_fn
        runs[side][0].extend(cuda_ms(fn))
        runs[side][1].extend(back_to_back_ms(fn))
    med = statistics.median
    return dict(
        ms=med(runs["kernel"][1]), plain_ms=med(runs["plain"][1]),
        ms_per_call=med(runs["kernel"][0]), plain_ms_per_call=med(runs["plain"][0]),
    )


def format_ms(t: dict) -> str:
    return (f"kernel_ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} (20 back to back); "
            f"per call kernel {t['ms_per_call']:.4f} plain {t['plain_ms_per_call']:.4f}")


def bound(num_bytes: float, ops: float) -> dict:
    """The least time the card could take: bytes over the HBM rate or
    operations over the float32 rate, whichever is larger."""
    bytes_ms, ops_ms = 1e3 * num_bytes / HBM_BYTES_PER_S, 1e3 * ops / F32_OPS_PER_S
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def canonical_desc_cfg(sizes):
    desc = ModelDesc(
        word_repr_size=sizes["word_dim"], entity_repr_size=sizes["entity_dim"],
        nonlinearity=Nonlinearity.HARD_TANH, batch_normalization=True,
    )
    cfg = TrainConfig(
        batch_size=sizes["batch"], window_size=sizes["window"],
        num_random_entities=sizes["negatives"], update_method=UpdateMethod.ADAM,
        adam=AdamConfig(mode=AdamMode.DENSE_UPDATE_DENSE_VARIANCE),
        learning_rate=1e-3, regularization_lambda=1e-2,
        stream_dtype="bfloat16", window_sum_dtype="bfloat16",
        uniform_feature_weights=True, negative_pool_size=-1,
    )
    return desc, cfg


def sweep_operands(rows, dim, device, gen):
    """Sweep operands (p, m, v, s) at the scales of a training step.

    Half the rows of the gradient s are zero, as for rows no instance
    touched: there agg is -lam * p alone, so a sweep without the L2 term
    leaves m' and p' visibly wrong.  v is of the order of s**2, so v' moves
    by about a thousandth of itself and a sweep that never stores v' shows.
    """
    s = torch.randn((rows, dim), device=device, generator=gen) * 1e-3
    s[rows // 2:] = 0.0
    m = torch.randn((rows, dim), device=device, generator=gen) * 1e-4
    v = torch.rand((rows, dim), device=device, generator=gen) * 2e-6
    p = (torch.rand((rows, dim), device=device, generator=gen) - 0.5) * 0.2
    return p, m, v, s


def check_sweep(device, rows, dim, gen):
    """The sweep kernel against its plain version, bitwise.

    Both compute the same IEEE operations in the same order (``_rn``
    division and square root, no FMA contraction), so m', v' and p' must be
    equal bit for bit.  The operands are first shown to expose a sweep that
    drops the L2 term or skips a store.  Returns the operands, the kernel's
    outputs and the max abs difference (0.0).
    """
    p, m, v, s = sweep_operands(rows, dim, device, gen)
    scale = torch.tensor(1e-3 * 0.0316, device=device)
    ref = [t.clone() for t in (p, m, v)]
    got = [t.clone() for t in (p, m, v)]
    no_l2 = [t.clone() for t in (p, m, v)]
    adam_sweep.sweep_plain(*ref, s, scale, **SWEEP_HYPER)
    adam_sweep.sweep_plain(*no_l2, s, scale, **{**SWEEP_HYPER, "lam": 0.0})
    for name, before, after, wrong in zip(("p", "m", "v"), (p, m, v), ref, no_l2):
        if torch.equal(before, after):
            raise AssertionError(f"sweep operands leave {name} unchanged")
        if name != "v" and torch.equal(after, wrong):
            raise AssertionError(f"sweep operands hide the L2 term in {name}'")
    adam_sweep.fused_adam_dense_sweep(*got, s, scale, **SWEEP_HYPER)
    torch.cuda.synchronize()
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    for name, g, r in zip(("p'", "m'", "v'"), got, ref):
        if not torch.equal(g, r):
            raise AssertionError(
                f"sweep kernel {name} on [{rows}, {dim}] differs from the plain "
                f"version: max abs {float((g - r).abs().max()):.3e}")
    return (p, m, v, s, scale), got, err


# float32 bit patterns at the edges of the float32 -> bfloat16 rounding.
CAST_EDGE_BITS = (
    0x3F808000, 0x3F818000, 0xBF808000,  # exact ties: round to the even neighbour
    0x00000001, 0x80000001, 0x00008000, 0x007FFFFF,  # subnormals (a tie; the largest)
    0x00000000, 0x80000000, 0x7F800000, 0xFF800000,  # +-0, +-inf
    0x7F7F7FFF, 0x7F7F8000, 0x7F7FFFFF, 0xFF7FFFFF,  # largest finite bf16, then inf
    0x7FC00000, 0xFFC00000, 0x7F800001, 0x7FC00001, 0x7FFFFFFF,  # NaNs
)


def cast_operands(device, sizes, gen):
    """The cast's operands: the main path's table, an operand of edge values
    and random bit patterns (odd length), a slice of the table that starts
    one element in (misaligned, odd length) and 5 elements."""
    x = torch.randn((sizes["num_words"], sizes["word_dim"]), device=device, generator=gen)
    x = x * torch.exp(torch.rand(x.shape, device=device, generator=gen) * 40 - 20)
    edge = torch.tensor(np.array(CAST_EDGE_BITS, np.uint32).view(np.int32), device=device)
    bits = torch.randint(-2**31, 2**31, ((1 << 20) + 1,), device=device, generator=gen,
                         dtype=torch.int64).to(torch.int32)
    edge = torch.cat([edge, bits]).view(torch.float32)
    return [
        (f"[{x.shape[0]}, {x.shape[1]}]", x), (f"edge values + random bits [{edge.numel()}]", edge),
        (f"x.view(-1)[1:] [{x.numel() - 1}]", x.view(-1)[1:]), ("[5]", x.view(-1)[:5].clone()),
    ]


def check_cast(name, x):
    """The cast kernel against ``.to(torch.bfloat16)``: bitwise where the
    result is not NaN, NaN where it is NaN.  Returns the result."""
    before = cast.cast_table.launches
    y = cast.cast_table(x, torch.bfloat16)
    ref = cast.cast_plain(x, torch.bfloat16)
    torch.cuda.synchronize()
    if cast.cast_table.launches != before + 1:
        raise AssertionError(f"cast_table did not launch its kernel on {name}")
    nan = torch.isnan(ref)
    if not torch.equal(torch.isnan(y), nan):
        raise AssertionError(f"cast kernel on {name}: NaN where .to(bfloat16) has none, or not")
    yb, rb = y.view(torch.int16), ref.view(torch.int16)
    if not torch.equal(yb[~nan], rb[~nan]):
        bad = int((yb[~nan] != rb[~nan]).sum())
        raise AssertionError(f"cast kernel on {name}: {bad} values differ from .to(bfloat16)")

    def patterns(t):
        return sorted(f"0x{v & 0xFFFF:04X}" for v in t[nan].cpu().unique().tolist())

    log(f"A cast {name}: bitwise equal to .to(bfloat16) off NaN; {int(nan.sum())} NaN, "
        f"bits kernel {patterns(yb)} plain {patterns(rb)}")
    return y


def segment_operands(device, sizes, gen):
    """full_adam's two accumulations of a canonical step: the word table's
    descriptor, [B, d] gradient rows and B x W ids drawn from Zipf 1.07 over
    the vocabulary (the commonest word holds about 12% of the entries), and
    the entity table's two, B labels and the 2,048 rows of the negative
    pool, uniform over the documents.  Returns (name, rows, descriptors)."""
    b, w = sizes["batch"], sizes["window"]
    zipf = torch.arange(1, sizes["num_words"] + 1, dtype=torch.float64, device=device)
    zipf = zipf.pow(-1.07).to(torch.float32)
    word = SparseGrad(
        torch.randn((b, sizes["word_dim"]), device=device, generator=gen) * 1e-3,
        torch.multinomial(zipf, b * w, replacement=True, generator=gen).reshape(b, w), None)
    entity = tuple(
        SparseGrad(torch.randn((n, sizes["entity_dim"]), device=device, generator=gen) * 1e-3,
                   torch.randint(0, sizes["num_entities"], (n, 1), device=device, generator=gen),
                   None)
        for n in (b, 2048))
    return [("word", sizes["num_words"], (word,)), ("entity", sizes["num_entities"], entity)]


def check_segment_sum(name, num_rows, descs):
    """The segment sum under bfloat16 streams against its plain version on
    the same plan, bitwise, and against a float64 sum of the same rounded
    terms within n * 2^-24 * mass in every row and column (n terms in the
    row), the bound of a float32 sum in any order.  Returns the max abs
    difference from float64, its largest share of that bound and the
    plain version's seconds (one call, driven from the host)."""
    stream = torch.bfloat16
    before = segment_kernels.segment_sum.launches
    got = segment_kernels.segment_sum(num_rows, descs, stream)
    plan = segment_kernels.plan_segments(num_rows, descs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = segment_kernels.segment_sum_plain(num_rows, descs, stream, plan)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if segment_kernels.segment_sum.launches != before + 1:
        raise AssertionError(f"segment_sum did not launch its kernel on the {name} table")
    if not torch.equal(got, ref):
        raise AssertionError(
            f"segment sum of the {name} table differs from the plain version: max abs "
            f"{float((got - ref).abs().max()):.3e}")
    del ref
    wide = tuple(d._replace(grad=d.grad.double()) for d in descs)
    exact = segment_kernels.index_add_sum(num_rows, wide, stream)
    mass = segment_kernels.index_add_sum(
        num_rows, tuple(d._replace(grad=d.grad.abs()) for d in wide), stream)
    count = torch.bincount(torch.cat([d.indices.reshape(-1) for d in descs]), minlength=num_rows)
    err = (got.double() - exact).abs()
    limit = count.to(torch.float64)[:, None] * 2.0 ** -24 * mass
    if bool((err > limit).any()):
        raise AssertionError(
            f"segment sum of the {name} table misses n * 2^-24 * mass by "
            f"{float((err - limit).max()):.3e}")
    share = float((err / limit.clamp(min=1e-300)).max())
    return float(err.max()), share, plain_s, int(count.max())


def phase_segment_sum(device, sizes, gen):
    """The segment sum at both of nvsm.train's tables: checked, then timed
    with its plan, its two passes alone, and ``index_add_sum``, the
    library path it replaced, which the CPU keeps."""
    totals, err, num_bytes, ops = {}, 0.0, 0, 0
    for name, num_rows, descs in segment_operands(device, sizes, gen):
        e, share, plain_s, longest = check_segment_sum(name, num_rows, descs)
        err = max(err, e)
        plan = segment_kernels.plan_segments(num_rows, descs)
        t = dict(
            ms=statistics.median(back_to_back_ms(
                lambda: segment_kernels.segment_sum(num_rows, descs, torch.bfloat16))),
            ms_per_call=statistics.median(cuda_ms(
                lambda: segment_kernels.segment_sum(num_rows, descs, torch.bfloat16), reps=40)),
            passes_ms=statistics.median(back_to_back_ms(
                lambda: segment_kernels._launch(num_rows, descs, torch.bfloat16, plan))),
            library_ms=statistics.median(back_to_back_ms(
                lambda: segment_kernels.index_add_sum(num_rows, descs, torch.bfloat16))),
            library_ms_per_call=statistics.median(cuda_ms(
                lambda: segment_kernels.index_add_sum(num_rows, descs, torch.bfloat16), reps=40)),
            plain_ms=1e3 * plain_s, plain_ms_per_call=1e3 * plain_s,
        )
        dim = descs[0].grad.shape[1]
        entries = sum(d.indices.numel() for d in descs)
        # The gradient rows read once, the ids (int64), the table written.
        moved = sum(d.grad.numel() * 4 + d.indices.numel() * 8 for d in descs) + num_rows * dim * 4
        log(f"A segment sum {name} [{num_rows}, {dim}] from {entries} entries (longest row "
            f"{longest}): bitwise equal to the plain version; max abs err vs float64 {e:.3e}, "
            f"{share:.3f} of n*2^-24*mass; kernel_ms={t['ms']:.4f} with the plan, passes "
            f"{t['passes_ms']:.4f} (20 back to back), per call {t['ms_per_call']:.4f}; "
            f"index_add_sum {t['library_ms']:.4f}, per call {t['library_ms_per_call']:.4f}; "
            f"plain one call {t['plain_ms']:.1f}; bound {bound(moved, entries * dim)['bound_ms']:.4f}")
        totals = {k: totals.get(k, 0.0) + t[k] for k in t}
        num_bytes, ops = num_bytes + moved, ops + entries * dim
        del plan
    return dict(max_abs_err=err, **totals, **bound(num_bytes, ops))


def phase_a(device, sizes):
    """Each kernel against its plain version at the main path's shapes."""
    out = {}
    gen = torch.Generator(device=device).manual_seed(0)
    t0 = time.perf_counter()
    cuda_build.build_library("cast_bf16", ("cast_bf16.cu",))
    log(f"A nvcc build of the cast: {time.perf_counter() - t0:.1f}s")
    sweep_err, sweep_t, elements = 0.0, {}, 0
    for rows, dim in ((sizes["num_words"], sizes["word_dim"]),
                      (sizes["num_entities"], sizes["entity_dim"])):
        (p, m, v, s, scale), got, err = check_sweep(device, rows, dim, gen)
        sweep_err = max(sweep_err, err)
        ref = [p, m, v]
        t = paired_ms(
            lambda: adam_sweep.fused_adam_dense_sweep(*got, s, scale, **SWEEP_HYPER),
            lambda: adam_sweep.sweep_plain(*ref, s, scale, **SWEEP_HYPER),
        )
        gbs = 28 * rows * dim / (t["ms"] * 1e-3) / 1e9
        log(f"A sweep [{rows}, {dim}]: bitwise equal, max_abs_err={err:.3e} {format_ms(t)} "
            f"kernel_GB/s={gbs:.0f}")
        sweep_t = {k: sweep_t.get(k, 0.0) + t[k] for k in t}
        elements += rows * dim
        del s, m, v, p, ref, got
    # p, m, v and s read once, p, m and v written once: 28 B per element.
    # No library call computes this function (torch._fused_adam_ scales eps
    # by sqrt(1 - beta2^t), descends, and folds L2 into the gradient).
    out["sweep"] = dict(max_abs_err=sweep_err, **sweep_t,
                        **bound(28 * elements, SWEEP_OPS * elements), library_ms=None)

    operands = cast_operands(device, sizes, gen)
    y = [check_cast(name, x) for name, x in operands][0]
    x = operands[0][1]
    err = float((y.float() - cast.cast_plain(x, torch.bfloat16).float()).abs().max())
    t = paired_ms(
        lambda: cast.cast_table(x, torch.bfloat16), lambda: cast.cast_plain(x, torch.bfloat16)
    )
    log(f"A cast {operands[0][0]}: {format_ms(t)} kernel_GB/s="
        f"{6 * x.numel() / (t['ms'] * 1e-3) / 1e9:.0f} plain_GB/s="
        f"{6 * x.numel() / (t['plain_ms'] * 1e-3) / 1e9:.0f}")
    # The plain version is the library call x.to(torch.bfloat16): its time
    # is plain_ms.  4 B read and 2 B written per element.
    out["cast"] = dict(max_abs_err=err, **t, **bound(6 * x.numel(), CAST_OPS * x.numel()),
                       library_ms=t["plain_ms"])
    del operands, x, y

    t0 = time.perf_counter()
    cuda_build.build_library("segment_sum", ("segment_sum.cu",))
    log(f"A nvcc build of the segment sum: {time.perf_counter() - t0:.1f}s")
    # ms and passes_ms: the two tables' calls with their plans and the
    # kernels' passes alone; library_ms: index_add_sum, one index_add_ per
    # window slot into a zeroed table.
    out["segsum"] = phase_segment_sum(device, sizes, gen)
    return out


def phase_b0(device):
    """Three small steps on the card (float32) against the CPU (float64)."""
    sizes = dict(CANONICAL, num_words=64, num_entities=48, word_dim=12, entity_dim=8,
                 batch=32, window=4, negatives=3)
    desc, cfg = canonical_desc_cfg(sizes)
    cfg = TrainConfig(**{**cfg.__dict__, "stream_dtype": "float32",
                         "window_sum_dtype": "float32", "negative_pool_size": 8})
    init = init_params(torch.Generator().manual_seed(0), 64, 48, desc, dtype=torch.float64,
                       device=torch.device("cpu"))
    runs = []
    for dev, dtype in ((device, torch.float32), (torch.device("cpu"), torch.float64)):
        params = params_from_numpy(params_to_numpy(init), dev, dtype)
        state = Optimizer(cfg).init(params)
        step = make_train_step(desc, cfg, dev, None)
        costs = []
        rng = np.random.RandomState(1)
        for _ in range(3):
            feats = rng.randint(0, 64, (32, 4))
            batch = TextEntityBatch(
                torch.as_tensor(feats, device=dev), torch.ones((32, 4), dtype=dtype, device=dev),
                torch.as_tensor(rng.randint(0, 48, 32), device=dev),
                torch.ones(32, dtype=dtype, device=dev),
            )
            pool = torch.as_tensor(rng.randint(0, 48, 8), device=dev)
            costs.append(float(step(params, state, batch, negative_ids=pool)))
        runs.append((np.array(costs), params_to_numpy(params)))
    (gc, gp), (cc, cp) = runs
    table_err = max(float(np.abs(g.astype(np.float64) - c).max()) for g, c in zip(gp, cp))
    cost_err = float(np.abs(gc - cc).max() / np.abs(cc).max())
    log(f"B0 small steps card f32 vs cpu f64: cost_rel_err={cost_err:.3e} "
        f"table_max_abs_err={table_err:.3e}")
    if not (cost_err < 1e-5 and table_err < 1e-4):
        raise AssertionError("the card's small steps disagree with the CPU reference")


def canonical_corpus(sizes):
    """The Zipf corpus of phases B and D."""
    return zipf_corpus(sizes["num_entities"], sizes["doc_len"], vocab_size=sizes["num_words"],
                       window_size=sizes["window"], seed=4242)


def canonical_training(device, sizes):
    """Set up the canonical configuration at full width on ``device``.

    Returns ``run(n) -> (costs, host_seconds)``, which takes n host-fed
    training steps, and the params, corpus, pool size and stride.
    """
    desc, cfg = canonical_desc_cfg(sizes)
    n_ent, batch = sizes["num_entities"], sizes["batch"]
    t0 = time.perf_counter()
    corpus = canonical_corpus(sizes)
    source = TextEntitySource(corpus, batch_size=batch, seed=cfg.seed)
    batches = source.epoch_batches()
    log(f"B corpus {n_ent} docs x {sizes['doc_len']} tokens, "
        f"{source.instances_per_epoch()} instances/epoch, set-up {time.perf_counter() - t0:.1f}s")
    pool, stride = resolve_negative_sampling(cfg, desc, batch, n_ent)
    log(f"B negative sampling: pool={pool} stride={stride}")
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(gen, sizes["num_words"], n_ent, desc, device=device)
    state = Optimizer(cfg).init(params)
    step = make_train_step(desc, cfg, device, gen, num_entities=n_ent)

    def run(n):
        host_s = 0.0
        costs = []
        for _ in range(n):
            h0 = time.perf_counter()
            b = TextEntityBatch.from_numpy(next(batches), device)
            host_s += time.perf_counter() - h0
            costs.append(step(params, state, b))
        return costs, host_s

    return run, params, corpus, pool, stride


def phase_b(device, sizes):
    """The canonical configuration at full width; returns its numbers."""
    run, params, corpus, pool, stride = canonical_training(device, sizes)
    batch = sizes["batch"]
    costs, _ = run(sizes["warmup"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    timed, host_s = run(sizes["steps"])
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    costs = [float(c) for c in costs + timed]
    if not all(np.isfinite(costs)):
        raise AssertionError(f"non-finite cost in phase B: {costs}")
    stats = dict(
        steps=sizes["warmup"] + sizes["steps"],
        pool=pool, stride=stride,
        pairs_per_s=batch * sizes["steps"] / elapsed,
        ms_per_step=1e3 * elapsed / sizes["steps"],
        host_batch_ms_per_step=1e3 * host_s / sizes["steps"],
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        first_cost=costs[0], last_cost=costs[-1],
    )
    return stats, params, corpus


TOPICS = {
    "space": "rocket orbit launch satellite astronaut mission gravity".split(),
    "cooking": "recipe oven flour butter bake sugar yeast".split(),
    "sports": "goal match player referee score stadium league".split(),
}


def three_topic_corpus(num_docs_per_topic=6, doc_len=30, seed=0):
    """The synthetic corpus of tests/test_train_integration.py."""
    rng = np.random.RandomState(seed)
    docs, labels = [], {}
    common = "the and with from this that".split()
    for topic, words in TOPICS.items():
        for i in range(num_docs_per_topic):
            body = [
                words[rng.randint(len(words))] if rng.rand() < 0.7
                else common[rng.randint(len(common))]
                for _ in range(doc_len)
            ]
            docno = f"{topic}_{i}"
            docs.append((docno, " ".join(body)))
            labels[docno] = topic
    return docs, labels


def phase_c(device, params_b, corpus_b):
    docs, labels = three_topic_corpus()
    corpus = build_corpus(
        docs, DataConfig(max_vocabulary_size=0, min_document_frequency=0,
                         max_document_frequency=0), window_size=4,
    )
    desc = ModelDesc(word_repr_size=24, entity_repr_size=16,
                     nonlinearity=Nonlinearity.TANH, bias_negative_samples=True)
    cfg = TrainConfig(
        num_epochs=30, batch_size=32, window_size=4, num_random_entities=5,
        learning_rate=0.01, regularization_lambda=0.01, update_method=UpdateMethod.ADAM,
        adam=AdamConfig(mode=AdamMode.DENSE_UPDATE_DENSE_VARIANCE), seed=1,
    )
    result = train_model(desc, cfg, corpus, device)
    costs = result.epoch_costs
    if not (all(np.isfinite(costs)) and costs[-1] < 0.6 * costs[0]):
        raise AssertionError(f"three-topic training did not converge: {costs}")
    engine = QueryEngine(result.params, corpus.vocab.terms, corpus.docnos, nonlinearity="tanh")
    run = engine.rank({t: w[:3] for t, w in TOPICS.items()}, top_k=len(corpus.docnos))
    qrels = {t: {d: int(labels[d] == t) for d in corpus.docnos} for t in TOPICS}
    map_ = evaluate_run(run, qrels, measures=("map",))["map"]
    log(f"C three-topic: {result.steps} steps, cost {costs[0]:.4f} -> {costs[-1]:.4f}, MAP={map_:.4f}")
    if not map_ > 0.8:
        raise AssertionError(f"three-topic MAP {map_} <= 0.8")

    engine = QueryEngine(params_b, corpus_b.vocab.terms, corpus_b.docnos)
    rng = np.random.RandomState(7)
    terms = corpus_b.vocab.terms
    queries = {f"q{i}": [terms[j] for j in rng.randint(0, len(terms), 3)] for i in range(100)}
    engine.rank(queries, top_k=1000)  # warm-up
    t0 = time.perf_counter()
    ranked = engine.rank(queries, top_k=1000)
    rank_ms = 1e3 * (time.perf_counter() - t0)
    if len(ranked) != 100 or any(len(r) != 1000 for r in ranked.values()):
        raise AssertionError("ranking did not return 100 x 1000 results")
    for r in ranked.values():
        s = np.array([x for _, x in r])
        if not (np.all(np.isfinite(s)) and np.all(np.diff(s) <= 0)):
            raise AssertionError("ranking scores not finite and descending")
    q = torch.as_tensor(
        np.stack([engine.query_representation(t) for t in queries.values()]), device=device
    )
    kernel_ms = statistics.median(cuda_ms(lambda: _rank_kernel(
        q, engine.transform_w, engine._bias_scaled, engine._entity_norm, 1000,
        engine.nonlinearity)))
    log(f"C serve: 100 queries top-1000 over {len(corpus_b.docnos)} docs: "
        f"rank()_ms={rank_ms:.2f} (host included) device_rank_ms={kernel_ms:.3f}")
    return dict(map=map_, rank_ms=rank_ms, device_rank_ms=kernel_ms)


# The counts that ``launch_counts`` reads: the sweep's and the cast's
# launches, the segment sum's launches and full_adam's accumulations that
# fell back to ``index_add_`` (``segment_kernels.index_add_sum``).
LAUNCH_KEYS = ("sweep", "cast", "segsum", "index_add")
# A canonical step: 2 sweeps, 1 cast, 2 segment sums, no fallback.
CANONICAL_LAUNCHES = {"sweep": 2, "cast": 1, "segsum": 2, "index_add": 0}


def no_launches() -> dict:
    return dict.fromkeys(LAUNCH_KEYS, 0)


def reset_launches():
    adam_sweep.fused_adam_dense_sweep.launches = 0
    cast.cast_table.launches = 0
    segment_kernels.segment_sum.launches = 0
    segment_kernels.index_add_sum.calls = 0


def launch_counts() -> dict:
    return {"sweep": adam_sweep.fused_adam_dense_sweep.launches,
            "cast": cast.cast_table.launches,
            "segsum": segment_kernels.segment_sum.launches,
            "index_add": segment_kernels.index_add_sum.calls}


def read_launches(steps, phase, per_step=None):
    """The launch counts since ``reset_launches``; raises unless the path
    launched each kernel ``per_step`` times per step (by default
    ``CANONICAL_LAUNCHES``)."""
    per_step = per_step or CANONICAL_LAUNCHES
    launches = launch_counts()
    if launches != {key: n * steps for key, n in per_step.items()}:
        raise AssertionError(f"{phase}: kernel launches {launches} for {steps} steps, "
                             f"expected {per_step} per step")
    log(f"{phase} launches: {launches} over {steps} steps")
    return launches


def on_device_training(device, sizes, corpus, variant=None):
    """The canonical configuration, or the text-entity ``variant`` of
    ``E_CONFIGS``, through on-device sampling on ``corpus``.  Returns
    ``run(calls, start_call=0) -> costs``, which trains ``calls`` calls of K
    steps from one shuffled epoch, and the device corpus, the shuffled
    pointers and steps_epoch."""
    desc, cfg = variant_desc_cfg(sizes, variant) if variant else canonical_desc_cfg(sizes)
    batch, k = sizes["batch"], sizes["steps_per_call"]
    dc = device_sampler.prepare_device_corpus(corpus, device)
    permute, n_ptrs = device_sampler.make_epoch_permuter(dc)
    steps_epoch = max(min(TextEntitySource(corpus, batch).batches_per_epoch(), n_ptrs // batch), 1)
    if steps_epoch % k:
        raise AssertionError(f"K={k} does not divide the epoch's {steps_epoch} steps")
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(gen, sizes["num_words"], sizes["num_entities"], desc, device=device)
    state = Optimizer(cfg).init(params)
    multistep = device_sampler.make_device_sampled_multistep(
        desc, cfg, dc, k, gen, num_entities=sizes["num_entities"])
    doc_perm = permute(gen)

    def run(calls, start_call=0):
        return [multistep(params, state, doc_perm, (start_call + c) * k * batch)
                for c in range(calls)]

    return run, dc, doc_perm, steps_epoch


def check_sampling(dc, doc_perm, corpus, batch, gen):
    """The shuffled pointers are a permutation of the epoch's pointers
    (sorted and compared on the device), and one batch's windows are
    ``tokens[offset + pos : offset + pos + W]`` with 0 <= pos < len - W + 1,
    recomputed on the host from the corpus."""
    ptrs = device_sampler.epoch_doc_pointers(dc)
    if not torch.equal(torch.sort(doc_perm).values, torch.sort(ptrs).values):
        raise AssertionError("the device permutation is not a permutation of the epoch's pointers")
    u = torch.rand(batch, generator=gen, device=doc_perm.device)
    b = device_sampler.sample_batch(dc, batch, docs=doc_perm[:batch], uniforms=u)
    docs, uu = doc_perm[:batch].cpu().numpy(), u.cpu().numpy()
    w = dc.window_size
    n = np.diff(corpus.doc_offsets)[docs] - w + 1
    pos = np.minimum(np.floor(uu * n.astype(np.float32)).astype(np.int64), n - 1)
    if not (np.all(pos >= 0) and np.all(pos < n)):
        raise AssertionError("a sampled window starts outside its document")
    want = corpus.tokens[corpus.doc_offsets[docs][:, None] + pos[:, None] + np.arange(w)]
    if not np.array_equal(b.features.cpu().numpy(), want):
        raise AssertionError("a sampled window differs from the corpus's tokens")
    if not np.array_equal(b.labels.cpu().numpy(), docs):
        raise AssertionError("sampled labels differ from the pointers")
    log(f"D1 sampling: permutation of {ptrs.shape[0]} pointers checked; "
        f"{batch} windows equal to the corpus's tokens, pos in [{pos.min()}, {pos.max()}]")


def phase_d1(device, sizes, corpus):
    """One whole epoch of the epoch-exact multistep at full width."""
    t0 = time.perf_counter()
    run, dc, doc_perm, steps_epoch = on_device_training(device, sizes, corpus)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check_sampling(dc, doc_perm, corpus, sizes["batch"],
                   torch.Generator(device=device).manual_seed(1))
    calls = steps_epoch // sizes["steps_per_call"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    # Any op of the epoch that waits for the device raises: the K steps of
    # a call must be enqueued back to back.
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    try:
        costs = torch.cat(run(calls))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_launches(steps_epoch, "D1")
    costs = costs.cpu().numpy()
    if not (costs.shape == (steps_epoch,) and np.all(np.isfinite(costs))):
        raise AssertionError(f"non-finite or missing cost in phase D1: {costs}")
    stats = dict(
        steps=steps_epoch, steps_per_call=sizes["steps_per_call"],
        setup_s=setup_s, ms_per_step=1e3 * elapsed / steps_epoch,
        pairs_per_s=sizes["batch"] * steps_epoch / elapsed,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        corpus_device_mib=dc.nbytes() / 2**20,
        pointers_device_mib=doc_perm.numel() * doc_perm.element_size() / 2**20,
        first_cost=float(costs[0]), last_cost=float(costs[-1]),
    )
    log("D1 " + json.dumps(stats))
    return stats, launches


def phase_d2(device, sizes, corpus):
    """train_model with on-device sampling: 2 epochs into checkpoints, the
    last read back bitwise, then a resumed third epoch."""
    desc, cfg = canonical_desc_cfg(sizes)
    k = sizes["steps_per_call"]
    os.makedirs(BUILD, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="phase_d_", dir=BUILD)
    prefix = os.path.join(tmp, "m")
    try:
        reset_launches()
        t0 = time.perf_counter()
        first = train_model(desc, dataclasses.replace(cfg, num_epochs=2), corpus, device,
                            output_prefix=prefix, on_device_sampling=True, steps_per_call=k)
        first_s = time.perf_counter() - t0
        steps_epoch = first.steps // 2
        for name in ("_1.hdf5", "_2.hdf5", "_meta", "_resume.npz"):
            if not os.path.exists(prefix + name):
                raise AssertionError(f"phase D2 wrote no {prefix + name}")
        loaded = checkpoint.load_model_hdf5(prefix, 2, device)
        for name, a, b in zip(loaded._fields, first.params, loaded):
            if not torch.equal(a, b):
                raise AssertionError(f"{name} read back from _2.hdf5 differs from the trained table")
        t0 = time.perf_counter()
        resumed = train_model(desc, dataclasses.replace(cfg, num_epochs=3), corpus, device,
                              output_prefix=prefix, resume=True, on_device_sampling=True,
                              steps_per_call=k)
        resumed_s = time.perf_counter() - t0
        launches = read_launches(first.steps + resumed.steps, "D2")
        with np.load(prefix + "_resume.npz") as data:
            total = int(data["extra_total_batches"])
        if not (len(resumed.epoch_costs) == 1 and resumed.steps == steps_epoch
                and int(resumed.opt_state.word.t) == 3 * steps_epoch + 1
                and total == 3 * steps_epoch):
            raise AssertionError(
                f"the resumed run did not start at epoch 3, step {2 * steps_epoch}: "
                f"{resumed.epoch_costs}, {resumed.steps} steps, t={int(resumed.opt_state.word.t)}")
        costs = first.epoch_costs + resumed.epoch_costs
        if not all(np.isfinite(costs)):
            raise AssertionError(f"non-finite epoch cost in phase D2: {costs}")
        t0 = time.perf_counter()
        checkpoint.save_model_hdf5(resumed.params, prefix, "timed")
        model_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        checkpoint.save_training_state(prefix + "_timed", resumed.params, resumed.opt_state, 3)
        resume_s = time.perf_counter() - t0
        stats = dict(
            steps_epoch=steps_epoch, epoch_costs=costs,
            two_epochs_s=first_s, resumed_epoch_s=resumed_s,
            batches_per_sec=first.batches_per_sec,
            model_hdf5_mib=os.path.getsize(checkpoint.checkpoint_path(prefix, 2)) / 2**20,
            resume_npz_mib=os.path.getsize(prefix + "_resume.npz") / 2**20,
            model_write_s=model_s, resume_write_s=resume_s,
        )
    finally:
        shutil.rmtree(tmp)
    log("D2 " + json.dumps(stats))
    return stats, launches


# Phases E0 and E: (overrides of the canonical TrainConfig, of its
# ModelDesc).  Mixture weights as tests/test_gradcheck_training.py's.
E_CONFIGS = {
    "sgd": (dict(update_method=UpdateMethod.SGD), {}),
    "adagrad": (dict(update_method=UpdateMethod.ADAGRAD), {}),
    "sparse_adam": (dict(adam=AdamConfig(mode=AdamMode.SPARSE)), {}),
    "dense_adam": (dict(adam=AdamConfig(mode=AdamMode.DENSE_UPDATE)), {}),
    "full_adam_entity_l2": ({}, dict(l2_normalize_entity_reprs=True)),
    "full_adam_shared": (dict(shared_negatives=True), {}),
    "full_adam_entity_entity": (dict(text_entity_weight=0.7, entity_entity_weight=0.3), {}),
    "full_adam_term_term": (dict(text_entity_weight=0.6, term_term_weight=0.4), {}),
}


def variant_desc_cfg(sizes, name, **cfg_overrides):
    desc, cfg = canonical_desc_cfg(sizes)
    cfg_kw, desc_kw = E_CONFIGS[name]
    return (dataclasses.replace(desc, **desc_kw),
            dataclasses.replace(cfg, **cfg_kw, **cfg_overrides))


def expected_launches(cfg, desc, num_entities) -> dict:
    """Kernel launches per step: the sweep twice under full_adam, and one
    accumulation a table, the segment sum with a float32 accumulator and
    ``index_add_`` with a bfloat16 one; the cast once where the pooled,
    shared or factored path runs under bfloat16 streams, none on the
    expanded per-instance path (the window-averaged optimizers, the entity
    L2 normalizer)."""
    full_adam = (cfg.update_method == UpdateMethod.ADAM
                 and cfg.adam.mode == AdamMode.DENSE_UPDATE_DENSE_VARIANCE)
    pool, _ = resolve_negative_sampling(cfg, desc, cfg.batch_size, num_entities)
    factored = ((full_adam or cfg.update_method == UpdateMethod.SGD)
                and not desc.l2_normalize_entity_reprs)
    streams = cfg.resolved_stream_dtype() == "bfloat16"
    casts = streams and (pool > 0 or cfg.shared_negatives or factored)
    narrow = cfg.resolved_accum_dtype() == "bfloat16"
    return {"sweep": 2 if full_adam else 0, "cast": 1 if casts else 0,
            "segsum": 2 if full_adam and not narrow else 0,
            "index_add": 2 if full_adam and narrow else 0}


def phase_e0(device):
    """Three small steps of each E configuration on the card (float32,
    kernels) against the same steps on the CPU (float64, plain versions),
    fed the same draws."""
    sizes = dict(CANONICAL, num_words=64, num_entities=48, word_dim=12, entity_dim=8,
                 batch=32, window=4, negatives=3)
    worst = {}
    for name, (cfg_kw, _) in E_CONFIGS.items():
        pooled = cfg_kw.get("update_method") == UpdateMethod.SGD or "text_entity_weight" in cfg_kw
        desc, cfg = variant_desc_cfg(sizes, name, stream_dtype="float32",
                                     window_sum_dtype="float32",
                                     negative_pool_size=8 if pooled else -1)
        kind = objective_kind_from_config(cfg)
        pool, _ = resolve_negative_sampling(cfg, desc, 32, 48)
        init = init_params(torch.Generator().manual_seed(0), 64, 48, desc, dtype=torch.float64,
                           device=torch.device("cpu"))
        runs = []
        for dev, dtype in ((device, torch.float32), (torch.device("cpu"), torch.float64)):
            params = params_from_numpy(params_to_numpy(init), dev, dtype)
            state = Optimizer(cfg).init(params)
            step = make_train_step(desc, cfg, dev, None)
            rng = np.random.RandomState(1)
            costs = []
            for _ in range(3):
                batch = TextEntityBatch(
                    torch.as_tensor(rng.randint(0, 64, (32, 4)), device=dev),
                    torch.ones((32, 4), dtype=dtype, device=dev),
                    torch.as_tensor(rng.randint(0, 48, 32), device=dev),
                    torch.as_tensor(rng.uniform(0.5, 1.5, 32), dtype=dtype, device=dev),
                )
                if pool:
                    ids = rng.randint(0, 48, pool)
                elif cfg.shared_negatives:
                    ids = rng.randint(0, 48, 3)
                else:
                    ids = rng.randint(0, 48, (32, 3))
                if kind != ObjectiveKind.TEXT_ENTITY:
                    rows = 48 if kind == ObjectiveKind.TEXT_ENTITY_ENTITY_ENTITY else 64
                    batch = (batch, SimilarityBatch(
                        torch.as_tensor(rng.randint(0, rows, (32, 2)), device=dev),
                        torch.as_tensor(rng.uniform(0.5, 1.5, 32), dtype=dtype, device=dev)))
                costs.append(float(step(params, state, batch,
                                        negative_ids=torch.as_tensor(ids, device=dev))))
            runs.append((np.array(costs), params_to_numpy(params)))
        (gc, gp), (cc, cp) = runs
        table_err = max(float(np.abs(g.astype(np.float64) - c).max()) for g, c in zip(gp, cp))
        cost_err = float(np.abs(gc - cc).max() / np.abs(cc).max())
        moved = max(float(np.abs(c - i).max()) for c, i in zip(cp, params_to_numpy(init)))
        log(f"E0 {name} ({negative_layout(cfg, desc, 48)}): card f32 vs cpu f64 "
            f"cost_rel_err={cost_err:.3e} table_max_abs_err={table_err:.3e} "
            f"(tables moved by up to {moved:.3e})")
        if not (cost_err < 1e-5 and table_err < 1e-4 and moved > 0.0):
            raise AssertionError(f"E0 {name}: the card's small steps disagree with the CPU")
        worst[name] = (cost_err, table_err)
    return worst


def write_similarity_file(path, names, num_pairs, seed):
    """``num_pairs`` lines ``name name weight`` of uniform random pairs."""
    rng = np.random.RandomState(seed)
    a, b = rng.randint(0, len(names), num_pairs), rng.randint(0, len(names), num_pairs)
    w = rng.uniform(0.5, 1.5, num_pairs)
    with open(path, "w") as f:
        f.writelines(f"{names[i]} {names[j]} {x:.6f}\n" for i, j, x in zip(a, b, w))


def e_on_device(device, sizes, name, dc, permute, seed, **cfg_overrides):
    """One warm-up call and one timed call of K steps, on-device sampling,
    of the variant ``name`` (None: the canonical configuration).  Returns
    (desc, cfg, K, stats of the timed call, the 2K costs)."""
    if name:
        desc, cfg = variant_desc_cfg(sizes, name, **cfg_overrides)
    else:
        desc, cfg = canonical_desc_cfg(sizes)
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    batch, k, n_ent = sizes["batch"], sizes["steps_per_call"], sizes["num_entities"]
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(gen, sizes["num_words"], n_ent, desc, device=device)
    state = Optimizer(cfg).init(params)
    multistep = device_sampler.make_device_sampled_multistep(
        desc, cfg, dc, k, gen, num_entities=n_ent)
    doc_perm = permute(gen)
    warm = multistep(params, state, doc_perm, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    try:
        timed = multistep(params, state, doc_perm, k * batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    costs = torch.cat([warm, timed]).cpu().numpy()
    return desc, cfg, k, dict(
        ms_per_step=1e3 * elapsed / k, pairs_per_s=batch * k / elapsed,
        first_cost=float(costs[0]), last_cost=float(costs[-1]), all_costs_finite=bool(
            np.all(np.isfinite(costs)))), costs


def e_composite(device, sizes, name, corpus, seed):
    """train_model(similarity_source=...) on the host-fed path, 2 epochs."""
    desc, cfg = variant_desc_cfg(sizes, name, num_epochs=2, seed=seed)
    kind = objective_kind_from_config(cfg)
    names = corpus.docnos if kind == ObjectiveKind.TEXT_ENTITY_ENTITY_ENTITY else corpus.vocab.terms
    os.makedirs(BUILD, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="phase_e_", dir=BUILD)
    try:
        path = os.path.join(tmp, "similarities.txt")
        write_similarity_file(path, names, corpus.num_docs, seed)
        ids, weights = load_similarities(path, {n: i for i, n in enumerate(names)})
    finally:
        shutil.rmtree(tmp)
    if ids.shape[0] != corpus.num_docs:
        raise AssertionError(f"E {name}: {ids.shape[0]} of {corpus.num_docs} pairs read back")
    source = SimilaritySource(ids, weights, batch_size=sizes["batch"], seed=seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    result = train_model(desc, cfg, corpus, device, similarity_source=source)
    torch.cuda.synchronize()
    costs = result.epoch_costs
    return desc, cfg, result.steps, dict(
        ms_per_step=1e3 / result.batches_per_sec,
        pairs_per_s=sizes["batch"] * result.batches_per_sec,
        first_cost=costs[0], last_cost=costs[-1], all_costs_finite=bool(np.all(np.isfinite(costs))),
        similarity_pairs=int(ids.shape[0]),
    )


def phase_e(device, sizes, corpus, seed):
    """Every E configuration at full width; returns the summed launches."""
    dc = device_sampler.prepare_device_corpus(corpus, device)
    permute, _ = device_sampler.make_epoch_permuter(dc)
    total = no_launches()
    for name, (cfg_kw, _) in E_CONFIGS.items():
        if "text_entity_weight" in cfg_kw:
            desc, cfg, steps, stats = e_composite(device, sizes, name, corpus, seed)
        else:
            desc, cfg, steps, stats, _ = e_on_device(device, sizes, name, dc, permute, seed)
        stats["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        stats["negatives"] = negative_layout(cfg, desc, sizes["num_entities"])
        log(f"E {name} " + json.dumps(stats))
        if not stats["all_costs_finite"]:
            raise AssertionError(f"E {name}: a cost is not finite")
        launches = read_launches(steps, f"E {name}",
                                 expected_launches(cfg, desc, sizes["num_entities"]))
        total = {key: total[key] + launches[key] for key in total}
        torch.cuda.empty_cache()
    return total


class LogRecords(logging.Handler):
    """Every log record of a command, and the kernel launches counted when
    the trainer logs its initial cost (the end of that pass)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records, self.at_initial_cost = [], None

    def emit(self, record):
        if record.msg.startswith("Initial cost"):
            self.at_initial_cost = launch_counts()
        self.records.append(record)

    def args(self, msg_prefix):
        """The arguments of the records whose format starts so."""
        return [r.args for r in self.records if r.msg.startswith(msg_prefix)]


@contextlib.contextmanager
def captured_logs():
    handler, root = LogRecords(), logging.getLogger()
    level = root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    try:
        yield handler
    finally:
        root.removeHandler(handler)
        root.setLevel(level)


def run_command(main_fn, argv, what):
    """``main_fn(argv)`` in process with its log records kept; raises
    unless it returns 0.  Returns (records, wall seconds)."""
    t0 = time.perf_counter()
    with captured_logs() as logs:
        rc = main_fn(argv)
    if rc != 0:
        raise AssertionError(f"{what} exited with {rc}")
    return logs, time.perf_counter() - t0


def trained_epochs(logs):
    """[(epoch, cost, steps, seconds)] of every epoch the trainer logged."""
    return [(a[0], a[2], a[3], a[4]) for a in logs.args("Epoch %d%s: cost")]


def epoch_records(logs):
    """(cost, steps, seconds) of every epoch the trainer logged."""
    return [e[1:] for e in trained_epochs(logs)]


def canonical_flags(sizes):
    """cunvsm-torch-train's flags of the canonical configuration."""
    return [
        "--update_method", "full_adam", "--nonlinearity", "hard_tanh", "--batch_normalization",
        "--word_repr_size", str(sizes["word_dim"]), "--entity_repr_size", str(sizes["entity_dim"]),
        "--batch_size", str(sizes["batch"]), "--window_size", str(sizes["window"]),
        "--num_random_entities", str(sizes["negatives"]), "--learning_rate", "1e-3",
        "--regularization_lambda", "0.01", "--stream_dtype", "bfloat16",
        "--window_sum_dtype", "bfloat16",
    ]


def phase_f1(device, sizes, corpus, seed, tmp):
    """cunvsm-torch-train at full width: phase B's corpus as a packed .npz,
    the canonical flags, on-device sampling, 2 epochs and the initial cost.
    Returns the model prefix, the stats and the launches of the command."""
    corpus_path = os.path.join(tmp, "corpus.npz")
    corpus.save(corpus_path)
    prefix = os.path.join(tmp, "m")
    argv = [corpus_path, "--output", prefix, "--device", str(device), *canonical_flags(sizes),
            "--on_device_sampling", "--steps_per_call", str(sizes["steps_per_call"]),
            "--num_epochs", "2", "--compute_initial_cost", "--seed", str(seed + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    logs, wall_s = run_command(train_cli.main, argv, "F1 cunvsm-torch-train")
    launches = launch_counts()
    (initial,) = logs.args("Initial cost")  # (cost, batches, seconds)
    epochs = epoch_records(logs)
    costs = [initial[0]] + [c for c, _, _ in epochs]
    if not (len(epochs) == 2 and all(np.isfinite(costs)) and costs[-1] < costs[0]):
        raise AssertionError(f"F1: initial and epoch costs {costs}")
    # The initial-cost pass is forward only: no sweep, no accumulation.  The
    # trained steps launch the sweep twice, the cast once and the segment
    # sum twice each.
    at_initial = logs.at_initial_cost
    trained = {key: launches[key] - at_initial[key] for key in launches}
    steps = sum(n for _, n, _ in epochs)
    if (any(at_initial[key] for key in ("sweep", "segsum", "index_add"))
            or trained != {key: n * steps for key, n in CANONICAL_LAUNCHES.items()}):
        raise AssertionError(f"F1: launches {at_initial} in the initial-cost pass and "
                             f"{trained} over {steps} trained steps")
    log(f"F1 launches: initial-cost pass {at_initial} over {initial[1]} batches; "
        f"{trained} over {steps} trained steps")

    shapes = [(sizes["num_words"], sizes["word_dim"]), (sizes["num_entities"], sizes["entity_dim"]),
              (sizes["word_dim"], sizes["entity_dim"]), (sizes["entity_dim"],)]
    tables = [checkpoint.load_model_hdf5(prefix, epoch, device) for epoch in (1, 2)]
    for epoch, params in zip((1, 2), tables):
        for name, t, shape in zip(params._fields, params, shapes):
            if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
                raise AssertionError(f"F1: {name} of _{epoch}.hdf5 is {tuple(t.shape)} or not finite")
    if torch.equal(tables[0].entity_reprs, tables[1].entity_reprs):
        raise AssertionError("F1: the second epoch left the entity table as it was")
    meta = checkpoint.load_meta(prefix)
    if not (checkpoint.load_strings(prefix + "_vocab.txt") == corpus.vocab.terms
            and checkpoint.load_strings(prefix + "_docnos.txt") == corpus.docnos
            and meta.total_terms == corpus.vocab.total_terms):
        raise AssertionError("F1: the _meta or a sidecar does not describe the corpus")
    train_s = sum(s for _, _, s in epochs)
    stats = dict(
        wall_s=wall_s, initial_cost=initial[0], epoch_costs=costs[1:],
        initial_cost_s=initial[2], initial_cost_batches=initial[1],
        ms_per_step_by_epoch=[1e3 * s / n for _, n, s in epochs],
        pairs_per_s=sizes["batch"] * steps / train_s,
        peak_mib=torch.cuda.max_memory_allocated() / 2**20,
    )
    log("F1 " + json.dumps(stats))
    return prefix, launches


# How far below the float32 run's document at a rank the document that
# the bfloat16 run puts there may score in float32.  Rounding both operands
# to bfloat16 (2^-9 relative each) moves a cosine of unit vectors by at
# most 2^-8, so the bfloat16 engine can swap two documents only if their
# float32 scores lie within 2 * 2^-8.  (The share of top-10 positions at
# which the two runs name the same document is printed, not held: near-ties
# put it at 94.7-98.1% over eight runs of one configuration.)
BF16_RANK_SLACK = 2 * 2.0 ** -8
# The most by which the bfloat16 engine's scores on the card may differ
# from float32 sums of the same bfloat16 products (exact in float32): the
# summation order over 256 terms moves a cosine by about 1e-6, and scores
# rounded to bfloat16 would miss by about 1e-3.
BF16_SCORE_ATOL = 1e-5


def read_run_lines(path):
    """qid -> [(docno, rank, score)] in the file's order."""
    run = {}
    with open(path) as f:
        for line in f:
            qid, _, docno, rank, score, _ = line.split()
            run.setdefault(qid, []).append((docno, int(rank), float(score)))
    return run


def phase_f2(device, corpus, prefix, epoch, seed, tmp):
    """cunvsm-torch-query on F1's model: 100 topics from --seed, top-1000
    with float32 and bfloat16 scores, then a qrels file as --top_k."""
    rng = np.random.RandomState(seed)
    terms, n_docs = corpus.vocab.terms, corpus.num_docs
    topics = {str(q + 1): " ".join(terms[j] for j in rng.randint(0, len(terms), 3))
              for q in range(100)}
    topics_path, qrels_path = os.path.join(tmp, "topics.txt"), os.path.join(tmp, "qrels.txt")
    with open(topics_path, "w") as f:
        f.writelines(f"{q} {text}\n" for q, text in topics.items())
    qrels = {q: [corpus.docnos[i] for i in rng.choice(n_docs, 50, replace=False)] for q in topics}
    with open(qrels_path, "w") as f:
        f.writelines(f"{q} 0 {d} 1\n" for q, docs in qrels.items() for d in docs)
    common = ["--topics", topics_path, "--model", prefix, "--epoch", str(epoch),
              "--device", str(device)]
    runs, stats = {}, {}
    for name, extra, want in (
        ("float32", ["--top_k", "1000", "--score_dtype", "float32"], min(1000, n_docs)),
        ("bfloat16", ["--top_k", "1000", "--score_dtype", "bfloat16"], min(1000, n_docs)),
        ("qrels", ["--top_k", qrels_path], 50),
    ):
        out = os.path.join(tmp, f"run_{name}")
        _, stats[f"{name}_s"] = run_command(query_cli.main, [*common, *extra, out],
                                            f"F2 cunvsm-torch-query {name}")
        runs[name] = read_run_lines(out)
        if set(runs[name]) != set(topics):
            raise AssertionError(f"F2 {name}: {len(runs[name])} of {len(topics)} topics answered")
        for qid, lines in runs[name].items():
            scores = np.array([s for _, _, s in lines])
            if not (len(lines) == want and [r for _, r, _ in lines] == list(range(1, want + 1))
                    and np.all(np.isfinite(scores)) and np.all(np.diff(scores) <= 0)):
                raise AssertionError(f"F2 {name}: topic {qid} has {len(lines)} lines, not "
                                     f"{want} ranked by descending finite scores")
    same = sum(a[0] == b[0] for q in topics
               for a, b in zip(runs["float32"][q][:10], runs["bfloat16"][q][:10]))
    stats["top10_positions_equal"] = same / (10 * len(topics))
    log(f"F2 top-10 positions equal in the float32 and bfloat16 runs: {same} of "
        f"{10 * len(topics)}; commands {stats}")

    engines = {dtype: load_query_engine(prefix, epoch, device, nonlinearity="tanh",
                                        score_dtype=dtype)
               for dtype in (None, torch.bfloat16)}
    worst = 0.0
    for q, text in topics.items():
        ranked = [d for d, _, _ in runs["bfloat16"][q][:10]]
        in_float32 = dict(engines[None].score_documents(tokenize(text), ranked))
        worst = max(worst, max(at_rank[2] - in_float32[d]
                               for d, at_rank in zip(ranked, runs["float32"][q][:10])))
    stats["bfloat16_top10_below_float32_rank"] = worst
    if worst > BF16_RANK_SLACK + 1e-6:  # the run file rounds to 6 decimals
        raise AssertionError(f"F2: a document of the bfloat16 top 10 scores {worst:.3e} below the "
                             f"float32 run's document at its rank (> {BF16_RANK_SLACK:.3e})")
    worst = 0.0
    for q, text in topics.items():
        want = dict(engines[None].score_documents(tokenize(text), qrels[q]))
        got = {d: s for d, _, s in runs["qrels"][q]}
        if got.keys() != want.keys():
            raise AssertionError(f"F2 qrels: topic {q} ranks other documents than its qrels")
        worst = max(worst, max(abs(got[d] - want[d]) for d in got))
    if worst > 1e-6:  # the run file rounds to 6 decimals
        raise AssertionError(f"F2 qrels: scores differ from score_documents by {worst:.3e}")
    stats["qrels_max_abs_err"] = worst
    q = torch.as_tensor(np.stack([engines[None].query_representation(tokenize(t))
                                  for t in topics.values()]), device=device)

    bf = engines[torch.bfloat16]
    got, idx = _rank_kernel(q, bf.transform_w, bf._bias_scaled, bf._entity_norm, 1000,
                            bf.nonlinearity)
    q_bf = _project_queries(q, bf.transform_w, bf._bias_scaled, bf.nonlinearity).to(torch.bfloat16)
    want = q_bf.float() @ bf._entity_norm.float().T
    err = max(float((got - want.gather(1, idx)).abs().max()),
              float((got - torch.topk(want, 1000, dim=1).values).abs().max()))
    stats["bfloat16_scores_max_abs_err"] = err
    del want
    if got.dtype != torch.float32 or not err <= BF16_SCORE_ATOL:
        raise AssertionError(f"F2: the bfloat16 engine's {got.dtype} scores differ from float32 "
                             f"sums of its bfloat16 products by {err:.3e} > {BF16_SCORE_ATOL}")
    for dtype, engine in engines.items():
        stats[f"device_rank_ms_{'bfloat16' if dtype else 'float32'}"] = statistics.median(
            cuda_ms(lambda: _rank_kernel(q, engine.transform_w, engine._bias_scaled,
                                         engine._entity_norm, 1000, engine.nonlinearity)))
    log("F2 " + json.dumps(stats))


def phase_f3(device, tmp):
    """--reference_rng through cunvsm-torch-train on the card and on the
    CPU, then the card's model through cunvsm-torch-query."""
    docs, labels = three_topic_corpus()
    corpus_path = os.path.join(tmp, "three_topics.trec")
    with open(corpus_path, "w") as f:
        f.writelines(f"<DOC>\n<DOCNO>{d}</DOCNO>\n<TEXT>\n{text}\n</TEXT>\n</DOC>\n"
                     for d, text in docs)
    epochs = 30
    flags = [corpus_path, "--update_method", "full_adam", "--nonlinearity", "tanh",
             "--bias_negative_samples", "--word_repr_size", "24", "--entity_repr_size", "16",
             "--num_epochs", str(epochs), "--batch_size", "32", "--window_size", "4",
             "--num_random_entities", "5", "--learning_rate", "0.01",
             "--regularization_lambda", "0.01", "--seed", "1", "--reference_rng",
             "--max_vocabulary_size", "0", "--min_document_frequency", "0",
             "--max_document_frequency", "0"]
    out = []
    # The CPU's tables take the plain sweep and index_add_.
    for name, dev, per_step in (
            ("card", device, {"sweep": 2, "cast": 0, "segsum": 2, "index_add": 0}),
            ("cpu", torch.device("cpu"), {"sweep": 0, "cast": 0, "segsum": 0, "index_add": 2})):
        prefix = os.path.join(tmp, f"reference_{name}")
        reset_launches()
        logs, wall_s = run_command(train_cli.main, [*flags, "--output", prefix, "--device",
                                                    str(dev)], f"F3 cunvsm-torch-train {name}")
        records = epoch_records(logs)
        steps = sum(n for _, n, _ in records)
        launches = read_launches(steps, f"F3 {name}", per_step)
        out.append((prefix, [c for c, _, _ in records], wall_s, steps, launches))
    (card, card_costs, card_s, steps, card_launches), (cpu, cpu_costs, cpu_s, _, _) = out
    a = checkpoint.load_model_hdf5(card, epochs, torch.device("cpu"))
    b = checkpoint.load_model_hdf5(cpu, epochs, torch.device("cpu"))
    abs_err = max(float((x - y).abs().max()) for x, y in zip(a, b))
    if not all(torch.allclose(x, y, rtol=1e-5, atol=1e-4) for x, y in zip(a, b)):
        raise AssertionError(f"F3: the card's tables differ from the CPU's by {abs_err:.3e}")
    cost_err = float(np.max(np.abs(np.subtract(card_costs, cpu_costs)) / np.abs(cpu_costs)))

    topics_path, run_path = os.path.join(tmp, "three_topics.txt"), os.path.join(tmp, "run_f3")
    with open(topics_path, "w") as f:
        f.writelines(f"{t} {' '.join(words[:3])}\n" for t, words in TOPICS.items())
    _, query_s = run_command(query_cli.main, ["--topics", topics_path, "--model", card, "--epoch",
                                              str(epochs), "--device", str(device), "--top_k",
                                              "all", run_path], "F3 cunvsm-torch-query")
    docnos = [d for d, _ in docs]
    qrels = {t: {d: int(labels[d] == t) for d in docnos} for t in TOPICS}
    map_ = evaluate_run(read_run(run_path), qrels, measures=("map",))["map"]
    stats = dict(steps=steps, cost_first=card_costs[0], cost_last=card_costs[-1],
                 card_vs_cpu_cost_rel_err=cost_err, card_vs_cpu_table_max_abs_err=abs_err,
                 map=map_, card_train_s=card_s,
                 cpu_train_s=cpu_s, query_s=query_s)
    log("F3 " + json.dumps(stats))
    if not map_ > 0.8:
        raise AssertionError(f"F3: MAP {map_} <= 0.8")
    return card_launches


def phase_f(device, sizes, corpus, seed, tmp):
    """The command-line entry points, their files under ``tmp``; returns
    F1's model prefix and the launches of F1 and F3's card run."""
    prefix, f1 = phase_f1(device, sizes, corpus, seed, tmp)
    phase_f2(device, corpus, prefix, 2, seed, tmp)
    f3 = phase_f3(device, tmp)
    return prefix, {key: f1[key] + f3[key] for key in f1}


def load_source(name, *relative):
    """A module of the checkout that is no part of a package, by its path."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, *relative))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# G2: the least MAP of one seed (the JAX package's five-seed means on this
# corpus are 0.9342 +- 0.0012 per instance and 0.9373 +- 0.0017 pooled; the
# random streams differ by design, so the gate is statistical).
STUDY_MIN_MAP = 0.92
STUDY_DOCS, STUDY_STEPS_PER_CALL = 16384, 7
# G3: an n-gram's cosine on the card against float64, and the size of a tie.
NGRAM_ATOL = 1e-5
# G4: costs of K-step calls with the bfloat16 accumulator against the
# float32 one.  A partial sum rounds to 2^-9 relative at every add, so a
# row's sum is off by about 2^-9 * sqrt(updates into it); at the canonical
# shape a word row takes B * W / V updates on average.
G4_COST_RTOL = 2.0 ** -9 * (CANONICAL["batch"] * CANONICAL["window"]
                            / CANONICAL["num_words"]) ** 0.5


def assert_same_corpus(a, b, what):
    same = (a.vocab.terms == b.vocab.terms and a.docnos == b.docnos
            and a.vocab.total_terms == b.vocab.total_terms and a.window_size == b.window_size
            and all(np.array_equal(getattr(a, f), getattr(b, f)) and
                    getattr(a, f).dtype == getattr(b, f).dtype
                    for f in ("tokens", "doc_offsets", "index_lengths", "index_doc_ids"))
            and np.array_equal(a.vocab.term_freq, b.vocab.term_freq)
            and np.array_equal(a.vocab.index_term_ids, b.vocab.index_term_ids))
    if not same:
        raise AssertionError(f"{what}: the two readers disagree")


def phase_g1(device, sizes, corpus, queries, qrels, tmp, reader_build_s):
    """From an Indri repository to a run: both readers, then the train and
    query commands on the repository.  ``reader_build_s`` is the g++ build
    of the C++ reader, timed where the script built it."""
    fixture = load_source("indri_fixture", "tests", "indri_fixture.py")
    repo = os.path.join(tmp, "study_indri")
    t0 = time.perf_counter()
    terms = np.array(corpus.vocab.terms, dtype=object)
    docs = [(corpus.docnos[d], terms[corpus.tokens[a:b]].tolist())
            for d, (a, b) in enumerate(zip(corpus.doc_offsets[:-1], corpus.doc_offsets[1:]))]
    fixture.write_repository(repo, [docs[:6000], docs[6000:]])
    write_s = time.perf_counter() - t0
    del docs

    window = sizes["window"]
    cfg = DataConfig(corpus_path=repo, max_vocabulary_size=0, min_document_frequency=0,
                     max_document_frequency=0)
    t0 = time.perf_counter()
    from_cpp = load_corpus(cfg, window)
    cpp_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    from_python = load_corpus(cfg, window, use_native=False)
    python_s = time.perf_counter() - t0
    assert_same_corpus(from_cpp, from_python, "G1")
    used = np.flatnonzero(corpus.vocab.term_freq)
    if not (from_cpp.docnos == corpus.docnos
            and sorted(t for t in from_cpp.vocab.terms if t) == sorted(terms[used].tolist())
            and len(from_cpp.tokens) == len(corpus.tokens)
            and np.array_equal(np.array(from_cpp.vocab.terms, dtype=object)[from_cpp.tokens],
                               terms[corpus.tokens])):
        raise AssertionError("G1: the repository read back is not the study's corpus")
    log(f"G1 repository: {corpus.num_docs} docs, {len(corpus.tokens)} tokens, 2 indexes, written "
        f"in {write_s:.2f}s; g++ build {reader_build_s:.2f}s; C++ reader "
        f"{cpp_s:.2f}s, Python reader {python_s:.2f}s; every array, the vocabulary "
        f"({from_cpp.vocab.size} terms) and the docnos equal")

    prefix = os.path.join(tmp, "study")
    k = STUDY_STEPS_PER_CALL
    argv = [repo, "--output", prefix, "--device", str(device), *canonical_flags(sizes),
            "--on_device_sampling", "--steps_per_call", str(k), "--num_epochs", "2",
            "--seed", "1", "--max_vocabulary_size", "0", "--min_document_frequency", "0",
            "--max_document_frequency", "0"]
    torch.cuda.synchronize()
    reset_launches()
    logs, train_s = run_command(train_cli.main, argv, "G1 cunvsm-torch-train")
    epochs = epoch_records(logs)
    steps = sum(n for _, n, _ in epochs)
    launches = read_launches(steps, "G1")
    costs = [c for c, _, _ in epochs]
    if not (len(costs) == 2 and all(np.isfinite(costs)) and costs[1] < costs[0]):
        raise AssertionError(f"G1: epoch costs {costs} do not fall")
    meta = checkpoint.load_meta(prefix)
    index = IndriIndex(repo)
    term_ids = {e.term: e.term_id for e in index.vocabulary()}
    doc_ids = {docno: i for i, docno in index.docnos().items()}
    model_terms = checkpoint.load_strings(prefix + "_vocab.txt")
    model_docnos = checkpoint.load_strings(prefix + "_docnos.txt")
    if not (len(meta.term) == len(term_ids) and len(meta.object) == corpus.num_docs
            and all(term_ids[model_terms[t.model_term_id]] == t.index_term_id for t in meta.term)
            and all(doc_ids[model_docnos[o.model_object_id]] == o.index_object_id
                    for o in meta.object)):
        raise AssertionError("G1: _meta does not carry the repository's term and document ids")

    topics_path, run_path = os.path.join(tmp, "study_topics.txt"), os.path.join(tmp, "study_run")
    with open(topics_path, "w") as f:
        f.writelines(f"{q} {' '.join(words)}\n" for q, words in queries.items())
    _, query_s = run_command(
        query_cli.main, ["--topics", topics_path, "--model", prefix, "--epoch", "2", "--device",
                         str(device), "--linear", "--score_dtype", "bfloat16", "--top_k", "1000",
                         run_path],
        "G1 cunvsm-torch-query")
    run = read_run(run_path)
    map_ = evaluate_run(run, qrels, measures=("map",))["map"]
    if not (set(run) == set(queries) and all(len(r) == min(1000, corpus.num_docs) for r in run.values())):
        raise AssertionError(f"G1: the run answers {len(run)} of {len(queries)} topics")
    stats = dict(steps=steps, epoch_costs=costs, train_command_s=train_s,
                 ms_per_step_by_epoch=[1e3 * s / n for _, n, s in epochs],
                 query_command_s=query_s, map_after_2_epochs=map_,
                 g_plus_plus_build_s=reader_build_s, cpp_reader_s=cpp_s, python_reader_s=python_s)
    log("G1 " + json.dumps(stats))
    return launches


def phase_g2(device, study, corpus, queries, qrels):
    """Quality parity: one seed of each configuration of the study."""
    total = no_launches()
    for config in ("perinst", "pool2048_s205"):
        cfg = study.study_config(config, 1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        line = study.run_seed(corpus, queries, qrels, config, 1, device,
                              steps_per_call=STUDY_STEPS_PER_CALL)
        line["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        line["negatives"] = negative_layout(cfg, study.study_desc(), corpus.num_docs)
        log(f"G2 {config} " + json.dumps(line))
        launches = read_launches(line["steps"], f"G2 {config}",
                                 expected_launches(cfg, study.study_desc(), corpus.num_docs))
        total = {key: total[key] + launches[key] for key in total}
        if not line["map"] >= STUDY_MIN_MAP:
            raise AssertionError(f"G2 {config}: MAP {line['map']} < {STUDY_MIN_MAP}")
        if not line["last_epoch_cost"] < line["first_epoch_cost"]:
            raise AssertionError(f"G2 {config}: the cost did not fall")
        torch.cuda.empty_cache()
    return total


def event_ms(fn):
    """(fn's result, ms between two CUDA events around it)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def phase_g3(device, corpus, prefix, epoch, seed, tmp):
    """The tools on F1's model (V 65536, N 262144, 300 -> 256)."""
    rng = np.random.RandomState(seed + 7)
    engine = load_query_engine(prefix, epoch, device, nonlinearity="tanh")
    meta = nvsm_compat.load_meta(prefix)
    model = nvsm_compat.load_model(meta, prefix, epoch, device=device)
    if not (model.num_terms == corpus.vocab.size and model.num_objects == corpus.num_docs
            and model.word_representations.shape == (corpus.vocab.size, 300)
            and model.transform_matrix.shape == (300, 256)):
        raise AssertionError(f"G3 compat: {model!r} does not describe F1's model")
    docno_to_model = {d: i for i, d in enumerate(corpus.docnos)}
    index_ids = corpus.vocab.index_term_ids
    worst = 0.0
    for q in range(5):
        ids = rng.randint(1, corpus.vocab.size, 3)
        terms = [corpus.vocab.terms[i] for i in ids]
        got = model.query([int(index_ids[i]) for i in ids], top_k=1000)
        want = engine.rank({"q": terms}, top_k=1000)["q"]
        if [o for o, _ in got] != [model.object_mapping[docno_to_model[d]] for d, _ in want]:
            raise AssertionError(f"G3 compat: query {q} ranks other documents than QueryEngine")
        worst = max(worst, max(abs(a - b) for (_, a), (_, b) in zip(got, want)))
    objects = [model.object_mapping[i] for i in rng.choice(corpus.num_docs, 50, replace=False)]
    scored = model.score_documents([int(index_ids[i]) for i in ids], objects)
    related = model.related_terms(int(index_ids[ids[0]]), k=10)
    similarity = model.term_similarity(int(index_ids[ids[0]]), int(index_ids[ids[1]]))
    if not (worst <= 1e-6 and len(scored) == len(objects) and len(related) == 10
            and all(np.isfinite(s) for _, s in scored + related) and -1.0 <= similarity <= 1.0):
        raise AssertionError("G3 compat: an answer is missing or not finite")
    log(f"G3 compat: 5 queries equal QueryEngine.rank through object_mapping (scores within "
        f"{worst:.1e}); score_documents {len(scored)} rows, related_terms {len(related)}, "
        f"term_similarity {similarity:.4f}")
    del model

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    brute, build_ms = event_ms(lambda: TermBruteforcer(engine, max_ngram_cardinality=2,
                                                       max_terms=64))
    build_wall_ms = 1e3 * (time.perf_counter() - t0)
    n_terms = len(engine.term_to_id)
    if len(brute.ngrams) != n_terms + 2016:
        raise AssertionError(f"G3 bruteforcer: {len(brute.ngrams)} n-grams")
    # The same cosines in float64 on the host.
    words = engine._word_reprs_np.astype(np.float64)
    rows = [words[[engine.term_to_id[t] for t in gram]].mean(axis=0) for gram in brute.ngrams]
    projected = np.tanh(np.stack(rows) @ engine.transform_w.double().cpu().numpy()
                        + engine._bias_scaled.double().cpu().numpy())
    projected /= np.maximum(np.linalg.norm(projected, axis=1, keepdims=True), 1e-30)
    documents = checkpoint.load_model_hdf5(prefix, epoch, "cpu").entity_reprs.numpy()
    position = {gram: i for i, gram in enumerate(brute.ngrams)}
    lookup_ms, worst = [], 0.0
    for doc in rng.randint(0, corpus.num_docs, 3):
        target = documents[doc]
        top, ms = event_ms(lambda: brute.nearest_ngrams(target, k=10))
        lookup_ms.append(ms)
        t64 = target.astype(np.float32).astype(np.float64)
        exact = projected @ (t64 / max(np.linalg.norm(t64), 1e-30))
        best = np.sort(exact)[::-1][:10]
        for (gram, score), want in zip(top, best):
            # The card's i-th n-gram is the float64 i-th, or ties with it.
            worst = max(worst, abs(score - exact[position[gram]]), abs(exact[position[gram]] - want))
    if not worst <= NGRAM_ATOL:
        raise AssertionError(f"G3 bruteforcer: top-10 differs from float64 by {worst:.3e}")
    log(f"G3 bruteforcer: {len(brute.ngrams)} n-grams ({n_terms} + 2016); build_ms={build_ms:.1f} "
        f"(CUDA events; wall {build_wall_ms:.1f}); lookup_ms={[round(x, 3) for x in lookup_ms]}; "
        f"top-10 of 3 document vectors within {worst:.2e} of float64")
    del brute, projected, rows, words

    fused_path = os.path.join(tmp, "run_fused")
    runs = [os.path.join(tmp, f"run_{name}") for name in ("float32", "bfloat16")]
    _, fuse_s = run_command(
        combine_runs_cli.main, ["--runs", *runs, "--alpha", "0.5", "--score_normalizer",
                                "standardize", fused_path], "G3 cunvsm-torch-combine-runs")
    fused = read_run(fused_path)
    want = fuse_fixed_alpha(read_run(runs[0]), read_run(runs[1]), 0.5, "standardize")
    worst = 0.0
    if fused.keys() != want.keys():
        raise AssertionError("G3 combine-runs: other topics than compute_combined_run's")
    for q in want:
        a, b = dict(fused[q]), dict(want[q])
        if a.keys() != b.keys():
            raise AssertionError(f"G3 combine-runs: topic {q} fuses other documents")
        worst = max(worst, max(abs(a[d] - b[d]) for d in a))
    if worst > 1e-6:  # the run file rounds to 6 decimals
        raise AssertionError(f"G3 combine-runs: scores differ by {worst:.3e}")

    vocab_path, plot = os.path.join(tmp, "vocab_dump.txt"), os.path.join(tmp, "projector")
    _, dump_s = run_command(dump_vocabulary_cli.main, ["--model", prefix, vocab_path],
                            "G3 cunvsm-torch-dump-vocabulary")
    with open(vocab_path) as f:
        if f.read().split("\n")[:-1] != [t for t in corpus.vocab.terms if t]:
            raise AssertionError("G3 dump-vocabulary: not the model's vocabulary")
    limit = min(2048, corpus.num_docs)
    _, visualize_s = run_command(
        visualize_cli.main, ["--model", prefix, "--epoch", str(epoch), "--device", str(device),
                             "--mode", "embedding_projector", "--limit", str(limit),
                             "--plot_out", plot], "G3 cunvsm-torch-visualize")
    tensors = np.loadtxt(plot + "_tensors.tsv", delimiter="\t")
    with open(plot + "_metadata.tsv") as f:
        rows = f.read().split("\n")[:-1]
    if not (tensors.shape == (limit, 256) and np.allclose(tensors, documents[:limit], atol=1e-6)
            and rows[0] == "docno\tclass"
            and [r.split("\t")[0] for r in rows[1:]] == corpus.docnos[:limit]):
        raise AssertionError("G3 visualize: the projector files are not the model's rows")
    log(f"G3 commands: combine-runs {fuse_s:.2f}s ({len(fused)} topics, scores within "
        f"{worst:.1e} of fuse_fixed_alpha); dump-vocabulary {dump_s:.2f}s; visualize "
        f"embedding_projector {visualize_s:.2f}s ({limit} rows read back)")


def phase_g4(device, sizes, corpus, seed):
    """accum_dtype="bfloat16" at the canonical width."""
    n_words, batch, window = sizes["num_words"], sizes["batch"], sizes["window"]
    gen = torch.Generator(device=device).manual_seed(seed + 11)
    grad = torch.randn((batch, sizes["word_dim"]), device=device, generator=gen) * 1e-3
    rows = torch.as_tensor(corpus.tokens[:batch * window].reshape(batch, window).astype(np.int64),
                           device=device)
    desc = (SparseGrad(grad, rows, None),)
    f32 = _sorted_segment_accumulate(n_words, desc, torch.bfloat16)
    first = _sorted_segment_accumulate(n_words, desc, torch.bfloat16, torch.bfloat16)
    second = _sorted_segment_accumulate(n_words, desc, torch.bfloat16, torch.bfloat16)
    # Each of the n adds into a row rounds a partial sum, which is at most
    # the mass summed into the row (per column), to 2^-8 relative: n * 2^-8
    # * mass bounds the error whatever the order of the adds, and twice that
    # two runs against each other.  The rounding model of
    # TrainConfig.accum_dtype, 2^-9 * sqrt(n) * mass, is what random
    # roundings add up to; the share of it that was reached is printed.
    n = torch.bincount(rows.reshape(-1), minlength=n_words).to(torch.float32)[:, None]
    mass = torch.zeros_like(f32)
    for w in range(window):
        mass.index_add_(0, rows[:, w], grad.to(torch.bfloat16).float().abs())
    err = (first.float() - f32).abs()
    between = (first.float() - second.float()).abs()
    bound_ = 2.0 ** -8 * n * mass
    model = (2.0 ** -9 * torch.sqrt(n) * mass).clamp(min=1e-30)
    differing = int((first != second).sum())
    if (first.dtype != torch.bfloat16 or bool((err > bound_).any())
            or bool((between > 2 * bound_).any())):
        raise AssertionError(
            f"G4: the bfloat16 accumulator misses its error bound by "
            f"{float((err - bound_).max()):.3e} (against float32) / "
            f"{float((between - 2 * bound_).max()):.3e} (two runs)")
    log(f"G4 accumulator [{n_words}, {sizes['word_dim']}] from {batch * window} updates (up to "
        f"{int(n.max())} into one row): bfloat16 against float32 sums max abs "
        f"{float(err.max()):.3e}, at most {float((err / model).max()):.2f} of "
        f"2^-9*sqrt(n)*mass, inside n*2^-8*mass; two runs differ in {differing} of "
        f"{first.numel()} entries (index_add_ adds in no fixed order) by at most "
        f"{float(between.max()):.3e}, {float((between / model).max()):.2f} of the same")
    del f32, first, second, mass, err, between, bound_, model

    dc = device_sampler.prepare_device_corpus(corpus, device)
    permute, _ = device_sampler.make_epoch_permuter(dc)
    runs, total = {}, no_launches()
    for accum in ("bfloat16", "float32"):
        desc_, cfg, steps, stats, costs = e_on_device(device, sizes, None, dc, permute, seed,
                                                      accum_dtype=accum)
        launches = read_launches(steps, f"G4 {accum}",
                                 expected_launches(cfg, desc_, sizes["num_entities"]))
        total = {key: total[key] + launches[key] for key in total}
        runs[accum] = (stats, costs)
        log(f"G4 accum_dtype={accum} " + json.dumps(stats))
    a, b = runs["bfloat16"][1], runs["float32"][1]
    rel = float(np.max(np.abs(a - b) / np.abs(b)))
    log(f"G4 costs of {len(a)} steps, bfloat16 against float32 accumulation from the same "
        f"draws: max relative difference {rel:.3e} (tolerance {G4_COST_RTOL:.3e}); ms/step "
        f"{runs['bfloat16'][0]['ms_per_step']:.2f} against {runs['float32'][0]['ms_per_step']:.2f}")
    if not (np.all(np.isfinite(a)) and rel <= G4_COST_RTOL and abs(a[0] - b[0]) <= 1e-5 * b[0]):
        raise AssertionError(f"G4: costs differ by {rel:.3e} > {G4_COST_RTOL:.3e}")
    return total


def phase_g(device, sizes, corpus_b, prefix, seed, tmp, reader_build_s):
    """The tools and the last single-device modules; returns the launches
    of G1, G2 and G4's timed calls."""
    study = load_source("collection_scale_study_torch", "scripts",
                        "collection_scale_study_torch.py")
    t0 = time.perf_counter()
    corpus, queries, qrels = study.make_corpus(STUDY_DOCS)
    log(f"G study corpus: {corpus.num_docs} docs x {study.DOC_LEN} tokens, V {study.VOCAB}, "
        f"{len(queries)} queries, made in {time.perf_counter() - t0:.1f}s")
    parts = [phase_g1(device, sizes, corpus, queries, qrels, tmp, reader_build_s),
             phase_g2(device, study, corpus, queries, qrels)]
    phase_g3(device, corpus_b, prefix, 2, seed, tmp)
    parts.append(phase_g4(device, sizes, corpus_b, seed))
    return {key: sum(p[key] for p in parts) for key in LAUNCH_KEYS}



# H1: the mesh run against the single-device run of the same seed, both
# float32 on the card.  Wherever a sum of a step adds in no fixed order (a
# scatter with atomics, a collective), 117 Adam steps amplify its last bit
# (``scripts/run_to_run_spread_torch.py`` measures two single-device runs).
# So the epoch is trained twice on either side:
# with the default kernels, for the time, the launches and the cost, and with
# deterministic algorithms, where the tables are held entry by entry.  The
# mesh is also held after two calls of K steps with the default kernels,
# before the runs have drifted apart, to the limits of
# ``scripts/mesh_phase_torch.py``.
H_TABLE_ATOL = 5e-6
H_COST_RTOL = 1e-5


@contextlib.contextmanager
def deterministic_algorithms():
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def log_collectives(phase, steps):
    for name, entry in sorted(distributed.collective_log().items()):
        log(f"{phase} collective {name}: {entry['op']} calls={entry['calls']} "
            f"bytes={entry['bytes']} ({entry['bytes'] / max(steps, 1) / 2**20:.3f} MiB/step)"
            f"{' staged through the host' if entry['staged_through_host'] else ''}")


def h1_two_calls(mesh_phase, sizes, corpus, device, mesh=None):
    """{streams: (costs, full tables, ms/step of the timed call)} of two
    calls of K steps from one seed, on ``mesh`` or on one device."""
    h_sizes = dict(mesh_phase.CANONICAL, **{k: sizes[k] for k in mesh_phase.CANONICAL if k in sizes})
    out = {}
    for streams in ("bfloat16", "float32"):
        costs, params, seconds, _ = mesh_phase.two_calls(
            h_sizes, corpus, device, 0, mesh, stream_dtype=streams)
        out[streams] = (costs, params, 1e3 * seconds / h_sizes["steps_per_call"])
    return out


def phase_h1(device, sizes, corpus, tmp):
    """A 1x1 mesh over an NCCL group of one rank: one epoch through
    ``train_model(mesh=)`` against the single-device run of the same seed,
    and two calls of K steps against the same two calls on one device."""
    mesh_phase = load_source("mesh_phase_torch", "scripts", "mesh_phase_torch.py")
    table_differences = mesh_phase.table_differences
    short_single = h1_two_calls(mesh_phase, sizes, corpus, device)
    desc, cfg = canonical_desc_cfg(sizes)
    cfg = dataclasses.replace(cfg, num_epochs=1, cross_chip_reduce_dtype="float32")
    kw = dict(on_device_sampling=True, steps_per_call=sizes["steps_per_call"])
    single = train_model(desc, cfg, corpus, device, **kw)
    with deterministic_algorithms():
        exact_single = train_model(desc, cfg, corpus, device, **kw)
    torch.cuda.synchronize()
    distributed.initialize(f"file://{os.path.join(tmp, 'h1_rendezvous')}", 1, 0,
                           backend="nccl", device=torch.device("cuda", 0))
    try:
        mesh = pmesh.make_mesh(1, 1)
        distributed.reset_collective_log()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        meshed = train_model(desc, cfg, corpus, device, mesh=mesh, **kw)
        torch.cuda.synchronize()
        launches = read_launches(meshed.steps, "H1")
        log_collectives("H1", meshed.steps)
        staged = [n for n, e in distributed.collective_log().items() if e["staged_through_host"]]
        if staged:
            raise AssertionError(f"H1: NCCL collectives staged through the host: {staged}")
        peak = torch.cuda.max_memory_allocated()
        with deterministic_algorithms():
            exact_mesh = train_model(desc, cfg, corpus, device, mesh=mesh, **kw)
        exact_full = pmesh.fetch_params(mesh, exact_mesh.params, sizes["num_entities"])
        short_mesh = h1_two_calls(mesh_phase, sizes, corpus, device, mesh)
    finally:
        distributed.shutdown()
    failures = []
    if meshed.steps != single.steps or not np.allclose(
            meshed.epoch_costs + exact_mesh.epoch_costs,
            single.epoch_costs + exact_single.epoch_costs, rtol=H_COST_RTOL, atol=0):
        failures.append(f"mesh {meshed.steps} steps, costs {meshed.epoch_costs} and "
                        f"{exact_mesh.epoch_costs}; one device {single.steps} steps, costs "
                        f"{single.epoch_costs} and {exact_single.epoch_costs}")
    diffs = table_differences(exact_full, exact_single.params, H_TABLE_ATOL)
    failures += [f"deterministic epoch, {name}: mesh against one device {d}, limit {H_TABLE_ATOL}"
                 for name, d in diffs.items() if d["max"] > H_TABLE_ATOL]
    short = {}
    for streams, (costs, params, ms) in short_mesh.items():
        ref_costs, ref_params, ref_ms = short_single[streams]
        if not np.allclose(costs, ref_costs, rtol=mesh_phase.COST_RTOL, atol=0):
            failures.append(f"two calls, {streams} streams: mesh costs {costs}, one device {ref_costs}")
        short[streams] = dict(differences=table_differences(params, ref_params),
                              ms_per_step=ms, single_device_ms_per_step=ref_ms)
        failures += [f"two calls, {streams} streams, {name}: {d}, limits {mesh_phase.LIMITS[streams]}"
                     for name, d in short[streams]["differences"].items()
                     if any(d[key] > limit for key, limit in mesh_phase.LIMITS[streams].items())]
    stats = dict(
        steps=meshed.steps, ms_per_step=1e3 / meshed.batches_per_sec,
        single_device_ms_per_step=1e3 / single.batches_per_sec,
        deterministic_ms_per_step=1e3 / exact_mesh.batches_per_sec,
        deterministic_single_device_ms_per_step=1e3 / exact_single.batches_per_sec,
        epoch_cost=meshed.epoch_costs[0], single_device_epoch_cost=single.epoch_costs[0],
        deterministic_differences=diffs, table_atol=H_TABLE_ATOL, cost_rtol=H_COST_RTOL,
        default_kernels_differences=table_differences(meshed.params, single.params),
        two_calls=short, two_calls_limits=mesh_phase.LIMITS, peak_mem_gib=peak / 2**30,
    )
    log("H1 " + json.dumps(stats))
    if failures:
        raise AssertionError("H1: " + "; ".join(failures))
    return launches


def phase_h2(device, sizes, corpus, tmp, seed):
    """Four ranks on the one card as a 2x2 mesh over gloo
    (``scripts/mesh_phase_torch.py``)."""
    mesh_phase = load_source("mesh_phase_torch", "scripts", "mesh_phase_torch.py")
    out = os.path.join(tmp, "h2")
    os.makedirs(out)
    h2_sizes = dict(mesh_phase.CANONICAL, **{k: sizes[k] for k in mesh_phase.CANONICAL if k in sizes})
    where = "cuda:0" if device.type == "cuda" else str(device)
    stats, launches = mesh_phase.run("2x2", "gloo", [where], h2_sizes, corpus, out, seed)
    log("H2 " + json.dumps(stats))
    log(f"H2 launches on every rank: {launches} over {h2_sizes['steps_per_call']} steps")
    return launches


def phase_h(device, sizes, corpus, tmp, seed):
    parts = [phase_h1(device, sizes, corpus, tmp), phase_h2(device, sizes, corpus, tmp, seed)]
    return {key: sum(p[key] for p in parts) for key in LAUNCH_KEYS}


# ---------------------------------------------------------------------------
# Phase I: the evaluation pipelines of ``scripts/*_torch.py``, in process.
# ---------------------------------------------------------------------------

# The ad hoc fixture's depth is cut from the rehearsal's 524,288 documents
# (scripts/rehearse_adhoc_torch.sh) for the time limit; its widths are not:
# 120 tokens a document over V 65536, 512 topics, 4 indexes.  The protocol
# runs at the canonical width (d 300 -> 256, B 51200, W 10, k 10, bfloat16
# streams, pool auto) for 4 epochs in calls of K = 13.  The Cranfield shape:
# 1,398 documents and 225 topics, trained 3 epochs at full width; the
# product fixture: 65,536 products (the reference's sports_and_outdoors
# product list) and 2,048 topics, 2 epochs.
PHASE_I = dict(
    adhoc_docs=65536, epochs=4, steps_per_call=13, batch=51200, word_dim=300, entity_dim=256,
    cranfield_docs=1398, cranfield_topics=225, cranfield_epochs=3, cranfield_quick=False,
    products=65536, product_topics=2048, product_epochs=2,
)
# The least NVSM test MAP of I1 and I2 after 4 epochs (the JAX package's
# 524,288-document record is 0.7689 at its selected epoch 9).
I_MIN_NVSM_MAP = 0.5
I_BUDGET_S = 120.0
ADHOC_RESULT_KEYS = sorted([
    "best_epoch", "validation_map", "validation_curve", "nvsm_test_map", "wall_clock_s",
    "num_docs", "resumed", "qlm_jm_prf_test_map", "nvsm+qlm_jm_prf_test_map",
    "qlm_dirichlet_prf_test_map", "nvsm+qlm_dirichlet_prf_test_map",
])
QLM_NAMES = ("qlm_jm", "qlm_jm_prf", "qlm_dirichlet", "qlm_dirichlet_prf")


def start_adhoc_fixture(root, num_docs):
    """``scripts/make_adhoc_fixture.py`` (4 indexes, its default seed; run
    through ``scripts/make_adhoc_fixture_torch.py``) in a process of its own, started before phase B so that its minutes of host
    work overlap phases B-H; phase I waits for it.  Returns (process, log
    path)."""
    log_path = root + ".log"
    with open(log_path, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "scripts", "make_adhoc_fixture_torch.py"), "--root", root,
             "--num_docs", str(num_docs), "--num_indexes", "4"],
            cwd=ROOT, stdout=out, stderr=subprocess.STDOUT)
    return proc, log_path


def mesh_launch_flags(tmp, name):
    """The launch flags of a process group of one rank (NCCL on the card)
    with a 1x1 mesh, rendezvous in a fresh file."""
    return ["--mesh", "1x1", "--coordinator_address", f"file://{os.path.join(tmp, name)}",
            "--num_processes", "1", "--process_id", "0"]


def i_adhoc(name, device, sizes, tmp, mesh):
    """``rank_adhoc_torch.main`` twice: a crash after epoch 2, then
    ``--resume``; on one device or on a 1x1 mesh."""
    adhoc = load_source("rank_adhoc_torch", "scripts", "rank_adhoc_torch.py")
    root, wd = os.path.join(tmp, "adhoc"), os.path.join(tmp, f"{name}_wd")
    argv = ["--corpus", os.path.join(root, "repository"), "--topics", os.path.join(root, "topics.txt"),
            "--qrels", os.path.join(root, "qrels.txt"), "--splits", os.path.join(root, "splits"),
            "--workdir", wd, "--num_epochs", str(sizes["epochs"]), "--eval_every", "2",
            "--checkpoint_every", "2", "--batch_size", str(sizes["batch"]),
            "--word_repr_size", str(sizes["word_dim"]), "--entity_repr_size", str(sizes["entity_dim"]),
            "--on_device_sampling", "--steps_per_call", str(sizes["steps_per_call"]),
            "--stream_dtype", "bfloat16", "--window_sum_dtype", "bfloat16", "--device", str(device)]
    stages, launches = [], no_launches()
    for stage, extra in ((1, ["--fail_after_epoch", "2"]), (2, ["--resume"])):
        if mesh:
            extra = extra + mesh_launch_flags(tmp, f"{name}_rendezvous{stage}")
            distributed.reset_collective_log()
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        with captured_logs() as logs:
            if stage == 1:
                try:
                    adhoc.main(argv + extra)
                except RuntimeError as exc:
                    if "simulated crash after epoch 2" not in str(exc):
                        raise
                else:
                    raise AssertionError(f"{name}: stage 1 finished without the simulated crash")
            elif adhoc.main(argv + extra) != 0:
                raise AssertionError(f"{name}: the resumed stage failed")
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        epochs = trained_epochs(logs)
        steps = sum(n for _, _, n, _ in epochs)
        got = read_launches(steps, f"{name} stage {stage}")
        launches = {key: launches[key] + got[key] for key in launches}
        if mesh:
            log_collectives(f"{name} stage {stage}", steps)
        want = [1, 2] if stage == 1 else [3, 4]
        if [e for e, _, _, _ in epochs] != want or not all(np.isfinite(c) for _, c, _, _ in epochs):
            raise AssertionError(f"{name} stage {stage}: epochs {epochs}, expected {want}")
        resumed = [a[0] for a in logs.args("Resumed from epoch")]
        if resumed != ([] if stage == 1 else [2]):
            raise AssertionError(f"{name} stage {stage}: resumed from {resumed}")
        stages.append(dict(wall_s=wall_s, epochs=[e for e, _, _, _ in epochs],
                           ms_per_step=[1e3 * sec / n for _, _, n, sec in epochs],
                           costs=[c for _, c, _, _ in epochs]))
    with open(os.path.join(wd, "results.json")) as f:
        results = json.load(f)
    curve = [e for e, _ in results["validation_curve"]]
    failures = []
    if sorted(results) != ADHOC_RESULT_KEYS:
        failures.append(f"results.json keys {sorted(results)}")
    if curve != [2, 4] or results["best_epoch"] not in curve or results["resumed"] is not True:
        failures.append(f"curve {results['validation_curve']}, best {results['best_epoch']}")
    if not results["nvsm_test_map"] >= I_MIN_NVSM_MAP:
        failures.append(f"NVSM test MAP {results['nvsm_test_map']} < {I_MIN_NVSM_MAP}")
    stats = dict(stages=stages, results=results, launches=launches)
    log(f"{name} " + json.dumps(stats))
    if failures:
        raise AssertionError(f"{name}: " + "; ".join(failures))
    return stats


def write_cranfield_shape(root, num_docs, num_topics, seed, vocab=8192, doc_len=96, head=80,
                          topic_fraction=0.2, query_terms=5):
    """A synthetic collection in the Cranfield layout (``cranfield.trectext``,
    ``.topics``, ``.qrel``): every document belongs to a topic and draws a
    fifth of its tokens from the topic's 80 head words, the rest from a
    Zipf background; a query is 5 head words of its topic, whose documents
    are its relevant ones."""
    rng = np.random.RandomState(seed)
    bg_p = 1.0 / np.arange(1, vocab + 1) ** 1.07
    bg_p /= bg_p.sum()
    heads = np.stack([rng.choice(vocab, head, replace=False) for _ in range(num_topics)])
    doc_topic = rng.randint(0, num_topics, num_docs)
    n_topic = int(doc_len * topic_fraction)
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "cranfield.trectext"), "w") as f:
        for d in range(num_docs):
            words = np.concatenate([heads[doc_topic[d]][rng.randint(0, head, n_topic)],
                                    rng.choice(vocab, doc_len - n_topic, p=bg_p)])
            rng.shuffle(words)
            f.write(f"<DOC>\n<DOCNO>{d + 1}</DOCNO>\n<TEXT>\n"
                    + " ".join(f"w{w}" for w in words) + "\n</TEXT>\n</DOC>\n")
    with open(os.path.join(root, "cranfield.topics"), "w") as f:
        f.writelines(f"{q + 1} " + " ".join(f"w{w}" for w in rng.choice(heads[q], query_terms,
                                                                          replace=False)) + "\n"
                     for q in range(num_topics))
    with open(os.path.join(root, "cranfield.qrel"), "w") as f:
        f.writelines(f"{q + 1} 0 {d + 1} 1\n" for q in range(num_topics)
                     for d in np.flatnonzero(doc_topic == q))


def counted_run(main_fn, argv, what, rule):
    """``main_fn(argv)`` in process with the kernels' launches counted from
    0: (log records, trained epochs, launches, wall s).  ``rule()``, called
    after the run, gives the launches per step that ``read_launches`` holds
    them to; every trained epoch's cost must be finite."""
    torch.cuda.synchronize()
    reset_launches()
    logs, wall_s = run_command(main_fn, argv, what)
    torch.cuda.synchronize()
    epochs = trained_epochs(logs)
    launches = read_launches(sum(n for _, _, n, _ in epochs), what, rule())
    if not epochs or not all(np.isfinite(c) for _, c, _, _ in epochs):
        raise AssertionError(f"{what}: epochs {epochs}")
    return logs, epochs, launches, wall_s


def i_run(main_fn, argv, what, steps_per_kernel=None):
    """``main_fn(argv)`` with the launches counted: (results of the run's
    results.json, trained epochs, launches, wall s)."""
    _, epochs, launches, wall_s = counted_run(main_fn, argv, what, lambda: steps_per_kernel)
    with open(os.path.join(argv[argv.index("--workdir") + 1], "results.json")) as f:
        return json.load(f), epochs, launches, wall_s


def phase_i3(device, sizes, tmp, seed):
    """rank_cranfield_torch.main on a collection of Cranfield's size: LSE
    (host-fed, batch 4096) and NVSM (batch 51200) at full width, the QLM
    MAPs against the same call on the CPU, then NVSM on a 1x1 mesh."""
    cranfield = load_source("rank_cranfield_torch", "scripts", "rank_cranfield_torch.py")
    data = os.path.join(tmp, "cranfield")
    write_cranfield_shape(data, sizes["cranfield_docs"], sizes["cranfield_topics"], seed)
    common = ["--data_dir", data, "--num_epochs", str(sizes["cranfield_epochs"]),
              "--stream_dtype", "bfloat16", "--window_sum_dtype", "bfloat16",
              "--grid_cv_fusion", "off", *(["--quick"] if sizes["cranfield_quick"] else [])]
    results, epochs, launches, wall_s = i_run(
        cranfield.main, common + ["--workdir", os.path.join(tmp, "I3_wd"), "--device", str(device)],
        "I3 LSE + NVSM")
    cpu, _ = run_command(cranfield.main, ["--data_dir", data, "--workdir", os.path.join(tmp, "I3_cpu"),
                                          "--models", "", "--device", "cpu"], "I3 QLM on the CPU")
    with open(os.path.join(tmp, "I3_cpu", "results.json")) as f:
        cpu_results = json.load(f)
    distributed.reset_collective_log()
    mesh_results, mesh_epochs, mesh_launches, mesh_wall_s = i_run(
        cranfield.main, common + ["--workdir", os.path.join(tmp, "I3_mesh"), "--models", "nvsm",
                                  "--device", str(device), *mesh_launch_flags(tmp, "I3_rendezvous")],
        "I3 NVSM on a 1x1 mesh")
    log_collectives("I3 mesh", sum(n for _, _, n, _ in mesh_epochs))
    failures = []
    for name in QLM_NAMES:
        if not (results[name] == cpu_results[name] == mesh_results[name]):
            failures.append(f"{name}: card {results[name]}, CPU {cpu_results[name]}, "
                            f"mesh {mesh_results[name]}")
    for got in (results, mesh_results):
        if not all(0.0 <= v <= 1.0 for v in got.values()):
            failures.append(f"a MAP outside [0, 1]: {got}")
    if len(epochs) != 2 * sizes["cranfield_epochs"] or len(mesh_epochs) != sizes["cranfield_epochs"]:
        failures.append(f"epochs {epochs} and {mesh_epochs}")
    stats = dict(results=results, mesh_results=mesh_results, wall_s=wall_s, mesh_wall_s=mesh_wall_s,
                 epochs=epochs, mesh_epochs=mesh_epochs)
    log("I3 " + json.dumps(stats))
    if failures:
        raise AssertionError("I3: " + "; ".join(failures))
    return {key: launches[key] + mesh_launches[key] for key in launches}


def phase_i4(device, sizes, tmp, seed):
    """product_substitutability_torch.main on a synthetic product fixture:
    the TEXT_ENTITY_ENTITY_ENTITY composite at weight 0.1, full width,
    host-fed, float32 streams (2 sweeps per step, no cast)."""
    product = load_source("product_substitutability_torch", "scripts",
                          "product_substitutability_torch.py")
    paths = product.write_synthetic_fixture(os.path.join(tmp, "products"), sizes["products"],
                                            sizes["product_topics"], seed=seed)
    results, epochs, launches, wall_s = i_run(product.main, [
        "--corpus", paths["corpus"], "--substitutes", paths["substitutes"],
        "--resources", paths["resources"], "--workdir", os.path.join(tmp, "I4_wd"),
        "--entity_similarity_weight", "0.1", "--num_epochs", str(sizes["product_epochs"]),
        "--eval_every", "1", "--batch_size", str(sizes["batch"]),
        "--word_repr_size", str(sizes["word_dim"]), "--entity_repr_size", str(sizes["entity_dim"]),
        "--planted_split", paths["planted_split"], "--device", str(device),
    ], "I4 Mix 'n Match", {"sweep": 2, "cast": 0, "segsum": 2, "index_add": 0})
    stats = dict(results=results, epochs=epochs, wall_s=wall_s,
                 ms_per_step=[1e3 * sec / n for _, _, n, sec in epochs])
    log("I4 " + json.dumps(stats))
    best = results["mix_n_match"]["best_epoch"]
    if best not in range(1, sizes["product_epochs"] + 1):
        raise AssertionError(f"I4: selected epoch {best}")
    return launches


def phase_i(device, sizes, tmp, fixture, seed):
    """The evaluation pipelines: I1 the ad hoc protocol with a crash and
    --resume on one device, I2 the same on a 1x1 mesh (held to I1), I3 the
    Cranfield pipeline, I4 the Mix 'n Match protocol."""
    proc, fixture_log = fixture
    t0 = time.perf_counter()
    if proc.wait(timeout=900) != 0:
        with open(fixture_log) as f:
            raise AssertionError(f"I: the ad hoc fixture failed:\n{f.read()[-4000:]}")
    log(f"I waited {time.perf_counter() - t0:.1f}s for the ad hoc fixture")
    t0 = time.perf_counter()
    i1 = i_adhoc("I1", device, sizes, tmp, mesh=False)
    i2 = i_adhoc("I2", device, sizes, tmp, mesh=True)
    # A 1x1 mesh draws what one device draws but rounds otherwise on the
    # card (PERF.md section 6, the mesh path): everything but the trained tables'
    # numbers is held equal.
    r1, r2 = i1["results"], i2["results"]
    failures = [key for key in ("resumed", "num_docs", "qlm_jm_prf_test_map",
                                "qlm_dirichlet_prf_test_map") if r2[key] != r1[key]]
    if [s["epochs"] for s in i2["stages"]] != [s["epochs"] for s in i1["stages"]]:
        failures.append("the trained epochs")
    if [e for e, _ in r2["validation_curve"]] != [e for e, _ in r1["validation_curve"]]:
        failures.append("the curve's epochs")
    if failures:
        raise AssertionError(f"I2 against I1: {failures}")
    i12_s = time.perf_counter() - t0
    launches = [i1["launches"], i2["launches"], phase_i3(device, sizes, tmp, seed),
                phase_i4(device, sizes, tmp, seed)]
    total = time.perf_counter() - t0
    log(f"I done in {total:.1f}s (I1 + I2 {i12_s:.1f}s; budget {I_BUDGET_S:.0f}s)")
    return {key: sum(p[key] for p in launches) for key in LAUNCH_KEYS}


# Phase J: the last scripts of the JAX package.  The Reuters pipeline runs
# at its default widths (d 300 -> 256, batch 4096) on synthetic SGML of
# Reuters-21578's 21,578 articles in 10 topic classes, cut in depth from 15
# epochs to 3 and in length to 64 words an article.  The quality campaign
# trains the canonical NVSM (bfloat16 streams) on the Cranfield shape for 3
# epochs (cut from 100) and 2 seeds (cut from 8).  The throughput tool runs
# 65,536 documents x 120 tokens (cut from 262,144) for 3 epochs (cut from
# 10): 142 steps an epoch in calls of K = 8, a dump every 2 epochs.  The
# serving benchmark runs at its defaults (262,144 documents, top 1000).
PHASE_J = dict(
    reuters_articles=21578, reuters_classes=10, reuters_words=64, reuters_epochs=3,
    reuters_batch=4096, reuters_word_dim=300, reuters_entity_dim=256,
    cranfield_docs=1398, cranfield_topics=225, quality_epochs=3, quality_seeds="1,2",
    e2e_docs=65536, e2e_doc_len=120, e2e_epochs=3, e2e_steps_per_call=8,
    e2e_checkpoint_every=2, e2e_batch=51200, e2e_word_dim=300, e2e_entity_dim=256,
    bench_docs=262144, bench_top_k=1000,
)
J_BUDGET_S = 90.0
QUALITY_KEYS = sorted(["config", "seed", "map", "minutes", "fusion_dirichlet_prf_map",
                       "fusion_jm_prf_map"])
FUSION_KEYS = sorted(["num_nvsm_runs", "qlm_jm_prf_map", "unsupervised_alpha0.5",
                      "supervised_cv20_step0.01"])


def write_reuters_shape(path, num_articles, num_classes, num_words, seed, class_vocab=300,
                        background_vocab=4000, class_share=0.4):
    """Synthetic SGML in the Reuters-21578 layout: every tenth article has
    no topic; the others have one of ``num_classes``, and draw
    ``class_share`` of their words from their topic's ``class_vocab``, the
    rest from a Zipf background."""
    rng = np.random.RandomState(seed)
    bg_p = 1.0 / np.arange(1, background_vocab + 1) ** 1.07
    bg_p /= bg_p.sum()
    n_class = int(num_words * class_share)
    with open(path, "w", encoding="latin1") as f:
        for i in range(num_articles):
            words = [f"bg{w}" for w in rng.choice(background_vocab, num_words, p=bg_p)]
            topics = ""
            if i % 10:
                c = rng.randint(num_classes)
                words[:n_class] = [f"t{c}w{w}" for w in rng.randint(0, class_vocab, n_class)]
                rng.shuffle(words)
                topics = f"<D>topic{c}</D>"
            f.write(f'<REUTERS NEWID="{i + 1}">\n<TOPICS>{topics}</TOPICS>\n'
                    f"<TEXT>\n<TITLE>article {i + 1}</TITLE>\n<BODY>{' '.join(words)}</BODY>\n"
                    "</TEXT>\n</REUTERS>\n")


@contextlib.contextmanager
def recorded_trainings(module):
    """``module.train_model`` wrapped: yields the list of (desc, cfg, number
    of documents) of its calls."""
    calls, real = [], module.train_model

    def spy(desc, cfg, corpus, *args, **kwargs):
        calls.append((desc, cfg, corpus.num_docs))
        return real(desc, cfg, corpus, *args, **kwargs)

    module.train_model = spy
    try:
        yield calls
    finally:
        module.train_model = real


def j_run(script, argv, what, want_per_step=None):
    """``script.main(argv)`` in process, its trainings' launches counted and
    held to the rule of their configuration (and to ``want_per_step``):
    (log records, trained epochs, launches, wall s)."""

    def rule():
        rules = [expected_launches(cfg, desc, n) for desc, cfg, n in calls]
        if not calls or any(r != rules[0] for r in rules):
            raise AssertionError(f"{what}: trainings {len(calls)}, launch rules {rules}")
        if want_per_step and rules[0] != want_per_step:
            raise AssertionError(f"{what}: launch rule {rules[0]}, expected {want_per_step}")
        return rules[0]

    with recorded_trainings(script) as calls:
        logs, epochs, launches, wall_s = counted_run(script.main, argv, what, rule)
    desc, cfg, n = calls[0]
    log(f"{what}: {len(epochs)} epochs, ms/step "
        + ", ".join(f"{1e3 * sec / steps:.2f}" for _, _, steps, sec in epochs)
        + f"; negatives {negative_layout(cfg, desc, n)}; wall {wall_s:.1f}s")
    return logs, epochs, launches, wall_s


def phase_j1(device, sizes, tmp, seed):
    """``scripts/visualize_reuters_torch.py``: full_adam with float32
    streams (2 sweeps, no cast per step); the class silhouette must rise
    from the first epoch to the last."""
    reuters = load_source("visualize_reuters_torch", "scripts", "visualize_reuters_torch.py")
    sgm, wd = os.path.join(tmp, "reuters.sgm"), os.path.join(tmp, "J1_wd")
    write_reuters_shape(sgm, sizes["reuters_articles"], sizes["reuters_classes"],
                        sizes["reuters_words"], seed)
    logs, epochs, launches, wall_s = j_run(reuters, [
        "--sgm", sgm, "--workdir", wd, "--num_epochs", str(sizes["reuters_epochs"]),
        "--batch_size", str(sizes["reuters_batch"]),
        "--word_repr_size", str(sizes["reuters_word_dim"]),
        "--entity_repr_size", str(sizes["reuters_entity_dim"]), "--device", str(device)],
        "J1 Reuters", {"sweep": 2, "cast": 0, "segsum": 2, "index_add": 0})
    with open(os.path.join(wd, "metrics.json")) as f:
        metrics = json.load(f)
    curve = metrics["class_silhouette_cosine_by_epoch"]
    plots = sorted(os.listdir(os.path.join(wd, "plots")))
    log("J1 " + json.dumps(dict(metrics, plots=len(plots),
                               plotting=reuters.missing_plot_library() or "available")))
    failures = []
    if metrics["num_classes"] != sizes["reuters_classes"]:
        failures.append(f"{metrics['num_classes']} classes")
    if [e for e, _ in curve] != list(range(1, sizes["reuters_epochs"] + 1)):
        failures.append(f"the curve's epochs {curve}")
    elif not curve[-1][1] > curve[0][1]:
        failures.append(f"the silhouette did not rise: {curve}")
    skipped = [r for r in logs.records if r.msg.startswith("No t-SNE plots")]
    if reuters.missing_plot_library() and (plots or len(skipped) != 1):
        failures.append(f"plots {plots} and {len(skipped)} warnings without the plotting "
                        "libraries")
    if failures:
        raise AssertionError("J1: " + "; ".join(failures))
    return launches


def phase_j2(device, sizes, tmp, seed):
    """``scripts/quality_seeds_torch.py --config auto`` on the Cranfield
    shape, read back by the unchanged ``scripts/quality_stats.py``; returns
    the launches and the directory of the dumped runs."""
    quality = load_source("quality_seeds_torch", "scripts", "quality_seeds_torch.py")
    data, out, runs = (os.path.join(tmp, name) for name in ("cranfield", "J2.jsonl", "J2_runs"))
    write_cranfield_shape(data, sizes["cranfield_docs"], sizes["cranfield_topics"], seed)
    _, epochs, launches, wall_s = j_run(quality, [
        "--data_dir", data, "--out", out, "--config", "auto", "--seeds", sizes["quality_seeds"],
        "--num_epochs", str(sizes["quality_epochs"]), "--dump_runs", runs,
        "--device", str(device)], "J2 quality campaign")
    with open(out) as f:
        lines = [json.loads(line) for line in f]
    stats = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "quality_stats.py"), out,
                            "--baseline", "auto"], capture_output=True, text=True, timeout=120)
    log("J2 " + json.dumps(lines))
    log("J2 quality_stats.py: " + stats.stdout.strip().replace("\n", " | "))
    seeds = [int(s) for s in sizes["quality_seeds"].split(",")]
    failures = []
    if stats.returncode != 0 or "auto" not in stats.stdout:
        failures.append(f"quality_stats.py exited {stats.returncode}: {stats.stderr[-2000:]}")
    if [line["seed"] for line in lines] != seeds or len(epochs) != len(seeds) * sizes[
            "quality_epochs"]:
        failures.append(f"seeds {[line['seed'] for line in lines]}, epochs {len(epochs)}")
    for line in lines:
        if sorted(line) != QUALITY_KEYS or not all(
                0.0 <= line[k] <= 1.0 for k in QUALITY_KEYS if k.endswith("map")):
            failures.append(f"line {line}")
    for seed in seeds:
        run = read_run(os.path.join(runs, f"nvsm_auto_s{seed}.run"))
        if len(run) != sizes["cranfield_topics"] or max(map(len, run.values())) > 1000:
            failures.append(f"run of seed {seed}: {len(run)} topics")
    if failures:
        raise AssertionError("J2: " + "; ".join(failures))
    return launches, runs, data


def phase_j3(runs, data, tmp):
    """``scripts/fusion_study_torch.py`` over J2's runs, its default cells
    (host work only)."""
    fusion = load_source("fusion_study_torch", "scripts", "fusion_study_torch.py")
    out = os.path.join(tmp, "J3.json")
    with contextlib.redirect_stdout(open(os.devnull, "w")):
        _, wall_s = run_command(fusion.main, ["--data_dir", data, "--runs_dir", runs,
                                              "--out", out], "J3 fusion study")
    with open(out) as f:
        results = json.load(f)
    log(f"J3 ({wall_s:.1f}s) " + json.dumps(results))
    cells = [results[k][s] for k in FUSION_KEYS[2:] for s in ("mean", "min", "max")]
    if (sorted(results) != FUSION_KEYS or results["num_nvsm_runs"] != len(os.listdir(runs))
            or not all(0.0 <= v <= 1.0 for v in cells + [results["qlm_jm_prf_map"]])):
        raise AssertionError(f"J3: {results}")


def phase_j4(device, sizes, tmp):
    """``scripts/e2e_throughput_torch.py``: on-device sampling, bfloat16
    streams, the async writer; the model files of the dump epochs read
    back."""
    e2e = load_source("e2e_throughput_torch", "scripts", "e2e_throughput_torch.py")
    out, wd = os.path.join(tmp, "J4.json"), os.path.join(tmp, "J4_wd")
    _, epochs, launches, wall_s = j_run(e2e, [
        "--out", out, "--workdir", wd, "--num_docs", str(sizes["e2e_docs"]),
        "--doc_len", str(sizes["e2e_doc_len"]), "--epochs", str(sizes["e2e_epochs"]),
        "--steps_per_call", str(sizes["e2e_steps_per_call"]),
        "--checkpoint_every", str(sizes["e2e_checkpoint_every"]),
        "--batch_size", str(sizes["e2e_batch"]), "--word_repr_size", str(sizes["e2e_word_dim"]),
        "--entity_repr_size", str(sizes["e2e_entity_dim"]), "--device", str(device)],
        "J4 end-to-end throughput")
    with open(out) as f:
        result = json.load(f)
    log(f"J4: {result['value']} pairs/s steady, epochs {result['epoch_wall_s']} s, writer drain "
        f"{result['writer_drain_s']} s ({result['device']})")
    failures = []
    steps = result["steps_per_epoch"]
    if [n for _, _, n, _ in epochs] != [steps] * sizes["e2e_epochs"]:
        failures.append(f"epochs {epochs}, {steps} steps an epoch")
    if not (result["value"] and np.isfinite(result["final_cost"])):
        failures.append(f"value {result['value']}, final cost {result['final_cost']}")
    dumps = [e for e in range(1, sizes["e2e_epochs"] + 1)
             if e % sizes["e2e_checkpoint_every"] == 0 or e == sizes["e2e_epochs"]]
    for epoch in dumps:
        params = checkpoint.load_model_hdf5(os.path.join(wd, "model"), epoch, device)
        tables = (params.word_reprs, params.entity_reprs, params.transform_w, params.transform_b)
        if (params.entity_reprs.shape != (sizes["e2e_docs"], sizes["e2e_entity_dim"])
                or not all(bool(torch.isfinite(t).all()) for t in tables)):
            failures.append(f"the model file of epoch {epoch}")
    if failures:
        raise AssertionError("J4: " + "; ".join(failures))
    return launches


def phase_j5(device, sizes):
    """``scripts/bench_query_torch.py`` at its defaults: float32 and
    bfloat16 documents, 1 and 16 queries (no kernel of the port)."""
    bench = load_source("bench_query_torch", "scripts", "bench_query_torch.py")
    _, wall_s = run_command(bench.main, ["--docs", str(sizes["bench_docs"]),
                                         "--top_k", str(sizes["bench_top_k"]),
                                         "--device", str(device)], "J5 serving latency")
    log(f"J5 done in {wall_s:.1f}s")


def phase_j(device, sizes, tmp, seed):
    """The last scripts of the JAX package, called in process: J1 the
    Reuters pipeline, J2 the quality campaign, J3 the fusion study over
    J2's runs, J4 the end-to-end throughput tool, J5 the serving-latency
    benchmark."""
    t0 = time.perf_counter()
    j1 = phase_j1(device, sizes, tmp, seed)
    j2, runs, data = phase_j2(device, sizes, tmp, seed)
    phase_j3(runs, data, tmp)
    j4 = phase_j4(device, sizes, tmp)
    phase_j5(device, sizes)
    total = time.perf_counter() - t0
    log(f"J done in {total:.1f}s (budget {J_BUDGET_S:.0f}s)")
    return {key: j1[key] + j2[key] + j4[key] for key in LAUNCH_KEYS}


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of phase E's parameters, draws and similarity pairs")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; the smoke test runs only on a GPU")
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"nvidia-smi: {gpu_name_and_power()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    log(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    kernels = phase_a(device, CANONICAL)
    log(f"A done in {time.perf_counter() - t0:.1f}s (the kernels' builds included)")
    # The C++ corpus reader, which phases F3 and G1 read text and Indri
    # repositories with, is built here so that its build is timed alone.
    t0 = time.perf_counter()
    reader = native.build_library()
    reader_build_s = time.perf_counter() - t0
    if not native.available():
        raise AssertionError("the C++ corpus reader did not build or load")
    log(f"A g++ build of the C++ corpus reader: {reader_build_s:.1f}s "
        f"({os.path.relpath(reader, ROOT)})")
    os.makedirs(BUILD, exist_ok=True)
    tmp_i = tempfile.mkdtemp(prefix="phase_i_", dir=BUILD)
    fixture = start_adhoc_fixture(os.path.join(tmp_i, "adhoc"), PHASE_I["adhoc_docs"])
    try:
        by_path = phases_b_to_i(device, args.seed, reader_build_s, tmp_i, fixture)
    finally:
        if fixture[0].poll() is None:
            fixture[0].kill()
            fixture[0].wait()
        shutil.rmtree(tmp_i)
    launches = {key: sum(p[key] for p in by_path.values()) for key in LAUNCH_KEYS}

    meta = {
        "sweep": ("fused_adam_dense_sweep", "triton", "cunvsm_torch/ops/adam_sweep.py",
                  "cunvsm_tpu/ops/adam_sweep.py:72"),
        "cast": ("cast_table", "cuda", "cunvsm_torch/csrc/cast_bf16.cu",
                 "cunvsm_tpu/ops/cast.py:31"),
        "segsum": ("segment_sum", "cuda", "cunvsm_torch/csrc/segment_sum.cu",
                   "cunvsm_tpu/optim/updates.py:207 (XLA's sorted segment sum)"),
    }
    kernels["segsum"].update(
        index_add_fallbacks=launches["index_add"],
        index_add_fallbacks_by_path={path: p["index_add"] for path, p in by_path.items()})
    print(json.dumps({"kernels": [
        {"name": name, "route": route, "source": src, "replaces": rep,
         "launches": launches[key], **kernels[key],
         "launches_by_path": {path: p[key] for path, p in by_path.items()}}
        for key, (name, route, src, rep) in meta.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


def phases_b_to_i(device, seed, reader_build_s, tmp_i, fixture):
    """Phases B0 to J; the launches of each path."""
    phase_b0(device)
    reset_launches()
    stats, params_b, corpus_b = phase_b(device, CANONICAL)
    log("B " + json.dumps(stats))
    by_path = {"B": read_launches(stats["steps"], "B")}
    phase_c(device, params_b, corpus_b)
    del params_b
    by_path["D1"] = phase_d1(device, CANONICAL, corpus_b)[1]
    by_path["D2"] = phase_d2(device, CANONICAL, corpus_b)[1]
    phase_e0(device)
    by_path["E"] = phase_e(device, CANONICAL, corpus_b, seed)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s: %(message)s")
    tmp = tempfile.mkdtemp(prefix="phase_fg_", dir=BUILD)
    try:
        t0 = time.perf_counter()
        prefix, by_path["F"] = phase_f(device, CANONICAL, corpus_b, seed, tmp)
        log(f"F done in {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        by_path["G"] = phase_g(device, CANONICAL, corpus_b, prefix, seed, tmp, reader_build_s)
        log(f"G done in {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        by_path["H"] = phase_h(device, CANONICAL, corpus_b, tmp, seed)
        log(f"H done in {time.perf_counter() - t0:.1f}s")
    finally:
        shutil.rmtree(tmp)
    del corpus_b
    by_path["I"] = phase_i(device, PHASE_I, tmp_i, fixture, seed)
    tmp_j = tempfile.mkdtemp(prefix="phase_j_", dir=BUILD)
    try:
        by_path["J"] = phase_j(device, PHASE_J, tmp_j, seed)
    finally:
        shutil.rmtree(tmp_j)
    return by_path


if __name__ == "__main__":
    main()
