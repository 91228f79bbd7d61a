#!/usr/bin/env python3
"""The port's mesh path at full width: four ranks on a 2x2 mesh, trained on
the device and served sharded, held to the single-device path.

    python3 scripts/mesh_phase_torch.py --mesh 2x2 --backend nccl   # 4 cards
    python3 scripts/mesh_phase_torch.py --mesh 2x2 --backend gloo \\
        --devices cuda:0                                            # 1 card

With ``--backend nccl`` every rank takes a card of its own (``cuda:<rank>``).
NCCL refuses two ranks on one device, so on a machine with one card the
caller asks for gloo by name and every rank runs on ``cuda:0``: the
collectives layer then stages each buffer through the host and says so in
its log, and the step times say nothing of four cards.  This is phase H2 of
``chip_smoke.py``, which calls :func:`run` with the corpus it already has.

The parent builds the kernels (one small launch of each), writes the corpus
and starts one process of this script per rank (``--rank``), joins them with
a deadline and kills the rest when one fails or is late.  Every rank:

1. joins the group (a file rendezvous), makes the mesh, initializes the full
   tables from ``--seed`` and keeps its shards;
2. trains one warm-up and one timed call of K steps through
   ``make_device_sampled_sharded_multistep`` (canonical configuration:
   V 65536, N 262144, d 300 -> 256, B 51200, W 10, k 10, pool 2048 / stride
   205, full_adam, bfloat16 streams), then fetches the tables;
3. counts its kernel launches (2 sweeps, 1 cast and 2 segment sums per
   step, the entity sweep over its [N / model, 256] shard, the word segment
   sum over the rank's slice of its data group's descriptors; no
   ``index_add_`` accumulation) and its collectives by name;
4. takes one host-fed step with N - 1 entities, which pads the table;
5. trains one epoch through ``train_model(mesh=, shard_corpus=True)`` with a
   model file and a resume file, on the canonical documents cut to 12
   tokens (15 steps: one call of K and a remainder call), each data group
   holding and shuffling its own documents;
6. serves 100 queries, top 1000, through ``QueryEngine(mesh=)`` with
   float32 and with bfloat16 scores.

The parent then runs the same two calls on one device from the same seed
(the same draws) and the same queries through the single-device engine, and
holds costs, tables and rankings to them; the sharded corpus is held to one
device that plays the data groups in turn (:func:`play_data_groups`), and
the model file to the tables the ranks fetched.  The mesh sums every word row,
pool row and transform gradient in another order than one device, so its
float32 values differ in the last bit from the first step on.  The costs
stay within COST_RTOL.  The tables cannot be held entry by entry: Adam
from a zero state normalizes a gradient entry that is all rounding noise
to a step of about the learning rate with the noise's sign, and under
bfloat16 streams a last-bit difference now and then turns a rounding of
2^-9.  They are held by their root-mean-square difference and by a bound on
the largest difference of a few such steps (the limits below, beside what
an NVIDIA H100 measured) with bfloat16 streams and, more closely and also
by the share of entries that differ by more than TABLE_ATOL, with float32
streams.  A fault of the mesh program (a missing reduce, a wrong
normalizer) moves the costs and every entry by orders of magnitude more;
the CPU tests hold the same program to rtol 1e-9 in float64.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from cunvsm_torch.config import (  # noqa: E402
    AdamConfig, AdamMode, ModelDesc, Nonlinearity, TrainConfig, UpdateMethod,
)
from cunvsm_torch.data import device_sampler  # noqa: E402
from cunvsm_torch.data.corpus import Corpus  # noqa: E402
from cunvsm_torch.data.instances import TextEntitySource  # noqa: E402
from cunvsm_torch.data.synth import zipf_corpus  # noqa: E402
from cunvsm_torch.io import checkpoint  # noqa: E402
from cunvsm_torch.models.objectives import SparseGrad, TextEntityBatch  # noqa: E402
from cunvsm_torch.models.params import ModelParams, init_params  # noqa: E402
from cunvsm_torch.ops import adam_sweep, cast, segment_kernels  # noqa: E402
from cunvsm_torch.optim.updates import Optimizer  # noqa: E402
from cunvsm_torch.parallel import distributed, mesh as pmesh  # noqa: E402
from cunvsm_torch.query.engine import QueryEngine  # noqa: E402
from cunvsm_torch.train import trainer  # noqa: E402
from cunvsm_torch.train.step import make_train_step  # noqa: E402

CANONICAL = dict(
    num_words=65536, num_entities=262144, doc_len=32, word_dim=300, entity_dim=256,
    batch=51200, window=10, negatives=10, steps_per_call=13, queries=100, top_k=1000,
    shard_doc_len=12,
)
# Costs and tables after 2K = 26 steps, mesh against one device, both
# float32 on the card from the same draws (see the module doc).  Measured on
# an NVIDIA H100 80GB HBM3 at 700 W, 2x2 over gloo: costs within 3.6e-7;
# bfloat16 streams rms 2.7e-6 to 7.2e-6, largest 8.9e-5; float32 streams rms
# 1.7e-8 to 5.3e-7, 0.09% of the entries beyond 5e-6, largest 2.4e-5.
COST_RTOL = 1e-5
TABLE_ATOL = 5e-6
LIMITS = {
    "bfloat16": dict(rms=2e-5, max=5e-4),
    "float32": dict(rms=2e-6, share_over_atol=5e-3, max=1e-4),
}
SCORE_ATOL = 1e-5
# A rank that hangs fails its group after GROUP_TIMEOUT_SECONDS and is killed
# at the deadline: a hang still ends well inside a 900 s run of the smoke test.
RANK_DEADLINE_SECONDS = 360
GROUP_TIMEOUT_SECONDS = 120.0


def log(msg: str) -> None:
    print(msg, flush=True)


def desc_cfg(sizes, reduce_dtype="float32", stream_dtype="bfloat16"):
    """The canonical configuration.  The cross-rank word reduce is float32
    where the mesh is held to one device (only the order of the sums then
    differs); ``"auto"`` narrows it to the streams' bfloat16, which rounds
    the reduced partials once more.  ``stream_dtype="float32"`` takes the
    bfloat16 streams (and the cast kernel) out."""
    desc = ModelDesc(
        word_repr_size=sizes["word_dim"], entity_repr_size=sizes["entity_dim"],
        nonlinearity=Nonlinearity.HARD_TANH, batch_normalization=True,
    )
    cfg = TrainConfig(
        batch_size=sizes["batch"], window_size=sizes["window"],
        num_random_entities=sizes["negatives"], update_method=UpdateMethod.ADAM,
        adam=AdamConfig(mode=AdamMode.DENSE_UPDATE_DENSE_VARIANCE),
        learning_rate=1e-3, regularization_lambda=1e-2,
        stream_dtype=stream_dtype, window_sum_dtype=stream_dtype,
        uniform_feature_weights=True, negative_pool_size=-1,
        cross_chip_reduce_dtype=reduce_dtype,
    )
    return desc, cfg


def launch_counts() -> dict:
    return {"sweep": adam_sweep.fused_adam_dense_sweep.launches,
            "cast": cast.cast_table.launches,
            "segsum": segment_kernels.segment_sum.launches,
            "index_add": segment_kernels.index_add_sum.calls}


def per_step_launches(steps: int) -> dict:
    """The launches of ``steps`` canonical steps on a card."""
    return {"sweep": 2 * steps, "cast": steps, "segsum": 2 * steps, "index_add": 0}


def reset_launches() -> None:
    adam_sweep.fused_adam_dense_sweep.launches = 0
    cast.cast_table.launches = 0
    segment_kernels.segment_sum.launches = 0
    segment_kernels.index_add_sum.calls = 0


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def two_calls(sizes, corpus, device, seed, mesh=None, reduce_dtype="float32",
              stream_dtype="bfloat16"):
    """One warm-up and one timed call of K steps on the device, from
    ``seed``; with ``mesh`` as this rank's part of the mesh run.  Returns
    (costs [2K], params, seconds of the timed call, launches of the timed
    call)."""
    desc, cfg = desc_cfg(sizes, reduce_dtype, stream_dtype)
    k, batch, n_ent = sizes["steps_per_call"], sizes["batch"], sizes["num_entities"]
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(gen, sizes["num_words"], n_ent, desc, device=device)
    if mesh is not None:
        params = pmesh.shard_params(mesh, params)
    state = Optimizer(cfg).init(params)
    dc = device_sampler.prepare_device_corpus(corpus, device)
    permute, _ = device_sampler.make_epoch_permuter(dc)
    if mesh is None:
        run = device_sampler.make_device_sampled_multistep(desc, cfg, dc, k, gen, num_entities=n_ent)
    else:
        run = device_sampler.make_device_sampled_sharded_multistep(
            desc, cfg, dc, k, mesh, gen, num_entities=n_ent)
    doc_perm = permute(gen)
    warm = run(params, state, doc_perm, 0)
    sync(device)
    reset_launches()
    distributed.reset_collective_log()
    t0 = time.perf_counter()
    timed = run(params, state, doc_perm, k * batch)
    sync(device)
    seconds = time.perf_counter() - t0
    return torch.cat([warm, timed]).cpu().numpy(), params, seconds, launch_counts()


def queries_of(corpus, sizes, seed):
    rng = np.random.RandomState(seed + 7)
    terms = corpus.vocab.terms
    return {f"q{i}": [terms[j] for j in rng.randint(0, len(terms), 3)]
            for i in range(sizes["queries"])}


def serve(params, corpus, sizes, seed, device, mesh=None):
    """{score dtype: (run, ms of the second ``rank`` call, host included)}."""
    out = {}
    queries = queries_of(corpus, sizes, seed)
    for name in ("float32", "bfloat16"):
        engine = QueryEngine(params, corpus.vocab.terms, corpus.docnos,
                             score_dtype=getattr(torch, name), mesh=mesh)
        engine.rank(queries, top_k=sizes["top_k"])  # warm-up
        sync(device)
        t0 = time.perf_counter()
        run = engine.rank(queries, top_k=sizes["top_k"])
        out[name] = (run, 1e3 * (time.perf_counter() - t0))
    return out


def padded_step(sizes, device, seed, mesh):
    """One host-fed step with N - 1 entities (the model axis pads the table
    by one row): the cost, and whether the padded row stayed zero and the
    fetched table has N - 1 rows."""
    desc, cfg = desc_cfg(sizes)
    n_ent = sizes["num_entities"] - 1
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    params = init_params(gen, sizes["num_words"], n_ent, desc, device=device)
    state = Optimizer(cfg).init(params)
    step, params, state = pmesh.make_sharded_train_step(
        desc, cfg, mesh, params, state, device, gen)
    rng = np.random.RandomState(seed)
    b, w = sizes["batch"], sizes["window"]
    batch = TextEntityBatch(
        features=torch.from_numpy(rng.randint(0, sizes["num_words"], (b, w))).to(device),
        feature_weights=torch.ones((b, w), device=device),
        labels=torch.from_numpy(rng.randint(0, n_ent, b)).to(device),
        weights=torch.ones(b, device=device),
    )
    cost = float(step(params, state, batch))
    full = pmesh.fetch_params(mesh, params)
    real = pmesh.fetch_params(mesh, params, n_ent)
    return dict(
        cost=cost, shard_rows=int(params.entity_reprs.shape[0]),
        padded_rows=int(full.entity_reprs.shape[0]),
        padded_row_zero=not bool(full.entity_reprs[n_ent:].any()),
        fetched_rows=int(real.entity_reprs.shape[0]),
    )


def shard_cfg(sizes, seed):
    desc, cfg = desc_cfg(sizes)
    return desc, dataclasses.replace(cfg, num_epochs=1, seed=seed)


def sharded_corpus_epoch(sizes, corpus, device, seed, mesh, prefix):
    """One epoch of ``train_model(mesh=, shard_corpus=True)`` into a model
    file and a resume file under ``prefix`` (the primary writes)."""
    desc, cfg = shard_cfg(sizes, seed)
    sync(device)
    t0 = time.perf_counter()
    result = trainer.train_model(
        desc, cfg, corpus, device, output_prefix=prefix, mesh=mesh, on_device_sampling=True,
        shard_corpus=True, steps_per_call=sizes["steps_per_call"])
    sync(device)
    return result, time.perf_counter() - t0


def play_data_groups(sizes, corpus, device, seed, n_data):
    """One device in the place of the mesh's data groups: their shards,
    generators and shuffles played in turn, their rows concatenated into
    the global batch of the single-device step, seeded as the trainer
    seeds an epoch.  Returns (params, the steps' costs)."""
    desc, cfg = shard_cfg(sizes, seed)
    generator = torch.Generator(device=device).manual_seed(seed)
    params = init_params(generator, sizes["num_words"], corpus.num_docs, desc, device=device)
    state = Optimizer(cfg).init(params)
    shards = [device_sampler.prepare_sharded_device_corpus(corpus, pmesh.Mesh(n_data, 1, rank=g), device)
              for g in range(n_data)]
    permuters = [device_sampler.make_sharded_epoch_permuter(sdc) for sdc in shards]
    batch, k = cfg.batch_size, sizes["steps_per_call"]
    source = TextEntitySource(corpus, batch_size=batch, seed=seed)
    steps_epoch = max(min(source.batches_per_epoch(), permuters[0][1] // batch), 1)
    k = min(k, steps_epoch)
    calls = [k] * (steps_epoch // k) + ([steps_epoch % k] if steps_epoch % k else [])
    step = make_train_step(desc, cfg, device, generator, num_entities=corpus.num_docs)
    group_gens = [torch.Generator(device=device) for _ in range(n_data)]
    generator.manual_seed(trainer.derived_seed(seed, trainer.PERMUTATION_STREAM, 1))
    perms = [permute(generator) for permute, _ in permuters]
    cursor, total, costs = 0, 0, []
    for n in calls:
        generator.manual_seed(trainer.derived_seed(seed, trainer.STEP_STREAM, total))
        for g, gen in enumerate(group_gens):
            gen.manual_seed(device_sampler.derived_seed(
                generator.initial_seed(), device_sampler.GROUP_STREAM, g))
        for i in range(n):
            parts = [device_sampler.sample_sharded_batch(
                shards[g], batch // n_data, perms[g], cursor // n_data + i * (batch // n_data),
                group_gens[g]) for g in range(n_data)]
            costs.append(step(params, state, TextEntityBatch(
                *(torch.cat(field) for field in list(zip(*parts))[:4]))))
        cursor += n * batch
        total += n
    return params, torch.stack(costs).cpu().numpy()


def rank_main(args) -> int:
    """One rank of the mesh run (see the module doc)."""
    with open(args.sizes) as f:
        sizes = json.load(f)
    device = torch.device(args.device)
    distributed.initialize(
        f"file://{args.rendezvous}", args.world, args.rank, backend=args.backend,
        device=device, timeout=GROUP_TIMEOUT_SECONDS,
    )
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    mesh = pmesh.make_mesh(*pmesh.parse_mesh_shape(args.mesh))
    corpus = Corpus.load(args.corpus)
    costs, params, seconds, launches = two_calls(sizes, corpus, device, args.seed, mesh)
    collectives = distributed.collective_log()
    k = sizes["steps_per_call"]
    full = pmesh.fetch_params(mesh, params, sizes["num_entities"])
    report = dict(
        rank=args.rank, ms_per_step=1e3 * seconds / k, launches=launches, steps=k,
        shard_rows=int(params.entity_reprs.shape[0]), collectives=collectives,
        peak_mem_gib=(torch.cuda.max_memory_allocated(device) / 2**30
                      if device.type == "cuda" else None),
    )
    # The same two calls with the word reduce narrowed to bfloat16.
    _, narrow, narrow_s, _ = two_calls(sizes, corpus, device, args.seed, mesh, "auto")
    report["bfloat16_reduce"] = dict(
        ms_per_step=1e3 * narrow_s / k,
        word_partial=distributed.collective_log()["word_partial"],
        max_abs_diff_words=float((narrow.word_reprs - params.word_reprs).abs().max()),
    )
    del narrow
    # And with float32 streams, where the floors are held outright.
    exact_costs, exact, _, _ = two_calls(sizes, corpus, device, args.seed, mesh,
                                         stream_dtype="float32")
    exact = pmesh.fetch_params(mesh, exact, sizes["num_entities"])
    report["padded"] = padded_step(sizes, device, args.seed, mesh)
    distributed.reset_collective_log()
    reset_launches()
    prefix = os.path.join(args.out, "shard")
    sharded, sharded_s = sharded_corpus_epoch(
        sizes, Corpus.load(args.short_corpus), device, args.seed, mesh, prefix)
    report["sharded_corpus"] = dict(
        steps=sharded.steps, epoch_cost=sharded.epoch_costs[0], launches=launch_counts(),
        epoch_s=sharded_s, collectives=distributed.collective_log(),
        wrote=sorted(f for f in os.listdir(args.out) if f.startswith("shard_"))
        if distributed.is_primary() else None,
    )
    sharded = pmesh.fetch_params(mesh, sharded.params, sizes["num_entities"])
    served = serve(full, corpus, sizes, args.seed, device, mesh)
    report["rank_ms"] = {name: ms for name, (_, ms) in served.items()}
    if distributed.is_primary():
        np.savez(os.path.join(args.out, "mesh_result.npz"), costs=costs,
                 **{name: t.cpu().numpy() for name, t in zip(full._fields, full)})
        np.savez(os.path.join(args.out, "mesh_float32_streams.npz"), costs=exact_costs,
                 **{name: t.cpu().numpy() for name, t in zip(exact._fields, exact)})
        np.savez(os.path.join(args.out, "mesh_sharded_corpus.npz"),
                 costs=np.asarray(report["sharded_corpus"]["epoch_cost"]),
                 **{name: t.cpu().numpy() for name, t in zip(sharded._fields, sharded)})
        with open(os.path.join(args.out, "mesh_runs.json"), "w") as f:
            json.dump({name: run for name, (run, _) in served.items()}, f)
    with open(os.path.join(args.out, f"rank{args.rank}.json"), "w") as f:
        json.dump(report, f)
    distributed.shutdown()
    log(f"RANK-OK {args.rank}")
    return 0


def build_kernels(device) -> None:
    """One small launch of each kernel, so that the ranks find them built."""
    if device.type != "cuda":
        return
    x = torch.ones((8, 4), device=device)
    cast.cast_table(x, torch.bfloat16)
    adam_sweep.fused_adam_dense_sweep(
        x.clone(), x.clone(), x.clone(), x.clone(), torch.ones((), device=device),
        lam=0.0, beta1=0.9, beta2=0.999, eps=1e-6)
    segment_kernels.segment_sum(
        8, (SparseGrad(x, torch.zeros((8, 1), dtype=torch.int64, device=device), None),))
    torch.cuda.synchronize(device)


def spawn_ranks(mesh_shape, backend, devices, corpus_path, short_corpus_path, sizes_path, out,
                seed, deadline=RANK_DEADLINE_SECONDS):
    data, model = pmesh.parse_mesh_shape(mesh_shape)
    world = data * model
    rendezvous = os.path.join(out, "rendezvous")
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r), "--world", str(world),
             "--mesh", mesh_shape, "--backend", backend, "--device", devices[r % len(devices)],
             "--rendezvous", rendezvous, "--corpus", corpus_path,
             "--short_corpus", short_corpus_path, "--sizes", sizes_path,
             "--out", out, "--seed", str(seed)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(world)
    ]
    outputs, end = [], time.monotonic() + deadline
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=max(end - time.monotonic(), 1))[0])
    except subprocess.TimeoutExpired:
        raise AssertionError(f"a rank of the {mesh_shape} run was still running after "
                             f"{deadline}s and was killed") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, outputs)):
        if p.returncode != 0 or f"RANK-OK {r}" not in text:
            raise AssertionError(f"rank {r} of the {mesh_shape} run failed:\n{text[-6000:]}")
    return world


def same_ranking(got, want, atol):
    """Scores within ``atol``; the same documents wherever the reference's
    neighbouring scores differ by more than twice that."""
    worst, checked, total = 0.0, 0, 0
    for qid, ranked in want.items():
        ref = np.asarray([s for _, s in ranked])
        have = np.asarray([s for _, s in got[qid]])
        worst = max(worst, float(np.abs(have - ref).max()))
        gaps = np.abs(np.diff(ref))
        distinct = np.ones(len(ref), bool)
        distinct[1:] &= gaps > 2 * atol
        distinct[:-1] &= gaps > 2 * atol
        for i in np.flatnonzero(distinct):
            if got[qid][i][0] != ranked[i][0]:
                raise AssertionError(f"query {qid}: rank {i} is {got[qid][i]}, expected {ranked[i]}")
        checked += int(distinct.sum())
        total += len(ref)
    if worst > atol:
        raise AssertionError(f"sharded scores differ by {worst} > {atol}")
    return worst, checked, total


def table_differences(tables, reference, atol=TABLE_ATOL) -> dict:
    """Per table: the largest and the root-mean-square difference, and the
    share of the entries that differ by more than ``atol``."""
    out = {}
    for name, a, b in zip(ModelParams._fields, tables, reference):
        d = (a.cpu().double() - b.cpu().double()).abs()
        out[name] = dict(max=float(d.max()), rms=float(d.square().mean().sqrt()),
                         share_over_atol=float((d > atol).double().mean()))
    return out


def held_to(path, ref_costs, ref_params, streams):
    """The mesh run saved at ``path`` against one device's costs and
    tables, at the ``LIMITS`` of its ``streams``.  Returns (costs, tables,
    the differences)."""
    with np.load(path) as got:
        costs = got["costs"]
        tables = ModelParams(*(torch.from_numpy(got[name]) for name in ModelParams._fields))
    if not (np.all(np.isfinite(costs)) and np.allclose(costs, ref_costs, rtol=COST_RTOL, atol=0)):
        raise AssertionError(f"{streams} streams: mesh costs {costs} differ from one "
                             f"device's {ref_costs}")
    diffs = table_differences(tables, ref_params)
    for name, d in diffs.items():
        if any(d[key] > limit for key, limit in LIMITS[streams].items()):
            raise AssertionError(f"{streams} streams, {name}: mesh against one device {d}, "
                                 f"limits {LIMITS[streams]}")
    return costs, tables, diffs


def run(mesh_shape, backend, devices, sizes, corpus, out, seed=0):
    """Phase H2: the mesh run in ``out`` (a directory), held to the
    single-device run on ``devices[0]``.  Returns the stats and rank 0's
    launches of the timed call; raises if a rank fails, hangs or disagrees."""
    device = torch.device(devices[0])
    on_card = device.type == "cuda"
    build_kernels(device)
    corpus_path = os.path.join(out, "corpus.npz")
    corpus.save(corpus_path)
    # The canonical documents cut to a few windows each: a short epoch.
    short = zipf_corpus(sizes["num_entities"], sizes["shard_doc_len"],
                        vocab_size=sizes["num_words"], window_size=sizes["window"], seed=4243)
    short_path = os.path.join(out, "short_corpus.npz")
    short.save(short_path)
    sizes_path = os.path.join(out, "sizes.json")
    with open(sizes_path, "w") as f:
        json.dump(sizes, f)
    t0 = time.perf_counter()
    world = spawn_ranks(mesh_shape, backend, devices, corpus_path, short_path, sizes_path, out,
                        seed)
    ranks_s = time.perf_counter() - t0
    reports = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            reports.append(json.load(f))
    data, model = pmesh.parse_mesh_shape(mesh_shape)
    k, n_ent = sizes["steps_per_call"], sizes["num_entities"]

    # Every rank launched the same kernels: 2 sweeps, 1 cast and 2 segment
    # sums per step, the entity sweep over its [N / model, d] shard.
    launches = reports[0]["launches"]
    for rep in reports:
        if rep["launches"] != launches:
            raise AssertionError(f"rank {rep['rank']} counted {rep['launches']}, rank 0 {launches}")
        if rep["shard_rows"] != pmesh.pad_entities(n_ent, model) // model:
            raise AssertionError(f"rank {rep['rank']} holds {rep['shard_rows']} entity rows")
    if on_card and launches != per_step_launches(k):
        raise AssertionError(f"{launches} launches for {k} steps, expected "
                             f"{per_step_launches(1)} each")
    for rep in reports:
        p = rep["padded"]
        if not (np.isfinite(p["cost"]) and p["padded_row_zero"] and p["fetched_rows"] == n_ent - 1
                and p["padded_rows"] == pmesh.pad_entities(n_ent - 1, model)):
            raise AssertionError(f"padded step on rank {rep['rank']}: {p}")

    # The same two calls on one device from the same seed.
    ref_costs, ref_params, ref_s, _ = two_calls(sizes, corpus, device, seed)
    costs, tables, diffs = held_to(
        os.path.join(out, "mesh_result.npz"), ref_costs, ref_params, "bfloat16")
    exact_costs, exact_params, _, _ = two_calls(sizes, corpus, device, seed,
                                                stream_dtype="float32")
    _, _, exact_diffs = held_to(
        os.path.join(out, "mesh_float32_streams.npz"), exact_costs, exact_params, "float32")
    del exact_params

    # The sharded corpus: one device plays the data groups; the model file
    # holds the fetched tables with the real rows, and one rank wrote it.
    sharded = reports[0]["sharded_corpus"]
    for rep in reports:
        got = rep["sharded_corpus"]
        if (got["steps"], got["launches"]) != (sharded["steps"], sharded["launches"]):
            raise AssertionError(f"sharded corpus, rank {rep['rank']}: {got}, rank 0 {sharded}")
    steps = sharded["steps"]
    if steps <= k or (on_card and sharded["launches"] != per_step_launches(steps)):
        raise AssertionError(f"sharded corpus: {steps} steps, launches {sharded['launches']}")
    if not {"shard_1.hdf5", "shard_meta", "shard_resume.npz"} <= set(sharded["wrote"]):
        raise AssertionError(f"sharded corpus: the primary wrote {sharded['wrote']}")
    played, played_costs = play_data_groups(sizes, short, device, seed, data)
    _, shard_tables, shard_diffs = held_to(
        os.path.join(out, "mesh_sharded_corpus.npz"), np.asarray(played_costs.mean()), played,
        "bfloat16")
    del played
    model_file = checkpoint.load_model_hdf5(os.path.join(out, "shard"), 1, torch.device("cpu"))
    for name, a, b in zip(ModelParams._fields, model_file, shard_tables):
        if not torch.equal(a, b):
            raise AssertionError(f"sharded corpus: {name} of the model file differs from the "
                                 f"fetched table ({tuple(a.shape)} and {tuple(b.shape)})")
    with np.load(os.path.join(out, "shard_resume.npz")) as resume:
        if int(resume["extra_total_batches"]) != steps:
            raise AssertionError("sharded corpus: the resume file counts other steps")

    # Serving: the single-device engine on the tables the mesh fetched.
    with open(os.path.join(out, "mesh_runs.json")) as f:
        mesh_runs = json.load(f)
    single = serve(ModelParams(*(t.to(device) for t in tables)), corpus, sizes, seed, device)
    serving = {}
    for name, (want, ms) in single.items():
        got = {q: [tuple(x) for x in r] for q, r in mesh_runs[name].items()}
        if got.keys() != want.keys() or any(len(r) != min(sizes["top_k"], n_ent) for r in got.values()):
            raise AssertionError(f"sharded {name} run has the wrong shape")
        worst, checked, total = same_ranking(got, want, SCORE_ATOL)
        serving[name] = dict(
            sharded_rank_ms=reports[0]["rank_ms"][name], single_rank_ms=ms,
            max_score_diff=worst, documents_checked=checked, documents=total)

    # The bfloat16 reduce moves the tables by its rounding, which Adam's
    # normalization turns into a share of the steps taken: bounded here by
    # the most 2K steps can move a weight.
    narrow = reports[0]["bfloat16_reduce"]
    if not narrow["max_abs_diff_words"] <= 2 * 1e-3 * 2 * k:
        raise AssertionError(f"bfloat16 word reduce moved the word table by {narrow}")
    if narrow["word_partial"]["bytes"] * 2 != reports[0]["collectives"]["word_partial"]["bytes"]:
        raise AssertionError(f"the bfloat16 word reduce did not halve the bytes: {narrow}")

    stats = dict(
        mesh=mesh_shape, backend=backend, devices=devices, steps_per_call=k,
        ms_per_step=[rep["ms_per_step"] for rep in reports],
        single_device_ms_per_step=1e3 * ref_s / k,
        ranks_wall_s=ranks_s, peak_mem_gib=[rep["peak_mem_gib"] for rep in reports],
        first_cost=float(costs[0]), last_cost=float(costs[-1]), cost_rtol=COST_RTOL,
        max_cost_rel_diff=float(np.abs(costs / ref_costs - 1).max()),
        differences=diffs, differences_float32_streams=exact_diffs, limits=LIMITS,
        table_atol=TABLE_ATOL, shard_rows=reports[0]["shard_rows"],
        padded=reports[0]["padded"], serving=serving, score_atol=SCORE_ATOL,
        collectives_timed_call=reports[0]["collectives"], bfloat16_reduce=narrow,
        sharded_corpus=dict(
            steps=steps, doc_len=sizes["shard_doc_len"], epoch_cost=sharded["epoch_cost"],
            played_groups_cost=float(played_costs.mean()), differences=shard_diffs,
            epoch_s=[rep["sharded_corpus"]["epoch_s"] for rep in reports],
            collectives=sharded["collectives"], wrote=sharded["wrote"]),
    )
    return stats, launches


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return "; ".join(out.stdout.strip().splitlines())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mesh", default="2x2")
    p.add_argument("--backend", required=True, choices=("nccl", "gloo"))
    p.add_argument("--devices", default=None,
                   help="comma-separated devices, taken in turn by the ranks "
                        "(default: cuda:<rank> for nccl, cuda:0 for gloo)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sizes", default=None, help="JSON file of sizes (default: canonical)")
    # The flags of one rank, set by the parent.
    p.add_argument("--rank", type=int, default=None)
    p.add_argument("--world", type=int, default=None)
    p.add_argument("--device", default=None)
    p.add_argument("--rendezvous", default=None)
    p.add_argument("--corpus", default=None)
    p.add_argument("--short_corpus", default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if args.rank is not None:
        return rank_main(args)

    data, model = pmesh.parse_mesh_shape(args.mesh)
    if args.devices:
        devices = args.devices.split(",")
    elif args.backend == "nccl":
        devices = [f"cuda:{r}" for r in range(data * model)]
    else:
        devices = ["cuda:0"]
    if any(d.startswith("cuda") for d in devices):
        if not torch.cuda.is_available():
            raise SystemExit("mesh_phase_torch.py: no CUDA device")
        if args.backend == "nccl" and torch.cuda.device_count() < len(set(devices)):
            raise SystemExit(f"--backend nccl needs {len(set(devices))} cards, "
                             f"this machine has {torch.cuda.device_count()}")
        log(f"nvidia-smi: {gpu_name_and_power()}")
    sizes = dict(CANONICAL)
    if args.sizes:
        with open(args.sizes) as f:
            sizes.update(json.load(f))
    corpus = zipf_corpus(sizes["num_entities"], sizes["doc_len"], vocab_size=sizes["num_words"],
                         window_size=sizes["window"], seed=4242)
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="mesh_phase_", dir=build) as out:
        stats, launches = run(args.mesh, args.backend, devices, sizes, corpus, out, args.seed)
    log("H2 " + json.dumps(stats))
    log(f"H2 launches per rank: {launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
