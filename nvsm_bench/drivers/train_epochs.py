"""Training traffic: ``train_model`` with on-device sampling over the
configuration's synthetic collection, measured in whole epochs.

Set-up makes the collection's tokens from the seed, hands them to the
port's ``corpus_from_tokens`` and calls ``train_model`` with the mix's
``steps_per_call``, no output prefix (no files) and more epochs than any
window holds.  Epoch 1 is the warm-up: its callback snapshots the tables,
takes the window's start and, with ``--trace 1``, starts the profiler for
epoch 2.  Each later callback marks an epoch's end; the first after
``--seconds`` closes the window by raising an exception of this module,
which ``train_model`` lets through.  The trainer reads the epoch's cost
before its callback, so the device's work of the epoch has ended at each
mark.

``correct``: the plain reference (``reference/train.py``) trains the first
two epochs from the same seed and the same draws.  The program's cost of
each and the change of each of its tables over each are held to it: epoch
1, the warm-up, and epoch 2, the window's first epoch, whose tables the
callback copies on the device.  Every epoch of the window must end with a
finite cost and with every table moved: the callback takes each table's
norm on the device at every epoch's end, and a norm equal to the one an
epoch before is a fault.
"""

from __future__ import annotations

import gc
import math
import statistics
import time

import torch

from nvsm_bench import yardstick
from nvsm_bench.harness import Record, log
from nvsm_bench.reference import train as ref
from nvsm_bench.synth import program_seed, zipf_tokens


class WindowClosed(Exception):
    """Raised from the epoch callback to end ``train_model``."""


def build(config: dict, seed: int):
    """(ModelDesc, TrainConfig) of the configuration, seeded with ``seed``."""
    from cunvsm_torch.config import (
        UPDATE_METHOD_NAMES, AdamConfig, ModelDesc, Nonlinearity, TrainConfig,
    )

    m, t = config["model"], config["train"]
    method, mode = UPDATE_METHOD_NAMES[t["update_method"]]
    desc = ModelDesc(
        word_repr_size=m["word_repr_size"], entity_repr_size=m["entity_repr_size"],
        nonlinearity=Nonlinearity(m["nonlinearity"]),
        batch_normalization=m["batch_normalization"],
        bias_negative_samples=m["bias_negative_samples"],
    )
    extra = {"adam": AdamConfig(mode=mode)} if mode is not None else {}
    cfg = TrainConfig(
        num_epochs=1_000_000, batch_size=t["batch_size"], window_size=t["window_size"],
        num_random_entities=t["num_random_entities"],
        regularization_lambda=t["regularization_lambda"],
        learning_rate=t["learning_rate"], update_method=method,
        stream_dtype=t["stream_dtype"],
        window_sum_dtype=t.get("window_sum_dtype"),
        negative_pool_size=t["negative_pool_size"], seed=seed, **extra,
    )
    return desc, cfg


def collection(config: dict, seed: int, device):
    """The tokens ([docs * doc_len] int32, host) and the port's Corpus."""
    from cunvsm_torch.data.synth import corpus_from_tokens

    c, t = config["collection"], config["train"]
    tokens = zipf_tokens(seed, c["num_docs"] * c["doc_len"], c["vocab_size"],
                         c["zipf_exponent"], device)
    corpus = corpus_from_tokens(tokens, c["num_docs"], c["doc_len"], c["vocab_size"],
                                window_size=t["window_size"])
    return tokens, corpus


def train_window(ctx):
    """Run ``train_model`` through the warm-up and the window; returns the
    marks, every epoch's cost, the tables after epochs 1 and 2 (host
    copies), the tables' norms after every epoch, the profiled summary and
    the peak device memory."""
    from cunvsm_torch.train.trainer import train_model

    seed = program_seed(ctx.seed)
    log(f"set-up: imports done at {time.perf_counter() - ctx.start:.3f} s")
    tokens, corpus = collection(ctx.config, ctx.seed, ctx.device)
    log(f"set-up: collection made at {time.perf_counter() - ctx.start:.3f} s")
    desc, cfg = build(ctx.config, seed)
    spec = ref.Spec.from_config(ctx.config)
    steps_epoch = spec.steps_per_epoch()
    state = {"marks": [], "profiler": None, "costs": [], "norms": []}
    sync = torch.cuda.synchronize if ctx.device.type == "cuda" else (lambda: None)

    def norms(params):
        return torch.stack([torch.linalg.vector_norm(getattr(params, n).detach())
                            for n in ref.LEAVES])

    def callback(epoch, params, cost):
        state["costs"].append(cost)
        if epoch == 1:
            log(f"set-up: warm-up epoch ended at {time.perf_counter() - ctx.start:.3f} s")
            state["after1"] = {n: getattr(params, n).detach().to("cpu", copy=True)
                               for n in ref.LEAVES}
            state["norms"].append(norms(params))
            if ctx.trace:
                state["profiler"] = _start_profiler(ctx.device)
            sync()
            state["marks"].append(time.perf_counter())
            return
        now = time.perf_counter()
        state["marks"].append(now)
        if epoch == 2:
            if state["profiler"] is not None:
                state["profiler"].stop()
                state["traced_wall"] = now - state["marks"][0]
            state["after2"] = {n: getattr(params, n).detach().clone() for n in ref.LEAVES}
        state["norms"].append(norms(params))
        if epoch == 2 and state["profiler"] is not None:
            # The untraced part of the window starts once the profiler has
            # stopped.
            state["resume"] = time.perf_counter()
        if now - state["marks"][0] >= ctx.seconds:
            raise WindowClosed()

    _log_epoch_starts(ctx)
    try:
        train_model(desc, cfg, corpus, ctx.device, epoch_callback=callback,
                    on_device_sampling=True, steps_per_call=ctx.mix["steps_per_call"])
    except WindowClosed:
        pass
    peak = torch.cuda.max_memory_allocated() if ctx.device.type == "cuda" else 0
    trace = None
    if state["profiler"] is not None:
        trace = yardstick.TraceSummary.from_profiler(
            state["profiler"], state["traced_wall"], steps_epoch)
    after2 = {n: t.to("cpu") for n, t in state["after2"].items()}
    return dict(tokens=tokens, seed=seed, spec=spec, steps_epoch=steps_epoch,
                marks=state["marks"], resume=state.get("resume"), costs=state["costs"],
                after=[state["after1"], after2], norms=torch.stack(state["norms"]).cpu(),
                trace=trace, peak=peak)


def _log_epoch_starts(ctx):
    """Show the trainer's own log lines (the negative layout, each epoch's
    seconds) on standard error, timed from the process's start."""
    import logging

    class Since(logging.Formatter):
        def format(self, record):
            return f"trainer: [{record.created - wall_start:.3f} s] {record.getMessage()}"

    wall_start = time.time() - (time.perf_counter() - ctx.start)
    trainer = logging.getLogger("cunvsm_torch.train.trainer")
    if not trainer.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(Since())
        trainer.addHandler(handler)
        trainer.setLevel(logging.INFO)


def _start_profiler(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    prof = profile(activities=acts)
    prof.start()
    return prof


def readings(costs, after, followed: "ref.Followed"):
    """The numbers compared with the reference, for each epoch e that the
    reference followed, and what else is printed.

    ``loss_gap_e<e>``: |the program's cost of epoch e - the reference's|
    over the reference's.  ``change_gap_e<e>``: over the leaves whose first
    reference gradient is not nought to rounding (norm at least a thousandth
    of the median leaf's), the widest gap between the norm of the program's
    change of a leaf over epoch e and the reference's, over the larger of
    the reference's change of that leaf and of the median leaf.
    ``diff_gap_e<e>``: over the same leaves, the widest norm of the
    difference between the program's leaf after epoch e and the
    reference's, over the same denominator: where the change gap compares
    lengths, this one sees directions."""
    med_grad = statistics.median(followed.first_grad_norms.values())
    leaves = [n for n in ref.LEAVES if followed.first_grad_norms[n] >= 1e-3 * med_grad]
    values, info = {}, dict(left_out=[n for n in ref.LEAVES if n not in leaves])
    ref_before = prog_before = followed.init
    for e, (ref_after, prog_after) in enumerate(zip(followed.after, after), start=1):
        ref_cost = statistics.fmean(followed.costs[e - 1])
        ref_change, prog_change, diff = {}, {}, {}
        for n in ref.LEAVES:
            r0, r1 = ref_before[n].double(), ref_after[n].double()
            p0 = prog_before[n].to(r0.device).double()
            p1 = prog_after[n].to(r0.device).double()
            ref_change[n] = float(torch.linalg.vector_norm(r1 - r0))
            prog_change[n] = float(torch.linalg.vector_norm(p1 - p0))
            diff[n] = float(torch.linalg.vector_norm(p1 - r1))
        med = statistics.median(ref_change[n] for n in leaves)
        scale = {n: max(ref_change[n], med) for n in leaves}
        values[f"loss_gap_e{e}"] = abs(costs[e - 1] - ref_cost) / abs(ref_cost)
        values[f"change_gap_e{e}"] = max(abs(prog_change[n] - ref_change[n]) / scale[n]
                                         for n in leaves)
        values[f"diff_gap_e{e}"] = max(diff[n] / scale[n] for n in leaves)
        info[f"epoch{e}"] = dict(program_cost=costs[e - 1], reference_cost=ref_cost,
                                 change_ref=ref_change, change_program=prog_change,
                                 diff=diff)
        ref_before, prog_before = ref_after, prog_after
    return values, info


def window_faults(costs, norms) -> list:
    """Faults of the window's epochs: a cost that is not finite, or a table
    whose norm after an epoch equals its norm an epoch before (it did not
    move).  ``norms`` [epochs, leaves], from epoch 1 on."""
    faults = [f"epoch {e}: cost {c!r}" for e, c in enumerate(costs, start=1)
              if not math.isfinite(c)]
    for e in range(1, norms.shape[0]):
        for i, n in enumerate(ref.LEAVES):
            if not bool(torch.isfinite(norms[e, i])) or bool(norms[e, i] == norms[e - 1, i]):
                faults.append(f"epoch {e + 1}: {n} did not move (norm {float(norms[e, i])!r})")
    return faults


def run(ctx) -> Record:
    got = train_window(ctx)
    marks, steps_epoch, batch = got["marks"], got["steps_epoch"], got["spec"].batch
    epochs = len(marks) - 1
    wall = marks[-1] - marks[0]
    setup_s = marks[0] - ctx.start
    log(f"set-up {setup_s:.3f} s; {epochs} epochs of {steps_epoch} steps in {wall:.3f} s; "
        f"epoch s {[round(b - a, 4) for a, b in zip(marks, marks[1:])]}")
    # The untraced window: the epochs after the profiled one, from the
    # profiler's stop (every epoch of a run without it).
    if not ctx.trace:
        untraced_units, untraced_s = steps_epoch * epochs, wall
    elif epochs >= 2:
        untraced_units, untraced_s = steps_epoch * (epochs - 1), marks[-1] - got["resume"]
    else:
        untraced_units, untraced_s = None, None
    facts = dict(steps_epoch=steps_epoch, epochs=epochs, marks=marks,
                 unit_flops=ctx.work.train_step_flops(ctx.config),
                 untraced_units=untraced_units, untraced_s=untraced_s)
    faults = window_faults(got["costs"], got["norms"])
    # The judge runs once the window's state is gone: a process's peak
    # never falls, so it is read first.
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    followed = ref.follow(got["tokens"], got["seed"], got["spec"], ctx.mix["steps_per_call"],
                          ctx.device, epochs=len(got["after"]))
    values, info = readings(got["costs"], got["after"], followed)
    log(f"reference: {sum(map(len, followed.costs))} steps in "
        f"{time.perf_counter() - t0:.3f} s; {info}; all readings {values}")
    limits = ctx.checks["limits"]
    checks = [(n, values[n], limits[n]) for n in limits]
    e2e = {"setup_s": setup_s, "train_pairs_per_s": batch * steps_epoch * epochs / wall}
    return Record(end_to_end=e2e, attempted=steps_epoch * epochs, failed=0,
                  memory_peak_bytes=got["peak"], checks=checks, faults=faults,
                  trace=got["trace"], facts=facts)
