"""Mix 'n Match training traffic: ``train_model`` of a composite objective
(the text of the configuration's synthetic collection and a graph of
substitute pairs) with both streams sampled on the device, measured in whole
epochs as ``train_epochs`` measures the text-only cells.

Set-up makes the collection's tokens and the substitute pairs from the seed
on the card, hands the tokens to ``corpus_from_tokens`` and the pairs to a
``SimilaritySource``, and calls ``train_model(..., similarity_source=...,
on_device_sampling=True)`` with the mix's ``steps_per_call``.  The window,
its marks, the profiled epoch and the faults are ``train_epochs``'s.
``train_pairs_per_s`` counts the text instances: B × steps over the
window's wall.

``correct``: the plain reference (``reference/train_mix.py``) trains the
first two epochs from the same seed, on the same text draws and the same
pair stream, and the program's cost and tables after each are held to it
by ``train_epochs.readings`` (``*_e1``, ``*_e2``).  After the window the
program trains its first call of K steps afresh (``first_call``), which
the reference follows too (``*_c1``): over 116 steps Adam amplifies every
rounding to a floor that float32 and bfloat16 streams nearly share, and
after K steps it has not yet.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from nvsm_bench import yardstick
from nvsm_bench.drivers import train_epochs as base
from nvsm_bench.harness import Record, log
from nvsm_bench.reference import train as ref
from nvsm_bench.reference import train_mix as ref_mix
from nvsm_bench.synth import program_seed, zipf_cdf

PAIR_SEED_STREAM = 0x50A1  # the pairs' seed, apart from the tokens'


def build(config: dict, seed: int):
    """(ModelDesc, TrainConfig) of the composite configuration."""
    desc, cfg = base.build(config, seed)
    t = config["train"]
    return desc, dataclasses.replace(cfg, text_entity_weight=t["text_entity_weight"],
                                     entity_entity_weight=t["entity_entity_weight"])


def substitute_pairs(config: dict, seed: int, device):
    """(ids [n, 2] int32, weights [n] float32), host arrays drawn on
    ``device`` from ``seed``: both endpoints of each pair by a Zipf law over
    the product ranks (id = rank), the second redrawn uniformly among the
    other products where it equals the first; every weight 1."""
    s, n = config["similarity"], config["collection"]["num_docs"]
    gen = torch.Generator(device=device).manual_seed(
        int(np.random.SeedSequence([seed, PAIR_SEED_STREAM]).generate_state(1, np.uint64)[0]
            >> np.uint64(1)))
    cdf = torch.as_tensor(zipf_cdf(n, s["zipf_exponent"]), device=device)
    u = torch.rand((s["num_pairs"], 2), generator=gen, dtype=torch.float64, device=device)
    ids = torch.searchsorted(cdf, u).clamp_(max=n - 1)
    shift = torch.randint(1, n, (s["num_pairs"],), generator=gen, device=device)
    same = ids[:, 0] == ids[:, 1]
    ids[:, 1] = torch.where(same, (ids[:, 0] + shift) % n, ids[:, 1])
    weights = torch.full((s["num_pairs"],), s["weight"], dtype=torch.float32, device=device)
    return ids.to(torch.int32).cpu().numpy(), weights.cpu().numpy()


def train_window(ctx):
    """``train_epochs.train_window`` for the composite: also the pairs."""
    from cunvsm_torch.data.sources import SimilaritySource
    from cunvsm_torch.train.trainer import train_model

    seed = program_seed(ctx.seed)
    log(f"set-up: imports done at {time.perf_counter() - ctx.start:.3f} s")
    tokens, corpus = base.collection(ctx.config, ctx.seed, ctx.device)
    pair_ids, pair_weights = substitute_pairs(ctx.config, ctx.seed, ctx.device)
    log(f"set-up: collection and {len(pair_ids)} pairs made at "
        f"{time.perf_counter() - ctx.start:.3f} s")
    desc, cfg = build(ctx.config, seed)
    source = SimilaritySource(pair_ids, pair_weights, cfg.batch_size, seed=seed)
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
                state["profiler"] = base._start_profiler(ctx.device)
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
            state["resume"] = time.perf_counter()
        if now - state["marks"][0] >= ctx.seconds:
            raise base.WindowClosed()

    base._log_epoch_starts(ctx)
    try:
        train_model(desc, cfg, corpus, ctx.device, epoch_callback=callback,
                    similarity_source=source, on_device_sampling=True,
                    steps_per_call=ctx.mix["steps_per_call"])
    except base.WindowClosed:
        pass
    peak = torch.cuda.max_memory_allocated() if ctx.device.type == "cuda" else 0
    trace = None
    if state["profiler"] is not None:
        trace = yardstick.TraceSummary.from_profiler(
            state["profiler"], state["traced_wall"], steps_epoch)
    after2 = {n: t.to("cpu") for n, t in state["after2"].items()}
    return dict(tokens=tokens, pairs=(pair_ids, pair_weights), seed=seed, spec=spec,
                corpus=corpus, source=source, model=(desc, cfg),
                weights=(cfg.text_entity_weight, cfg.entity_entity_weight),
                steps_epoch=steps_epoch, marks=state["marks"], resume=state.get("resume"),
                costs=state["costs"], after=[state["after1"], after2],
                norms=torch.stack(state["norms"]).cpu(), trace=trace, peak=peak)


def first_call(ctx, got):
    """(step costs [K] float64, tables) on the host: the program's first
    call of the run ``got`` trained again from the start, as
    ``train_model``'s on-device path trains it (the tables from the
    generator seeded with the seed, the epoch's shuffle after a reseed from
    (seed, ``PERMUTATION_STREAM``, 1), the call's draws after one from
    (seed, ``STEP_STREAM``, 0), the pair stream from step 0)."""
    from cunvsm_torch.data import device_sampler as ds
    from cunvsm_torch.models.params import init_params
    from cunvsm_torch.optim.updates import Optimizer
    from cunvsm_torch.train import trainer

    corpus, (desc, cfg), device = got["corpus"], got["model"], ctx.device
    cfg = dataclasses.replace(cfg, uniform_feature_weights=True)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    params = init_params(gen, corpus.vocab.size, corpus.num_docs, desc, device=device)
    opt_state = Optimizer(cfg).init(params)
    dc = ds.prepare_device_corpus(corpus, device)
    permute, _ = ds.make_epoch_permuter(dc)
    pairs = ds.DevicePairStream.from_source(got["source"], cfg.seed, device)
    run = ds.make_device_sampled_multistep(desc, cfg, dc, ctx.mix["steps_per_call"], gen,
                                           num_entities=corpus.num_docs, pairs=pairs)
    gen.manual_seed(ds.derived_seed(cfg.seed, trainer.PERMUTATION_STREAM, 1))
    doc_perm = permute(gen)
    gen.manual_seed(ds.derived_seed(cfg.seed, trainer.STEP_STREAM, 0))
    costs = run(params, opt_state, doc_perm, 0).double().cpu()
    return costs, {n: getattr(params, n).detach().cpu() for n in ref.LEAVES}


def follow(ctx, got, first: bool = False, **kw) -> "ref.Followed":
    """The reference's first two epochs of the run ``got``, or with
    ``first`` its first call; ``kw`` are ``train_mix.follow``'s faults and
    ``spec`` another precision."""
    spec = kw.pop("spec", got["spec"])
    k = ctx.mix["steps_per_call"]
    return ref_mix.follow(got["tokens"], *got["pairs"], got["seed"], spec, got["weights"],
                          k, ctx.device, 1 if first else len(got["after"]),
                          steps=k if first else None, **kw)


def readings(costs, after, call, followed, followed_call):
    """``train_epochs.readings`` of the epochs (``*_e<e>``) and of the
    first call (``*_c1``): ``call`` is (step costs, tables) of the program's
    first call, ``followed_call`` the reference's."""
    values, info = base.readings(costs, after, followed)
    at_call, _ = base.readings([float(call[0].mean())], [call[1]], followed_call)
    values.update({n.replace("_e1", "_c1"): v for n, v in at_call.items()})
    return values, info


def run(ctx) -> Record:
    got = train_window(ctx)
    marks, steps_epoch, batch = got["marks"], got["steps_epoch"], got["spec"].batch
    epochs = len(marks) - 1
    wall = marks[-1] - marks[0]
    setup_s = marks[0] - ctx.start
    log(f"set-up {setup_s:.3f} s; {epochs} epochs of {steps_epoch} steps in {wall:.3f} s; "
        f"epoch s {[round(b - a, 4) for a, b in zip(marks, marks[1:])]}")
    if not ctx.trace:
        untraced_units, untraced_s = steps_epoch * epochs, wall
    elif epochs >= 2:
        untraced_units, untraced_s = steps_epoch * (epochs - 1), marks[-1] - got["resume"]
    else:
        untraced_units, untraced_s = None, None
    facts = dict(steps_epoch=steps_epoch, epochs=epochs, marks=marks,
                 unit_flops=ctx.work.train_step_flops(ctx.config),
                 untraced_units=untraced_units, untraced_s=untraced_s)
    faults = base.window_faults(got["costs"], got["norms"])
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    followed = follow(ctx, got)
    call = first_call(ctx, got)
    values, info = readings(got["costs"], got["after"], call, followed,
                            follow(ctx, got, first=True))
    log(f"reference: {sum(map(len, followed.costs))} steps in "
        f"{time.perf_counter() - t0:.3f} s; {info}; all readings {values}")
    limits = ctx.checks["limits"]
    checks = [(n, values[n], limits[n]) for n in limits]
    e2e = {"setup_s": setup_s, "train_pairs_per_s": batch * steps_epoch * epochs / wall}
    return Record(end_to_end=e2e, attempted=steps_epoch * epochs, failed=0,
                  memory_peak_bytes=got["peak"], checks=checks, faults=faults,
                  trace=got["trace"], facts=facts)
