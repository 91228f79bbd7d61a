"""One rank of the PyTorch port's multi-process tests (gloo, CPU, float64).

``tests/test_torch_parallel.py`` and ``tests/test_torch_sharded_corpus.py``
write a pickled list of scenarios, spawn one process of this module per
rank of a mesh, and compare the ``.npz`` files the ranks write.  Every
scenario is a dict with a ``name``, a ``run`` (the function of ``RUNNERS``
to call) and that function's inputs, all numpy, torch-free and jax-free:
this module imports torch, numpy and the port only.

    python tests/_torch_distributed_worker.py --rank 0 --world 4 --mesh 2x2 \\
        --rendezvous /tmp/x/rdv --spec /tmp/x/spec.pkl --outdir /tmp/x

Each rank writes ``<outdir>/<name>_rank<r>.npz`` per scenario, and prints
``WORKER-OK`` at the end.
"""

import argparse
import json
import os
import pickle
import sys

import numpy as np
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

from cunvsm_torch.io import checkpoint as ckpt  # noqa: E402
from cunvsm_torch.models import objectives as obj  # noqa: E402
from cunvsm_torch.models.params import params_from_numpy  # noqa: E402
from cunvsm_torch.optim.updates import opt_state_from_numpy  # noqa: E402
from cunvsm_torch.parallel import distributed, mesh as pmesh  # noqa: E402
from cunvsm_torch.parallel.query import make_sharded_scorer  # noqa: E402
from cunvsm_torch.query.engine import QueryEngine  # noqa: E402
from cunvsm_torch.train import gradcheck  # noqa: E402
from cunvsm_torch.train.step import ObjectiveKind  # noqa: E402
from cunvsm_torch.train.trainer import train_model  # noqa: E402

GROUP_TIMEOUT_SECONDS = 120.0


def _float(sc):
    return getattr(torch, sc.get("dtype", "float64"))


def text_batch(arrays, dtype=torch.float64) -> obj.TextEntityBatch:
    return obj.TextEntityBatch(
        features=torch.from_numpy(arrays["features"]).long(),
        feature_weights=torch.from_numpy(arrays["feature_weights"]).to(dtype),
        labels=torch.from_numpy(arrays["labels"]).long(),
        weights=torch.from_numpy(arrays["weights"]).to(dtype),
    )


def similarity_batch(arrays, dtype=torch.float64) -> obj.SimilarityBatch:
    return obj.SimilarityBatch(
        ids=torch.from_numpy(arrays["ids"]).long(),
        weights=torch.from_numpy(arrays["sim_weights"]).to(dtype),
    )


def port_batch(arrays, kind, dtype=torch.float64):
    """The port's batch of ``kind`` from a dict of arrays."""
    if kind in (ObjectiveKind.ENTITY_ENTITY, ObjectiveKind.TERM_TERM):
        return similarity_batch(arrays, dtype)
    if kind in (None, ObjectiveKind.TEXT_ENTITY):
        return text_batch(arrays, dtype)
    return (text_batch(arrays, dtype), similarity_batch(arrays, dtype))


def state_arrays(prefix, params, opt_state):
    out = {f"{prefix}{name}": t.detach().cpu().numpy() for name, t in zip(params._fields, params)}
    for part, state in zip(opt_state._fields, opt_state):
        for name, t in zip(state._fields, state):
            out[f"{prefix}state_{part}_{name}"] = t.detach().cpu().numpy()
    return out


def run_steps(sc, mesh, outdir):
    """Host-fed steps of ``make_sharded_train_step`` (or, with ``multistep``,
    one call of ``make_sharded_multistep``) on injected draws."""
    kind = None if sc["kind"] is None else ObjectiveKind(sc["kind"])
    params = params_from_numpy(sc["params"])
    state = opt_state_from_numpy(sc["state"])
    num_entities = sc["num_entities"]
    batches = [port_batch(b, kind, _float(sc)) for b in sc["batches"]]
    ids = [None if i is None else torch.from_numpy(i).long() for i in sc["negative_ids"]]
    distributed.reset_collective_log()
    if sc.get("multistep"):
        run, params, state = pmesh.make_sharded_multistep(
            sc["desc"], sc["cfg"], mesh, params, state, "cpu", None, len(batches),
            kind=kind, num_entities=num_entities,
        )

        def stack(items):
            if isinstance(items[0], tuple) and not hasattr(items[0], "_fields"):
                return tuple(stack([it[j] for it in items]) for j in range(len(items[0])))
            return type(items[0])(*(
                None if leaves[0] is None else torch.stack(leaves) for leaves in zip(*items)
            ))

        costs = run(params, state, stack(batches), ids).tolist()
    else:
        step, params, state = pmesh.make_sharded_train_step(
            sc["desc"], sc["cfg"], mesh, params, state, "cpu", None,
            kind=kind, num_entities=num_entities,
        )
        costs = [float(step(params, state, b, negative_ids=i)) for b, i in zip(batches, ids)]
    log = distributed.collective_log()
    shard_rows = params.entity_reprs.shape[0]
    full = pmesh.fetch_params(mesh, params)
    full_state = pmesh.fetch_opt_state(mesh, state)
    return dict(
        costs=np.asarray(costs), shard_rows=np.asarray(shard_rows),
        log=np.asarray(json.dumps(log)),
        **state_arrays("", full, full_state),
    )


_WRITERS = ("save_meta", "save_corpus_sidecars", "save_model_hdf5", "save_training_state")


def _count_writes(counts):
    """Wrap the checkpoint module's writing functions to count their calls
    in this process; returns the undo."""
    originals = {name: getattr(ckpt, name) for name in _WRITERS}

    def wrap(name):
        def counted(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return originals[name](*args, **kwargs)

        return counted

    for name in _WRITERS:
        setattr(ckpt, name, wrap(name))

    def undo():
        for name, fn in originals.items():
            setattr(ckpt, name, fn)

    return undo


def run_train(sc, mesh, outdir):
    """``train_model(mesh=)`` once per phase (a later phase may resume an
    earlier one's prefix); the fetched tables and state after each phase,
    and how many times this rank called each writing function."""
    out, counts = {}, {}
    undo = _count_writes(counts)
    try:
        for i, phase in enumerate(sc["phases"]):
            kwargs = dict(phase["kwargs"])
            if kwargs.get("output_prefix"):
                kwargs["output_prefix"] = os.path.join(outdir, kwargs["output_prefix"])
            distributed.reset_collective_log()
            result = train_model(
                sc["desc"], phase["cfg"], sc["corpus"], torch.device("cpu"),
                dtype=torch.float64, mesh=mesh, **kwargs,
            )
            full = pmesh.fetch_params(mesh, result.params, sc["corpus"].num_docs)
            state = pmesh.fetch_opt_state(mesh, result.opt_state)
            out.update(state_arrays(f"p{i}_", full, state))
            out[f"p{i}_costs"] = np.asarray(result.epoch_costs)
            out[f"p{i}_steps"] = np.asarray(result.steps)
            out[f"p{i}_shard_rows"] = np.asarray(result.params.entity_reprs.shape[0])
            out[f"p{i}_log"] = np.asarray(json.dumps(distributed.collective_log()))
    finally:
        undo()
    out["writes"] = np.asarray(json.dumps(counts))
    return out


def run_gradcheck(sc, mesh, outdir):
    """(num_checked, max_relative_error) of ``train/gradcheck.py`` under the
    mesh: of one check of full ``params`` (cut to the rank's shards) on a
    global ``batch`` (cut to its rows) when the scenario gives them, else of
    the check before every step of ``train_model(mesh=,
    check_gradients=True)``."""
    if "params" in sc:
        kind = ObjectiveKind(sc["kind"])
        generator = torch.Generator().manual_seed(sc["generator_seed"])
        checked = gradcheck.check_gradients(
            kind, pmesh.shard_params(mesh, params_from_numpy(sc["params"])),
            pmesh.local_batch(mesh, port_batch(sc["batch"], kind)), generator, "cpu",
            sc["desc"], sc["cfg"], num_entities=sc["num_entities"], mesh=mesh,
        )
        return dict(checks=np.asarray([checked], dtype=np.float64))
    checks = []
    check = gradcheck.check_gradients

    def recording(*args, **kwargs):
        checks.append(check(*args, **kwargs))
        return checks[-1]

    gradcheck.check_gradients = recording
    try:
        result = train_model(sc["desc"], sc["cfg"], sc["corpus"], torch.device("cpu"),
                             dtype=torch.float64, mesh=mesh, check_gradients=True,
                             **sc.get("kwargs", {}))
    finally:
        gradcheck.check_gradients = check
    return dict(checks=np.asarray(checks, dtype=np.float64),
                costs=np.asarray(result.epoch_costs))


def run_scorer(sc, mesh, outdir):
    """``make_sharded_scorer`` for every k of ``ks``, the shard cut once and
    reused; the collective log of each call."""
    dtype = getattr(torch, sc["score_dtype"])
    entity = torch.from_numpy(sc["entity_norm"]).to(dtype)
    queries = torch.from_numpy(sc["queries"]).to(dtype)
    num_docs = entity.shape[0]
    out = {}
    for k in sc["ks"]:
        scorer, entity = make_sharded_scorer(mesh, entity, k, num_docs=num_docs)
        distributed.reset_collective_log()
        scores, ids = scorer(queries)
        out[f"scores_{k}"] = scores.numpy()
        out[f"ids_{k}"] = ids.numpy()
        out[f"log_{k}"] = np.asarray(json.dumps(distributed.collective_log()))
    out["shard_rows"] = np.asarray(entity.shape[0])
    return out


def run_engine(sc, mesh, outdir):
    """``QueryEngine(mesh=).rank`` for every k of ``ks`` and
    ``score_documents`` of one query on a document subset."""
    engine = QueryEngine(
        params_from_numpy(sc["params"]), sc["terms"], sc["docnos"], nonlinearity="tanh",
        score_dtype=getattr(torch, sc["score_dtype"]), mesh=mesh,
    )
    out = {}
    for k in sc["ks"] + sc["ks"][:1]:
        run = engine.rank(sc["queries"], top_k=k)
        out[f"run_{k}"] = np.asarray(json.dumps(run))
    scored = engine.score_documents(sc["subset_query"], sc["subset"])
    out["subset"] = np.asarray(json.dumps(scored))
    out["scorers"] = np.asarray(len(engine._sharded_scorers))
    out["shard_rows"] = np.asarray(engine._entity_norm.shape[0])
    return out


RUNNERS = {"steps": run_steps, "train": run_train, "gradcheck": run_gradcheck,
           "scorer": run_scorer, "engine": run_engine}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--mesh", required=True)
    p.add_argument("--rendezvous", required=True)
    p.add_argument("--spec", required=True)
    p.add_argument("--outdir", required=True)
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    distributed.initialize(
        f"file://{args.rendezvous}", args.world, args.rank, backend="gloo",
        timeout=GROUP_TIMEOUT_SECONDS,
    )
    mesh = pmesh.make_mesh(*pmesh.parse_mesh_shape(args.mesh))
    with open(args.spec, "rb") as f:
        scenarios = pickle.load(f)
    for sc in scenarios:
        out = RUNNERS[sc["run"]](sc, mesh, args.outdir)
        np.savez(os.path.join(args.outdir, f"{sc['name']}_rank{args.rank}.npz"), **out)
    distributed.shutdown()
    print("WORKER-OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
