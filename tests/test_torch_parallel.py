"""The PyTorch port's mesh path, held to the JAX package and to the port's
own single-device path.

The port's mesh program is N processes with explicit collectives
(``cunvsm_torch/parallel``); here they are four gloo ranks on the CPU in
float64, spawned once per mesh shape (2x2, 1x4, 4x1) by a module-scoped
fixture that runs every scenario through ``tests/_torch_distributed_worker.py``.
The JAX side is ``cunvsm_tpu.parallel.mesh.make_sharded_train_step`` on a
2x2 mesh of the virtual CPU devices that ``tests/conftest.py`` provides, on
the same parameters, batches and negative draws (``torch_parity.jax_draws``).

Sizes: V 64, N 50 (so that a model axis of 4 pads the entity table to 52),
d 12 -> 8, B 32, W 4, k 3, P 8.  Every spawned rank is joined with a
deadline and the rest are killed when one fails or hangs; the rendezvous is
a file under the test's temporary directory.
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cunvsm_tpu.models import objectives as jobj
from cunvsm_tpu.models.params import ModelParams as JModelParams
from cunvsm_tpu.optim import updates as jupd
from cunvsm_tpu.parallel import mesh as jmesh
from cunvsm_tpu.train import step as jstep
from cunvsm_tpu.parallel import query as jpquery
from cunvsm_torch.config import DataConfig, ModelDesc, Nonlinearity
from cunvsm_torch.data.corpus import build_corpus
from cunvsm_torch.io import checkpoint as tckpt
from cunvsm_torch.query.engine import QueryEngine
from cunvsm_torch.train.trainer import train_model
from tests.test_torch_slice import synthetic_corpus
from cunvsm_torch.models.params import ModelParams as TModelParams, params_from_numpy
from cunvsm_torch.optim import updates as tupd
from cunvsm_torch.parallel import distributed, mesh as pmesh
from cunvsm_torch.train import step as tstep

import _torch_distributed_worker as worker
from torch_parity import jax_draws, nonzero_state, optimizer_config, twin

V, N, D_W, D_E, B, W, K, POOL = 64, 50, 12, 8, 32, 4, 3, 8
STEPS = 3
RTOL, ATOL = 1e-9, 1e-12
MESHES = ("2x2", "1x4", "4x1")
WORKER_DEADLINE_SECONDS = 300
_WORKER = os.path.join(os.path.dirname(__file__), "_torch_distributed_worker.py")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NVSM = ModelDesc(word_repr_size=D_W, entity_repr_size=D_E,
                 nonlinearity=Nonlinearity.HARD_TANH, batch_normalization=True)
LSE = ModelDesc(word_repr_size=D_W, entity_repr_size=D_E, nonlinearity=Nonlinearity.TANH,
                bias_negative_samples=True, l2_normalize_phrase_reprs=True)
ENTITY_L2 = dataclasses.replace(NVSM, l2_normalize_entity_reprs=True)

OPTIMIZERS = ("sgd", "adagrad", "sparse_adam", "dense_adam", "full_adam")
ACCUMULATE_ONLY = ("sgd", "full_adam")


def spawn_ranks(mesh_shape: str, spec, outdir: str, deadline=WORKER_DEADLINE_SECONDS):
    """Run ``spec`` (a list of scenarios) on the ranks of ``mesh_shape``;
    every rank is waited for until ``deadline`` and all are killed when one
    is late or fails."""
    data, model = pmesh.parse_mesh_shape(mesh_shape)
    world = data * model
    spec_path = os.path.join(outdir, "spec.pkl")
    with open(spec_path, "wb") as f:
        pickle.dump(spec, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, "--rank", str(r), "--world", str(world),
             "--mesh", mesh_shape, "--rendezvous", os.path.join(outdir, "rendezvous"),
             "--spec", spec_path, "--outdir", outdir],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        )
        for r in range(world)
    ]
    outputs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=deadline)
            outputs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0 and "WORKER-OK" in out, (
            f"rank {r} of {mesh_shape} failed:\n{out[-4000:]}"
        )


def load_rank(outdir, name, rank=0):
    with np.load(os.path.join(outdir, f"{name}_rank{rank}.npz")) as data:
        return {k: data[k] for k in data.files}


# ---------------------------------------------------------------------------
# The step scenarios.
# ---------------------------------------------------------------------------


def numpy_params(seed):
    rng = np.random.RandomState(seed)
    return JModelParams(
        word_reprs=rng.uniform(-0.5, 0.5, (V, D_W)),
        entity_reprs=rng.uniform(-0.5, 0.5, (N, D_E)),
        transform_w=rng.uniform(-0.5, 0.5, (D_W, D_E)),
        transform_b=rng.uniform(-0.1, 0.1, (D_E,)),
    )


def numpy_batch(seed, sim_rows):
    """One step's arrays: the text batch, and pairs over ``sim_rows`` rows
    for the similarity objectives."""
    rng = np.random.RandomState(seed)
    return dict(
        features=rng.randint(0, V, (B, W)).astype(np.int32),
        feature_weights=rng.uniform(0.5, 1.5, (B, W)),
        labels=rng.randint(0, N, B).astype(np.int32),
        weights=rng.uniform(0.5, 1.5, B),
        ids=rng.randint(0, sim_rows, (B, 2)).astype(np.int32),
        sim_weights=rng.uniform(0.5, 1.5, B),
    )


def _scenario(name, desc, optimizer, kind=None, multistep=False, **cfg_kw):
    cfg_kw.setdefault("negative_pool_size", 0)
    return dict(name=name, run="steps", desc=desc, cfg=optimizer_config(optimizer, **cfg_kw),
                kind=kind, multistep=multistep)


def step_scenarios():
    out = []
    for opt in OPTIMIZERS:
        out.append(_scenario(f"{opt}-perinst", NVSM, opt))
        out.append(_scenario(f"{opt}-entity_l2", ENTITY_L2, opt))
    for opt in ACCUMULATE_ONLY:
        out.append(_scenario(f"{opt}-pooled", NVSM, opt, negative_pool_size=POOL,
                             negative_pool_stride=3))
        out.append(_scenario(f"{opt}-shared", NVSM, opt, shared_negatives=True))
        out.append(_scenario(
            f"{opt}-entity_entity", NVSM, opt, kind="text_entity_entity_entity",
            text_entity_weight=0.7, entity_entity_weight=0.3))
        out.append(_scenario(
            f"{opt}-term_term", NVSM, opt, kind="text_entity_term_term",
            text_entity_weight=0.6, term_term_weight=0.4))
    out.append(_scenario("full_adam-pooled-lse", LSE, "full_adam", negative_pool_size=POOL))
    out.append(_scenario("full_adam-pooled-multistep", NVSM, "full_adam", multistep=True,
                         negative_pool_size=POOL))
    out.append(_scenario("sgd-perinst-lse", LSE, "sgd"))
    return out


STEP_SCENARIOS = step_scenarios()
STEP_NAMES = [sc["name"] for sc in STEP_SCENARIOS]


def with_inputs(sc, seed):
    """``sc`` with its arrays: parameters, a non-zero optimizer state,
    ``STEPS`` batches and the negative ids that the JAX step draws."""
    jdesc, jcfg = twin(sc["desc"]), twin(sc["cfg"])
    np_params = numpy_params(seed)
    jparams = JModelParams(*(jnp.asarray(x) for x in np_params))
    jstate = nonzero_state(jupd.Optimizer(jcfg).init(jparams), seed + 1)
    sim_rows = V if sc["kind"] == "text_entity_term_term" else N
    batches = [numpy_batch(seed + 10 + i, sim_rows) for i in range(STEPS)]
    ids = [
        jax_draws(jcfg, jdesc, jax.random.PRNGKey(100 + i), jnp.asarray(b["labels"]), N).numpy()
        for i, b in enumerate(batches)
    ]
    state = tupd.opt_state_to_numpy(tupd.opt_state_from_numpy(jstate))
    # The spec is unpickled by the ranks, which import no JAX: port types only.
    return dict(sc, params=TModelParams(*np_params), state=state, batches=batches, negative_ids=ids,
                num_entities=N)


@pytest.fixture(scope="module")
def step_inputs():
    return {sc["name"]: with_inputs(sc, 1000 + 7 * i) for i, sc in enumerate(STEP_SCENARIOS)}


# The cross-rank reduce width: the sizes and the bound of
# tests/test_sharding.py::test_bf16_cross_chip_reduce_numerics.
REDUCE = dict(docs=256, vocab=64, dim=8, batch=64, window=4, k=2, pool=16)


def reduce_scenario(reduce_dtype):
    r = REDUCE
    desc = ModelDesc(word_repr_size=r["dim"], entity_repr_size=r["dim"],
                     nonlinearity=Nonlinearity.HARD_TANH, batch_normalization=True)
    cfg = optimizer_config(
        "full_adam", batch_size=r["batch"], window_size=r["window"],
        num_random_entities=r["k"], learning_rate=1e-3, regularization_lambda=1e-2,
        uniform_feature_weights=True, negative_pool_size=r["pool"], stream_dtype="bfloat16",
        cross_chip_reduce_dtype=reduce_dtype,
    )
    rng = np.random.RandomState(0)
    lim_w, lim_e = (6.0 / (r["vocab"] + r["dim"])) ** 0.5, (6.0 / (r["docs"] + r["dim"])) ** 0.5
    params = TModelParams(
        rng.uniform(-lim_w, lim_w, (r["vocab"], r["dim"])).astype(np.float32),
        rng.uniform(-lim_e, lim_e, (r["docs"], r["dim"])).astype(np.float32),
        rng.uniform(-0.6, 0.6, (r["dim"], r["dim"])).astype(np.float32),
        np.zeros(r["dim"], np.float32),
    )
    state = tupd.opt_state_to_numpy(tupd.Optimizer(cfg).init(params_from_numpy(params)))
    batch = dict(
        features=rng.randint(0, r["vocab"], (r["batch"], r["window"])).astype(np.int32),
        feature_weights=np.ones((r["batch"], r["window"]), np.float32),
        labels=rng.randint(0, r["docs"], r["batch"]).astype(np.int32),
        weights=np.ones(r["batch"], np.float32),
    )
    return dict(name=f"reduce-{reduce_dtype}", run="steps", desc=desc, cfg=cfg, kind=None,
                multistep=False, dtype="float32", params=params, state=state, batches=[batch],
                negative_ids=[rng.randint(0, r["docs"], r["pool"])], num_entities=r["docs"])


# Sharded serving: an uneven document count, two k on one shard.
SCORER = dict(docs=50, dim=8, queries=5, ks=[7, 60])


def scorer_scenario(score_dtype):
    rng = np.random.RandomState(11)
    entity = rng.normal(size=(SCORER["docs"], SCORER["dim"]))
    queries = rng.normal(size=(SCORER["queries"], SCORER["dim"]))
    unit = lambda x: (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)  # noqa: E731
    return dict(name=f"scorer-{score_dtype}", run="scorer", entity_norm=unit(entity),
                queries=unit(queries), ks=SCORER["ks"], score_dtype=score_dtype)


def engine_scenario(score_dtype):
    rng = np.random.RandomState(12)
    terms = [f"t{i}" for i in range(V)]
    queries = {f"q{i}": [terms[j] for j in rng.randint(0, V, 3)] + ["unknown"] for i in range(4)}
    queries["none"] = ["unknown"]
    docnos = [f"d{i}" for i in range(N)]
    params = TModelParams(*(x.astype(np.float32) for x in numpy_params(5)))
    return dict(name=f"engine-{score_dtype}", run="engine", params=params, terms=terms,
                docnos=docnos, queries=queries, ks=[5, 1000], score_dtype=score_dtype,
                subset_query=queries["q1"], subset=docnos[3:40:4] + ["absent"])


def trainer_corpus():
    docs, _ = synthetic_corpus(num_docs_per_topic=3, doc_len=24)
    return build_corpus(
        docs,
        DataConfig(max_vocabulary_size=0, min_document_frequency=0, max_document_frequency=0),
        window_size=4,
    )


TRAIN_DESC = ModelDesc(word_repr_size=8, entity_repr_size=6, batch_normalization=True,
                       nonlinearity=Nonlinearity.HARD_TANH)


def train_cfg(epochs, optimizer="full_adam", **kw):
    return optimizer_config(optimizer, **{**dict(
        num_epochs=epochs, batch_size=8, window_size=4, num_random_entities=2,
        learning_rate=0.01, seed=3, negative_pool_size=-1), **kw})


def train_scenarios():
    corpus = trainer_corpus()

    def scenario(name, phases):
        return dict(name=name, run="train", desc=TRAIN_DESC, corpus=corpus, phases=phases)

    device = dict(on_device_sampling=True, steps_per_call=2)
    return [
        scenario("train-host", [dict(cfg=train_cfg(3), kwargs=dict(
            steps_per_call=2, output_prefix="host", dump_initial_model=True))]),
        scenario("train-host-adagrad", [dict(cfg=train_cfg(2, "adagrad"), kwargs={})]),
        scenario("train-host-reference_rng", [dict(
            cfg=train_cfg(2, reference_rng=True), kwargs={})]),
        scenario("train-device", [dict(cfg=train_cfg(3), kwargs=dict(
            device, output_prefix="device"))]),
        scenario("train-device-pooled", [dict(
            cfg=train_cfg(2, negative_pool_size=4), kwargs=dict(device, compute_initial_cost=True))]),
        scenario("train-device-resumed", [
            dict(cfg=train_cfg(2), kwargs=dict(device, output_prefix="resumed")),
            dict(cfg=train_cfg(3), kwargs=dict(device, output_prefix="resumed", resume=True)),
        ]),
    ]


@pytest.fixture(scope="module")
def scenarios(step_inputs):
    extra = [reduce_scenario("float32"), reduce_scenario("bfloat16")]
    extra += [scorer_scenario(d) for d in ("float32", "bfloat16")]
    extra += [engine_scenario(d) for d in ("float32", "bfloat16")]
    extra += train_scenarios()
    return {sc["name"]: sc for sc in [*step_inputs.values(), *extra]}


@pytest.fixture(scope="module", params=MESHES)
def mesh_run(request, scenarios, tmp_path_factory):
    """(mesh shape, directory of the ranks' results) of one spawn, which
    runs every scenario."""
    outdir = str(tmp_path_factory.mktemp(f"mesh_{request.param}"))
    spawn_ranks(request.param, list(scenarios.values()), outdir)
    return request.param, outdir


def _jax_batch(arrays, kind):
    te = jobj.TextEntityBatch(
        features=jnp.asarray(arrays["features"]), feature_weights=jnp.asarray(arrays["feature_weights"]),
        labels=jnp.asarray(arrays["labels"]), weights=jnp.asarray(arrays["weights"]),
    )
    if kind is None:
        return te
    return (te, jobj.SimilarityBatch(ids=jnp.asarray(arrays["ids"]),
                                     weights=jnp.asarray(arrays["sim_weights"])))


_JAX_CACHE = {}


def jax_sharded_reference(sc):
    """Costs, tables and state of the JAX package's sharded step on a 2x2
    mesh, from ``sc``'s inputs."""
    if sc["name"] in _JAX_CACHE:
        return _JAX_CACHE[sc["name"]]
    jdesc, jcfg = twin(sc["desc"]), twin(sc["cfg"])
    kind = None if sc["kind"] is None else jstep.ObjectiveKind(sc["kind"])
    jparams = JModelParams(*(jnp.asarray(x) for x in sc["params"]))
    # The JAX state types have the port's field names.
    jstate = jupd.OptState(*(
        type(ref)(*(jnp.asarray(x) for x in s))
        for ref, s in zip(jupd.Optimizer(jcfg).init(jparams), sc["state"])
    ))
    mesh = jmesh.make_mesh(2, 2)
    batches = [_jax_batch(b, kind) for b in sc["batches"]]
    step, p, o = jmesh.make_sharded_train_step(
        jdesc, jcfg, mesh, jparams, jstate, batches[0], kind, num_entities=N
    )
    costs = []
    for i, b in enumerate(batches):
        p, o, c = step(p, o, b, jax.random.PRNGKey(100 + i))
        costs.append(float(c))
    out = dict(costs=np.asarray(costs))
    out.update({name: np.asarray(x) for name, x in zip(p._fields, p)})
    for part, s in zip(o._fields, o):
        out.update({f"state_{part}_{name}": np.asarray(x) for name, x in zip(s._fields, s)})
    _JAX_CACHE[sc["name"]] = out
    return out


def port_single_device_reference(sc):
    """The same from the port's own single-device step."""
    kind = None if sc["kind"] is None else tstep.ObjectiveKind(sc["kind"])
    params = params_from_numpy(sc["params"])
    state = tupd.opt_state_from_numpy(sc["state"])
    step = tstep.make_train_step(sc["desc"], sc["cfg"], "cpu", None, kind=kind)
    dtype = getattr(torch, sc.get("dtype", "float64"))
    costs = [
        float(step(params, state, worker.port_batch(b, kind, dtype),
                   negative_ids=None if i is None else torch.from_numpy(i).long()))
        for b, i in zip(sc["batches"], sc["negative_ids"])
    ]
    return dict(costs=np.asarray(costs), **worker.state_arrays("", params, state))


def assert_same_run(got, want):
    """Costs, the four tables and every state leaf agree; entity rows are
    compared over the real N (the port's fetch keeps the padded rows)."""
    np.testing.assert_allclose(got["costs"], want["costs"], rtol=RTOL)
    checked = 0
    for name, ref in want.items():
        if name == "costs":
            continue
        have = got[name]
        if have.ndim and have.shape[0] != ref.shape[0]:
            assert have.shape[0] == pmesh.pad_entities(N, 4) and ref.shape[0] == N, name
            assert not have[N:].any(), f"{name}: padded rows moved"
            have = have[:N]
        if ref.dtype.kind == "i":
            np.testing.assert_array_equal(have, ref, err_msg=name)
        else:
            np.testing.assert_allclose(have, ref, rtol=RTOL, atol=ATOL, err_msg=name)
        checked += 1
    assert checked >= 4


@pytest.mark.parametrize("name", STEP_NAMES)
def test_mesh_step_matches_jax_sharded_step(mesh_run, step_inputs, name):
    """Three steps from a non-zero optimizer state on the port's mesh give
    the cost, tables and state of the JAX package's 2x2 sharded step at
    rtol 1e-9 / atol 1e-12 (float64; the order of sums differs)."""
    _, outdir = mesh_run
    assert_same_run(load_rank(outdir, name), jax_sharded_reference(step_inputs[name]))


@pytest.mark.parametrize("name", STEP_NAMES)
def test_mesh_step_matches_single_device_step(mesh_run, step_inputs, name):
    """... and those of the port's own single-device step, at the same
    tolerance; every rank fetched the same tables."""
    shape, outdir = mesh_run
    got = load_rank(outdir, name)
    assert_same_run(got, port_single_device_reference(step_inputs[name]))
    data, model = pmesh.parse_mesh_shape(shape)
    assert int(got["shard_rows"]) == pmesh.pad_entities(N, model) // model
    last = load_rank(outdir, name, rank=data * model - 1)
    for key in ("costs", "word_reprs", "entity_reprs", "transform_w"):
        np.testing.assert_array_equal(last[key], got[key], err_msg=key)


# ---------------------------------------------------------------------------
# What crosses the ranks: the collective log.
# ---------------------------------------------------------------------------


def _log(outdir, name, key="log", rank=0):
    return json.loads(str(load_rank(outdir, name, rank)[key]))


def _per_call(entry):
    return entry["bytes"] // entry["calls"]


F64 = 8
UPDATE_STREAM_BYTES = B * W * D_W * F64  # the [B*W, d] word update stream


@pytest.mark.parametrize("name", ["full_adam-pooled", "full_adam-perinst", "full_adam-term_term"])
def test_one_table_sized_word_all_reduce_per_step(mesh_run, name):
    """full_adam: per step one all-reduce of the [V, d] word partial over
    every rank, and no collective as large as the B*W*d update stream."""
    shape, outdir = mesh_run
    log = _log(outdir, name)
    assert log["word_partial"] == dict(
        op="all_reduce", calls=STEPS, bytes=STEPS * V * D_W * F64, staged_through_host=False)
    assert "word_grads" not in log
    for entry in log.values():
        assert _per_call(entry) < UPDATE_STREAM_BYTES, entry


@pytest.mark.parametrize("name", ["sgd-perinst", "adagrad-perinst", "sparse_adam-entity_l2"])
def test_other_optimizers_gather_the_word_descriptors(mesh_run, name):
    """The optimizers with per-instance statistics all-gather the [B, d]
    word descriptor (gradient rows, ids and weights): B*d, never B*W*d."""
    _, outdir = mesh_run
    log = _log(outdir, name)
    assert "word_partial" not in log
    entry = log["word_grads"]
    assert entry["calls"] == 3 * STEPS  # grad, indices, weights
    assert entry["bytes"] == STEPS * (B * D_W * F64 + B * W * 8 + B * W * F64)
    for e in log.values():
        assert _per_call(e) < UPDATE_STREAM_BYTES, e


def test_entity_traffic_is_that_of_the_gathered_rows(mesh_run):
    """Pooled path: per step the entity rows read are the data group's B/D
    label rows and the P pool rows (one all-reduce each over the model
    axis), the label-row gradients are all-gathered ([B, d], ids), and the
    pool gradient [P, d] is reduced over the data axis: within 3x of
    (B + P) * d values, never N * d per rank... and the word table apart,
    nothing table-sized."""
    shape, outdir = mesh_run
    data, _ = pmesh.parse_mesh_shape(shape)
    log = _log(outdir, "full_adam-pooled")
    rows = log["entity_rows"]
    assert rows["calls"] == 2 * STEPS
    assert rows["bytes"] == STEPS * (B // data + POOL) * D_E * F64
    assert log["pool_grad"]["bytes"] == STEPS * POOL * D_E * F64
    assert log["entity_grads"]["bytes"] == STEPS * (B * D_E * F64 + B * 8)
    entity_bytes = sum(log[k]["bytes"] for k in ("entity_rows", "pool_grad", "entity_grads"))
    assert entity_bytes <= 3 * STEPS * (B + POOL) * D_E * F64
    assert log["cost_and_transform_grads"]["bytes"] == STEPS * (1 + D_W * D_E + D_E) * F64
    assert log["batch_norm_mean"]["calls"] == log["batch_norm_var_grad"]["calls"] == STEPS


def test_bfloat16_cross_rank_reduce(mesh_run, scenarios):
    """``cross_chip_reduce_dtype="bfloat16"`` halves the bytes of the word
    all-reduce and stays within the JAX package's bound of the float32
    reduce (atol 1e-4 on the word table after one step at these sizes; the
    forward pass is the same)."""
    _, outdir = mesh_run
    f32, bf16 = load_rank(outdir, "reduce-float32"), load_rank(outdir, "reduce-bfloat16")
    words = REDUCE["vocab"] * REDUCE["dim"]
    assert _log(outdir, "reduce-float32")["word_partial"]["bytes"] == words * 4
    assert _log(outdir, "reduce-bfloat16")["word_partial"]["bytes"] == words * 2
    assert np.isfinite(bf16["costs"]).all() and abs(bf16["costs"][0] - f32["costs"][0]) < 1e-5
    np.testing.assert_allclose(bf16["word_reprs"], f32["word_reprs"], atol=1e-4)
    assert not np.array_equal(bf16["word_reprs"], f32["word_reprs"])
    np.testing.assert_allclose(bf16["entity_reprs"], f32["entity_reprs"], atol=1e-4)
    # With the float32 reduce the mesh step is the single-device step up to
    # the order of float32 sums, bfloat16 streams and all.
    single = port_single_device_reference(scenarios["reduce-float32"])
    np.testing.assert_allclose(f32["costs"], single["costs"], rtol=1e-6)
    for key in ("word_reprs", "entity_reprs", "transform_w", "transform_b"):
        np.testing.assert_allclose(f32[key], single[key], rtol=0, atol=2e-6, err_msg=key)


# ---------------------------------------------------------------------------
# Sharded serving.
# ---------------------------------------------------------------------------


def _assert_same_ranking(scores, ids, ref_scores, ref_ids, atol):
    """Scores at the tolerance; ids where the neighbouring reference scores
    differ by more than it (``topk`` orders ties as it likes)."""
    np.testing.assert_allclose(scores, ref_scores, rtol=0, atol=atol)
    gaps = np.abs(np.diff(ref_scores, axis=1))
    distinct = np.ones(ref_scores.shape, bool)
    distinct[:, 1:] &= gaps > 2 * atol
    distinct[:, :-1] &= gaps > 2 * atol
    np.testing.assert_array_equal(ids[distinct], ref_ids[distinct])
    assert distinct.mean() > 0.5


@pytest.mark.parametrize("score_dtype,atol", [("float32", 1e-6), ("bfloat16", 1e-6)])
def test_sharded_scorer_matches_dense_and_jax(mesh_run, scenarios, score_dtype, atol):
    """Per-shard top-k and merge against the dense ranking of the same
    (rounded) operands and against the JAX package's sharded scorer, with
    50 documents (a model axis of 4 pads them to 52) and a second k (60 > 50)
    on the shard cut for the first; only the candidates cross the ranks."""
    shape, outdir = mesh_run
    _, model = pmesh.parse_mesh_shape(shape)
    sc = scenarios[f"scorer-{score_dtype}"]
    got = load_rank(outdir, sc["name"])
    dtype = getattr(torch, score_dtype)
    e = torch.from_numpy(sc["entity_norm"]).to(dtype)
    q = torch.from_numpy(sc["queries"]).to(dtype)
    dense = q.to(torch.float32) @ e.to(torch.float32).T
    jdtype = jnp.bfloat16 if score_dtype == "bfloat16" else jnp.float32
    docs, nq = SCORER["docs"], SCORER["queries"]
    assert int(got["shard_rows"]) == pmesh.pad_entities(docs, model) // model
    for k in sc["ks"]:
        kk = min(k, docs)
        ref_scores, ref_ids = torch.topk(dense, kk, dim=1)
        assert got[f"ids_{k}"].shape == (nq, kk) and got[f"ids_{k}"].max() < docs
        _assert_same_ranking(got[f"scores_{k}"], got[f"ids_{k}"], ref_scores.numpy(),
                             ref_ids.numpy(), atol)
        jscorer, _ = jpquery.make_sharded_scorer(
            jmesh.make_mesh(2, 2), jnp.asarray(sc["entity_norm"]).astype(jdtype), k)
        jscores, jids = jscorer(jnp.asarray(sc["queries"]).astype(jdtype))
        _assert_same_ranking(got[f"scores_{k}"], got[f"ids_{k}"], np.asarray(jscores),
                             np.asarray(jids), atol)
        # Q * shards * min(k, shard rows) candidates, scores and ids.
        local_k = min(kk, int(got["shard_rows"]))
        log = _log(outdir, sc["name"], f"log_{k}")
        assert set(log) == {"topk_scores", "topk_ids"}
        assert log["topk_scores"]["bytes"] == nq * model * local_k * 4
        assert log["topk_ids"]["bytes"] == nq * model * local_k * 8
        if model > 1 and k < docs:
            assert log["topk_scores"]["bytes"] < nq * docs * 4  # no [Q, D] matrix
    last = load_rank(outdir, sc["name"], rank=3)
    np.testing.assert_array_equal(last["ids_7"], got["ids_7"])


@pytest.mark.parametrize("score_dtype", ["float32", "bfloat16"])
def test_query_engine_on_a_mesh(mesh_run, scenarios, score_dtype):
    """``QueryEngine(mesh=).rank`` gives the single-process engine's run;
    one scorer per k, and the matrix stays this rank's shard."""
    shape, outdir = mesh_run
    _, model = pmesh.parse_mesh_shape(shape)
    sc = scenarios[f"engine-{score_dtype}"]
    got = load_rank(outdir, sc["name"])
    engine = QueryEngine(params_from_numpy(sc["params"]), sc["terms"], sc["docnos"],
                         nonlinearity="tanh", score_dtype=getattr(torch, score_dtype))
    for k in sc["ks"]:
        want = engine.rank(sc["queries"], top_k=k)
        run = json.loads(str(got[f"run_{k}"]))
        assert run.keys() == want.keys() and "none" not in run
        for qid, ranked in want.items():
            ref_scores = np.asarray([[s for _, s in ranked]])
            ref_ids = np.asarray([[sc["docnos"].index(d) for d, _ in ranked]])
            scores = np.asarray([[s for _, s in run[qid]]])
            ids = np.asarray([[sc["docnos"].index(d) for d, _ in run[qid]]])
            assert ids.shape[1] == min(k, N)
            _assert_same_ranking(scores, ids, ref_scores, ref_ids, 1e-6)
    want = engine.score_documents(sc["subset_query"], sc["subset"])
    subset = json.loads(str(got["subset"]))
    np.testing.assert_allclose([s for _, s in subset], [s for _, s in want], rtol=0, atol=1e-6)
    assert sorted(d for d, _ in subset) == sorted(d for d, _ in want)
    assert int(got["scorers"]) == len(sc["ks"])
    assert int(got["shard_rows"]) == pmesh.pad_entities(N, model) // model


# ---------------------------------------------------------------------------
# The trainer on a mesh.
# ---------------------------------------------------------------------------

CPU = torch.device("cpu")
_TRAIN_CACHE = {}


def single_device_run(sc, phase=-1, epochs=None):
    """``train_model`` without a mesh on the scenario's last phase (no
    output files, no resume: ``epochs`` epochs straight through)."""
    key = (sc["name"], phase, epochs)
    if key not in _TRAIN_CACHE:
        p = sc["phases"][phase]
        kwargs = {k: v for k, v in p["kwargs"].items()
                  if k not in ("output_prefix", "resume", "dump_initial_model")}
        _TRAIN_CACHE[key] = train_model(
            sc["desc"], p["cfg"], sc["corpus"], CPU, dtype=torch.float64, **kwargs)
    return _TRAIN_CACHE[key]


TRAIN_NAMES = ["train-host", "train-host-adagrad", "train-host-reference_rng", "train-device",
               "train-device-pooled", "train-device-resumed"]


@pytest.mark.parametrize("name", TRAIN_NAMES)
def test_mesh_training_equals_the_single_device_run(mesh_run, scenarios, name):
    """``train_model(mesh=)``, host-fed with ``steps_per_call`` and sampled
    on the device, consumes the stream of the single-device run of the same
    seed: epoch costs, the four tables and the optimizer state agree at
    rtol 1e-9 (float64).  For the resumed scenario that is 2 + 1 resumed
    epochs against 3 straight ones.  The corpus has 9 documents, so every
    model axis pads the entity table."""
    shape, outdir = mesh_run
    _, model = pmesh.parse_mesh_shape(shape)
    sc = scenarios[name]
    got = load_rank(outdir, name)
    last = len(sc["phases"]) - 1
    ref = single_device_run(sc)
    num_docs = sc["corpus"].num_docs
    assert num_docs == 9
    assert int(got[f"p{last}_shard_rows"]) == pmesh.pad_entities(num_docs, model) // model
    want = worker.state_arrays(f"p{last}_", ref.params, ref.opt_state)
    costs = np.concatenate([got[f"p{i}_costs"] for i in range(last + 1)])
    np.testing.assert_allclose(costs, ref.epoch_costs, rtol=RTOL)
    assert sum(int(got[f"p{i}_steps"]) for i in range(last + 1)) == ref.steps > 0
    for key, value in want.items():
        have = got[key]
        if have.ndim and have.shape[0] != value.shape[0]:
            assert not have[num_docs:].any(), key  # the state's padded rows
            have = have[:num_docs]
        np.testing.assert_allclose(have, value, rtol=RTOL, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("name,prefix,epochs,initial", [
    ("train-host", "host", 3, 1), ("train-device", "device", 3, 0),
    ("train-device-resumed", "resumed", 3, 0),
])
def test_exactly_one_rank_writes(mesh_run, scenarios, name, prefix, epochs, initial):
    """The primary alone writes ``_meta``, the sidecars, one model file per
    epoch and the resume file; the model file holds the real entity rows
    (the fetched table, cast to float32), the resume file the padded
    layout."""
    shape, outdir = mesh_run
    _, model = pmesh.parse_mesh_shape(shape)
    sc = scenarios[name]
    counts = [_log(outdir, name, "writes", rank=r) for r in range(4)]
    assert counts[0] == dict(save_meta=1, save_corpus_sidecars=1,
                             save_model_hdf5=epochs + initial, save_training_state=epochs)
    assert counts[1:] == [{}, {}, {}]
    path = os.path.join(outdir, prefix)
    for suffix in ("_meta", "_vocab.txt", "_docnos.txt", "_resume.npz",
                   *(f"_{e}.hdf5" for e in range(1 - initial, epochs + 1))):
        assert os.path.exists(path + suffix), suffix
    assert not [f for f in os.listdir(outdir) if ".tmp" in f]
    got = load_rank(outdir, name)
    last = len(sc["phases"]) - 1
    loaded = tckpt.load_model_hdf5(path, epochs, CPU)
    num_docs = sc["corpus"].num_docs
    assert loaded.entity_reprs.shape[0] == num_docs
    for field in loaded._fields:
        np.testing.assert_array_equal(
            getattr(loaded, field).numpy(), got[f"p{last}_{field}"].astype(np.float32), field)
    with np.load(path + "_resume.npz") as resume:
        assert resume["leaf_1"].shape[0] == pmesh.pad_entities(num_docs, model)
        np.testing.assert_array_equal(resume["leaf_1"][:num_docs], got[f"p{last}_entity_reprs"])
        assert not resume["leaf_1"][num_docs:].any()


def test_on_device_mesh_training_moves_no_batch(mesh_run, scenarios):
    """Sampled on the device, the steps' collectives are those of the
    host-fed step: the word all-reduce once per step, and apart from it and
    the dumps' fetches nothing as large as a batch's [B, W] windows of word
    rows, so no sampled batch and no part of the corpus crosses the ranks."""
    _, outdir = mesh_run
    got = load_rank(outdir, "train-device")
    log = _log(outdir, "train-device", "p0_log")
    steps = int(got["p0_steps"])
    cfg = scenarios["train-device"]["phases"][0]["cfg"]
    assert log["word_partial"]["calls"] == steps
    assert log["fetch"]["calls"] > 0  # the dumps
    windows = cfg.batch_size * cfg.window_size * TRAIN_DESC.word_repr_size * F64
    for name, entry in log.items():
        if name not in ("word_partial", "fetch"):
            assert _per_call(entry) < windows, (name, entry)


# ---------------------------------------------------------------------------
# The commands, launched both ways.
# ---------------------------------------------------------------------------

CLI_TOPICS = {
    "space": "rocket orbit launch satellite astronaut".split(),
    "food": "recipe oven flour butter bake".split(),
    "sport": "goal match player referee stadium".split(),
}
CLI_TRAIN_FLAGS = [
    "--num_epochs", "2", "--batch_size", "16", "--window_size", "4",
    "--num_random_entities", "3", "--word_repr_size", "10", "--entity_repr_size", "8",
    "--update_method", "full_adam", "--nonlinearity", "hard_tanh", "--batch_normalization",
    "--max_vocabulary_size", "0", "--min_document_frequency", "0",
    "--max_document_frequency", "0", "--seed", "3", "--learning_rate", "0.02",
    "--device", "cpu",
]
CLI_QUERIES = [("1", "rocket orbits launched"), ("2", "the oven baking butter"),
               ("3", "referee and players"), ("4", "nothing known here")]
LAUNCHES = {
    "triple": ["--reference_rng"],
    "torchrun_env": ["--on_device_sampling", "--steps_per_call", "2"],
}


def _launch(module, flags, style, outdir, mesh_shape="2x2"):
    """Four processes of ``python -m module``: ``triple`` passes the
    rendezvous and the ranks as flags (a file rendezvous), ``torchrun_env``
    sets the variables that torchrun sets and passes bare ``--distributed``."""
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="1")
    procs = []
    if style == "torchrun_env":
        import socket

        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
    for r in range(4):
        renv = dict(env)
        if style == "triple":
            rdv = os.path.join(outdir, f"rdv_{module.rsplit('.', 1)[-1]}")
            launch = ["--coordinator_address", f"file://{rdv}", "--num_processes", "4",
                      "--process_id", str(r)]
        else:
            launch = ["--distributed"]
            renv.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(r),
                        WORLD_SIZE="4", LOCAL_RANK=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, *flags, "--mesh", mesh_shape, *launch],
            cwd=_REPO, env=renv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=WORKER_DEADLINE_SECONDS)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"rank {r} ({style}) failed:\n{out[-4000:]}"
    return outputs


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.RandomState(0)
    corpus = d / "docs.jsonl"
    with open(corpus, "w") as f:
        for topic, words in CLI_TOPICS.items():
            for i in range(4):
                body = " ".join(words[rng.randint(len(words))] if rng.rand() < 0.8 else "the"
                                for _ in range(16))
                f.write(json.dumps({"id": f"{topic}_{i}", "text": body}) + "\n")
    topics = d / "topics.txt"
    topics.write_text("".join(f"{q};{text}\n" for q, text in CLI_QUERIES))
    return str(d), str(corpus), str(topics)


@pytest.mark.parametrize("style", sorted(LAUNCHES))
def test_commands_on_a_mesh_from_a_corpus_to_a_run(cli_files, style):
    """Both commands on a 2x2 mesh of four processes, launched with the
    ``--coordinator_address`` triple (host-fed, reference RNG) and with
    ``--distributed`` under torchrun's variables (on-device sampling): the
    model within 1e-5 (float32) of the single-process command's, one set of
    files, and the TREC run equal to the single-process command's."""
    from cunvsm_torch.cli import query as tquery
    from cunvsm_torch.cli import train as ttrain
    from cunvsm_torch.io.trec import read_run

    d, corpus, topics = cli_files
    flags = [*CLI_TRAIN_FLAGS, *LAUNCHES[style]]
    single, meshed = os.path.join(d, f"single_{style}"), os.path.join(d, f"mesh_{style}")
    assert ttrain.main([corpus, "--output", single, *flags]) == 0
    outputs = _launch("cunvsm_torch.cli.train", [corpus, "--output", meshed, *flags], style, d)
    assert "Epoch 2" in outputs[0] and "Epoch 2" not in outputs[1]  # the primary logs
    assert sorted(f.replace("mesh_", "") for f in os.listdir(d) if f.startswith("mesh_" + style)) \
        == sorted(f.replace("single_", "") for f in os.listdir(d) if f.startswith("single_" + style))
    a, b = tckpt.load_model_hdf5(single, 2, CPU), tckpt.load_model_hdf5(meshed, 2, CPU)
    for x, y in zip(a, b):
        assert x.shape == y.shape
        np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=1e-5, atol=1e-5)
    for suffix in ("_meta", "_vocab.txt", "_docnos.txt"):
        with open(single + suffix, "rb") as f, open(meshed + suffix, "rb") as g:
            assert f.read() == g.read(), suffix

    query = ["--topics", topics, "--model", single, "--epoch", "2", "--device", "cpu",
             "--top_k", "7"]
    run_single, run_mesh = os.path.join(d, f"run_single_{style}"), os.path.join(d, f"run_mesh_{style}")
    assert tquery.main([*query, run_single]) == 0
    _launch("cunvsm_torch.cli.query", [*query, run_mesh], style, d, mesh_shape="1x4")
    want, got = read_run(run_single), read_run(run_mesh)
    assert got.keys() == want.keys() and "4" not in got
    for qid in want:
        assert [doc for doc, _ in got[qid]] == [doc for doc, _ in want[qid]], qid
        # The run file prints six decimals: a float32 rounding difference
        # may turn the last one.
        np.testing.assert_allclose([s for _, s in got[qid]], [s for _, s in want[qid]],
                                   rtol=0, atol=2e-6)


# ---------------------------------------------------------------------------
# Without a process group, and the refusals.
# ---------------------------------------------------------------------------


def test_a_single_process_is_a_1x1_mesh_that_calls_no_collective():
    """No group: ``make_mesh(1, 1)`` works, the step under it is the
    single-device step bit for bit, and the log stays empty."""
    distributed.reset_collective_log()
    assert not distributed.is_initialized() and distributed.is_primary()
    assert distributed.process_count() == 1
    mesh = pmesh.make_mesh(1, 1)
    sc = with_inputs(STEP_SCENARIOS[STEP_NAMES.index("full_adam-pooled")], 77)
    ref = port_single_device_reference(sc)
    step, params, state = pmesh.make_sharded_train_step(
        sc["desc"], sc["cfg"], mesh, params_from_numpy(sc["params"]),
        tupd.opt_state_from_numpy(sc["state"]), "cpu", None)
    costs = [float(step(params, state, worker.port_batch(b, None),
                        negative_ids=torch.from_numpy(i).long()))
             for b, i in zip(sc["batches"], sc["negative_ids"])]
    assert costs == ref["costs"].tolist()
    for name, t in zip(params._fields, pmesh.fetch_params(mesh, params)):
        np.testing.assert_array_equal(t.numpy(), ref[name])
    x = torch.ones(3)
    assert distributed.all_reduce(x, "x") is x and distributed.all_gather(x, "x") is x
    assert distributed.fetch(x) is x
    assert distributed.collective_log() == {}


# A mesh position made without a process group serves the checks that run
# before any collective.
_FakeMesh = pmesh.Mesh


@pytest.mark.parametrize("call,match", [
    (lambda: pmesh.make_mesh(2, 2), "mesh 2x2 needs 4 processes; the process group has 1"),
    (lambda: pmesh.make_mesh(0, 1), "needs 0 processes"),
    (lambda: pmesh.parse_mesh_shape("2by2"), "--mesh takes 'DATAxMODEL'"),
    (lambda: _FakeMesh(3, 1).batch_rows(32), "batch_size 32 not divisible by data axis 3"),
    (lambda: tupd._every_rank_slice(
        tstep.obj.SparseGrad(torch.zeros(16, 2), torch.zeros(16, 1, dtype=torch.long), None),
        _FakeMesh(2, 3)),
     r"instance count 32 not divisible by the total device count 6 \(mesh "
     r"\{'data': 2, 'model': 3\}\); pick a batch size divisible by data\*model"),
    (lambda: train_model(TRAIN_DESC, train_cfg(1), trainer_corpus(), CPU, mesh=_FakeMesh(2, 2)),
     "mesh 2x2 needs 4 processes; the process group has 1"),
    (lambda: train_model(TRAIN_DESC, train_cfg(1), trainer_corpus(), CPU,
                         on_device_sampling=True, shard_corpus=True),
     "shard_corpus requires a mesh"),
    (lambda: distributed.initialize(backend="mpi"), "backend must be 'nccl' or 'gloo'"),
    (lambda: distributed.initialize("localhost:1", 2, backend="gloo"),
     "coordinator_address, num_processes and process_id together"),
    (lambda: distributed.initialize("localhost:1", 2, 0, backend="nccl", device="cpu"),
     "the nccl backend needs a CUDA device"),
])
def test_refusals(call, match):
    with pytest.raises(ValueError, match=match):
        call()


@pytest.mark.parametrize("batch,optimizer,match", [
    (6, "sgd", "batch_size 6 not divisible by data axis 4"),
    (6, "full_adam", "batch_size 6 not divisible by data axis 4"),
    (8, "full_adam", r"batch_size 8 not divisible by the total device count 16 \(mesh 4x4\): "
                     "the full_adam word accumulation shards the update stream over every "
                     "mesh axis"),
])
def test_trainer_divisibility_errors(monkeypatch, batch, optimizer, match):
    """The JAX trainer's messages, before anything is built."""
    monkeypatch.setattr(distributed, "process_count", lambda: 16)
    with pytest.raises(ValueError, match=match):
        train_model(TRAIN_DESC, train_cfg(1, optimizer, batch_size=batch), trainer_corpus(), CPU,
                    mesh=_FakeMesh(4, 4))


def test_pool_must_divide_over_the_data_axis():
    sc = with_inputs(STEP_SCENARIOS[STEP_NAMES.index("sgd-pooled")], 5)
    params = params_from_numpy(sc["params"])
    batch = pmesh.local_batch(_FakeMesh(3, 1), worker.port_batch(
        {k: np.concatenate([v, v, v])[:48] for k, v in sc["batches"][0].items()}, None))
    with pytest.raises(ValueError, match="pool size 8 not divisible by data axis 3"):
        tstep.obj.text_entity_cost_and_grads_pooled(
            params, batch, torch.arange(POOL), K, sc["desc"], mesh=_FakeMesh(3, 1))
