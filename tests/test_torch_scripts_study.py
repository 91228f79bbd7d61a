"""The port's last scripts (``scripts/*_torch.py``) against their JAX
originals on the CPU: the Reuters visualization pipeline, the Cranfield
quality campaign, the fusion study, the end-to-end throughput and
serving-latency tools, and the product fixture.

* **The silhouette**: ``visualize_reuters_torch.cosine_silhouette`` (numpy)
  against ``sklearn.metrics.silhouette_score(metric="cosine")``, which the
  JAX script calls, within 1e-12 in float64 and 1e-5 in float32.
* **Equal between the two packages**, where nothing is random: the quality
  campaign ranks from one JAX-written model (``train_model`` replaced in
  both by a stand-in, as ``tests/test_torch_scripts.py`` does): its JSON
  lines equal but for ``minutes`` and its run files document for document;
  the fusion studies' result JSON equal on one runs directory with every
  cell; ``cv_map_fast`` within 1e-9 of both packages'; the product fixture
  byte for byte; the end-to-end script's corpus, epoch arithmetic and keys.
* **Trained**, the random streams differing by design: the Reuters pipeline
  at the JAX test's bar (``tests/test_scripts.py:247-284``: the class
  silhouette rises), with and without the plotting libraries, and the
  end-to-end script's model files read back.
"""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from cunvsm_tpu.config import DataConfig as JDataConfig
from cunvsm_tpu.data.corpus import build_corpus as jbuild_corpus
from cunvsm_tpu.data.text import iter_trectext as jiter_trectext
from cunvsm_tpu.data.text import lemur_stopwords as jlemur_stopwords
from cunvsm_tpu.query.fusion import fuse_cross_validated as jfuse_cross_validated
from cunvsm_tpu.query.metrics import evaluate_run as jevaluate_run
from cunvsm_tpu.train import trainer as jtrainer
from cunvsm_torch.io.trec import write_run
from cunvsm_torch.query.fusion import fuse_cross_validated
from cunvsm_torch.query.metrics import evaluate_run
from tests.test_torch_scripts import (
    assert_same_run,
    jax_load,
    port_load,
    write_adhoc_collection,
    write_jax_models,
)

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")
sys.path.insert(0, SCRIPTS)

import bench_query_torch as tbench_query  # noqa: E402
import e2e_throughput as je2e  # noqa: E402
import e2e_throughput_torch as te2e  # noqa: E402
import fusion_study as jfusion  # noqa: E402
import fusion_study_torch as tfusion  # noqa: E402
import make_product_fixture as jfixture  # noqa: E402
import make_product_fixture_torch as tfixture  # noqa: E402
import quality_seeds as jquality  # noqa: E402
import quality_seeds_torch as tquality  # noqa: E402
import visualize_reuters as jreuters  # noqa: E402
import visualize_reuters_torch as treuters  # noqa: E402

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def collection(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("collection"))
    write_adhoc_collection(root)
    return root


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def load_json(path):
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# The Reuters pipeline.
# ---------------------------------------------------------------------------


def seeded_embeddings(n, d, classes, dtype, seed):
    """Class centers plus noise, so the silhouette is neither 0 nor 1."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, classes, n)
    centers = rng.randn(classes, d)
    emb = centers[labels] + 1.5 * rng.randn(n, d)
    return emb.astype(dtype), [f"c{c}" for c in labels]


@pytest.mark.parametrize("case", ["unsampled", "sampled", "singleton"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_cosine_silhouette_equals_sklearn(case, dtype):
    """The numpy silhouette against scikit-learn's on the same rows, with
    the JAX script's sampling (2048 rows by RandomState(0) when n > 2048)."""
    from sklearn.metrics import silhouette_score

    n = {"unsampled": 700, "sampled": 2600, "singleton": 300}[case]
    emb, labels = seeded_embeddings(n, 12, 5, dtype, seed=n)
    if case == "singleton":
        labels[17] = "alone"
    sample = 2048 if n > 2048 else None
    want = silhouette_score(emb, labels, metric="cosine", sample_size=sample, random_state=0)
    got = treuters.cosine_silhouette(emb, labels)
    assert 0.05 < abs(want) < 0.95
    assert abs(got - want) <= (1e-12 if dtype == np.float64 else 1e-5), (got, want)


def test_cosine_silhouette_label_guard():
    """None outside 2 <= n_labels <= n - 1 (where scikit-learn raises),
    checked on the whole set before sampling."""
    emb = np.random.RandomState(0).randn(6, 3)
    assert treuters.cosine_silhouette(emb, ["a"] * 6) is None
    assert treuters.cosine_silhouette(emb, list("abcdef")) is None
    assert treuters.cosine_silhouette(emb, list("aabbcd")) is not None


def write_reuters_sgml(path):
    """The synthetic SGML of ``tests/test_scripts.py:253-266``: 24
    articles of 3 topics, each 40 words of its topic's 7."""
    import random

    random.seed(5)
    classes = ["grain", "oil", "ship"]
    arts = []
    for i in range(24):
        c = classes[i % 3]
        words = " ".join(f"{c}w{random.randint(0, 6)}" for _ in range(40))
        arts.append(f'<REUTERS NEWID="{i + 1}"><TOPICS><D>{c}</D></TOPICS>'
                    f"<TITLE>t</TITLE><BODY>{words}</BODY></REUTERS>")
    path.write_text("\n".join(arts) + "\n")


REUTERS_FLAGS = ["--num_epochs", "6", "--batch_size", "32", "--word_repr_size", "8",
                 "--entity_repr_size", "8"]


@pytest.fixture(scope="module")
def reuters_sgml(tmp_path_factory):
    path = tmp_path_factory.mktemp("reuters") / "synth.sgm"
    write_reuters_sgml(path)
    return path


def test_visualize_reuters_equals_jax_pipeline(reuters_sgml, tmp_path):
    """Both packages' scripts on the JAX test's SGML: the same labeled
    documents and classes, a curve of every epoch, the class structure
    emerging in the port's curve, and the plots and the animation."""
    out = {}
    for name, script, extra in (("jax", jreuters, []), ("torch", treuters, ["--device", "cpu"])):
        work = tmp_path / name
        assert script.main(["--sgm", str(reuters_sgml), "--workdir", str(work),
                            *REUTERS_FLAGS, *extra]) == 0
        out[name] = work
    want, got = (load_json(out[n] / "metrics.json") for n in ("jax", "torch"))
    assert sorted(got) == sorted(want)
    assert got["num_labeled_docs"] == want["num_labeled_docs"] == 24
    assert got["num_classes"] == want["num_classes"] == 3
    curve = got["class_silhouette_cosine_by_epoch"]
    assert [e for e, _ in curve] == [e for e, _ in want["class_silhouette_cosine_by_epoch"]] \
        == list(range(1, 7))
    assert curve[-1][1] > curve[0][1]
    assert (out["torch"] / "plots" / "epoch_006.png").exists()
    assert (out["torch"] / "training.gif").exists()


def test_visualize_reuters_without_plotting_libraries(reuters_sgml, tmp_path, monkeypatch,
                                                      caplog):
    """Where scikit-learn is missing (as on the card's machine): one
    warning naming it, no plot, metrics.json written, exit 0."""
    for name in ("sklearn", "sklearn.manifold"):
        monkeypatch.setitem(sys.modules, name, None)
    work = tmp_path / "work"
    assert treuters.main(["--sgm", str(reuters_sgml), "--workdir", str(work), *REUTERS_FLAGS,
                          "--device", "cpu"]) == 0
    warnings = [r.getMessage() for r in caplog.records if r.levelname == "WARNING"]
    assert len(warnings) == 1 and "sklearn" in warnings[0], warnings
    assert os.listdir(work / "plots") == []
    assert not (work / "training.gif").exists()
    metrics = load_json(work / "metrics.json")
    assert metrics["num_classes"] == 3 and len(metrics["class_silhouette_cosine_by_epoch"]) == 6


def test_visualize_reuters_refuses_without_a_card(reuters_sgml, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device is available"):
        treuters.main(["--sgm", str(reuters_sgml), "--workdir", str(tmp_path)])


# ---------------------------------------------------------------------------
# The quality campaign.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def quality_model(collection, tmp_path_factory):
    """JAX-written tables (d 16) of the corpus the campaign builds."""
    cran = os.path.join(collection, "cranfield")
    docs = list(jiter_trectext(os.path.join(cran, "cranfield.trectext")))
    jcorpus = jbuild_corpus(docs, JDataConfig(max_vocabulary_size=65536, min_document_frequency=0,
                                              max_document_frequency=0.5), 10,
                            stopwords=jlemur_stopwords())
    prefix = os.path.join(str(tmp_path_factory.mktemp("quality_model")), "nvsm")
    write_jax_models(jcorpus, prefix, [1], 16, 16, seed=21)
    return prefix


class StandInResult:
    """``train_model`` replaced: returns the model file's tables as the
    trained parameters and records each call's configuration."""

    def __init__(self, prefix, load):
        self.prefix, self.load, self.calls = prefix, load, []

    def __call__(self, desc, cfg, corpus, *args, **kwargs):
        self.calls.append(dict(desc=desc, cfg=cfg, num_docs=corpus.num_docs, **kwargs))
        return types.SimpleNamespace(params=self.load(self.prefix, 1))


@pytest.mark.parametrize("config", ["auto", "pool2048_s205"])
def test_quality_seeds_equals_jax_on_one_model(monkeypatch, collection, quality_model, tmp_path,
                                               config):
    """Both campaigns rank from the same tables: the JSON lines equal but
    for ``minutes``, the dumped runs document for document (their scores,
    float32 cosines of two libraries printed to six decimals, within
    SCORE_ATOL: the last digit turns on a few lines), and the same
    configuration handed to the trainer."""
    out = {}
    for name, script, load, patch in (
            ("jax", jquality, jax_load, (jtrainer, "train_model")),
            ("torch", tquality, port_load, (tquality, "train_model"))):
        stand_in = StandInResult(quality_model, load)
        monkeypatch.setattr(*patch, stand_in)
        lines, runs = str(tmp_path / f"{name}.jsonl"), str(tmp_path / f"{name}_runs")
        argv = ["--data_dir", os.path.join(collection, "cranfield"), "--out", lines,
                "--config", config, "--seeds", "1,2", "--num_epochs", "3", "--dump_runs", runs]
        assert script.main(argv + (["--device", "cpu"] if name == "torch" else [])) == 0
        with open(lines) as f:
            out[name] = ([json.loads(line) for line in f], runs, stand_in)
    (want, jruns, jstand), (got, truns, tstand) = out["jax"], out["torch"]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == sorted(["config", "seed", "map", "minutes",
                                                 "fusion_dirichlet_prf_map", "fusion_jm_prf_map"])
        assert {k: v for k, v in g.items() if k != "minutes"} == \
            {k: v for k, v in w.items() if k != "minutes"}
    assert sorted(os.listdir(truns)) == sorted(os.listdir(jruns)) == [
        f"nvsm_{config}_s1.run", f"nvsm_{config}_s2.run"]
    for run in os.listdir(jruns):
        assert_same_run(os.path.join(truns, run), os.path.join(jruns, run))
    for jcall, tcall in zip(jstand.calls, tstand.calls):
        for field in ("num_epochs", "batch_size", "window_size", "num_random_entities",
                      "learning_rate", "regularization_lambda", "seed", "stream_dtype",
                      "window_sum_dtype", "negative_pool_size", "negative_pool_stride"):
            assert getattr(tcall["cfg"], field) == getattr(jcall["cfg"], field), field
        assert tcall["desc"].word_repr_size == jcall["desc"].word_repr_size == 300
        assert tcall["num_docs"] == jcall["num_docs"] == 60
    assert [c["cfg"].seed for c in tstand.calls] == [1, 2]


def test_quality_seeds_without_the_collection_exits_1(tmp_path, capsys):
    argv = ["--out", str(tmp_path / "q.jsonl"), "--config", "auto", "--device", "cpu"]
    assert tquality.main(argv) == 1
    assert "does not hold cranfield.trectext" in capsys.readouterr().err
    assert tquality.main(argv + ["--data_dir", str(tmp_path)]) == 1
    assert not os.path.exists(tmp_path / "q.jsonl")


# ---------------------------------------------------------------------------
# The fusion study.
# ---------------------------------------------------------------------------


def make_runs(docs, qrels, seeds_quality):
    """Seeded runs whose relevant documents score higher by ``quality``
    (``tests/test_scripts.py:182-193``)."""
    runs = []
    for seed, quality in seeds_quality:
        r = np.random.RandomState(seed)
        run = {}
        for q in sorted(qrels):
            scores = r.rand(len(docs))
            for j, d in enumerate(docs):
                if d in qrels[q]:
                    scores[j] += quality * r.rand()
            order = np.argsort(-scores)
            run[q] = [(docs[j], float(scores[j])) for j in order]
        runs.append(run)
    return runs


@pytest.mark.parametrize("folds, step", [(5, 0.1), (4, 0.25), (20, 0.01)])
def test_cv_map_fast_equals_the_library_and_jax(folds, step):
    """The copy against the port's ``fuse_cross_validated`` +
    ``evaluate_run``, the JAX package's, and the JAX study's own."""
    rng = np.random.RandomState(3)
    docs = [f"d{i}" for i in range(40)]
    qrels = {f"q{q}": {d: 1 for d in rng.choice(docs, 6, replace=False)} for q in range(15)}
    run_a, run_b = make_runs(docs, qrels, [(1, 1.2), (2, 0.5)])
    fast = tfusion.cv_map_fast(run_a, run_b, qrels, num_folds=folds, alpha_stepsize=step)
    assert abs(fast - jfusion.cv_map_fast(run_a, run_b, qrels, num_folds=folds,
                                          alpha_stepsize=step)) < 1e-9
    if step >= 0.1:
        lib = evaluate_run(fuse_cross_validated(run_a, run_b, qrels, num_folds=folds,
                                                alpha_stepsize=step), qrels,
                           measures=("map",))["map"]
        jlib = jevaluate_run(jfuse_cross_validated(run_a, run_b, qrels, num_folds=folds,
                                                   alpha_stepsize=step), qrels,
                             measures=("map",))["map"]
        assert abs(fast - lib) < 1e-9 and abs(fast - jlib) < 1e-9, (fast, lib, jlib)


def test_fusion_study_equals_jax(collection, tmp_path, capsys):
    """Both studies on one runs directory (three runs of the collection's
    documents) with the sweep and the grid-CV cells: the same result JSON,
    printed and written."""
    cran = os.path.join(collection, "cranfield")
    qrels = {}
    with open(os.path.join(cran, "cranfield.qrel")) as f:
        for line in f:
            q, _, d, r = line.split()
            qrels.setdefault(q, {})[d] = int(r)
    runs_dir = tmp_path / "runs"
    runs_dir.mkdir()
    docs = [f"d{i}" for i in range(60)]
    for i, run in enumerate(make_runs(docs, qrels, [(1, 1.2), (2, 0.5), (3, 0.8)])):
        write_run(run, str(runs_dir / f"nvsm_s{i}.run"), "nvsm")
    out = {}
    for name, script in (("jax", jfusion), ("torch", tfusion)):
        path = str(tmp_path / f"{name}.json")
        capsys.readouterr()
        assert script.main(["--data_dir", cran, "--runs_dir", str(runs_dir), "--out", path,
                            "--sweep", "--cv_grid"]) == 0
        out[name] = (read_bytes(path), capsys.readouterr().out)
    assert out["torch"] == out["jax"]
    results = json.loads(out["torch"][0])
    assert results["num_nvsm_runs"] == 3 and len(results["prf_attribution_sweep"]) == 8
    assert {"supervised_cvgrid_jm", "supervised_cvgrid_dirichlet"} <= set(results)


def test_fusion_study_refusals(collection, tmp_path, capsys):
    assert tfusion.main(["--runs_dir", str(tmp_path)]) == 1
    assert "does not hold cranfield.trectext" in capsys.readouterr().err
    assert tfusion.main(["--data_dir", os.path.join(collection, "cranfield"),
                         "--runs_dir", str(tmp_path)]) == 1
    assert "no runs found" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# End-to-end throughput.
# ---------------------------------------------------------------------------

E2E_FLAGS = ["--num_docs", "96", "--doc_len", "24", "--batch_size", "128", "--epochs", "3",
             "--steps_per_call", "4", "--checkpoint_every", "2", "--word_repr_size", "8",
             "--entity_repr_size", "8"]


class StandInTrainer:
    """The JAX ``train_model`` replaced: calls the epoch callback for every
    epoch and returns the costs."""

    def __init__(self):
        self.calls = []

    def __call__(self, desc, cfg, corpus, **kwargs):
        self.calls.append(dict(cfg=cfg, corpus=corpus, **kwargs))
        for epoch in range(1, cfg.num_epochs + 1):
            kwargs["epoch_callback"](epoch, None, 0.5)
        return types.SimpleNamespace(epoch_costs=[0.5] * cfg.num_epochs)


@pytest.mark.parametrize("mesh", [False, True])
def test_e2e_throughput_matches_jax(monkeypatch, tmp_path, mesh):
    """The port's script at a tiny width, on one device and on a 1x1 mesh
    over a gloo group of one rank: the JAX script's keys (``device`` in
    place of ``platform``), epoch arithmetic and corpus, the trainer's
    options, finite costs, and the model files of the dump epochs."""
    stand_in = StandInTrainer()
    monkeypatch.setattr(jtrainer, "train_model", stand_in)
    jout = str(tmp_path / "jax.json")
    assert je2e.main(["--out", jout, "--platform", "cpu", *E2E_FLAGS]) == 0
    want = load_json(jout)

    calls = []

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return train_model(*args, **kwargs)

    train_model = te2e.train_model
    monkeypatch.setattr(te2e, "train_model", spy)
    tout, work = str(tmp_path / "torch.json"), str(tmp_path / "work")
    flags = ["--mesh", "1x1", "--coordinator_address", f"file://{tmp_path / 'rendezvous'}",
             "--num_processes", "1", "--process_id", "0"] if mesh else []
    assert te2e.main(["--out", tout, "--device", "cpu", "--workdir", work, *E2E_FLAGS,
                      *flags]) == 0
    got = load_json(tout)
    assert sorted(got) == sorted([k for k in want if k != "platform"] + ["device"])
    assert got["device"] == "cpu" and got["mesh"] == ("1x1" if mesh else None)
    for key in ("metric", "unit", "num_docs", "batch_size", "steps_per_call", "steps_per_epoch",
                "pairs_per_epoch", "epochs", "checkpoint_every", "shard_corpus"):
        assert got[key] == want[key], key
    assert got["steps_per_epoch"] == 96 * 15 // 128
    assert len(got["epoch_wall_s"]) == 3 and got["value"] > 0
    assert np.isfinite(got["final_cost"])
    (jcall,), (tcall,) = stand_in.calls, calls
    for key in ("on_device_sampling", "steps_per_call", "checkpoint_every", "shard_corpus"):
        assert tcall[key] == jcall[key], key
    np.testing.assert_array_equal(te2e.make_corpus(96, 24).tokens, jcall["corpus"].tokens)
    for epoch in (2, 3):
        params = port_load(os.path.join(work, "model"), epoch)
        assert params.entity_reprs.shape == (96, 8)
        assert torch.isfinite(params.word_reprs).all()
    assert not os.path.exists(os.path.join(work, "model_1.hdf5"))


def test_e2e_throughput_removes_its_own_workdir(tmp_path, monkeypatch):
    """Without --workdir the model files go to a temporary directory that
    the script removes."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    out = str(tmp_path / "out.json")
    assert te2e.main(["--out", out, "--device", "cpu", *E2E_FLAGS]) == 0
    assert os.listdir(tmp_path) == ["out.json"]


# ---------------------------------------------------------------------------
# Serving latency.
# ---------------------------------------------------------------------------


def test_bench_query_prints_and_ranks_the_cosines(capsys):
    """The script's four lines at 512 documents, and its top-k against a
    numpy argsort of the same cosines (float64)."""
    assert tbench_query.main(["--docs", "512", "--iters", "2", "--top_k", "100",
                              "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in lines] == ["E f32 Q=  1", "E f32 Q= 16",
                                                      "E bf16 Q=  1", "E bf16 Q= 16"]
    assert all(line.endswith("top-100 over 512 docs") for line in lines)
    E, W, rng = tbench_query.serve_inputs(512, 256, 300, CPU)
    for dtype, atol in ((torch.float32, 1e-6), (torch.bfloat16, 1e-6)):
        q = rng.randn(16, 300).astype(np.float32)
        scores, idx = tbench_query.serve(torch.as_tensor(q), torch.as_tensor(E).to(dtype), W,
                                         torch.zeros(256), 100)
        proj = q.astype(np.float64) @ W.numpy().astype(np.float64)
        proj /= np.linalg.norm(proj, axis=1, keepdims=True)
        e = torch.as_tensor(E).to(dtype).to(torch.float64).numpy()
        if dtype == torch.bfloat16:
            # The queries are rounded to bfloat16 as the engine rounds them.
            proj = torch.as_tensor(proj.astype(np.float32)).to(dtype).to(torch.float64).numpy()
        cos = proj @ e.T
        want = np.argsort(-cos, axis=1, kind="stable")[:, :100]
        np.testing.assert_array_equal(idx.numpy(), want)
        np.testing.assert_allclose(scores.numpy(), np.take_along_axis(cos, want, 1), rtol=0,
                                   atol=atol)


def test_bench_query_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device is available"):
        tbench_query.main(["--docs", "512"])


# ---------------------------------------------------------------------------
# The product fixture.
# ---------------------------------------------------------------------------


def write_resources(root, num_products=80, num_topics=6, seed=0):
    """A tiny resources directory in the layout of the reference's
    sports_and_outdoors: product_list, topics (id;text), graded qrels and
    the substitutes graph."""
    rng = np.random.RandomState(seed)
    os.makedirs(root)
    products = [f"B{i:05d}" for i in range(num_products)]
    with open(os.path.join(root, "product_list"), "w") as f:
        f.write("\n".join(products) + "\n")
    with open(os.path.join(root, "topics"), "w") as f:
        f.writelines(f"{q};topic{q} word{q} gear{q % 3}\n" for q in range(num_topics))
    for name, topics in (("qrel_validation", range(0, num_topics, 2)),
                         ("qrel_test", range(1, num_topics, 2))):
        with open(os.path.join(root, name), "w") as f:
            f.writelines(f"{q} 0 {p} 1.0\n" for q in topics
                         for p in rng.choice(products, 5, replace=False))
    with open(os.path.join(root, "substitutes"), "w") as f:
        f.writelines(f"{products[a]} {products[b]} 1.0\n"
                     for a, b in rng.randint(0, num_products, (40, 2)))


def test_product_fixture_equals_jax_byte_for_byte(tmp_path, monkeypatch):
    """Both scripts on one resources directory, into one output path in
    turn: every file byte for byte (the stats' wall seconds from one
    stopped clock)."""
    res = str(tmp_path / "res")
    write_resources(res)
    out = str(tmp_path / "out")
    written = {}
    for name, script in (("jax", jfixture), ("torch", tfixture)):
        monkeypatch.setattr(script, "time", types.SimpleNamespace(time=lambda: 1000.0))
        assert script.main(["--resources", res, "--out", out, "--doc_len", "20"]) == 0
        written[name] = {f: read_bytes(os.path.join(out, f)) for f in sorted(os.listdir(out))}
        os.rename(out, str(tmp_path / name))
    assert sorted(written["torch"]) == ["corpus.trectext", "fixture_stats.json",
                                        "salted_products.txt"]
    assert written["torch"] == written["jax"]
    stats = json.loads(written["torch"]["fixture_stats.json"])
    assert stats["num_products"] == 80 and stats["num_salted_relevant"] > 0
