"""The port's evaluation pipelines (``scripts/*_torch.py``) against their
JAX originals (``scripts/rank_adhoc.py``, ``rank_cranfield.py``,
``product_substitutability.py``) on the CPU, one device.

The fixtures are those of ``tests/test_scripts.py``: 12 topics over 60
documents (TRECTEXT, and the same documents as a two-index Indri
repository), the same files in the Cranfield layout, and a small synthetic
product fixture (``product_substitutability_torch.write_synthetic_fixture``).

* **Equal between the two packages**, where nothing is random: both
  scripts rank from one set of model files written by the JAX package's
  writer (seeded tables, d 16, or --quick's 64 -> 48): ``train_model`` is
  replaced in both by a stand-in that copies those files to the run's
  prefix and calls the epoch callback with each epoch's tables.  The
  validation curves, the selected epoch, every ``evaluate_run`` number
  (NVSM, LSE, QLM, the fusions, the grid-CV fusion) within 1e-12, the
  Cranfield QLM run files byte for byte, the model runs document for
  document (scores within 2e-6: float32 cosines of two libraries,
  printed to six decimals), and a
  resumed run's selection over a curve written before it.
* **Trained, against the JAX tests' bars** (the random streams differ by
  design): the ad hoc protocol on both corpora (``qlm_jm_prf_test_map >
  0.95``, ``nvsm_test_map > 0.3``, best epoch 2 or 4, as
  ``tests/test_scripts.py:46-69``), a crash after epoch 2 and ``--resume``
  (the resumed epoch, the kept curve), the Cranfield pipeline under
  ``--quick`` and the Mix 'n Match composite with its baseline.
* The refusals: no card without ``--device cpu``, the eval/checkpoint
  cadence, a Cranfield directory without the collection.

The mesh versions (four gloo ranks): ``tests/test_torch_scripts_mesh.py``.
"""

import json
import logging
import os
import random
import shutil
import sys

import numpy as np
import pytest
import torch

from cunvsm_tpu.config import DataConfig as JDataConfig
from cunvsm_tpu.data.corpus import build_corpus as jbuild_corpus
from cunvsm_tpu.data.corpus import load_corpus as jload_corpus
from cunvsm_tpu.data.text import iter_trectext as jiter_trectext
from cunvsm_tpu.data.text import lemur_stopwords as jlemur_stopwords
from cunvsm_tpu.io import checkpoint as jckpt
from cunvsm_tpu.models.params import ModelParams as JModelParams
from cunvsm_tpu.train import trainer as jtrainer
from cunvsm_torch.data.text import iter_trectext, tokenize
from cunvsm_torch.io import checkpoint as tckpt
from cunvsm_torch.io.trec import read_run
from tests.indri_fixture import write_repository

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")
sys.path.insert(0, SCRIPTS)

import product_substitutability as jproduct  # noqa: E402
import product_substitutability_torch as tproduct  # noqa: E402
import rank_adhoc as jadhoc  # noqa: E402
import rank_adhoc_torch as tadhoc  # noqa: E402
import rank_cranfield as jcranfield  # noqa: E402
import rank_cranfield_torch as tcranfield  # noqa: E402

torch.set_num_threads(1)
CPU = torch.device("cpu")
ADHOC_FLAGS = ["--num_epochs", "4", "--eval_every", "2", "--word_repr_size", "16",
               "--entity_repr_size", "16", "--batch_size", "256"]
MAP_ATOL = 1e-12
# Run files print six decimals: float32 cosines of two libraries that differ
# in the last bits may turn the last one.
SCORE_ATOL = 2e-6


def write_adhoc_collection(root):
    """The collection of ``tests/test_scripts.py:14-43``: 12 topics, each
    owning 5 of 60 documents salted with its query words; validation
    topics 1-6, test topics 7-12."""
    random.seed(0)
    vocab = [f"w{i}" for i in range(300)]
    with open(os.path.join(root, "corpus.trectext"), "w") as f:
        for i in range(60):
            topic_words = [vocab[(i % 12) * 20 + j] for j in range(8)]
            body = " ".join(random.choices(vocab, k=40) + topic_words * 6)
            f.write(f"<DOC>\n<DOCNO>d{i}</DOCNO>\n<TEXT>\n{body}\n</TEXT>\n</DOC>\n")
    with open(os.path.join(root, "topics.txt"), "w") as f:
        for q in range(12):
            f.write(f"{q + 1} " + " ".join(vocab[q * 20 + j] for j in range(4)) + "\n")
    with open(os.path.join(root, "qrels.txt"), "w") as f:
        for q in range(12):
            f.writelines(f"{q + 1} 0 d{i} 1\n" for i in range(60) if i % 12 == q)
    os.makedirs(os.path.join(root, "splits"), exist_ok=True)
    with open(os.path.join(root, "splits", "validation"), "w") as f:
        f.write("\n".join(str(q + 1) for q in range(6)) + "\n")
    with open(os.path.join(root, "splits", "test"), "w") as f:
        f.write("\n".join(str(q + 1) for q in range(6, 12)) + "\n")
    # The same documents as a two-index Indri repository (test_scripts.py:133).
    docs = [(d, tokenize(t, frozenset()))
            for d, t in iter_trectext(os.path.join(root, "corpus.trectext"))]
    write_repository(os.path.join(root, "repo"), [docs[:25], docs[25:]])
    # The Cranfield layout.
    cran = os.path.join(root, "cranfield")
    os.makedirs(cran)
    for src, dst in (("corpus.trectext", "cranfield.trectext"), ("topics.txt", "cranfield.topics"),
                     ("qrels.txt", "cranfield.qrel")):
        shutil.copy(os.path.join(root, src), os.path.join(cran, dst))


@pytest.fixture(scope="module")
def collection(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("collection"))
    write_adhoc_collection(root)
    return root


def adhoc_args(root, workdir, corpus="corpus.trectext"):
    return ["--corpus", os.path.join(root, corpus), "--topics", os.path.join(root, "topics.txt"),
            "--qrels", os.path.join(root, "qrels.txt"), "--splits", os.path.join(root, "splits"),
            "--workdir", workdir]


def write_jax_models(jcorpus, prefix, epochs, d_w, d_e, seed):
    """Seeded tables for ``epochs``, the ``_meta`` and the sidecars of
    ``jcorpus`` under ``prefix``, through the JAX package's writer."""
    jckpt.save_meta(jckpt.build_metadata(
        jcorpus.vocab.index_term_ids, jcorpus.vocab.term_freq, jcorpus.num_docs,
        jcorpus.vocab.total_terms, jcorpus.vocab.include_oov,
        index_object_ids=jcorpus.index_doc_ids), prefix)
    jckpt.save_corpus_sidecars(jcorpus, prefix)
    rng = np.random.RandomState(seed)
    for epoch in epochs:
        jckpt.save_model_hdf5(JModelParams(
            word_reprs=rng.randn(jcorpus.vocab.size, d_w).astype(np.float32),
            entity_reprs=rng.randn(jcorpus.num_docs, d_e).astype(np.float32),
            transform_w=(rng.randn(d_w, d_e) / np.sqrt(d_w)).astype(np.float32),
            transform_b=(0.1 * rng.randn(d_e)).astype(np.float32),
        ), prefix, epoch)


def jax_load(prefix, epoch):
    return jckpt.load_model_hdf5(prefix, epoch)


def port_load(prefix, epoch):
    return tckpt.load_model_hdf5(prefix, epoch, CPU)


class StandInTrainer:
    """``train_model`` of either package, replaced: the files under
    ``sources[<basename of the prefix>]`` are copied to the run's prefix,
    then the epoch callback gets each epoch's tables (from ``first``, the
    epoch a resumed run starts at).  Records every call's arguments."""

    def __init__(self, sources, load, first=1):
        self.sources, self.load, self.first, self.calls = sources, load, first, []

    def __call__(self, desc, cfg, corpus, *args, output_prefix=None, epoch_callback=None,
                 **kwargs):
        self.calls.append(dict(desc=desc, cfg=cfg, num_docs=corpus.num_docs, **kwargs))
        source = self.sources[os.path.basename(output_prefix or "")]
        prefix = output_prefix or source
        if output_prefix:
            base = os.path.basename(source)
            for name in os.listdir(os.path.dirname(source)):
                if name.startswith(base + "_"):
                    shutil.copy(os.path.join(os.path.dirname(source), name),
                                output_prefix + name[len(base):])
        for epoch in range(self.first, cfg.num_epochs + 1):
            if epoch_callback:
                epoch_callback(epoch, self.load(prefix, epoch), 0.0)


def assert_same_results(got, want, skip=("wall_clock_s",)):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if key in skip:
            continue
        if isinstance(value, dict):
            assert_same_results(got[key], value, skip)
        elif isinstance(value, float):
            assert abs(got[key] - value) <= MAP_ATOL, (key, got[key], value)
        elif isinstance(value, list):
            np.testing.assert_allclose(np.asarray(got[key], float), np.asarray(value, float),
                                       rtol=0, atol=MAP_ATOL, err_msg=key)
        else:
            assert got[key] == value, key


def assert_same_run(got_path, want_path):
    got, want = read_run(got_path), read_run(want_path)
    assert got.keys() == want.keys() and want
    for qid in want:
        assert [d for d, _ in got[qid]] == [d for d, _ in want[qid]], qid
        np.testing.assert_allclose([s for _, s in got[qid]], [s for _, s in want[qid]],
                                   rtol=0, atol=SCORE_ATOL)


def load_json(path):
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# The ad hoc protocol.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def adhoc_models(collection, tmp_path_factory):
    """JAX-written tables of epochs 1-4 for each corpus form, described by
    the corpus the scripts load (max df 0.5, no stopwords)."""
    out = {}
    for corpus in ("corpus.trectext", "repo"):
        jcorpus = jload_corpus(JDataConfig(corpus_path=os.path.join(collection, corpus),
                                           max_vocabulary_size=65536, min_document_frequency=0,
                                           max_document_frequency=0.5), 10)
        prefix = os.path.join(str(tmp_path_factory.mktemp("adhoc_models")), "nvsm")
        write_jax_models(jcorpus, prefix, range(1, 5), 16, 16, seed=len(out) + 7)
        out[corpus] = prefix
    return out


def run_both_adhoc(monkeypatch, collection, tmp_path, corpus, source, flags=(), first=1,
                   curve=None):
    """Both packages' ad hoc scripts from the files under ``source``;
    ``curve`` is written to each workdir's validation curve first.
    Returns the two workdirs and stand-ins."""
    out = {}
    for name, script, load, patch in (
            ("jax", jadhoc, jax_load, (jtrainer, "train_model")),
            ("torch", tadhoc, port_load, (tadhoc, "train_model"))):
        workdir = str(tmp_path / name)
        os.makedirs(workdir)
        if curve is not None:
            with open(os.path.join(workdir, "validation_curve.jsonl"), "w") as f:
                f.writelines(json.dumps({"epoch": e, "map": m}) + "\n" for e, m in curve)
        stand_in = StandInTrainer({"nvsm": source}, load, first)
        monkeypatch.setattr(*patch, stand_in)
        argv = adhoc_args(collection, workdir, corpus) + ADHOC_FLAGS + list(flags)
        assert script.main(argv + (["--device", "cpu"] if name == "torch" else [])) == 0
        out[name] = (workdir, stand_in)
    return out


@pytest.mark.parametrize("corpus", ["corpus.trectext", "repo"])
def test_rank_adhoc_equals_jax_on_one_model(monkeypatch, collection, adhoc_models, tmp_path,
                                            corpus):
    """From the same JAX-written tables: the same curve, best epoch, NVSM
    test run, QLM and fused MAPs as the JAX script, and the same options
    handed to the trainer."""
    runs = run_both_adhoc(monkeypatch, collection, tmp_path, corpus, adhoc_models[corpus],
                          flags=["--on_device_sampling", "--steps_per_call", "3",
                                 "--checkpoint_every", "2"])
    (jdir, jstand), (tdir, tstand) = runs["jax"], runs["torch"]
    want, got = load_json(os.path.join(jdir, "results.json")), load_json(os.path.join(tdir,
                                                                                     "results.json"))
    assert_same_results(got, want)
    assert [e for e, _ in got["validation_curve"]] == [2, 4]
    assert got["qlm_jm_prf_test_map"] > 0.95 and got["resumed"] is False
    assert_same_run(os.path.join(tdir, "nvsm_test.run"), os.path.join(jdir, "nvsm_test.run"))
    (jcall,), (tcall,) = jstand.calls, tstand.calls
    for key in ("on_device_sampling", "steps_per_call", "checkpoint_every", "resume",
                "shard_corpus", "mesh"):
        assert tcall[key] == jcall[key], key
    assert tcall["num_docs"] == jcall["num_docs"] == 60
    for field in ("num_epochs", "batch_size", "window_size", "num_random_entities",
                  "learning_rate", "regularization_lambda", "seed", "stream_dtype",
                  "window_sum_dtype", "negative_pool_size", "negative_pool_stride"):
        assert getattr(tcall["cfg"], field) == getattr(jcall["cfg"], field), field
    assert tcall["cfg"].adam.mode.value == jcall["cfg"].adam.mode.value
    assert tcall["desc"].nonlinearity.value == jcall["desc"].nonlinearity.value
    assert tcall["desc"].batch_normalization is jcall["desc"].batch_normalization is True


def test_rank_adhoc_resume_selects_over_the_kept_curve(monkeypatch, collection, adhoc_models,
                                                       tmp_path):
    """A --resume run keeps the curve written before the crash and selects
    over all of it: an epoch-2 point that beats every later one is the
    best epoch of both packages, and its tables are ranked."""
    runs = run_both_adhoc(monkeypatch, collection, tmp_path, "corpus.trectext",
                          adhoc_models["corpus.trectext"], flags=["--resume"], first=3,
                          curve=[(2, 0.99)])
    (jdir, _), (tdir, _) = runs["jax"], runs["torch"]
    want, got = load_json(os.path.join(jdir, "results.json")), load_json(os.path.join(tdir,
                                                                                     "results.json"))
    assert_same_results(got, want)
    assert got["best_epoch"] == 2 and got["validation_map"] == 0.99 and got["resumed"] is True
    assert [e for e, _ in got["validation_curve"]] == [2, 4]
    assert_same_run(os.path.join(tdir, "nvsm_test.run"), os.path.join(jdir, "nvsm_test.run"))


@pytest.mark.parametrize("corpus", ["corpus.trectext", "repo"])
def test_rank_adhoc_trains_to_the_jax_bars(collection, tmp_path, corpus):
    """The port's own training, held to the JAX tests' bars
    (tests/test_scripts.py:46-69, 133-167)."""
    workdir = str(tmp_path / "out")
    assert tadhoc.main(adhoc_args(collection, workdir, corpus) + ADHOC_FLAGS
                       + ["--device", "cpu"]) == 0
    results = load_json(os.path.join(workdir, "results.json"))
    assert results["qlm_jm_prf_test_map"] > 0.95
    assert results["nvsm_test_map"] > 0.3
    assert results["best_epoch"] in (2, 4)
    assert sorted(results) == sorted([
        "best_epoch", "validation_map", "validation_curve", "nvsm_test_map", "wall_clock_s",
        "num_docs", "resumed", "qlm_jm_prf_test_map", "nvsm+qlm_jm_prf_test_map",
        "qlm_dirichlet_prf_test_map", "nvsm+qlm_dirichlet_prf_test_map"])


def test_rank_adhoc_crash_and_resume(collection, tmp_path, caplog):
    """--fail_after_epoch 2 raises after epoch 2's validation with the
    checkpoint on disk; --resume starts at epoch 3, keeps the curve's
    epoch 2 and finishes; a fresh run drops a stale curve."""
    workdir = str(tmp_path / "out")
    argv = adhoc_args(collection, workdir) + ADHOC_FLAGS + ["--device", "cpu",
                                                           "--checkpoint_every", "2"]
    with pytest.raises(RuntimeError, match="simulated crash after epoch 2"):
        tadhoc.main(argv + ["--fail_after_epoch", "2"])
    curve_path = os.path.join(workdir, "validation_curve.jsonl")
    assert [e for e, _ in tadhoc.read_curve(curve_path)] == [2]
    assert os.path.exists(os.path.join(workdir, "nvsm_2.hdf5"))
    assert not os.path.exists(os.path.join(workdir, "nvsm_3.hdf5"))
    with caplog.at_level(logging.INFO):
        assert tadhoc.main(argv + ["--resume"]) == 0
    resumed = [r for r in caplog.records if r.getMessage().startswith("Resumed from epoch")]
    assert [r.getMessage() for r in resumed] == ["Resumed from epoch 2 at step 36."]
    trained = [r.args[0] for r in caplog.records if r.msg.startswith("Epoch %d%s: cost")]
    assert trained == [3, 4]
    results = load_json(os.path.join(workdir, "results.json"))
    assert results["resumed"] is True and results["best_epoch"] in (2, 4)
    assert [e for e, _ in results["validation_curve"]] == [2, 4]
    assert results["qlm_jm_prf_test_map"] > 0.95
    # A fresh run (no --resume) drops a stale curve it finds in its workdir.
    fresh = str(tmp_path / "fresh")
    os.makedirs(fresh)
    with open(os.path.join(fresh, "validation_curve.jsonl"), "w") as f:
        f.write(json.dumps({"epoch": 7, "map": 0.5}) + "\n")
    assert tadhoc.main(adhoc_args(collection, fresh) + ADHOC_FLAGS
                       + ["--device", "cpu", "--num_epochs", "2"]) == 0
    assert [e for e, _ in tadhoc.read_curve(os.path.join(fresh, "validation_curve.jsonl"))] == [2]


def test_rank_adhoc_refusals(collection, tmp_path, capsys):
    argv = adhoc_args(collection, str(tmp_path / "out")) + ADHOC_FLAGS
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device is available"):
            tadhoc.main(argv)
    with pytest.raises(SystemExit):
        tadhoc.main(argv + ["--device", "cpu", "--eval_every", "3", "--checkpoint_every", "2"])
    assert "must be a multiple of --checkpoint_every 2" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# The Cranfield pipeline.
# ---------------------------------------------------------------------------

CRANFIELD_QLM = ("qlm_jm", "qlm_jm_prf", "qlm_dirichlet", "qlm_dirichlet_prf")


@pytest.fixture(scope="module")
def cranfield_models(collection, tmp_path_factory):
    """JAX-written LSE and NVSM tables at --quick's widths (64 -> 48) for
    its 5 epochs, described by the corpus the script builds."""
    docs = list(jiter_trectext(os.path.join(collection, "cranfield", "cranfield.trectext")))
    jcorpus = jbuild_corpus(docs, JDataConfig(max_vocabulary_size=65536, min_document_frequency=0,
                                              max_document_frequency=0.5), 10,
                            stopwords=jlemur_stopwords())
    root = str(tmp_path_factory.mktemp("cranfield_models"))
    out = {}
    for seed, name in enumerate(("lse", "nvsm")):
        out[name] = os.path.join(root, name)
        write_jax_models(jcorpus, out[name], [5], 64, 48, seed=seed + 11)
    return out


def run_both_cranfield(monkeypatch, collection, tmp_path, flags, sources=None):
    out = {}
    for name, script, load, patch in (
            ("jax", jcranfield, jax_load, (jtrainer, "train_model")),
            ("torch", tcranfield, port_load, (tcranfield, "train_model"))):
        workdir = str(tmp_path / name)
        if sources is not None:
            monkeypatch.setattr(*patch, StandInTrainer(sources, load))
        argv = ["--data_dir", os.path.join(collection, "cranfield"), "--workdir", workdir, *flags]
        assert script.main(argv + (["--device", "cpu"] if name == "torch" else [])) == 0
        out[name] = workdir
    return out["jax"], out["torch"]


def test_rank_cranfield_qlm_runs_equal_jax(monkeypatch, collection, tmp_path):
    """No model trained: the four QLM run files byte for byte and the
    report's numbers equal to the JAX script's, for both PRF posteriors."""
    for posterior in ("rm1", "indri"):
        jdir, tdir = run_both_cranfield(monkeypatch, collection, tmp_path / posterior,
                                        ["--models", "", "--prf_posterior", posterior])
        for name in CRANFIELD_QLM:
            with open(os.path.join(jdir, f"{name}.run"), "rb") as f, \
                    open(os.path.join(tdir, f"{name}.run"), "rb") as g:
                assert f.read() == g.read(), (posterior, name)
        want, got = load_json(os.path.join(jdir, "results.json")), load_json(
            os.path.join(tdir, "results.json"))
        assert sorted(want) == sorted(CRANFIELD_QLM) and got == want


def test_rank_cranfield_equals_jax_on_one_model(monkeypatch, collection, cranfield_models,
                                                tmp_path):
    """LSE and NVSM ranked from the same JAX-written tables: the model runs,
    every fused MAP (alpha 0.5 with the QLM runs and an external run) and
    the grid-CV fusion's MAPs and selections as the JAX script's."""
    lexical = tmp_path / "lexical"
    lexical.mkdir()
    jdir, _ = run_both_cranfield(monkeypatch, collection, tmp_path / "qlm", ["--models", ""])
    shutil.copy(os.path.join(jdir, "qlm_jm.run"), lexical / "indri-jm.run")
    jdir, tdir = run_both_cranfield(
        monkeypatch, collection, tmp_path / "models",
        ["--quick", "--num_epochs", "2", "--grid_cv_fusion", "on", "--lexical_runs_dir",
         str(lexical)], sources=cranfield_models)
    want, got = load_json(os.path.join(jdir, "results.json")), load_json(os.path.join(tdir,
                                                                                     "results.json"))
    assert "nvsm+qlm_jm_prf_cvgrid" in want and "lse+ext_indri-jm" in want
    assert_same_results(got, want)
    for name in ("lse", "nvsm"):
        assert_same_run(os.path.join(tdir, f"{name}.run"), os.path.join(jdir, f"{name}.run"))
    assert load_json(os.path.join(tdir, "grid_cv_selections.json")) == load_json(
        os.path.join(jdir, "grid_cv_selections.json"))


def test_rank_cranfield_trains_under_quick(collection, tmp_path):
    """The port's own LSE and NVSM training under --quick (64 -> 48, 30
    epochs, batches 1024 and 4096): every number of the report in [0, 1],
    the QLM runs solve the task, NVSM ranks far above chance (about 0.12
    on this collection; the JAX tests' ad hoc bar is 0.3).  LSE is the
    reference's weak model (0.0388 on Cranfield) and is held to [0, 1]."""
    workdir = str(tmp_path / "out")
    assert tcranfield.main(["--data_dir", os.path.join(collection, "cranfield"),
                            "--workdir", workdir, "--quick", "--num_epochs", "30",
                            "--device", "cpu"]) == 0
    results = load_json(os.path.join(workdir, "results.json"))
    assert all(0.0 <= v <= 1.0 for v in results.values())
    assert all(results[name] > 0.95 for name in CRANFIELD_QLM)
    assert results["nvsm"] > 0.5
    assert not os.path.exists(os.path.join(workdir, "grid_cv_selections.json"))
    for name in ("lse", "nvsm"):
        assert os.path.exists(os.path.join(workdir, f"{name}_30.hdf5"))


def test_rank_cranfield_without_the_collection_exits_1(tmp_path, capsys):
    assert tcranfield.main(["--workdir", str(tmp_path), "--device", "cpu"]) == 1
    assert "does not hold cranfield.trectext" in capsys.readouterr().err
    assert tcranfield.main(["--data_dir", str(tmp_path), "--workdir", str(tmp_path)]) == 1


# ---------------------------------------------------------------------------
# The Mix 'n Match product protocol.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def products(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("products"))
    return tproduct.write_synthetic_fixture(root, 200, 12, relevant_per_topic=6, seed=0)


def product_args(paths, workdir):
    return ["--corpus", paths["corpus"], "--substitutes", paths["substitutes"],
            "--resources", paths["resources"], "--workdir", workdir, "--batch_size", "256",
            "--word_repr_size", "16", "--entity_repr_size", "16", "--num_epochs", "4",
            "--eval_every", "2", "--planted_split", paths["planted_split"],
            "--train_text_only_baseline"]


def test_product_protocol_equals_jax_on_one_model(monkeypatch, products, tmp_path):
    """Validation selection and the test metrics (MAP, nDCG@10, the planted
    split) from the same JAX-written tables per epoch, as the JAX script's;
    both trainers get the same configurations and the same substitute
    pairs as a similarity source (none for the text-only baseline)."""
    prefix = str(tmp_path / "models" / "m")
    os.makedirs(os.path.dirname(prefix))
    stop = str(tmp_path / "stop.txt")
    with open(stop, "w") as f:
        f.write("\n".join(sorted(jlemur_stopwords())) + "\n")
    jcorpus = jload_corpus(JDataConfig(corpus_path=products["corpus"], max_vocabulary_size=65536,
                                       min_document_frequency=2, max_document_frequency=0.5),
                           10, stop)
    write_jax_models(jcorpus, prefix, range(1, 5), 16, 16, seed=3)
    out = {}
    for name, script, load, patch in (
            ("jax", jproduct, jax_load, (jtrainer, "train_model")),
            ("torch", tproduct, port_load, (tproduct, "train_model"))):
        workdir = str(tmp_path / name)
        stand_in = StandInTrainer({"": prefix}, load)
        monkeypatch.setattr(*patch, stand_in)
        argv = product_args(products, workdir) + (["--device", "cpu"] if name == "torch" else [])
        assert script.main(argv) == 0
        out[name] = (workdir, stand_in)
    (jdir, jstand), (tdir, tstand) = out["jax"], out["torch"]
    want, got = load_json(os.path.join(jdir, "results.json")), load_json(os.path.join(tdir,
                                                                                     "results.json"))
    assert_same_results(got, want)
    assert sorted(got) == ["mix_n_match", "text_only"]
    for tag in ("mix_n_match", "text_only"):
        assert_same_run(os.path.join(tdir, f"{tag}.run"), os.path.join(jdir, f"{tag}.run"))
    for jcall, tcall in zip(jstand.calls, tstand.calls):
        for field in ("text_entity_weight", "entity_entity_weight", "batch_size", "num_epochs",
                      "seed"):
            assert getattr(tcall["cfg"], field) == getattr(jcall["cfg"], field), field
        jsim, tsim = jcall["similarity_source"], tcall["similarity_source"]
        assert (jsim is None) == (tsim is None)
        if tsim is not None:
            np.testing.assert_array_equal(tsim.ids, jsim.ids)
            np.testing.assert_array_equal(tsim.weights, jsim.weights)
            assert tsim.batch_size == jsim.batch_size
    assert tstand.calls[0]["similarity_source"] is not None
    assert tstand.calls[1]["similarity_source"] is None


def test_product_protocol_trains_the_composite(products, tmp_path, caplog):
    """The port's own training: the TEXT_ENTITY_ENTITY_ENTITY composite at
    weight 0.1 and the text-only baseline, every epoch's cost finite, the
    selected epoch one that was validated."""
    workdir = str(tmp_path / "out")
    with caplog.at_level(logging.INFO):
        assert tproduct.main(product_args(products, workdir) + ["--device", "cpu"]) == 0
    costs = [r.args[2] for r in caplog.records if r.msg.startswith("Epoch %d%s: cost")]
    assert len(costs) == 8 and np.isfinite(costs).all()
    results = load_json(os.path.join(workdir, "results.json"))
    for tag in ("mix_n_match", "text_only"):
        assert results[tag]["best_epoch"] in (2, 4)
        assert 0.0 <= results[tag]["test_map"] <= 1.0
        assert set(results[tag]["test_text_invisible"]) == {"map", "recall_1000"}
