"""``cunvsm-torch-train`` and ``cunvsm-torch-query`` against the JAX
package's ``cunvsm-train`` and ``cunvsm-query``, on the CPU.

* both train commands on one tiny JSONL corpus with ``--reference_rng``
  (``--device cpu`` for the port): every HDF5 table within 1e-5 in float32
  after 4 epochs, and ``_meta`` and the sidecars byte for byte equal;
* both query commands on the port's model: the same documents in the same
  order in every top 10 and scores within 1e-5, for float32 and bfloat16
  scoring, with an int, ``all`` or a qrels file as ``--top_k``, several
  topic files, ``--rerank_exact_matching_documents --corpus``, the
  stemmers and the query-side options;
* ``python -m cunvsm_torch.cli.train`` and ``.query`` run as modules;
* the refusals: ``--seed 0`` exits 1 and ``--device cuda`` fails without
  a card (the multi-device flags: tests/test_torch_parallel.py).
"""

import json
import os
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

from cunvsm_tpu.cli import query as jquery
from cunvsm_tpu.cli import train as jtrain
from cunvsm_torch.cli import query as tquery
from cunvsm_torch.cli import train as ttrain
from cunvsm_torch.io.trec import read_run

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOPICS = {
    "space": "rocket orbit launch satellite astronaut".split(),
    "food": "recipe oven flour butter bake".split(),
    "sport": "goal match player referee stadium".split(),
}
EPOCHS = 4
TRAIN_FLAGS = [
    "--num_epochs", str(EPOCHS), "--batch_size", "16", "--window_size", "4",
    "--num_random_entities", "3", "--word_repr_size", "10", "--entity_repr_size", "8",
    "--update_method", "full_adam", "--nonlinearity", "tanh", "--max_vocabulary_size", "0",
    "--min_document_frequency", "0", "--max_document_frequency", "0", "--seed", "3",
    "--learning_rate", "0.02", "--reference_rng",
]


@pytest.fixture(scope="module")
def corpus_file(tmp_path_factory):
    rng = np.random.RandomState(0)
    path = tmp_path_factory.mktemp("corpus") / "docs.jsonl"
    with open(path, "w") as f:
        for topic, words in TOPICS.items():
            for i in range(4):
                body = " ".join(words[rng.randint(len(words))] if rng.rand() < 0.8 else "the"
                                for _ in range(16))
                f.write(json.dumps({"id": f"{topic}_{i}", "text": body}) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def models(corpus_file, tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    jprefix, tprefix = str(d / "jax"), str(d / "torch")
    assert jtrain.main([corpus_file, "--output", jprefix, *TRAIN_FLAGS]) == 0
    assert ttrain.main([corpus_file, "--output", tprefix, "--device", "cpu", *TRAIN_FLAGS]) == 0
    return jprefix, tprefix


def test_train_commands_write_the_same_model(models):
    jprefix, tprefix = models
    with h5py.File(f"{jprefix}_{EPOCHS}.hdf5", "r") as j, h5py.File(f"{tprefix}_{EPOCHS}.hdf5",
                                                                    "r") as t:
        assert set(j) == set(t) and len(t) == 4
        for name in j:
            assert t[name].dtype == j[name].dtype == np.float32
            np.testing.assert_allclose(t[name][()], j[name][()], rtol=1e-5, atol=1e-5)
            assert not np.array_equal(t[name][()], np.zeros_like(t[name][()]))
    for suffix in ("_meta", "_vocab.txt", "_docnos.txt"):
        with open(jprefix + suffix, "rb") as a, open(tprefix + suffix, "rb") as b:
            assert a.read() == b.read(), suffix
    assert sorted(f for f in os.listdir(os.path.dirname(tprefix)) if f.startswith("torch")) == \
        sorted(f.replace("jax", "torch") for f in os.listdir(os.path.dirname(jprefix))
               if f.startswith("jax"))


def _topics(tmp_path, name, lines):
    path = tmp_path / name
    path.write_text("".join(f"{q};{text}\n" for q, text in lines))
    return str(path)


QUERY_MODES = {
    "top_k_int": lambda tmp, corpus: ["--top_k", "5"],
    "top_k_all": lambda tmp, corpus: ["--top_k", "all", "--num_queries", "2"],
    "qrels": lambda tmp, corpus: ["--top_k", _qrels(tmp)],
    "rerank_exact": lambda tmp, corpus: ["--rerank_exact_matching_documents", "--corpus", corpus],
    "porter": lambda tmp, corpus: ["--stemmer", "porter"],
    "krovetz": lambda tmp, corpus: ["--stemmer", "krovetz", "--stopwords", "lemur"],
    "linear_bias_self_information": lambda tmp, corpus: [
        "--linear", "--bias_coefficient", "1.0", "--self_information", "--l2norm_phrase"],
}
QUERIES = [("1", "rocket orbits launched"), ("2", "the oven baking butter"),
           ("3", "referee and players"), ("4", "nothing known here")]


def _qrels(tmp):
    path = tmp / "qrels.txt"
    path.write_text("1 0 space_0 1\n1 0 food_1 0\n1 0 sport_2 0\n2 0 food_3 1\n2 0 nope 1\n")
    return str(path)


def _assert_same_runs(jrun, trun):
    assert trun.keys() == jrun.keys()
    for q in jrun:
        assert len(trun[q]) == len(jrun[q])
        assert [d for d, _ in trun[q][:10]] == [d for d, _ in jrun[q][:10]], q
        np.testing.assert_allclose([s for _, s in trun[q]], [s for _, s in jrun[q]],
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("score_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", sorted(QUERY_MODES))
def test_query_commands_give_the_same_runs(models, corpus_file, tmp_path, mode, score_dtype):
    _, prefix = models
    topics = _topics(tmp_path, "topics.txt", QUERIES)
    extra = QUERY_MODES[mode](tmp_path, corpus_file)
    common = ["--topics", topics, "--model", prefix, "--epoch", str(EPOCHS),
              "--score_dtype", score_dtype, *extra]
    jout, tout = str(tmp_path / "jax.run"), str(tmp_path / "torch.run")
    assert jquery.main([*common, jout]) == 0
    assert tquery.main([*common, "--device", "cpu", tout]) == 0
    jrun, trun = read_run(jout), read_run(tout)
    assert trun and "4" not in trun
    _assert_same_runs(jrun, trun)
    with open(tout) as f:
        assert all(line.split()[-1] == "cunvsm_torch" for line in f)
    if mode == "qrels":
        assert [d for d, _ in trun["2"]] == ["food_3"] and len(trun["1"]) == 3


def test_query_writes_one_run_per_topic_file(models, tmp_path):
    _, prefix = models
    a = _topics(tmp_path, "topicsA", QUERIES[:2])
    b = _topics(tmp_path, "topicsB", QUERIES[2:])
    common = ["--topics", a, b, "--model", prefix, "--epoch", str(EPOCHS), "--top_k", "3"]
    assert jquery.main([*common, str(tmp_path / "jax")]) == 0
    assert tquery.main([*common, "--device", "cpu", str(tmp_path / "torch")]) == 0
    for name, want in (("topicsA", {"1", "2"}), ("topicsB", {"3"})):
        trun = read_run(str(tmp_path / f"torch-{name}"))
        assert set(trun) == want
        _assert_same_runs(read_run(str(tmp_path / f"jax-{name}")), trun)


def test_the_commands_run_as_modules(corpus_file, tmp_path):
    prefix = str(tmp_path / "m")
    env = dict(os.environ, PYTHONPATH=REPO)
    flags = [f for f in TRAIN_FLAGS if f != "--reference_rng"]
    flags[flags.index("--num_epochs") + 1] = "1"
    out = subprocess.run(
        [sys.executable, "-m", "cunvsm_torch.cli.train", corpus_file, "--output", prefix,
         "--device", "cpu", *flags], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert "Epoch 1: cost=" in out.stderr
    topics = _topics(tmp_path, "t.txt", QUERIES)
    run = str(tmp_path / "run")
    out = subprocess.run(
        [sys.executable, "-m", "cunvsm_torch.cli.query", "--topics", topics, "--model", prefix,
         "--epoch", "1", "--device", "cpu", run], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert set(read_run(run)) == {"1", "2", "3"}


def test_train_requires_a_positive_seed(corpus_file, tmp_path):
    flags = TRAIN_FLAGS[:]
    flags[flags.index("--seed") + 1] = "0"
    assert ttrain.main([corpus_file, "--output", str(tmp_path / "x"), "--device", "cpu",
                        *flags]) == 1
    assert not os.listdir(tmp_path)


def test_device_cuda_without_a_card_fails(corpus_file, models, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        ttrain.main([corpus_file, "--output", str(tmp_path / "x"), *TRAIN_FLAGS])
    topics = _topics(tmp_path, "t.txt", QUERIES)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tquery.main(["--topics", topics, "--model", models[1], "--epoch", "1",
                     str(tmp_path / "run")])
    assert not os.path.exists(tmp_path / "run")
