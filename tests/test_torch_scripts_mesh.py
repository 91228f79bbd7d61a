"""The port's evaluation pipelines on a 2x2 mesh: four gloo processes on the
CPU per run, launched with the ``--coordinator_address`` triple (a file
rendezvous), on the fixtures of ``tests/test_torch_scripts.py``.

* ``scripts/rank_adhoc_torch.py``, on-device with ``--shard_corpus`` and
  host-fed: ``--fail_after_epoch 2`` makes every rank leave with the
  simulated crash (none waits at a barrier: each is joined with a
  deadline), then ``--resume`` starts every rank at epoch 3 and finishes.
  The kept curve holds epochs 2 and 4, one rank wrote it and the run
  files, the best epoch is 2 or 4 and the QLM MAPs equal the JAX
  package's on the same topics to 1e-12 (``qlm_jm_prf_test_map > 0.9``,
  the bar of ``tests/test_scripts.py:287-309``).
* ``scripts/rank_cranfield_torch.py --models nvsm --quick``: the host-fed
  mesh trainer at batch 4096; the QLM run files byte for byte those of the
  JAX script, the NVSM MAP in [0, 1].
"""

import json
import os
import re
import subprocess
import sys

import pytest

from cunvsm_tpu.config import DataConfig as JDataConfig
from cunvsm_tpu.data.corpus import load_corpus as jload_corpus
from cunvsm_tpu.data.text import lemur_stopwords as jlemur_stopwords
from cunvsm_tpu.data.text import tokenize as jtokenize
from cunvsm_tpu.io.trec import read_qrels, read_topics
from cunvsm_tpu.query.metrics import evaluate_run
from cunvsm_tpu.query.qlm import build_qlm_index, qlm_rank
from tests.test_torch_scripts import ADHOC_FLAGS, adhoc_args, load_json, write_adhoc_collection

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
sys.path.insert(0, SCRIPTS)

import rank_cranfield as jcranfield  # noqa: E402

DEADLINE_SECONDS = 240
WORLD = 4
TRAINED = re.compile(r"Epoch (\d+)(?: \(on-device sampling\))?: cost")


@pytest.fixture(scope="module")
def collection(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("collection"))
    write_adhoc_collection(root)
    return root


def launch(script, argv, rendezvous):
    """Four processes of ``script`` on a 2x2 mesh; [(returncode, output)]
    of every rank, each joined with a deadline (the rest are killed when
    one is late)."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(SCRIPTS, script), *argv, "--device", "cpu",
             "--mesh", "2x2", "--coordinator_address", f"file://{rendezvous}",
             "--num_processes", str(WORLD), "--process_id", str(r)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)
    ]
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=DEADLINE_SECONDS)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, out) for p, out in zip(procs, outputs)]


def jax_qlm_test_maps(root):
    """The QLM test MAPs of the JAX package on the ad hoc test topics."""
    corpus = jload_corpus(JDataConfig(corpus_path=os.path.join(root, "corpus.trectext"),
                                      max_vocabulary_size=65536, min_document_frequency=0,
                                      max_document_frequency=0.5), 10)
    with open(os.path.join(root, "splits", "test")) as f:
        test = {line.strip() for line in f if line.strip()}
    stop = jlemur_stopwords()
    queries = {q: jtokenize(t, stop) for q, t in read_topics(os.path.join(root, "topics.txt")).items()
               if q in test}
    qrels = {q: r for q, r in read_qrels(os.path.join(root, "qrels.txt")).items() if q in test}
    index = build_qlm_index(corpus)
    return {f"qlm_{s}_prf_test_map": evaluate_run(qlm_rank(index, queries, smoothing=s, prf=True),
                                                  qrels, measures=("map",))["map"]
            for s in ("jm", "dirichlet")}


ADHOC_PATHS = {
    "on_device_shard_corpus": ["--on_device_sampling", "--shard_corpus", "--steps_per_call", "2",
                               "--batch_size", "64"],
    "host_fed": [],
}


@pytest.mark.parametrize("path", sorted(ADHOC_PATHS))
def test_rank_adhoc_crash_and_resume_on_a_2x2_mesh(collection, tmp_path, path):
    workdir = str(tmp_path / "out")
    argv = (adhoc_args(collection, workdir) + ADHOC_FLAGS + ADHOC_PATHS[path]
            + ["--checkpoint_every", "2"])
    crashed = launch("rank_adhoc_torch.py", argv + ["--fail_after_epoch", "2"],
                     str(tmp_path / "rdv1"))
    for rank, (rc, out) in enumerate(crashed):
        assert rc != 0 and "simulated crash after epoch 2" in out, (rank, out[-4000:])
    curve_path = os.path.join(workdir, "validation_curve.jsonl")
    with open(curve_path) as f:
        assert [json.loads(line)["epoch"] for line in f] == [2]

    resumed = launch("rank_adhoc_torch.py", argv + ["--resume"], str(tmp_path / "rdv2"))
    for rank, (rc, out) in enumerate(resumed):
        assert rc == 0, (rank, out[-4000:])
    primary = resumed[0][1]
    assert "Resumed from epoch 2 at step" in primary
    assert [int(e) for e in TRAINED.findall(primary)] == [3, 4]
    assert all(not TRAINED.findall(out) for _, out in resumed[1:])  # the primary logs
    results = load_json(os.path.join(workdir, "results.json"))
    assert results["resumed"] is True and results["best_epoch"] in (2, 4)
    assert [e for e, _ in results["validation_curve"]] == [2, 4]
    with open(curve_path) as f:
        assert [json.loads(line)["epoch"] for line in f] == [2, 4]  # one writer
    assert results["qlm_jm_prf_test_map"] > 0.9
    for key, value in jax_qlm_test_maps(collection).items():
        assert abs(results[key] - value) <= 1e-12, key
    assert 0.0 <= results["nvsm_test_map"] <= 1.0
    with open(os.path.join(workdir, "nvsm_test.run")) as f:
        assert len(f.read().splitlines()) == 6 * 60


def test_rank_cranfield_host_fed_mesh_trainer(collection, tmp_path):
    """NVSM under --quick on a 2x2 mesh (batch 4096, host-fed): every rank
    finishes, the primary writes the QLM run files byte for byte as the JAX
    script does, and the report."""
    data = os.path.join(collection, "cranfield")
    jdir = str(tmp_path / "jax")
    assert jcranfield.main(["--data_dir", data, "--workdir", jdir, "--models", ""]) == 0
    workdir = str(tmp_path / "mesh")
    runs = launch("rank_cranfield_torch.py", ["--data_dir", data, "--workdir", workdir, "--quick",
                                              "--num_epochs", "2", "--models", "nvsm"],
                  str(tmp_path / "rdv"))
    for rank, (rc, out) in enumerate(runs):
        assert rc == 0, (rank, out[-4000:])
    for name in ("qlm_jm", "qlm_jm_prf", "qlm_dirichlet", "qlm_dirichlet_prf"):
        with open(os.path.join(jdir, f"{name}.run"), "rb") as f, \
                open(os.path.join(workdir, f"{name}.run"), "rb") as g:
            assert f.read() == g.read(), name
    results = load_json(os.path.join(workdir, "results.json"))
    assert sorted(k for k in results if "+" not in k) == [
        "nvsm", "qlm_dirichlet", "qlm_dirichlet_prf", "qlm_jm", "qlm_jm_prf"]
    assert all(0.0 <= v <= 1.0 for v in results.values())
    assert os.path.exists(os.path.join(workdir, "nvsm_5.hdf5"))
