"""The port's slice end to end on the CPU: train, rank, score; and package
hygiene.

* ``train_model`` on the three-topic corpus of tests/test_train_integration.py
  (its own copy of the generator, the same configuration) lowers the cost
  and ranks same-topic documents first (MAP > 0.8);
* ``QueryEngine.rank`` returns the JAX engine's ranking on the same tables;
* ``cunvsm_torch`` (its command-line entry points included) imports
  neither jax nor ``cunvsm_tpu``, h5py nor protobuf, and a run of both
  commands opens no file of the JAX package.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cunvsm_tpu.models.params import ModelParams as JModelParams
from cunvsm_tpu.query.engine import QueryEngine as JQueryEngine
from cunvsm_torch.config import (
    AdamConfig,
    AdamMode,
    DataConfig,
    ModelDesc,
    Nonlinearity,
    TrainConfig,
    UpdateMethod,
)
from cunvsm_torch.data.corpus import build_corpus
from cunvsm_torch.data.instances import TextEntitySource
from cunvsm_torch.models.objectives import TextEntityBatch
from cunvsm_torch.models.params import params_from_numpy, params_to_numpy
from cunvsm_torch.query.engine import QueryEngine
from cunvsm_torch.query.metrics import evaluate_run
from cunvsm_torch.train.trainer import train_model

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TOPICS = {
    "space": "rocket orbit launch satellite astronaut mission gravity".split(),
    "cooking": "recipe oven flour butter bake sugar yeast".split(),
    "sports": "goal match player referee score stadium league".split(),
}


def synthetic_corpus(num_docs_per_topic=6, doc_len=30, seed=0):
    rng = np.random.RandomState(seed)
    docs = []
    labels = {}
    common = "the and with from this that".split()
    for topic, words in TOPICS.items():
        for i in range(num_docs_per_topic):
            body = [
                words[rng.randint(len(words))]
                if rng.rand() < 0.7
                else common[rng.randint(len(common))]
                for _ in range(doc_len)
            ]
            docno = f"{topic}_{i}"
            docs.append((docno, " ".join(body)))
            labels[docno] = topic
    return docs, labels


@pytest.fixture(scope="module")
def trained():
    docs, labels = synthetic_corpus()
    corpus = build_corpus(
        docs,
        DataConfig(max_vocabulary_size=0, min_document_frequency=0, max_document_frequency=0),
        window_size=4,
    )
    desc = ModelDesc(
        word_repr_size=24, entity_repr_size=16,
        nonlinearity=Nonlinearity.TANH, bias_negative_samples=True,
    )
    cfg = TrainConfig(
        num_epochs=30, batch_size=32, window_size=4, num_random_entities=5,
        learning_rate=0.01, regularization_lambda=0.01,
        update_method=UpdateMethod.ADAM,
        adam=AdamConfig(mode=AdamMode.DENSE_UPDATE_DENSE_VARIANCE), seed=1,
    )
    return corpus, labels, cfg, train_model(desc, cfg, corpus, torch.device("cpu"))


def test_train_model_lowers_the_cost(trained):
    corpus, _, cfg, result = trained
    costs = result.epoch_costs
    assert len(costs) == cfg.num_epochs
    assert all(np.isfinite(costs))
    assert costs[-1] < 0.6 * costs[0]
    assert result.steps == cfg.num_epochs * TextEntitySource(corpus, 32).batches_per_epoch()
    assert int(result.opt_state.word.t) == result.steps + 1


def test_ranking_quality(trained):
    corpus, labels, _, result = trained
    engine = QueryEngine(result.params, corpus.vocab.terms, corpus.docnos, nonlinearity="tanh")
    run = engine.rank({t: words[:3] for t, words in TOPICS.items()}, top_k=len(corpus.docnos))
    qrels = {t: {d: int(labels[d] == t) for d in corpus.docnos} for t in TOPICS}
    metrics = evaluate_run(run, qrels, measures=("map", "p_10"))
    assert metrics["map"] > 0.8, metrics


@pytest.mark.parametrize("nonlinearity,bias,self_info", [
    ("tanh", 0.0, False), (None, 1.0, True),
])
def test_rank_matches_jax_engine(trained, nonlinearity, bias, self_info):
    corpus, _, _, result = trained
    np_params = params_to_numpy(result.params)
    kw = dict(
        term_frequencies=corpus.vocab.term_freq, total_terms=corpus.vocab.total_terms,
        nonlinearity=nonlinearity, bias_coefficient=bias, self_information=self_info,
    )
    j = JQueryEngine(JModelParams(*(jnp.asarray(x) for x in np_params)),
                     corpus.vocab.terms, corpus.docnos, **kw)
    t = QueryEngine(params_from_numpy(np_params), corpus.vocab.terms, corpus.docnos, **kw)
    rng = np.random.RandomState(0)
    terms = corpus.vocab.terms
    queries = {f"q{i}": [terms[x] for x in rng.randint(0, len(terms), 3)] for i in range(8)}
    queries["oov"] = ["not-a-term"]
    jr, tr = j.rank(queries, top_k=10), t.rank(queries, top_k=10)
    assert tr.keys() == jr.keys() and "oov" not in tr
    for q in jr:
        np.testing.assert_allclose([s for _, s in tr[q]], [s for _, s in jr[q]], rtol=0, atol=1e-6)
        assert [d for d, _ in tr[q]] == [d for d, _ in jr[q]]


@pytest.mark.parametrize("score_dtype", ["float32", "bfloat16"])
def test_engine_surface_matches_jax_engine(trained, score_dtype):
    """infer, score_documents (held to rank's scores as JAX holds them),
    related_terms and term_similarity on the same tables."""
    corpus, _, _, result = trained
    np_params = params_to_numpy(result.params)
    j = JQueryEngine(JModelParams(*(jnp.asarray(x) for x in np_params)), corpus.vocab.terms,
                     corpus.docnos, score_dtype=getattr(jnp, score_dtype))
    t = QueryEngine(params_from_numpy(np_params), corpus.vocab.terms, corpus.docnos,
                    score_dtype=getattr(torch, score_dtype))
    query = ["rocket", "oven", "goal"]
    r = t.query_representation(query)
    np.testing.assert_allclose(t.infer(r), j.infer(j.query_representation(query)), rtol=1e-6)
    docnos = corpus.docnos[::2] + ["not-a-docno"]
    ts, js = t.score_documents(query, docnos), j.score_documents(query, docnos)
    assert [d for d, _ in ts] == [d for d, _ in js] and len(ts) == len(corpus.docnos[::2])
    np.testing.assert_allclose([s for _, s in ts], [s for _, s in js], rtol=0, atol=1e-6)
    ranked = dict(t.rank({"q": query}, top_k=len(corpus.docnos))["q"])
    np.testing.assert_allclose([s for _, s in ts], [ranked[d] for d, _ in ts], rtol=0, atol=1e-6)
    assert t.score_documents(["not-a-term"], docnos) is None
    assert t.score_documents(query, ["not-a-docno"]) == []
    for term in ("rocket", "butter", "not-a-term"):
        tr, jr = t.related_terms(term, k=5), j.related_terms(term, k=5)
        assert [w for w, _ in tr] == [w for w, _ in jr]
        np.testing.assert_allclose([s for _, s in tr], [s for _, s in jr], rtol=1e-6)
    assert t.term_similarity("rocket", "orbit") == pytest.approx(
        j.term_similarity("rocket", "orbit"), rel=1e-6)
    assert t.term_similarity("rocket", "not-a-term") is None


def test_batch_from_numpy():
    docs, _ = synthetic_corpus(2)
    corpus = build_corpus(docs, DataConfig(max_vocabulary_size=0, min_document_frequency=0,
                                           max_document_frequency=0), window_size=4)
    nb = next(TextEntitySource(corpus, 8).epoch_batches())
    b = TextEntityBatch.from_numpy(nb, "cpu", torch.float64)
    assert b.features.dtype == b.labels.dtype == torch.int64
    assert b.weights.dtype == b.feature_weights.dtype == torch.float64
    np.testing.assert_array_equal(b.features.numpy(), nb.features)


FORBIDDEN = ("jax", "jaxlib", "cunvsm_tpu", "triton", "h5py", "google.protobuf", "sklearn",
             "matplotlib")
COMMANDS = ("train", "query", "combine_runs", "dump_vocabulary", "extract_reuters", "visualize")
NEW_MODULES = ("compat.nvsm", "query.fusion", "data.indri", "data.native",
               "parallel.distributed", "parallel.mesh", "parallel.query")
# Sources outside the package that run where there is no JAX: the card's
# scripts and tests, and the worker of the multi-process tests.
JAX_FREE_SOURCES = (
    "chip_smoke.py", "profile_torch_step.py",
    os.path.join("scripts", "mesh_phase_torch.py"),
    os.path.join("scripts", "collection_scale_study_torch.py"),
    os.path.join("scripts", "repeat_phase_f.py"),
    os.path.join("scripts", "run_to_run_spread_torch.py"),
    os.path.join("scripts", "rank_adhoc_torch.py"),
    os.path.join("scripts", "rank_cranfield_torch.py"),
    os.path.join("scripts", "product_substitutability_torch.py"),
    os.path.join("scripts", "visualize_reuters_torch.py"),
    os.path.join("scripts", "quality_seeds_torch.py"),
    os.path.join("scripts", "fusion_study_torch.py"),
    os.path.join("scripts", "e2e_throughput_torch.py"),
    os.path.join("scripts", "bench_query_torch.py"),
    os.path.join("scripts", "make_product_fixture_torch.py"),
    os.path.join("scripts", "make_adhoc_fixture.py"),
    os.path.join("scripts", "make_adhoc_fixture_torch.py"),
    os.path.join("tests", "indri_fixture.py"),
    os.path.join("tests", "_torch_distributed_worker.py"),
    os.path.join("tests_card", "conftest.py"), os.path.join("tests_card", "card_parity.py"),
    os.path.join("tests_card", "test_card_parallel.py"),
)


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_port_never_imports_jax():
    """Import every module of the port in a fresh interpreter and check
    that it loaded neither jax nor the JAX package, nor h5py, protobuf,
    scikit-learn or matplotlib (the card's machine has none of them), nor
    triton, which only a kernel launch imports."""
    code = (
        "import importlib, pkgutil, sys\n"
        "before = set(sys.modules)\n"
        "import cunvsm_torch\n"
        "for m in pkgutil.walk_packages(cunvsm_torch.__path__, 'cunvsm_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = sorted(m for m in set(sys.modules) - before\n"
        f"             if any(m == f or m.startswith(f + '.') for f in {FORBIDDEN!r}))\n"
        "assert not bad, bad\n"
        f"want = {{'cunvsm_torch.cli.' + c for c in {COMMANDS!r}}}\n"
        f"want |= {{'cunvsm_torch.' + m for m in {NEW_MODULES!r}}}\n"
        "assert want <= set(sys.modules), want - set(sys.modules)\n"
        "print(len([m for m in sys.modules if m.startswith('cunvsm_torch')]))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 40


def test_port_sources_name_no_jax_import():
    """The same rule read from the sources, which also holds where jax is
    already loaded: no import statement of the port names a forbidden
    package, but for triton in the kernel launcher's helper and the lazy
    plotting imports of ``cli/visualize.py`` and
    ``scripts/visualize_reuters_torch.py``."""
    import ast

    root = os.path.join(REPO, "cunvsm_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs if f.endswith(".py")]
    files += [os.path.join(REPO, f) for f in JAX_FREE_SOURCES]
    for path in files:
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root_name = name.split(".")[0]
                allowed = root_name == "triton" and path.endswith("triton_build.py")
                # The t-SNE mode's packages, imported inside the function that
                # plots and never when the module is imported.
                allowed |= (root_name in ("matplotlib", "sklearn") and node not in tree.body
                            and path.endswith((os.path.join("cli", "visualize.py"),
                                               "visualize_reuters_torch.py")))
                assert allowed or not _forbidden(name), (path, name)


def test_commands_open_no_file_of_the_jax_package(tmp_path):
    """Both commands, run in a fresh interpreter with an audit hook on
    ``open``, read no file under ``cunvsm_tpu/`` (the stoplist is the
    port's own copy) and load no forbidden package."""
    corpus = tmp_path / "docs.jsonl"
    docs, _ = synthetic_corpus(num_docs_per_topic=2, doc_len=12)
    corpus.write_text("".join(f'{{"id": "{d}", "text": "{t}"}}\n' for d, t in docs))
    topics = tmp_path / "topics.txt"
    topics.write_text("1;rocket orbit\n2;oven flour\n")
    prefix, run = str(tmp_path / "m"), str(tmp_path / "run")
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "opened = []\n"
        "sys.addaudithook(lambda e, a: opened.append(str(a[0])) if e == 'open' else None)\n"
        "from cunvsm_torch.cli import query, train\n"
        f"assert train.main([{str(corpus)!r}, '--output', {prefix!r}, '--device', 'cpu',\n"
        "    '--update_method', 'full_adam', '--nonlinearity', 'tanh', '--seed', '1',\n"
        "    '--num_epochs', '1', '--window_size', '4', '--batch_size', '8',\n"
        "    '--stopwords', 'lemur', '--min_document_frequency', '0',\n"
        "    '--max_document_frequency', '0']) == 0\n"
        f"assert query.main(['--topics', {str(topics)!r}, '--model', {prefix!r}, '--epoch', '1',\n"
        f"    '--device', 'cpu', '--stopwords', 'lemur', {run!r}]) == 0\n"
        "bad = [p for p in opened if 'cunvsm_tpu' in p]\n"
        "assert not bad, bad\n"
        "assert any(p.endswith('lemur_stoplist.txt') for p in opened)\n"
        f"bad = sorted(m for m in set(sys.modules) - before\n"
        f"             if any(m == f or m.startswith(f + '.') for f in {FORBIDDEN!r}))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert os.path.exists(run)


def test_tools_open_no_file_of_the_jax_package(tmp_path):
    """The remaining commands, the compat API and the C++ reader's build,
    run in a fresh interpreter with an audit hook on ``open``: no file
    under ``cunvsm_tpu/`` or ``native/`` is read, and no forbidden package
    is loaded."""
    docs, _ = synthetic_corpus(num_docs_per_topic=2, doc_len=12)
    corpus = tmp_path / "docs.trectext"
    corpus.write_text("".join(
        f"<DOC>\n<DOCNO> {d} </DOCNO>\n<TEXT>\n{t}\n</TEXT>\n</DOC>\n" for d, t in docs))
    prefix = str(tmp_path / "m")
    code = (
        "import os, sys\n"
        "before = set(sys.modules)\n"
        "opened = []\n"
        "sys.addaudithook(lambda e, a: opened.append(str(a[0])) if e == 'open' else None)\n"
        "from cunvsm_torch.cli import combine_runs, dump_vocabulary, query, train, visualize\n"
        "from cunvsm_torch.compat import nvsm\n"
        f"prefix, tmp = {prefix!r}, {str(tmp_path)!r}\n"
        f"assert train.main([{str(corpus)!r}, '--output', prefix, '--device', 'cpu',\n"
        "    '--update_method', 'full_adam', '--nonlinearity', 'tanh', '--seed', '1',\n"
        "    '--num_epochs', '1', '--window_size', '4', '--batch_size', '8',\n"
        "    '--accum_dtype', 'bfloat16', '--min_document_frequency', '0',\n"
        "    '--max_document_frequency', '0']) == 0\n"
        "open(tmp + '/topics.txt', 'w').write('1;rocket orbit\\n2;oven flour\\n')\n"
        "for name, flags in (('a', []), ('b', ['--score_dtype', 'bfloat16'])):\n"
        "    assert query.main(['--topics', tmp + '/topics.txt', '--model', prefix, '--epoch', '1',\n"
        "        '--device', 'cpu', *flags, tmp + '/' + name]) == 0\n"
        "assert combine_runs.main(['--runs', tmp + '/a', tmp + '/b', '--alpha', '0.5',\n"
        "    '--score_normalizer', 'standardize', tmp + '/fused']) == 0\n"
        "assert dump_vocabulary.main(['--model', prefix, tmp + '/vocab']) == 0\n"
        "assert visualize.main(['--model', prefix, '--epoch', '1', '--device', 'cpu',\n"
        "    '--mode', 'embedding_projector', '--plot_out', tmp + '/p']) == 0\n"
        "model = nvsm.load_model(nvsm.load_meta(prefix), prefix, 1, device='cpu')\n"
        "assert model.query([1, 2], top_k=3)\n"
        "sep = os.sep\n"
        "bad = [p for p in opened if 'cunvsm_tpu' in p or sep + 'native' + sep + 'corpus' in p\n"
        "       or p.endswith('native' + sep + 'libcunvsm_native.so')]\n"
        "assert not bad, bad\n"
        f"bad = sorted(m for m in set(sys.modules) - before\n"
        f"             if any(m == f or m.startswith(f + '.') for f in {FORBIDDEN!r}))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    for name in ("fused", "vocab", "p_tensors.tsv", "p_metadata.tsv"):
        assert os.path.exists(tmp_path / name), name


def test_mesh_paths_open_no_file_of_the_jax_package(tmp_path):
    """The mesh layer in a fresh interpreter with an audit hook on ``open``:
    both commands with ``--mesh 1x1`` (a single process is a 1x1 mesh), and
    the import of the multi-process tests' worker and of
    ``scripts/mesh_phase_torch.py``, read no file under ``cunvsm_tpu/`` and
    load no forbidden package."""
    corpus = tmp_path / "docs.jsonl"
    docs, _ = synthetic_corpus(num_docs_per_topic=2, doc_len=12)
    corpus.write_text("".join(f'{{"id": "{d}", "text": "{t}"}}\n' for d, t in docs))
    topics = tmp_path / "topics.txt"
    topics.write_text("1;rocket orbit\n2;oven flour\n")
    prefix, run = str(tmp_path / "m"), str(tmp_path / "run")
    code = (
        "import importlib.util, os, sys\n"
        "before = set(sys.modules)\n"
        "opened = []\n"
        "sys.addaudithook(lambda e, a: opened.append(str(a[0])) if e == 'open' else None)\n"
        "from cunvsm_torch.cli import query, train\n"
        f"assert train.main([{str(corpus)!r}, '--output', {prefix!r}, '--device', 'cpu',\n"
        "    '--update_method', 'full_adam', '--nonlinearity', 'hard_tanh',\n"
        "    '--batch_normalization', '--seed', '1', '--num_epochs', '1', '--window_size', '4',\n"
        "    '--batch_size', '8', '--min_document_frequency', '0',\n"
        "    '--max_document_frequency', '0', '--mesh', '1x1', '--on_device_sampling',\n"
        "    '--shard_corpus']) == 0\n"
        f"assert query.main(['--topics', {str(topics)!r}, '--model', {prefix!r}, '--epoch', '1',\n"
        f"    '--device', 'cpu', '--mesh', '1x1', {run!r}]) == 0\n"
        "for path in (os.path.join('tests', '_torch_distributed_worker.py'),\n"
        "             os.path.join('scripts', 'mesh_phase_torch.py')):\n"
        "    spec = importlib.util.spec_from_file_location('m', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [p for p in opened if 'cunvsm_tpu' in p]\n"
        "assert not bad, bad\n"
        f"bad = sorted(m for m in set(sys.modules) - before\n"
        f"             if any(m == f or m.startswith(f + '.') for f in {FORBIDDEN!r}))\n"
        "assert not bad, bad\n"
        "assert 'cunvsm_torch.parallel.mesh' in sys.modules\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert os.path.exists(run)


def test_pipelines_open_no_file_of_the_jax_package(tmp_path):
    """The three evaluation pipelines, run in a fresh interpreter with an
    audit hook on ``open`` (``--device cpu``, a tiny collection), read no
    file under ``cunvsm_tpu/`` and load no forbidden package."""
    from tests.test_torch_scripts import write_adhoc_collection

    root = tmp_path / "collection"
    root.mkdir()
    write_adhoc_collection(str(root))
    small = ["--word_repr_size", "8", "--entity_repr_size", "8", "--batch_size", "256",
             "--num_epochs", "2", "--eval_every", "2", "--device", "cpu"]
    adhoc = ["--corpus", str(root / "repo"), "--topics", str(root / "topics.txt"),
             "--qrels", str(root / "qrels.txt"), "--splits", str(root / "splits"),
             "--workdir", str(tmp_path / "adhoc"), *small]
    cranfield = ["--data_dir", str(root / "cranfield"), "--workdir", str(tmp_path / "cranfield"),
                 "--quick", "--num_epochs", "1", "--models", "nvsm", "--device", "cpu"]
    code = (
        "import importlib.util, os, sys\n"
        "before = set(sys.modules)\n"
        "opened = []\n"
        "sys.addaudithook(lambda e, a: opened.append(str(a[0])) if e == 'open' else None)\n"
        "def load(name):\n"
        "    spec = importlib.util.spec_from_file_location(name, os.path.join('scripts', name + '.py'))\n"
        "    module = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(module)\n"
        "    return module\n"
        "product = load('product_substitutability_torch')\n"
        f"paths = product.write_synthetic_fixture({str(tmp_path / 'products')!r}, 60, 4,\n"
        "                                        relevant_per_topic=4)\n"
        f"assert load('rank_adhoc_torch').main({adhoc!r}) == 0\n"
        f"assert load('rank_cranfield_torch').main({cranfield!r}) == 0\n"
        "assert product.main(['--corpus', paths['corpus'], '--substitutes', paths['substitutes'],\n"
        f"    '--resources', paths['resources'], '--workdir', {str(tmp_path / 'product')!r},\n"
        f"    *{small!r}]) == 0\n"
        "bad = [p for p in opened if 'cunvsm_tpu' in p]\n"
        "assert not bad, bad\n"
        f"bad = sorted(m for m in set(sys.modules) - before\n"
        f"             if any(m == f or m.startswith(f + '.') for f in {FORBIDDEN!r}))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    for path in ("adhoc/results.json", "cranfield/results.json", "product/results.json"):
        assert os.path.exists(tmp_path / path), path


def test_study_scripts_open_no_file_of_the_jax_package(tmp_path):
    """The last six scripts, run in a fresh interpreter with an audit hook
    on ``open`` (``--device cpu``, tiny inputs) and with scikit-learn and
    matplotlib absent, as on the card's machine: none reads a file under
    ``cunvsm_tpu/`` or loads a forbidden package, and the Reuters pipeline
    still writes its metrics."""
    from tests.test_torch_scripts import write_adhoc_collection
    from tests.test_torch_scripts_study import write_resources, write_reuters_sgml

    root = tmp_path / "collection"
    root.mkdir()
    write_adhoc_collection(str(root))
    write_reuters_sgml(tmp_path / "reuters.sgm")
    write_resources(str(tmp_path / "resources"))
    cran, tmp = str(root / "cranfield"), str(tmp_path)
    code = (
        "import importlib.util, os, sys\n"
        "sys.modules['sklearn'] = sys.modules['matplotlib'] = None\n"
        "before = set(sys.modules)\n"
        "opened = []\n"
        "sys.addaudithook(lambda e, a: opened.append(str(a[0])) if e == 'open' else None)\n"
        "def load(name):\n"
        "    spec = importlib.util.spec_from_file_location(name, os.path.join('scripts', name + '.py'))\n"
        "    module = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(module)\n"
        "    return module\n"
        f"tmp, cran = {tmp!r}, {cran!r}\n"
        "assert load('visualize_reuters_torch').main(['--sgm', tmp + '/reuters.sgm',\n"
        "    '--workdir', tmp + '/reuters', '--num_epochs', '2', '--batch_size', '32',\n"
        "    '--word_repr_size', '8', '--entity_repr_size', '8', '--device', 'cpu']) == 0\n"
        "assert load('quality_seeds_torch').main(['--data_dir', cran, '--out', tmp + '/q.jsonl',\n"
        "    '--config', 'auto', '--seeds', '1', '--num_epochs', '1', '--dump_runs', tmp + '/runs',\n"
        "    '--device', 'cpu']) == 0\n"
        "assert load('fusion_study_torch').main(['--data_dir', cran, '--runs_dir', tmp + '/runs',\n"
        "    '--out', tmp + '/fusion.json']) == 0\n"
        "assert load('make_product_fixture_torch').main(['--resources', tmp + '/resources',\n"
        "    '--out', tmp + '/products', '--doc_len', '16']) == 0\n"
        "assert load('e2e_throughput_torch').main(['--out', tmp + '/e2e.json', '--device', 'cpu',\n"
        "    '--num_docs', '64', '--doc_len', '16', '--batch_size', '64', '--epochs', '2',\n"
        "    '--steps_per_call', '2', '--word_repr_size', '8', '--entity_repr_size', '8',\n"
        "    '--checkpoint_every', '1', '--workdir', tmp + '/e2e']) == 0\n"
        "assert load('bench_query_torch').main(['--docs', '256', '--iters', '1', '--top_k', '10',\n"
        "    '--device', 'cpu']) == 0\n"
        "bad = [p for p in opened if 'cunvsm_tpu' in p]\n"
        "assert not bad, bad\n"
        f"bad = sorted(m for m in set(sys.modules) - before\n"
        f"             if any(m == f or m.startswith(f + '.') for f in {FORBIDDEN!r}))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    for path in ("reuters/metrics.json", "q.jsonl", "runs/nvsm_auto_s1.run", "fusion.json",
                 "products/corpus.trectext", "e2e.json", "e2e/model_2.hdf5"):
        assert os.path.exists(tmp_path / path), path
    assert os.listdir(tmp_path / "reuters" / "plots") == []


def test_rehearsal_script_runs_only_the_port():
    """``scripts/rehearse_adhoc_torch.sh`` runs the port's ad hoc script and
    the fixture generator (through its launcher), and its inline Python
    imports only the standard library."""
    import ast
    import re

    with open(os.path.join(REPO, "scripts", "rehearse_adhoc_torch.sh")) as f:
        text = f.read()
    assert "cunvsm_tpu" not in text and "jax" not in text
    scripts = re.findall(r"python3\s+(scripts/\S+\.py)", text)
    assert sorted(set(scripts)) == ["scripts/make_adhoc_fixture_torch.py",
                                    "scripts/rank_adhoc_torch.py"]
    inline = re.search(r"<<'EOF'[^\n]*\n(.*?)\nEOF\n", text, re.DOTALL).group(1)
    for node in ast.walk(ast.parse(inline)):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            for name in ([a.name for a in node.names] if isinstance(node, ast.Import)
                         else [node.module]):
                assert name.split(".")[0] in sys.stdlib_module_names, name


def test_fixture_launcher_finds_the_checkouts_tests(tmp_path):
    """``scripts/make_adhoc_fixture_torch.py`` runs the unchanged generator
    even where a regular package named ``tests`` comes first on the path
    (one is planted here), and writes the fixture."""
    shadow = tmp_path / "shadow" / "tests"
    shadow.mkdir(parents=True)
    (shadow / "__init__.py").write_text("")
    root = tmp_path / "fixture"
    env = dict(os.environ, PYTHONPATH=str(tmp_path / "shadow"))
    plain = subprocess.run(
        [sys.executable, os.path.join("scripts", "make_adhoc_fixture.py"), "--root", str(root),
         "--num_docs", "64", "--num_indexes", "2", "--num_topics", "8", "--num_queries", "8"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert plain.returncode != 0 and "tests.indri_fixture" in plain.stderr
    out = subprocess.run(
        [sys.executable, os.path.join("scripts", "make_adhoc_fixture_torch.py"), "--root",
         str(root), "--num_docs", "64", "--num_indexes", "2", "--num_topics", "8",
         "--num_queries", "8"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads((root / "fixture.json").read_text())["num_docs"] == 64
    assert sorted(os.listdir(root / "repository" / "index")) == ["0", "1"]
