"""The port's tools against the JAX package's on the same inputs, on the CPU.

* run fusion (``query/fusion.py``): every function of both packages on the
  same random runs and qrels, equal exactly;
* the ``combine_runs``, ``dump_vocabulary`` and ``extract_reuters`` commands
  write the same bytes as the JAX package's on the inputs of
  tests/test_cli.py; ``visualize --mode embedding_projector`` writes the same
  files, and its t-SNE mode exits with an error where scikit-learn or
  matplotlib is absent;
* ``TermBruteforcer``: the three cases of tests/test_query.py through both
  packages on carried-over parameters: the same n-grams in the same order,
  scores at rtol 1e-6 in float32;
* a ``QueryEngine`` built on CPU tensors is a snapshot: training that goes
  on in place does not change its rankings;
* the ``nvsm`` compat API: the cases of tests/test_compat.py through both
  packages on one trained checkpoint.
"""

import builtins
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cunvsm_tpu.cli import combine_runs as jcombine
from cunvsm_tpu.cli import dump_vocabulary as jdump
from cunvsm_tpu.cli import extract_reuters as jreuters
from cunvsm_tpu.cli import visualize as jvisualize
from cunvsm_tpu.compat import nvsm as jnvsm
from cunvsm_tpu.models.params import ModelParams as JModelParams
from cunvsm_tpu.query import engine as jengine
from cunvsm_tpu.query import fusion as jfusion
from cunvsm_torch.cli import combine_runs as tcombine
from cunvsm_torch.cli import dump_vocabulary as tdump
from cunvsm_torch.cli import extract_reuters as treuters
from cunvsm_torch.cli import visualize as tvisualize
from cunvsm_torch.compat import nvsm as tnvsm
from cunvsm_torch.config import DataConfig, ModelDesc, TrainConfig
from cunvsm_torch.data.corpus import build_corpus
from cunvsm_torch.io import checkpoint as tckpt
from cunvsm_torch.models.params import params_from_numpy
from cunvsm_torch.query import engine as tengine
from cunvsm_torch.query import fusion as tfusion
from cunvsm_torch.train.trainer import train_model

torch.set_num_threads(1)


# -- run fusion ---------------------------------------------------------------


def random_runs(seed, num_queries=12, num_docs=30):
    """Two runs over overlapping documents (run b lacks two queries and
    retrieves other documents) and graded qrels, one query without
    relevant documents."""
    rng = np.random.RandomState(seed)
    docs = [f"d{i}" for i in range(num_docs)]

    def run(queries, keep):
        out = {}
        for q in queries:
            chosen = [d for d in docs if rng.rand() < keep]
            out[q] = sorted(((d, float(rng.randn())) for d in chosen), key=lambda x: -x[1])
        return out

    queries = [f"q{i}" for i in range(num_queries)]
    qrels = {q: {d: int(rng.rand() < 0.25) * rng.randint(1, 3) for d in docs} for q in queries}
    qrels[queries[-1]] = {d: 0 for d in docs}
    return run(queries, 0.8), run(queries[2:], 0.6), run(queries, 0.7), qrels


@pytest.mark.parametrize("normalizer", sorted(tfusion.SCORE_NORMALIZERS))
def test_combined_run_and_fixed_alpha_match(normalizer):
    a, b, c, _ = random_runs(0)
    queries = sorted(set(a) | set(b))
    assert tfusion.compute_combined_run([a, b, c], [0.2, 0.5, 0.3], queries, normalizer) == \
        jfusion.compute_combined_run([a, b, c], [0.2, 0.5, 0.3], queries, normalizer)
    for alpha in (0.0, 0.35, 1.0):
        assert tfusion.fuse_fixed_alpha(a, b, alpha, normalizer) == \
            jfusion.fuse_fixed_alpha(a, b, alpha, normalizer)


@pytest.mark.parametrize("kw", [
    dict(num_folds=4, alpha_stepsize=0.25, seed=0),
    dict(num_folds=3, alpha_stepsize=0.1, normalizer="minmax", seed=5),
])
def test_cross_validated_fusion_matches(kw):
    a, b, c, qrels = random_runs(1)
    assert tfusion.fuse_cross_validated(a, b, qrels, **kw) == \
        jfusion.fuse_cross_validated(a, b, qrels, **kw)
    trun, tfolds = tfusion.fuse_cross_validated_grid(a, {"b": b, "c": c}, qrels, **kw)
    jrun, jfolds = jfusion.fuse_cross_validated_grid(a, {"b": b, "c": c}, qrels, **kw)
    assert trun == jrun and len(trun) > 0
    assert tfolds == jfolds and len(tfolds) == kw["num_folds"]


# -- the copied commands ------------------------------------------------------


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("mode", ["alpha", "qrel"])
def test_combine_runs_commands_write_the_same_bytes(tmp_path, mode):
    a, b = tmp_path / "a.run", tmp_path / "b.run"
    a.write_text("1 Q0 d1 1 2.0 a\n1 Q0 d2 2 1.0 a\n2 Q0 d1 1 0.5 a\n2 Q0 d4 2 0.25 a\n")
    b.write_text("1 Q0 d2 1 5.0 b\n1 Q0 d3 2 1.0 b\n2 Q0 d4 1 3.0 b\n")
    flags = ["--runs", str(a), str(b), "--score_normalizer", "minmax"]
    if mode == "alpha":
        flags += ["--alpha", "0.5"]
    else:
        qrel = tmp_path / "qrels"
        qrel.write_text("1 0 d2 1\n1 0 d1 0\n2 0 d4 1\n")
        flags += ["--qrel", str(qrel), "--num_folds", "2", "--alpha_stepsize", "0.25"]
    jout, tout = str(tmp_path / "j.run"), str(tmp_path / "t.run")
    assert jcombine.main([*flags, jout]) == 0
    assert tcombine.main([*flags, tout]) == 0
    assert _read(tout) == _read(jout) and len(_read(tout)) > 0
    # Both refuse to overwrite, and to take both or neither of the modes.
    assert tcombine.main([*flags, tout]) == jcombine.main([*flags, jout]) == 1
    assert tcombine.main(["--runs", str(a), str(b), "--score_normalizer", "minmax",
                          str(tmp_path / "x")]) == 1


def test_extract_reuters_commands_write_the_same_bytes(tmp_path):
    sgm = tmp_path / "reut.sgm"
    sgm.write_text(
        '<REUTERS NEWID="1"><TOPICS><D>grain</D></TOPICS>'
        "<TITLE>Wheat prices</TITLE><BODY>Wheat rose today.</BODY>"
        "</REUTERS>\n"
        '<REUTERS NEWID="2"><TOPICS><D>oil</D><D>grain</D></TOPICS>'
        "<TITLE>Oil news</TITLE><BODY>Oil &amp; gas fell.</BODY></REUTERS>\n"
        '<REUTERS NEWID="3"><TOPICS></TOPICS><TITLE>No topic</TITLE>'
        "<BODY>Nothing.</BODY></REUTERS>\n"
    )
    outs = {}
    for name, module in (("j", jreuters), ("t", treuters)):
        prefix, classes = str(tmp_path / f"{name}_out"), str(tmp_path / f"{name}_classes.txt")
        assert module.main([str(sgm), "--trectext_out_prefix", prefix,
                            "--document_classification_out", classes]) == 0
        outs[name] = (_read(prefix + "_0.trectext"), _read(classes))
    assert outs["t"] == outs["j"]
    assert outs["t"][1].decode().splitlines()[1] == "1 oil"


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One checkpoint of the port's trainer (tests/test_compat.py's
    corpus and configuration), which both packages then load."""
    rng = np.random.RandomState(0)
    topics = {
        "space": "rocket orbit launch satellite astronaut".split(),
        "food": "recipe oven flour butter bake".split(),
    }
    docs = []
    for t, words in topics.items():
        for i in range(5):
            docs.append((f"{t}_{i}", " ".join(words[rng.randint(len(words))] for _ in range(20))))
    corpus = build_corpus(
        docs,
        DataConfig(max_vocabulary_size=0, min_document_frequency=0, max_document_frequency=0),
        window_size=4,
    )
    desc = ModelDesc(word_repr_size=16, entity_repr_size=12)
    cfg = TrainConfig(num_epochs=10, batch_size=16, window_size=4, num_random_entities=3,
                      learning_rate=0.01, seed=1)
    prefix = str(tmp_path_factory.mktemp("tools") / "m")
    train_model(desc, cfg, corpus, torch.device("cpu"), output_prefix=prefix)
    return prefix, corpus


def test_dump_vocabulary_commands_write_the_same_bytes(trained, tmp_path):
    prefix, corpus = trained
    jout, tout = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    assert jdump.main(["--model", prefix, jout]) == 0
    assert tdump.main(["--model", prefix, tout]) == 0
    assert _read(tout) == _read(jout)
    assert "rocket" in _read(tout).decode().split()


@pytest.mark.parametrize("flags", [
    [], ["--l2_normalize", "--limit", "6"], ["--filter_unclassified"],
])
def test_visualize_projector_files_match(trained, tmp_path, flags):
    prefix, corpus = trained
    classes = tmp_path / "classes.txt"
    classes.write_text("".join(f"{d} {d.split('_')[0]}\n" for d in corpus.docnos[1:]))
    common = ["--model", prefix, "--epoch", "10", "--mode", "embedding_projector",
              "--object_classification", str(classes), *flags]
    jout, tout = str(tmp_path / "j"), str(tmp_path / "t")
    assert jvisualize.main([*common, "--plot_out", jout]) == 0
    assert tvisualize.main([*common, "--device", "cpu", "--plot_out", tout]) == 0
    for suffix in ("_tensors.tsv", "_metadata.tsv"):
        assert _read(tout + suffix) == _read(jout + suffix), suffix
    rows = _read(tout + "_metadata.tsv").decode().splitlines()
    assert rows[0] == "docno\tclass" and len(rows) > 1


def test_visualize_tsne_without_its_packages_exits_with_an_error(trained, tmp_path, monkeypatch):
    """The t-SNE mode imports scikit-learn and matplotlib only when it
    runs; where either is absent it exits with a message that names the
    mode which needs neither."""
    prefix, _ = trained
    real_import = builtins.__import__

    def no_plotting(name, *args, **kwargs):
        if name.split(".")[0] in ("matplotlib", "sklearn"):
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_plotting)
    with pytest.raises(SystemExit, match="embedding_projector"):
        tvisualize.main(["--model", prefix, "--epoch", "10", "--device", "cpu",
                         "--plot_out", str(tmp_path / "plot.png")])
    assert not os.path.exists(tmp_path / "plot.png")


def test_visualize_device_cuda_without_a_card_fails(trained, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        tvisualize.main(["--model", trained[0], "--epoch", "10", "--mode", "embedding_projector",
                         "--plot_out", str(tmp_path / "p")])


# -- the engine's snapshot and TermBruteforcer ---------------------------------

TERMS = ["alpha", "beta", "gamma", "delta", "eps", "zeta"]
DOCNOS = [f"d{i}" for i in range(5)]


def engine_params(dtype=np.float32):
    rng = np.random.RandomState(0)
    return JModelParams(
        word_reprs=rng.randn(6, 4).astype(dtype), entity_reprs=rng.randn(5, 3).astype(dtype),
        transform_w=rng.randn(4, 3).astype(dtype), transform_b=rng.randn(3).astype(dtype),
    )


def both_engines(**kw):
    np_params = engine_params()
    j = jengine.QueryEngine(JModelParams(*(jnp.asarray(x) for x in np_params)), TERMS, DOCNOS, **kw)
    t = tengine.QueryEngine(params_from_numpy(np_params), TERMS, DOCNOS, **kw)
    return j, t, np_params


@pytest.mark.parametrize("bias_coefficient", [0.0, 1.0])
def test_engine_on_cpu_tensors_is_a_snapshot(bias_coefficient):
    """Rank, change every table in place as a training step does, rank
    again: a built engine answers as before."""
    params = params_from_numpy(engine_params())
    engine = tengine.QueryEngine(params, TERMS, DOCNOS, bias_coefficient=bias_coefficient)
    queries = {"q1": ["alpha", "gamma"], "q2": ["zeta"]}
    before = engine.rank(queries, top_k=5)
    related = engine.related_terms("beta", k=3)
    params.word_reprs.add_(1.0)
    params.entity_reprs.mul_(-1.0)
    params.transform_w.mul_(0.5)
    params.transform_b.add_(3.0)
    assert engine.rank(queries, top_k=5) == before
    assert engine.related_terms("beta", k=3) == related
    moved = tengine.QueryEngine(params, TERMS, DOCNOS, bias_coefficient=bias_coefficient)
    assert moved.rank(queries, top_k=5) != before


BRUTEFORCER_CASES = {
    "cardinality_1": dict(max_ngram_cardinality=1),
    "full_vocabulary": dict(max_ngram_cardinality=1, max_terms=2),
    "cardinality_2_cap": dict(max_ngram_cardinality=2, max_terms=3),
    "cardinality_3": dict(max_ngram_cardinality=3, max_terms=4),
}


@pytest.mark.parametrize("frequencies", [False, True])
@pytest.mark.parametrize("case", sorted(BRUTEFORCER_CASES))
def test_term_bruteforcer_matches_jax(case, frequencies):
    kw = dict(term_frequencies=np.array([5, 9, 9, 1, 7, 3])) if frequencies else {}
    j, t, np_params = both_engines(**kw)
    jbf = jengine.TermBruteforcer(j, **BRUTEFORCER_CASES[case])
    tbf = tengine.TermBruteforcer(t, **BRUTEFORCER_CASES[case])
    assert tbf.ngrams == jbf.ngrams
    assert [g for g in tbf.ngrams if len(g) == 1] == [(term,) for term in TERMS]
    np.testing.assert_allclose(tbf._projected_norm.numpy(), np.asarray(jbf._projected_norm),
                               rtol=1e-6, atol=1e-7)
    targets = [t.infer(np_params.word_reprs[i]) for i in range(len(TERMS))]
    pairs = [g for g in tbf.ngrams if len(g) == 2]
    if pairs:
        ids = [t.term_to_id[x] for x in pairs[0]]
        targets.append(t.infer(np_params.word_reprs[ids].mean(axis=0)))
    for i, target in enumerate(targets):
        jtop, ttop = jbf.nearest_ngrams(target, k=4), tbf.nearest_ngrams(target, k=4)
        assert [g for g, _ in ttop] == [g for g, _ in jtop]
        np.testing.assert_allclose([s for _, s in ttop], [s for _, s in jtop], rtol=1e-6)
        # The nearest n-gram to an n-gram's own projection is that n-gram.
        want = (TERMS[i],) if i < len(TERMS) else pairs[0]
        assert ttop[0][0] == want
    assert len(tbf.nearest_ngrams(targets[0], k=1000)) == len(tbf.ngrams)


# -- the nvsm compat API -------------------------------------------------------


@pytest.fixture(scope="module")
def both_models(trained):
    prefix, corpus = trained
    j = jnvsm.load_model(jnvsm.load_meta(prefix), prefix, 10)
    t = tnvsm.load_model(tnvsm.load_meta(prefix), prefix, 10, device="cpu")
    return j, t, corpus


def _index_ids(corpus, terms):
    t2i = corpus.vocab.term_to_id
    return [int(corpus.vocab.index_term_ids[t2i[t]]) for t in terms]


def test_compat_meta_matches(trained):
    prefix, corpus = trained
    j, t = jnvsm.load_meta(prefix), tnvsm.load_meta(prefix)
    assert isinstance(t, tckpt.Metadata)
    assert t.total_terms == j.total_terms == corpus.vocab.total_terms
    assert [(x.index_term_id, x.model_term_id, x.term_frequency) for x in t.term] == \
        [(x.index_term_id, x.model_term_id, x.term_frequency) for x in j.term]
    assert [(x.index_object_id, x.model_object_id) for x in t.object] == \
        [(x.index_object_id, x.model_object_id) for x in j.object]


def test_compat_attributes_match(both_models):
    j, t, corpus = both_models
    assert t.num_terms == j.num_terms == corpus.vocab.size
    assert t.num_objects == j.num_objects == corpus.num_docs
    assert (t.term_repr_size, t.object_repr_size) == (j.term_repr_size, j.object_repr_size) == (16, 12)
    for name in ("word_representations", "object_representations", "transform_matrix",
                 "transform_bias"):
        tv, jv = getattr(t, name), getattr(j, name)
        assert isinstance(tv, np.ndarray) and tv.dtype == jv.dtype
        np.testing.assert_array_equal(tv, jv)
    for name in ("term_mapping", "inv_term_mapping", "inv_term_id_to_term_freq",
                 "object_mapping", "inv_object_mapping", "total_terms"):
        assert getattr(t, name) == getattr(j, name), name
    assert repr(t) == repr(j) and "NVSM" in repr(t)
    assert tnvsm.LSE is tnvsm.NVSM
    np.testing.assert_array_equal(t.get_average_object_repr(), j.get_average_object_repr())
    np.testing.assert_array_equal(t.get_average_word_repr(), j.get_average_word_repr())


def test_compat_attributes_are_copies(trained):
    """The array attributes own their memory: changing one changes neither
    the engine's tables nor another attribute."""
    prefix, corpus = trained
    t = tnvsm.load_model(tnvsm.load_meta(prefix), prefix, 10, device="cpu", bias_coefficient=1.0)
    ids = _index_ids(corpus, ["rocket", "orbit"])
    before = t.query(ids, top_k=5)
    t.object_representations[:] = 0.0
    t.transform_matrix[:] = 0.0
    t.transform_bias[:] = 7.0
    assert t.query(ids, top_k=5) == before


def test_compat_representations_and_infer_match(both_models):
    j, t, corpus = both_models
    ids = _index_ids(corpus, ["rocket", "oven"])
    np.testing.assert_array_equal(t.get_word_repr(ids[0]), j.get_word_repr(ids[0]))
    assert t.get_word_repr(999999) is None and t.query_representation([999999]) is None
    tr, jr = t.query_representation(ids + [999999]), j.query_representation(ids + [999999])
    np.testing.assert_allclose(tr, jr, rtol=1e-6)
    np.testing.assert_allclose(t.infer(tr), j.infer(jr), rtol=1e-6)
    assert t.infer(tr).shape == (12,) and t.infer(None) is None


@pytest.mark.parametrize("kw", [
    dict(), dict(nonlinearity=None, bias_coefficient=1.0),
    dict(self_information=True, strict=True, nonlinearity=np.tanh),
])
def test_compat_query_and_score_documents_match(trained, kw):
    prefix, corpus = trained
    j = jnvsm.load_model(jnvsm.load_meta(prefix), prefix, 10, **kw)
    t = tnvsm.load_model(tnvsm.load_meta(prefix), prefix, 10, device="cpu", **kw)
    ids = _index_ids(corpus, ["rocket", "orbit"])
    tq, jq = t.query(ids, top_k=5), j.query(ids, top_k=5)
    assert [o for o, _ in tq] == [o for o, _ in jq] and len(tq) == 5
    np.testing.assert_allclose([s for _, s in tq], [s for _, s in jq], rtol=0, atol=1e-6)
    assert corpus.docnos[t.inv_object_mapping[tq[0][0]]].startswith("space")
    assert t.query([999999]) is None and j.query([999999]) is None
    np.testing.assert_allclose(t.query_representation(ids), j.query_representation(ids), rtol=1e-6)
    objects = [t.object_mapping[m] for m in (0, 3, 7)] + [424242]
    ts, js = t.score_documents(ids, objects), j.score_documents(ids, objects)
    assert [o for o, _ in ts] == [o for o, _ in js] and len(ts) == 3
    np.testing.assert_allclose([s for _, s in ts], [s for _, s in js], rtol=0, atol=1e-6)
    assert t.score_documents([999999], objects) is None


def test_compat_related_terms_and_similarity_match(both_models):
    j, t, corpus = both_models
    rocket, orbit = _index_ids(corpus, ["rocket", "orbit"])
    tr, jr = t.related_terms(rocket, k=3), j.related_terms(rocket, k=3)
    assert [i for i, _ in tr] == [i for i, _ in jr] and len(tr) == 3
    np.testing.assert_allclose([s for _, s in tr], [s for _, s in jr], rtol=1e-6)
    assert t.related_terms(999999) is None
    assert t.term_similarity(rocket, orbit) == pytest.approx(j.term_similarity(rocket, orbit),
                                                             rel=1e-6)
    assert -1.0 <= t.term_similarity(rocket, orbit) <= 1.0
    assert t.term_similarity(rocket, 999999) is None
