"""The port's copied host modules against the JAX package's originals.

``cunvsm_torch`` copies its numpy host modules rather than importing them
(importing ``cunvsm_tpu`` imports jax); these tests hold the copies to the
originals: the config dataclasses and enums, the batches that
``TextEntitySource`` yields for one seed, corpus building, the synthetic
corpora, the MAP metric, the similarity streams (``load_similarities``,
``SimilaritySource``, ``repeating``, ``zip_sources``), the Lemur stoplist
file, the query stemmers (``data/stemming.py``) and the lexical rankers
(``query/qlm.py``).  Run fusion, the Indri reader and the three numpy-only
commands are copies whose text equals the original's once the package's
name is put in, and the C++ ingestion sources under ``csrc/`` equal
``native/`` byte for byte.  The ``minstd_rand0`` twin (``data/stdrng.py``) is
held to its original in tests/test_torch_reference_rng.py.
"""

import dataclasses
import enum
import os

import numpy as np
import pytest
import torch

import cunvsm_tpu.config as jconfig
import cunvsm_torch.config as tconfig
from cunvsm_tpu.data import corpus as jcorpus
from cunvsm_tpu.data import instances as jinst
from cunvsm_tpu.data import sources as jsources
from cunvsm_tpu.data import stemming as jstem
from cunvsm_tpu.data import synth as jsynth
from cunvsm_tpu.data import text as jtext
from cunvsm_tpu.query import metrics as jmetrics
from cunvsm_tpu.query import qlm as jqlm
from cunvsm_torch.data import corpus as tcorpus
from cunvsm_torch.data import instances as tinst
from cunvsm_torch.data import sources as tsources
from cunvsm_torch.data import stemming as tstem
from cunvsm_torch.data import synth as tsynth
from cunvsm_torch.data import text as ttext
from cunvsm_torch.io import trec as ttrec
from cunvsm_torch.query import metrics as tmetrics
from cunvsm_torch.query import qlm as tqlm
from tests.torch_parity import twin

torch.set_num_threads(1)


def _enum_items(module):
    return {
        name: [(m.name, m.value) for m in cls]
        for name, cls in vars(module).items()
        if isinstance(cls, type) and issubclass(cls, enum.Enum) and cls is not enum.Enum
    }


def test_config_enums_match():
    assert _enum_items(tconfig) == _enum_items(jconfig)
    assert {k: (a.value, b and b.value) for k, (a, b) in tconfig.UPDATE_METHOD_NAMES.items()} == {
        k: (a.value, b and b.value) for k, (a, b) in jconfig.UPDATE_METHOD_NAMES.items()
    }


@pytest.mark.parametrize("name", ["ModelDesc", "AdamConfig", "TrainConfig", "DataConfig"])
def test_config_fields_and_defaults_match(name):
    t, j = getattr(tconfig, name)(), getattr(jconfig, name)()
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    assert twin(t) == j


def test_config_resolution_matches():
    for kw in (
        {},
        dict(stream_dtype="bfloat16", window_sum_dtype="bfloat16"),
        dict(stream_dtype="bfloat16", cross_chip_reduce_dtype="float32"),
        dict(learning_rate=0.0, update_method=tconfig.UpdateMethod.SGD),
    ):
        t = tconfig.TrainConfig(**kw)
        j = twin(t)
        for m in ("resolved_stream_dtype", "resolved_accum_dtype",
                  "resolved_window_sum_dtype", "resolved_cross_chip_reduce_dtype",
                  "resolved_learning_rate"):
            assert getattr(t, m)() == getattr(j, m)(), m
    with pytest.raises(ValueError):
        tconfig.TrainConfig(window_sum_dtype="bfloat16")
    assert tconfig.config_to_json(tconfig.TrainConfig()) == jconfig.config_to_json(jconfig.TrainConfig())


DOCS = [
    (f"d{i}", " ".join(f"w{(i * 7 + j * 3) % 23} the and" for j in range(8 + i % 5)))
    for i in range(30)
]


def _both_corpora(window=4):
    cfg = dict(max_vocabulary_size=0, min_document_frequency=0, max_document_frequency=0)
    j = jcorpus.build_corpus(DOCS, jconfig.DataConfig(**cfg), window_size=window,
                             stopwords=jtext.lemur_stopwords())
    t = tcorpus.build_corpus(DOCS, tconfig.DataConfig(**cfg), window_size=window,
                             stopwords=ttext.lemur_stopwords())
    return j, t


def test_corpus_build_matches():
    j, t = _both_corpora()
    assert ttext.lemur_stopwords() == jtext.lemur_stopwords()
    assert t.vocab.terms == j.vocab.terms
    assert t.docnos == j.docnos
    for f in ("tokens", "doc_offsets", "index_lengths"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    np.testing.assert_array_equal(t.vocab.term_freq, j.vocab.term_freq)


@pytest.mark.parametrize("shuffle,fw", [
    (True, "uniform"), (True, "self_information"), (False, "uniform"),
])
def test_text_entity_source_batches_match(shuffle, fw):
    jc, tc = _both_corpora()
    kw = dict(batch_size=16, shuffle=shuffle, seed=5)
    js = jinst.TextEntitySource(jc, feature_weighting=jinst.FeatureWeighting(fw), **kw)
    ts = tinst.TextEntitySource(tc, feature_weighting=tinst.FeatureWeighting(fw), **kw)
    assert ts.batches_per_epoch() == js.batches_per_epoch() > 0
    for _ in range(2):  # two epochs: the RNG streams stay in step
        for jb, tb in zip(js.epoch_batches(), ts.epoch_batches(), strict=True):
            for f in ("features", "feature_weights", "labels", "weights"):
                np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f))


def test_synthetic_corpora_match():
    j = jsynth.zipf_corpus(64, 16, vocab_size=128, seed=3)
    t = tsynth.zipf_corpus(64, 16, vocab_size=128, seed=3)
    np.testing.assert_array_equal(t.tokens, j.tokens)
    np.testing.assert_array_equal(t.vocab.term_freq, j.vocab.term_freq)
    j = jsynth.uniform_corpus(8, 12, 50, window_size=4)
    t = tsynth.uniform_corpus(8, 12, 50, window_size=4)
    np.testing.assert_array_equal(t.tokens, j.tokens)


def test_metrics_and_run_io_match(tmp_path):
    rng = np.random.RandomState(0)
    docs = [f"d{i}" for i in range(40)]
    run = {f"q{q}": [(d, float(s)) for d, s in zip(docs, rng.randn(40))] for q in range(5)}
    for q in run:
        run[q].sort(key=lambda x: -x[1])
    qrels = {f"q{q}": {d: int(rng.rand() < 0.2) for d in docs} for q in range(6)}
    measures = ("map", "p_10", "ndcg_10", "recall_1000")
    assert tmetrics.evaluate_run(run, qrels, measures) == jmetrics.evaluate_run(run, qrels, measures)
    path = str(tmp_path / "run.txt")
    ttrec.write_run(run, path)
    back = ttrec.read_run(path)
    assert {q: [d for d, _ in r] for q, r in back.items()} == {q: [d for d, _ in r] for q, r in run.items()}


def test_load_similarities_matches(tmp_path):
    path = tmp_path / "sims.txt"
    path.write_text("d1 d2 0.5\n\nd3 unknown 1.0\nd2 d3 2\n  d4 d1 -0.25  \n")
    idents = {"d1": 0, "d2": 1, "d3": 2, "d4": 3}
    t = tsources.load_similarities(str(path), idents)
    j = jsources.load_similarities(str(path), idents)
    for a, b in zip(t, j):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert t[0].tolist() == [[0, 1], [1, 2], [3, 0]]
    path.write_text("d1 d2\n")
    for module in (tsources, jsources):
        with pytest.raises(ValueError, match="malformed"):
            module.load_similarities(str(path), idents)
    path.write_text("")
    assert tsources.load_similarities(str(path), idents)[0].shape == (0, 2)


@pytest.mark.parametrize("drop_remainder", [True, False])
def test_similarity_streams_match(drop_remainder):
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 50, (23, 2)).astype(np.int32)
    w = rng.rand(23).astype(np.float32)
    t = tsources.SimilaritySource(ids, w, 5, seed=7, drop_remainder=drop_remainder)
    j = jsources.SimilaritySource(ids, w, 5, seed=7, drop_remainder=drop_remainder)
    tb, jb = list(tsources.repeating(t, 3)), list(jsources.repeating(j, 3))
    assert len(tb) == len(jb) == 3 * (4 if drop_remainder else 5)
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.weights, b.weights)
    endless = tsources.repeating(
        tsources.SimilaritySource(ids, w, 5, seed=7, drop_remainder=drop_remainder))
    zipped = list(tsources.zip_sources(iter(range(9)), endless))
    assert [a for a, _ in zipped] == list(range(9))
    for (_, a), b in zip(zipped, tb):
        np.testing.assert_array_equal(a.ids, b.ids)
    with pytest.raises(ValueError):
        tsources.SimilaritySource(ids, w[:3], 5)


def test_stoplist_copy_is_the_original():
    def read(package):
        root = os.path.dirname(os.path.dirname(os.path.abspath(package.__file__)))
        with open(os.path.join(root, "resources", "lemur_stoplist.txt"), "rb") as f:
            return f.read()

    assert read(ttext) == read(jtext)
    assert len(ttext.lemur_stopwords()) == 418


WORDS = (
    "caresses ponies ties caress cats feed agreed plastered bled motoring sing "
    "conflated troubled sized hopping tanned falling hissing fizzed failing filing "
    "happy sky relational conditional rational valenci hesitanci digitizer "
    "conformabli radicalli differentli vileli analogousli vietnamization "
    "predication operator feudalism decisiveness hopefulness callousness "
    "formaliti sensitiviti sensibiliti triplicate formative formalize "
    "electriciti electrical hopeful goodness revival allowance inference "
    "airliner gyroscopic adjustable defensible irritant replacement adjustment "
    "dependent adoption homologou communism activate angulariti homologous "
    "effective bowdlerize probate rate cease controll roll a is was running "
    "studies studied flies dying lying agreement universities retrieval"
).split()


def test_stemmer_copies_match():
    assert [tstem.porter_stem(w) for w in WORDS] == [jstem.porter_stem(w) for w in WORDS]
    assert [tstem.krovetz_candidates(w) for w in WORDS] == [
        jstem.krovetz_candidates(w) for w in WORDS]
    vocab = sorted({jstem.porter_stem(w) for w in WORDS[::2]} | set(WORDS[1::3]))
    for name in ("porter", "krovetz", None):
        t, j = tstem.QueryStemmer(name, vocab), jstem.QueryStemmer(name, vocab)
        assert t.name == j.name
        assert t.stem_tokens(WORDS) == j.stem_tokens(WORDS)
    for module in (tstem, jstem):
        with pytest.raises(ValueError, match="unknown stemmer"):
            module.QueryStemmer("arabic")


def test_query_stemmer_sidecar_matches(tmp_path):
    vocab = ["run", "studi", "fli"]
    for content in (None, "porter\n", "arabic\n"):
        prefix = str(tmp_path / f"m{content and content.strip()}")
        if content is not None:
            with open(f"{prefix}_stemmer.txt", "w") as f:
                f.write(content)
        t, j = tstem.load_query_stemmer(prefix, vocab), jstem.load_query_stemmer(prefix, vocab)
        assert t.name == j.name
        assert t.stem_tokens(WORDS) == j.stem_tokens(WORDS)


def test_qlm_copies_rank_the_same():
    j, t = _both_corpora(window=1)
    jidx, tidx = jqlm.build_qlm_index(j), tqlm.build_qlm_index(t)
    assert tidx.docnos == jidx.docnos
    queries = {f"q{i}": [f"w{(i * 5 + k) % 23}" for k in range(3)] for i in range(6)}
    queries["oov"] = ["zzz"]
    for q, terms in queries.items():
        assert tqlm.tfidf_rank(tidx, terms, 7) == jqlm.tfidf_rank(jidx, terms, 7)
    for kw in (dict(smoothing="jm"), dict(smoothing="dirichlet", param=50.0),
               dict(smoothing="jm", prf=True, fb_docs=3, fb_terms=4)):
        assert tqlm.qlm_rank(tidx, queries, top_k=9, **kw) == \
            jqlm.qlm_rank(jidx, queries, top_k=9, **kw)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("module", [
    "query/fusion.py", "data/indri.py", "cli/combine_runs.py", "cli/dump_vocabulary.py",
    "cli/extract_reuters.py",
])
def test_copied_module_text_is_the_original(module):
    """The copy is the original with the package's name replaced: the
    import lines differ by that name only, and nothing else differs but
    the directory prefix of the citations of the reference's sources."""
    with open(os.path.join(REPO, "cunvsm_tpu", module)) as f:
        original = f.read()
    with open(os.path.join(REPO, "cunvsm_torch", module)) as f:
        copy = f.read()
    # (The original cites the reference's sources by an absolute path.)
    assert copy == original.replace("cunvsm_tpu", "cunvsm_torch").replace(
        "/" + "root/reference/", "")
    assert "cunvsm_tpu" not in copy and "jax" not in copy


@pytest.mark.parametrize("source", ["corpus.cpp", "indri.cpp", "corpus.h"])
def test_cpp_source_copy_is_the_original(source):
    with open(os.path.join(REPO, "native", source), "rb") as f:
        original = f.read()
    with open(os.path.join(REPO, "cunvsm_torch", "csrc", source), "rb") as f:
        assert f.read() == original


@pytest.mark.parametrize("n_devices", [0, 1, 2, 3, 4, 6, 7, 8, 9, 16, 64])
def test_default_mesh_shape_matches(n_devices):
    from cunvsm_tpu.parallel import mesh as jmesh
    from cunvsm_torch.parallel import mesh as tmesh

    assert tmesh.default_mesh_shape(n_devices) == jmesh.default_mesh_shape(n_devices)
    data, model = tmesh.default_mesh_shape(n_devices)
    assert data * model == max(n_devices, 1)


@pytest.mark.parametrize("model_axis", [1, 2, 3, 4, 8])
def test_pad_entities_matches(model_axis):
    from cunvsm_tpu.parallel import mesh as jmesh
    from cunvsm_torch.parallel import mesh as tmesh

    for n in (1, 2, 7, 8, 9, 50, 1398, 262143, 262144):
        padded = tmesh.pad_entities(n, model_axis)
        assert padded == jmesh.pad_entities(n, model_axis)
        assert padded % model_axis == 0 and 0 <= padded - n < model_axis


@pytest.mark.parametrize("n_groups", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("seed,num_docs,max_len", [(0, 40, 12), (1, 97, 40), (2, 513, 6)])
def test_token_balanced_groups_match(seed, num_docs, max_len, n_groups):
    """The data groups of the sharded corpus on a grid of collections: the
    same contiguous groups as the JAX package's, which partition the
    eligible documents."""
    from cunvsm_tpu.data import device_sampler as jds
    from cunvsm_torch.data import device_sampler as tds

    rng = np.random.RandomState(seed)
    lengths = rng.randint(1, max_len, num_docs)
    eligible = np.flatnonzero(lengths >= 4).astype(np.int32)
    want = jds._token_balanced_groups(eligible, lengths[eligible], n_groups)
    got = tds._token_balanced_groups(eligible, lengths[eligible], n_groups)
    assert len(got) == len(want) == n_groups
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.concatenate(got), eligible)


def test_token_balanced_groups_refuse_an_empty_group():
    from cunvsm_torch.data import device_sampler as tds

    with pytest.raises(ValueError, match="empty shard"):
        tds._token_balanced_groups(np.arange(2), np.asarray([100, 1]), 3)
