"""The port's Indri reader and C++ ingestion against the JAX package's.

On the synthetic repositories of tests/indri_fixture.py (one index and
several, with an indexing-time stopper):

* the file parsers (``rvl_decode_*``, ``iter_bulktree_leaves``,
  ``iter_keyfile_entries``) and ``IndriIndex`` of both packages return the
  same values;
* ``build_corpus_from_indri`` of both packages returns the same corpus
  under every option (document list, blacklist, cutoff, vocabulary
  filters, OOV): every array, the vocabulary and the docnos equal;
* the port's C++ reader (``cunvsm_torch/csrc``, built here with g++ at its
  first use) returns the port's Python reader's corpus on the same, and
  its TRECTEXT reader the Python pipeline's;
* ``load_corpus`` takes the C++ reader where it builds and the Python
  reader, with a logged warning that names g++, where it does not; a
  failed first build does not stop a later one;
* the build helper with a stand-in compiler: the flags, the hashed name
  under ``build/native/``, the move into place;
* ``cunvsm-torch-train`` and ``cunvsm-train`` on one repository write the
  same model: HDF5 within 1e-5, ``_meta`` and the sidecars byte for byte.
"""

import dataclasses
import logging
import os
import shutil
import stat
import sys

import h5py
import numpy as np
import pytest
import torch

from cunvsm_tpu.cli import train as jtrain
from cunvsm_tpu.config import DataConfig as JDataConfig
from cunvsm_tpu.data import indri as jindri
from cunvsm_torch.cli import train as ttrain
from cunvsm_torch.config import DataConfig
from cunvsm_torch.data import indri as tindri
from cunvsm_torch.data import native
from cunvsm_torch.data.corpus import build_corpus, load_corpus
from cunvsm_torch.data.text import iter_trectext, load_stopwords
from tests.indri_fixture import rvl_encode, write_repository

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STOP = ["the", "and", "over"]
WINDOW = 3


def make_docs(seed=0, num_docs=40):
    """Documents of 1-24 tokens over 60 words, some numeric, some stopped,
    some upper-case in the blacklist only."""
    rng = np.random.RandomState(seed)
    words = [f"w{i}" for i in range(50)] + ["42", "7", "x9"] + STOP + ["river", "mill", "fox", "dog"]
    return [
        (f"doc-{d:03d}", [words[rng.randint(len(words))] for _ in range(rng.randint(1, 25))])
        for d in range(num_docs)
    ]


DOCS = make_docs()


@pytest.fixture(scope="module")
def repos(tmp_path_factory):
    root = tmp_path_factory.mktemp("indri")
    single, multi = str(root / "single"), str(root / "multi")
    write_repository(single, [DOCS], stopwords=STOP)
    write_repository(multi, [DOCS[:11], DOCS[11:12], DOCS[12:30], DOCS[30:]], stopwords=STOP)
    doc_list = root / "docs.txt"
    doc_list.write_text("".join(f"{d}\n" for d, _ in DOCS[35:3:-2]))
    blacklist = root / "blacklist.txt"
    blacklist.write_text("W3\nriver\n\nFOX\n")
    return dict(single=single, multi=multi, doc_list=str(doc_list), blacklist=str(blacklist))


OPTIONS = {
    "plain": dict(),
    "document_list": dict(document_list="doc_list"),
    "blacklist": dict(term_blacklist="blacklist"),
    "cutoff": dict(documents_cutoff=9),
    "vocabulary_10": dict(max_vocabulary_size=10),
    "document_frequency": dict(min_document_frequency=3, max_document_frequency=0.5),
    "oov_and_digits": dict(include_oov=True, include_digits=True, max_vocabulary_size=20),
    "list_blacklist_cutoff": dict(document_list="doc_list", term_blacklist="blacklist",
                                  documents_cutoff=7),
}


def data_config(cls, repos, path, option):
    kw = dict(max_vocabulary_size=0, min_document_frequency=0, max_document_frequency=0)
    kw.update(OPTIONS[option])
    for key in ("document_list", "term_blacklist"):
        if key in kw:
            kw[key] = repos[kw[key]]
    return cls(corpus_path=path, **kw)


def read_lists(cfg):
    """(document_list, term_blacklist) as ``load_corpus`` reads them."""
    document_list = blacklist = None
    if cfg.document_list:
        with open(cfg.document_list) as f:
            document_list = [line.strip() for line in f if line.strip()]
    if cfg.term_blacklist:
        with open(cfg.term_blacklist) as f:
            blacklist = frozenset(line.strip().lower() for line in f if line.strip())
    return document_list, blacklist


def assert_same_corpus(a, b, index_term_ids=True, from_index=True):
    assert a.vocab.terms == b.vocab.terms
    assert a.vocab.term_to_id == b.vocab.term_to_id
    assert a.docnos == b.docnos
    assert a.vocab.total_terms == b.vocab.total_terms
    assert a.vocab.include_oov == b.vocab.include_oov
    assert a.window_size == b.window_size
    for f in ("tokens", "doc_offsets", "index_lengths", "index_doc_ids"):
        x, y = getattr(a, f), getattr(b, f)
        if f == "index_doc_ids" and not from_index:
            continue  # a corpus read from text carries none, or the model's ids
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    np.testing.assert_array_equal(a.vocab.term_freq, b.vocab.term_freq)
    if index_term_ids:
        np.testing.assert_array_equal(a.vocab.index_term_ids, b.vocab.index_term_ids)


# -- parsers and IndriIndex ----------------------------------------------------


def test_rvl_decoders_match():
    rng = np.random.RandomState(1)
    values = [0, 1, 127, 128, 16383, 16384, 2 ** 31 - 1, 2 ** 40] + rng.randint(0, 2 ** 20, 50).tolist()
    buf = b"".join(rvl_encode(int(v)) for v in values)
    pos, got = 0, []
    while pos < len(buf):
        assert tindri.rvl_decode_one(buf, pos) == jindri.rvl_decode_one(buf, pos)
        v, pos = tindri.rvl_decode_one(buf, pos)
        got.append(v)
    assert got == [int(v) for v in values]
    arr = np.frombuffer(buf, dtype=np.uint8)
    for t, j in zip(tindri.rvl_decode_all(arr), jindri.rvl_decode_all(arr)):
        np.testing.assert_array_equal(t, j)
    assert tindri.rvl_decode_all(arr)[0].tolist() == got


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_file_parsers_match(repos, kind):
    root = repos[kind]
    for name in ("frequentString", "infrequentString"):
        path = os.path.join(root, "index", "0", name)
        assert list(tindri.iter_bulktree_leaves(path)) == list(jindri.iter_bulktree_leaves(path))
    assert len(list(tindri.iter_bulktree_leaves(
        os.path.join(root, "index", "0", "infrequentString")))) > 20
    for name in ("forwardLookup0", "reverseLookup0"):
        path = os.path.join(root, "collection", name)
        entries = list(tindri.iter_keyfile_entries(path))
        assert entries == list(jindri.iter_keyfile_entries(path)) and len(entries) == len(DOCS)
    assert tindri.is_indri_repository(root) and jindri.is_indri_repository(root)
    assert not tindri.is_indri_repository(os.path.join(root, "index"))


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_indri_index_matches(repos, kind):
    t, j = tindri.IndriIndex(repos[kind]), jindri.IndriIndex(repos[kind])
    for name in ("document_count", "total_terms", "document_base", "maximum_document",
                 "unique_terms", "max_term_id"):
        assert getattr(t, name) == getattr(j, name), name
    assert t.document_count == len(DOCS)
    assert t.total_terms == sum(len(tokens) for _, tokens in DOCS)
    np.testing.assert_array_equal(t.document_lengths, j.document_lengths)
    assert [dataclasses.astuple(e) for e in t.vocabulary()] == [
        dataclasses.astuple(e) for e in j.vocabulary()]
    assert {e.term for e in t.vocabulary()} == {w for _, ts in DOCS for w in ts} - set(STOP)
    assert t.docnos() == j.docnos() == {i + 1: d for i, (d, _) in enumerate(DOCS)}
    picks = [DOCS[20][0], DOCS[0][0], DOCS[39][0]]
    assert t.docids_from_docnos(picks) == j.docids_from_docnos(picks) == [21, 1, 40]
    terms = {e.term_id: e.term for e in t.vocabulary()}
    for doc_id in range(1, len(DOCS) + 1):
        np.testing.assert_array_equal(t.term_list(doc_id), j.term_list(doc_id))
        assert t.document_length(doc_id) == j.document_length(doc_id) == len(DOCS[doc_id - 1][1])
        assert [terms.get(int(x), "") for x in t.term_list(doc_id)] == [
            "" if w in STOP else w for w in DOCS[doc_id - 1][1]]


def test_non_contiguous_ranges_rejected_by_both(tmp_path):
    import re

    bad = str(tmp_path / "bad")
    write_repository(bad, [DOCS[:2], DOCS[2:5]])
    manifest = os.path.join(bad, "index", "1", "manifest")
    text = open(manifest).read()
    open(manifest, "w").write(re.sub(r"<document-base>\d+", "<document-base>9", text))
    for module in (tindri, jindri):
        with pytest.raises(ValueError, match="non-contiguous"):
            module.IndriIndex(bad)


# -- corpora -------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["single", "multi"])
@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_python_reader_matches_jax(repos, kind, option):
    tcfg = data_config(DataConfig, repos, repos[kind], option)
    jcfg = data_config(JDataConfig, repos, repos[kind], option)
    document_list, blacklist = read_lists(tcfg)
    t = tindri.build_corpus_from_indri(repos[kind], tcfg, WINDOW, document_list=document_list,
                                       term_blacklist=blacklist)
    j = jindri.build_corpus_from_indri(repos[kind], jcfg, WINDOW, document_list=document_list,
                                       term_blacklist=blacklist)
    assert_same_corpus(t, j)
    assert t.stemmer == j.stemmer
    assert t.num_docs > 0 and len(t.tokens) > 0
    if option == "blacklist":
        assert not {"w3", "river", "fox"} & set(t.vocab.terms)


@pytest.fixture(scope="module")
def built():
    """The C++ reader, built from ``cunvsm_torch/csrc`` with g++."""
    if shutil.which(os.environ.get("CXX") or "g++") is None:
        pytest.skip("needs g++")
    assert native.available()
    return native


@pytest.mark.parametrize("kind", ["single", "multi"])
@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_cpp_reader_matches_python_reader(built, repos, kind, option):
    cfg = data_config(DataConfig, repos, repos[kind], option)
    nat = built.build_corpus_native_indri(repos[kind], cfg, WINDOW)
    py = load_corpus(cfg, WINDOW, use_native=False)
    assert_same_corpus(nat, py)
    assert nat.index_doc_ids is not None
    # load_corpus takes the C++ reader by default.
    assert_same_corpus(load_corpus(cfg, WINDOW), py)


def test_unknown_docno_in_the_document_list_is_refused(built, repos, tmp_path):
    doc_list = tmp_path / "docs.txt"
    doc_list.write_text(f"{DOCS[3][0]}\nnot-a-docno\n")
    cfg = DataConfig(corpus_path=repos["single"], max_vocabulary_size=0,
                     min_document_frequency=0, max_document_frequency=0,
                     document_list=str(doc_list))
    with pytest.raises(RuntimeError, match="unknown docno in document list: not-a-docno"):
        load_corpus(cfg, WINDOW)
    for module in (tindri, jindri):
        with pytest.raises(KeyError, match="not-a-docno"):
            module.build_corpus_from_indri(repos["single"], cfg, WINDOW,
                                           document_list=[DOCS[3][0], "not-a-docno"])


def test_single_and_multi_index_corpora_match(built, repos):
    """The split repository gives the compacted one's corpus (the merged
    term ids of a multi-index repository are synthetic)."""
    cs = load_corpus(data_config(DataConfig, repos, repos["single"], "plain"), WINDOW)
    cm = load_corpus(data_config(DataConfig, repos, repos["multi"], "plain"), WINDOW)
    assert_same_corpus(cs, cm, index_term_ids=False)


TRECTEXT_CONFIGS = {
    "plain": dict(),
    "vocabulary_10": dict(max_vocabulary_size=10),
    "document_frequency": dict(min_document_frequency=3, max_document_frequency=0.5),
    "oov": dict(include_oov=True),
    "digits": dict(include_digits=True),
    "cutoff": dict(documents_cutoff=7),
}


@pytest.fixture(scope="module")
def trectext(tmp_path_factory):
    rng = np.random.RandomState(3)
    words = [f"w{i}" for i in range(40)] + ["42", "3.5", "the", "And"]
    path = tmp_path_factory.mktemp("trectext") / "docs.trectext"
    with open(path, "w") as f:
        for d in range(25):
            body = " ".join(words[rng.randint(len(words))] for _ in range(rng.randint(2, 40)))
            f.write(f"<DOC>\n<DOCNO> doc{d} </DOCNO>\n<TITLE>Title {d}</TITLE>\n"
                    f"<TEXT>\n{body}\n</TEXT>\n</DOC>\n")
    return str(path)


@pytest.mark.parametrize("stopwords", [None, "lemur"])
@pytest.mark.parametrize("name", sorted(TRECTEXT_CONFIGS))
def test_cpp_trectext_reader_matches_python_pipeline(built, trectext, name, stopwords):
    kw = dict(max_vocabulary_size=0, min_document_frequency=0, max_document_frequency=0)
    kw.update(TRECTEXT_CONFIGS[name])
    cfg = DataConfig(corpus_path=trectext, **kw)
    py = build_corpus(iter_trectext(trectext), cfg, 4, stopwords=load_stopwords(stopwords))
    nat = built.build_corpus_native(trectext, cfg, 4, stopwords)
    assert_same_corpus(nat, py, index_term_ids=False, from_index=False)
    assert_same_corpus(load_corpus(cfg, 4, stopwords), py, index_term_ids=False,
                       from_index=False)
    if stopwords:
        assert "the" not in nat.vocab.terms and "and" not in nat.vocab.terms


def test_blacklist_is_lowercased_before_the_cpp_side(tmp_path):
    """Non-ASCII letters fold with Python's rules; the folded copy is a
    temporary file that the caller removes."""
    path = tmp_path / "blacklist.txt"
    path.write_text("ÉCOLE\nriver\n", encoding="utf-8")
    lowered = native._lowercased_blacklist(str(path))
    assert lowered != str(path)
    assert open(lowered, encoding="utf-8").read() == "école\nriver\n"
    os.unlink(lowered)
    path.write_text("already\nlower\n")
    assert native._lowercased_blacklist(str(path)) == str(path)
    assert native._lowercased_blacklist(None) is None


# -- the build helper ------------------------------------------------------------


def _fake_cxx(directory, rc=0):
    """An executable ``g++`` in ``directory`` that appends its arguments to
    ``calls.txt`` and writes ``built`` to the ``-o`` file, or fails."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "g++")
    with open(path, "w") as f:
        f.write(
            f"#!{sys.executable}\n"
            "import os, sys\n"
            "here = os.path.dirname(os.path.abspath(__file__))\n"
            "open(os.path.join(here, 'calls.txt'), 'a').write(' '.join(sys.argv[1:]) + '\\n')\n"
            f"if {rc}:\n"
            "    sys.stderr.write('error: boom\\n')\n"
            f"    sys.exit({rc})\n"
            "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('built')\n"
        )
    os.chmod(path, os.stat(path).st_mode | stat.S_IXUSR)
    return path


@pytest.fixture
def no_compiler(monkeypatch, tmp_path):
    """No CXX, an empty PATH, the build directory in tmp_path, and no
    library loaded yet."""
    monkeypatch.delenv("CXX", raising=False)
    empty = tmp_path / "empty"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build" / "native"))
    monkeypatch.setattr(native, "_lib", None)
    return tmp_path


def test_library_lies_under_build_native():
    path = native.library_path()
    assert os.path.dirname(path) == os.path.join(REPO, "build", "native")
    assert os.path.basename(path).startswith("libcunvsm_native-") and path.endswith(".so")
    assert os.path.abspath(path) != os.path.abspath(
        os.path.join(REPO, "native", "libcunvsm_native.so"))
    cmd = native.cxx_command("g++", "out.so")
    for flag in ("-std=c++17", "-O3", "-shared", "-fPIC"):
        assert flag in cmd
    assert cmd[cmd.index("-o") + 1] == "out.so"
    assert cmd[-2:] == [os.path.join(REPO, "cunvsm_torch", "csrc", s)
                        for s in ("corpus.cpp", "indri.cpp")]


def test_library_name_follows_sources_header_and_flags(monkeypatch, tmp_path):
    for name in native.SOURCES + native.HEADERS:
        shutil.copy(os.path.join(native.CSRC, name), tmp_path / name)
    monkeypatch.setattr(native, "CSRC", str(tmp_path))
    first = native.library_path()
    for name in ("indri.cpp", "corpus.h"):
        original = (tmp_path / name).read_bytes()
        (tmp_path / name).write_bytes(original + b"\n")
        assert native.library_path() != first, name
        (tmp_path / name).write_bytes(original)
        assert native.library_path() == first
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    assert native.library_path() != first


def test_build_with_a_stand_in_compiler(no_compiler, monkeypatch):
    bin_dir = str(no_compiler / "bin")
    _fake_cxx(bin_dir)
    monkeypatch.setenv("PATH", bin_dir)
    path = native.build_library()
    assert path == native.library_path() and open(path).read() == "built"
    assert os.listdir(native.BUILD_DIR) == [os.path.basename(path)]  # no temporary left
    calls = open(os.path.join(bin_dir, "calls.txt")).read().splitlines()
    assert len(calls) == 1 and "-shared" in calls[0] and "corpus.cpp" in calls[0]
    assert os.path.dirname(calls[0].split()[calls[0].split().index("-o") + 1]) == native.BUILD_DIR
    native.build_library()  # the library exists: no second compile
    assert len(open(os.path.join(bin_dir, "calls.txt")).read().splitlines()) == 1
    # $CXX names another compiler.
    other = str(no_compiler / "other")
    os.rename(_fake_cxx(other), os.path.join(other, "clang++"))
    monkeypatch.setenv("PATH", other)
    monkeypatch.setenv("CXX", "clang++")
    assert native.find_cxx() == os.path.join(other, "clang++")


def test_failed_build_is_not_remembered(no_compiler, monkeypatch, repos, caplog):
    """Without a compiler, and with one that fails, ``load_corpus`` reads
    the repository with the Python reader and logs a warning naming g++;
    once the compiler is there the same process builds and loads the
    library."""
    cfg = data_config(DataConfig, repos, repos["single"], "plain")
    want = load_corpus(cfg, WINDOW, use_native=False)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.build_library()
    with caplog.at_level(logging.WARNING, logger="cunvsm_torch.data.native"):
        assert not native.available()
        assert_same_corpus(load_corpus(cfg, WINDOW), want)
    assert "g++" in caplog.text and "Python ingestion pipeline" in caplog.text
    with pytest.raises(RuntimeError, match="could not be built"):
        native.build_corpus_native_indri(repos["single"], cfg, WINDOW)

    bin_dir = str(no_compiler / "bin")
    _fake_cxx(bin_dir, rc=3)
    monkeypatch.setenv("PATH", bin_dir)
    with pytest.raises(RuntimeError, match="boom"):
        native.build_library()
    assert os.listdir(native.BUILD_DIR) == []  # the temporary file is gone
    assert not native.available()
    assert not native.available()
    assert len(open(os.path.join(bin_dir, "calls.txt")).read().splitlines()) == 3

    real = shutil.which("g++", path=os.defpath + os.pathsep + "/usr/bin:/usr/local/bin")
    if real is None:
        pytest.skip("needs g++ for the later build")
    monkeypatch.setenv("PATH", os.path.dirname(real) + os.pathsep + "/usr/bin:/bin")
    assert native.available()
    assert os.path.dirname(native.library_path()) == native.BUILD_DIR
    assert os.path.exists(native.library_path())
    assert_same_corpus(load_corpus(cfg, WINDOW), want)


# -- the train command on a repository ---------------------------------------------

TRAIN_FLAGS = [
    "--num_epochs", "3", "--batch_size", "16", "--window_size", str(WINDOW),
    "--num_random_entities", "3", "--word_repr_size", "10", "--entity_repr_size", "8",
    "--update_method", "full_adam", "--nonlinearity", "tanh", "--max_vocabulary_size", "0",
    "--min_document_frequency", "0", "--max_document_frequency", "0", "--seed", "3",
    "--learning_rate", "0.02", "--reference_rng",
]


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_train_commands_on_a_repository_write_the_same_model(repos, tmp_path, kind):
    jprefix, tprefix = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jtrain.main([repos[kind], "--output", jprefix, *TRAIN_FLAGS]) == 0
    assert ttrain.main([repos[kind], "--output", tprefix, "--device", "cpu", *TRAIN_FLAGS]) == 0
    with h5py.File(f"{jprefix}_3.hdf5", "r") as j, h5py.File(f"{tprefix}_3.hdf5", "r") as t:
        assert set(j) == set(t) and len(t) == 4
        for name in j:
            np.testing.assert_allclose(t[name][()], j[name][()], rtol=1e-5, atol=1e-5)
    for suffix in ("_meta", "_vocab.txt", "_docnos.txt"):
        with open(jprefix + suffix, "rb") as a, open(tprefix + suffix, "rb") as b:
            assert a.read() == b.read(), suffix
    # _meta carries the repository's ids, not the model's.
    from cunvsm_torch.io import checkpoint as tckpt

    meta = tckpt.load_meta(tprefix)
    index = tindri.IndriIndex(repos[kind])
    by_term = {e.term: e.term_id for e in index.vocabulary()}
    terms = tckpt.load_strings(f"{tprefix}_vocab.txt")
    assert all(by_term[terms[x.model_term_id]] == x.index_term_id for x in meta.term)
    docids = {d: i for i, d in index.docnos().items()}
    docnos = tckpt.load_strings(f"{tprefix}_docnos.txt")
    assert all(docids[docnos[x.model_object_id]] == x.index_object_id for x in meta.object)
