"""ctypes bridge to the C++ corpus-ingestion library.

The C++ sources (``cunvsm_torch/csrc/corpus.cpp``, ``indri.cpp``,
``corpus.h``; copies of the repository's ``native/``) replicate the Python
pipeline (data/text.py + data/vocab.py + data/corpus.py, and data/indri.py
for Indri repositories) at collection-scale throughput; the Python path
remains the semantic reference and the fallback where the library does not
build.

The library is built with ``g++`` (``$CXX`` if set) at its first use, the
way ``ops/cuda_build.py`` builds the CUDA kernels: into the checkout's
``build/native/`` under a name that carries a hash of the sources and the
flags, written under a temporary name and moved into place.  A failed
build is not remembered: the next call tries again, so a compiler that
appears later is picked up without a restart.  Importing this module
needs no compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
from typing import Optional

import numpy as np

from cunvsm_torch.config import DataConfig
from cunvsm_torch.data.corpus import Corpus
from cunvsm_torch.data.vocab import Vocabulary
from cunvsm_torch.ops.cuda_build import compile_into_place

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PACKAGE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PACKAGE), "build", "native")
SOURCES = ("corpus.cpp", "indri.cpp")
HEADERS = ("corpus.h",)
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lib: Optional[ctypes.CDLL] = None


def find_cxx() -> str:
    """``$CXX``, else ``g++`` on ``PATH``; raises ``RuntimeError`` if
    neither is an executable."""
    cxx = shutil.which(os.environ.get("CXX") or "g++")
    if cxx:
        return cxx
    raise RuntimeError(
        "g++ not found: the C++ corpus reader is built at first use; install "
        "g++ or set CXX"
    )


def library_path() -> str:
    """``build/native/libcunvsm_native-<hash>.so``, the hash over the
    sources' and headers' bytes and the flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in SOURCES + HEADERS:
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libcunvsm_native-{h.hexdigest()[:16]}.so")


def cxx_command(cxx: str, out: str) -> list:
    return [cxx, *CXX_FLAGS, "-o", out, *(os.path.join(CSRC, s) for s in SOURCES)]


def build_library() -> str:
    """Compile the sources unless the library for their present bytes
    exists; returns its path.  Raises ``RuntimeError`` without a compiler
    or when the compiler fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    cxx = find_cxx()
    return compile_into_place(path, lambda out: cxx_command(cxx, out), "the corpus reader")


def load_library() -> Optional[ctypes.CDLL]:
    """The built library, loaded once per process; None, with a logged
    warning, where it cannot be built or loaded (the caller then takes the
    Python pipeline)."""
    global _lib
    if _lib is None:
        try:
            _lib = _bind(ctypes.CDLL(build_library()))
        except (RuntimeError, OSError, AttributeError) as e:
            logging.getLogger(__name__).warning(
                "C++ corpus reader unavailable (%s); falling back to the "
                "Python ingestion pipeline. It is built with g++ at first use.", e,
            )
            return None
    return _lib


def _lowercased_blacklist(path: Optional[str]) -> Optional[str]:
    """Pre-lowercase a blacklist file with Python semantics.

    The Python pipeline lowercases blacklist entries with ``str.lower()``
    (data/corpus.py), which also folds non-ASCII letters; the native
    readers use ASCII ``std::tolower``.  Handing the native side an
    already-folded copy keeps the two pipelines byte-identical for any
    input.  Returns the path of a temporary file (or None/path unchanged
    when there is nothing to fold)."""
    if not path:
        return path
    import tempfile

    with open(path, encoding="utf-8", errors="replace") as f:
        raw = f.read()
    lowered = "\n".join(line.lower() for line in raw.splitlines())
    if lowered == raw.rstrip("\n"):
        return path
    tmp = tempfile.NamedTemporaryFile(
        "w", suffix=".blacklist", delete=False, encoding="utf-8"
    )
    tmp.write(lowered + "\n")
    tmp.close()
    return tmp.name


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.corpus_build.restype = ctypes.c_void_p
    lib.corpus_build.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_int, ctypes.c_long, ctypes.c_long, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, ctypes.c_long,
    ]
    lib.indri_build.restype = ctypes.c_void_p
    lib.indri_build.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_int, ctypes.c_long, ctypes.c_long, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, ctypes.c_long,
    ]
    lib.corpus_num_index_doc_ids.restype = ctypes.c_long
    lib.corpus_num_index_doc_ids.argtypes = [ctypes.c_void_p]
    lib.corpus_copy_index_doc_ids.restype = None
    lib.corpus_copy_index_doc_ids.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p
    ]
    lib.corpus_error.restype = ctypes.c_char_p
    lib.corpus_error.argtypes = [ctypes.c_void_p]
    for name in (
        "corpus_num_docs", "corpus_num_tokens", "corpus_vocab_size",
        "corpus_total_terms", "corpus_vocab_bytes",
        "corpus_docnos_bytes",
    ):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_long
        fn.argtypes = [ctypes.c_void_p]
    for name, ptr_t in (
        ("corpus_copy_tokens", ctypes.c_void_p),
        ("corpus_copy_offsets", ctypes.c_void_p),
        ("corpus_copy_index_lengths", ctypes.c_void_p),
        ("corpus_copy_term_freq", ctypes.c_void_p),
        ("corpus_copy_index_term_ids", ctypes.c_void_p),
        ("corpus_copy_vocab", ctypes.c_char_p),
        ("corpus_copy_docnos", ctypes.c_char_p),
    ):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p, ptr_t]
    lib.corpus_free.restype = None
    lib.corpus_free.argtypes = [ctypes.c_void_p]
    return lib


_NOT_BUILT = "the C++ corpus reader could not be built (needs g++); see the log"


def available() -> bool:
    return load_library() is not None


def _corpus_from_handle(lib, handle, cfg, window_size) -> Corpus:
    try:
        err = lib.corpus_error(handle).decode()
        if err:
            raise RuntimeError(f"native corpus build failed: {err}")
        num_docs = lib.corpus_num_docs(handle)
        num_tokens = lib.corpus_num_tokens(handle)
        vocab_size = lib.corpus_vocab_size(handle)

        tokens = np.empty(num_tokens, dtype=np.int32)
        offsets = np.empty(num_docs + 1, dtype=np.int64)
        index_lengths = np.empty(num_docs, dtype=np.int64)
        term_freq = np.empty(vocab_size, dtype=np.int64)
        index_term_ids = np.empty(vocab_size, dtype=np.int64)
        if num_tokens:
            lib.corpus_copy_tokens(handle, tokens.ctypes.data)
        lib.corpus_copy_offsets(handle, offsets.ctypes.data)
        if num_docs:
            lib.corpus_copy_index_lengths(handle, index_lengths.ctypes.data)
        if vocab_size:
            lib.corpus_copy_term_freq(handle, term_freq.ctypes.data)
            lib.corpus_copy_index_term_ids(handle, index_term_ids.ctypes.data)
        index_doc_ids = None
        if lib.corpus_num_index_doc_ids(handle) == num_docs and num_docs:
            index_doc_ids = np.empty(num_docs, dtype=np.int64)
            lib.corpus_copy_index_doc_ids(handle, index_doc_ids.ctypes.data)

        vb = ctypes.create_string_buffer(lib.corpus_vocab_bytes(handle))
        lib.corpus_copy_vocab(handle, vb)
        terms = vb.raw.decode().split("\n")[:-1]
        db = ctypes.create_string_buffer(lib.corpus_docnos_bytes(handle))
        lib.corpus_copy_docnos(handle, db)
        docnos = db.raw.decode().split("\n")[:-1]

        vocab = Vocabulary(
            terms=terms,
            term_to_id={t: i for i, t in enumerate(terms) if t},
            term_freq=term_freq,
            total_terms=int(lib.corpus_total_terms(handle)),
            include_oov=cfg.include_oov,
            index_term_ids=index_term_ids,
        )
        return Corpus(
            vocab=vocab,
            tokens=tokens,
            doc_offsets=offsets,
            index_lengths=index_lengths,
            docnos=docnos,
            window_size=window_size,
            index_doc_ids=index_doc_ids,
        )
    finally:
        lib.corpus_free(handle)


def build_corpus_native_indri(
    repository_path: str,
    cfg: DataConfig,
    window_size: int,
) -> Corpus:
    """Packed corpus from an Indri DiskIndex repository (csrc/indri.cpp)."""
    lib = load_library()
    if lib is None:
        raise RuntimeError(_NOT_BUILT)
    blacklist = _lowercased_blacklist(cfg.term_blacklist)
    try:
        handle = lib.indri_build(
            repository_path.encode(),
            (cfg.document_list or "").encode(),
            (blacklist or "").encode(),
            window_size,
            cfg.max_vocabulary_size,
            cfg.min_document_frequency,
            float(cfg.max_document_frequency),
            int(cfg.include_oov),
            int(cfg.include_digits),
            cfg.documents_cutoff,
        )
        return _corpus_from_handle(lib, handle, cfg, window_size)
    finally:
        if blacklist and blacklist != cfg.term_blacklist:
            os.unlink(blacklist)


def build_corpus_native(
    trectext_path: str,
    cfg: DataConfig,
    window_size: int,
    stopword_path: Optional[str] = None,
) -> Corpus:
    lib = load_library()
    if lib is None:
        raise RuntimeError(_NOT_BUILT)
    if stopword_path == "lemur":  # data/text.py:load_stopwords' special value
        stopword_path = os.path.join(_PACKAGE, "resources", "lemur_stoplist.txt")
    blacklist = _lowercased_blacklist(cfg.term_blacklist)
    try:
        handle = lib.corpus_build(
            trectext_path.encode(),
            (stopword_path or "").encode(),
            (blacklist or "").encode(),
            window_size,
            cfg.max_vocabulary_size,
            cfg.min_document_frequency,
            float(cfg.max_document_frequency),
            int(cfg.include_oov),
            int(cfg.include_digits),
            cfg.documents_cutoff,
        )
        return _corpus_from_handle(lib, handle, cfg, window_size)
    finally:
        if blacklist and blacklist != cfg.term_blacklist:
            os.unlink(blacklist)
