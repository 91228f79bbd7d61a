"""Document parsing and tokenization.

Replaces the reference's dependency on a prebuilt Indri index
(cpp/data_indri.cpp opens DiskIndex/QueryEnvironment/CompressedCollection):
this framework ingests raw corpora directly.  Supported inputs:

* TRECTEXT files (``<DOC><DOCNO>...</DOCNO><TEXT>...</TEXT></DOC>``) — the
  format the reference pipelines index (functions.sh:352-360, class
  "trectext");
* JSONL files with {"id": ..., "text": ...} records;
* in-memory (docno, text) pairs (the InMemoryDocumentSource analog,
  data.h:301-364).

Tokenization mirrors Indri's default term normalization: lowercase,
alphanumeric token runs, optional stopword removal (the reference pipelines
index with the Lemur stoplist, functions.sh:344-350).  No stemming, matching
IndriBuildIndex defaults used by the reference scripts.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

_TOKEN_RE = re.compile(r"[a-z0-9]+")
_DOC_RE = re.compile(r"<DOC>(.*?)</DOC>", re.DOTALL)
_DOCNO_RE = re.compile(r"<DOCNO>\s*(.*?)\s*</DOCNO>", re.DOTALL)
_TAG_RE = re.compile(r"<[^>]+>")


def tokenize(text: str, stopwords: Optional[frozenset] = None) -> List[str]:
    """Lowercase alphanumeric tokens, minus stopwords."""
    tokens = _TOKEN_RE.findall(text.lower())
    if stopwords:
        tokens = [t for t in tokens if t not in stopwords]
    return tokens


def lemur_stopwords() -> frozenset:
    """The vendored Lemur stoplist (418 words).

    The reference pipelines index every collection with Lemur's
    ``stoplist.dft`` (functions.sh:330-367, downloaded at index-build time);
    the vendored copy is the stopper recorded in the checked-in Brown index
    manifest, which Indri embeds verbatim from that same file.
    """
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "resources", "lemur_stoplist.txt",
    )
    with open(path) as f:
        return frozenset(w.strip() for w in f if w.strip())


def load_stopwords(path: Optional[str]) -> Optional[frozenset]:
    """Load a stopword file; the special value ``lemur`` resolves to the
    vendored Lemur stoplist."""
    if not path:
        return None
    if path == "lemur":
        return lemur_stopwords()
    with open(path) as f:
        words = set()
        for line in f:
            # Lemur stoplist.dft lines look like ``<word>a</word>`` or
            # plain words; accept both.
            line = _TAG_RE.sub(" ", line).strip().lower()
            words.update(w for w in line.split() if w)
    return frozenset(words)


def _open_maybe_gzip(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt", errors="replace")
    return open(path, errors="replace")


def iter_trectext(path: str) -> Iterator[Tuple[str, str]]:
    """Yield (docno, text) from a TRECTEXT file; text is all content outside
    the DOCNO tag with SGML tags stripped."""
    with _open_maybe_gzip(path) as f:
        data = f.read()
    for m in _DOC_RE.finditer(data):
        doc = m.group(1)
        docno_m = _DOCNO_RE.search(doc)
        if not docno_m:
            continue
        docno = docno_m.group(1)
        body = doc[: docno_m.start()] + doc[docno_m.end():]
        yield docno, _TAG_RE.sub(" ", body)


def iter_jsonl(path: str) -> Iterator[Tuple[str, str]]:
    with _open_maybe_gzip(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            docno = str(rec.get("id") or rec.get("docno"))
            text = rec.get("text") or rec.get("contents") or ""
            yield docno, text


def iter_corpus_files(path: str) -> Iterator[Tuple[str, str]]:
    """Dispatch on path: file or directory of trectext/jsonl files."""
    if os.path.isdir(path):
        files = sorted(
            p
            for p in glob.glob(os.path.join(path, "**", "*"), recursive=True)
            if os.path.isfile(p)
        )
    else:
        files = [path]
    for p in files:
        base = os.path.basename(p).lower()
        if base.endswith((".jsonl", ".jsonl.gz", ".json", ".json.gz")):
            yield from iter_jsonl(p)
        else:
            yield from iter_trectext(p)


def is_number(term: str) -> bool:
    """Terms that parse as numbers are dropped from the vocabulary by default
    (data_indri.cpp:765 via is_number, base.h)."""
    try:
        float(term)
        return True
    except ValueError:
        return False
