"""cunvsm-extract-reuters: Reuters-21578 SGML -> TRECTEXT + topic classes.

Output contract (shared with the reference tooling, py/extract_reuters.py):
TRECTEXT shards of title/dateline/body text per article with sequential
numeric DOCNOs, and a document-classification file assigning each article
its most specific (least frequent) topic among the top-K most frequent
topics — the labels the Reuters t-SNE visualization colors by.

The extraction itself is segment-based: articles are sliced out of the SGML
stream on <REUTERS> boundaries and their fields pulled with tag-scoped
patterns (the format is machine-generated and rigidly regular, so no
event-driven SGML parsing is needed).

Usage:
    python -m cunvsm_torch.cli.extract_reuters *.sgm \
        --trectext_out_prefix out --document_classification_out classes.txt
"""

from __future__ import annotations

import argparse
import collections
import html
import logging
import re
import sys
from typing import Iterator, List, NamedTuple, Tuple

_ARTICLE_RE = re.compile(rb"<REUTERS\b.*?</REUTERS>", re.DOTALL)
_D_RE = re.compile(r"<D>(.*?)</D>", re.DOTALL)


class Article(NamedTuple):
    title: str
    dateline: str
    body: str
    topics: Tuple[str, ...]

    @property
    def text(self) -> str:
        return "\n".join((self.title, self.dateline, self.body))


def _tag_content(segment: str, tag: str) -> str:
    lo = segment.find(f"<{tag}>")
    if lo < 0:
        return ""
    hi = segment.find(f"</{tag}>", lo)
    if hi < 0:
        return ""
    return html.unescape(segment[lo + len(tag) + 2 : hi])


def iter_articles(raw: bytes) -> Iterator[Article]:
    """Slice one SGML file into articles."""
    for match in _ARTICLE_RE.finditer(raw):
        segment = match.group(0).decode("ISO-8859-1")
        yield Article(
            title=_tag_content(segment, "TITLE"),
            dateline=_tag_content(segment, "DATELINE"),
            body=_tag_content(segment, "BODY"),
            topics=tuple(
                html.unescape(m)
                for m in _D_RE.findall(_tag_content(segment, "TOPICS"))
            ),
        )


class ShardedTrectextWriter:
    """Writes <prefix>_<N>.trectext shards of at most shard_size documents."""

    def __init__(self, prefix: str, shard_size: int):
        self.prefix = prefix
        self.shard_size = shard_size
        self.shard_idx = -1
        self.in_shard = 0
        self.handle = None
        self._roll()

    def _roll(self):
        if self.handle:
            self.handle.close()
        self.shard_idx += 1
        self.in_shard = 0
        self.handle = open(
            f"{self.prefix}_{self.shard_idx}.trectext",
            "w", encoding="latin1", errors="replace",
        )

    def write(self, docno: str, text: str):
        if self.in_shard >= self.shard_size:
            self._roll()
        self.handle.write(
            f"<DOC>\n<DOCNO>{docno}</DOCNO>\n<TEXT>\n{text}\n</TEXT>\n</DOC>\n"
        )
        self.in_shard += 1

    def close(self):
        if self.handle:
            self.handle.close()
            self.handle = None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--loglevel", default="INFO")
    p.add_argument("--shard_size", type=int, default=1000000)
    p.add_argument("sgm", nargs="+")
    p.add_argument("--top_k_topics", type=int, default=20)
    p.add_argument("--trectext_out_prefix", required=True)
    p.add_argument("--document_classification_out", required=True)
    args = p.parse_args(argv)
    logging.basicConfig(level=args.loglevel)

    articles: List[Article] = []
    for path in args.sgm:
        logging.info("Parsing %s.", path)
        with open(path, "rb") as f:
            articles.extend(iter_articles(f.read()))
    logging.info("Parsed %d documents.", len(articles))

    histogram = collections.Counter(
        topic for article in articles for topic in article.topics
    )
    # Output contract with the reference tooling: the top-K set is the last
    # K of an ascending count-sort, so boundary TIES resolve the same way
    # (most_common would keep the other side of a tie).  Note [-0:] selects
    # every topic — the reference's slicing behaves identically at K=0.
    top_topics = frozenset(
        sorted(histogram, key=histogram.__getitem__)[-args.top_k_topics:]
    )
    logging.info("Top topics: %s", sorted(top_topics))

    writer = ShardedTrectextWriter(args.trectext_out_prefix, args.shard_size)
    with open(args.document_classification_out, "w") as f_classes:
        for docno, article in enumerate(articles):
            writer.write(str(docno), article.text)
            labeled = [t for t in article.topics if t in top_topics]
            if labeled:
                # The most specific (= least frequent) matching topic.
                f_classes.write(
                    f"{docno} {min(labeled, key=histogram.__getitem__)}\n"
                )
    writer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
