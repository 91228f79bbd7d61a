"""Query-side stemming for models trained from stemmed Indri repositories.

Copied from ``cunvsm_tpu.data.stemming`` (pure Python); the query CLI
of this package applies it as the JAX package's does.


The reference never needs a stemmer of its own: ``py/query.py`` resolves
query terms through pyndri's index dictionary
(py/query.py:111,141-142), so Indri applies the
repository's indexing-time stemmer to every query term for free.  This
framework tokenizes raw topic text itself (data/text.py), so when the model
vocabulary holds *stemmed* strings (the checked-in Brown index is
Krovetz-stemmed; TOIS-era Robust04 indexes typically are too) inflected
query terms would silently miss the vocabulary and ranking quality would
quietly degrade.

The repository manifest records the indexing-time stemmer
(``<stemmer><name>krovetz</name></stemmer>``); data/indri.py surfaces it,
the corpus carries it, the trainer persists it in a ``<prefix>_stemmer.txt``
checkpoint sidecar, and the query CLIs apply the matching ``QueryStemmer``
to topic tokens.

Stemmers:

* ``porter`` — the standard Porter (1980) algorithm, applied
  unconditionally: Indri's PorterStemmer transforms every indexed token the
  same way, so re-applying it to query tokens reproduces the indexing-time
  mapping.
* ``krovetz`` — vocabulary-guided kstem: Krovetz (1993) is a
  dictionary-checked inflectional stemmer (lemur's KrovetzStemmer carries
  its own lexicon); the governing mechanism is "only transform when the
  result is a known word".  The index vocabulary IS the set of known
  surface forms here, so each token is kept if already in-vocabulary, else
  the kstem inflectional candidates (plural -s/-es/-ies, past -ed/-ied,
  aspect -ing, with e-restoration and consonant undoubling) are tried in
  rule order and the first in-vocabulary form wins.  This differs from
  lemur's kstem only where kstem's internal lexicon disagrees with the
  corpus vocabulary — and never produces an out-of-vocabulary form from an
  in-vocabulary one.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

KNOWN_STEMMERS = ("krovetz", "porter")


# ---------------------------------------------------------------------------
# Porter stemmer (Porter, 1980, "An algorithm for suffix stripping") —
# the standard algorithm, steps 1a through 5b.
# ---------------------------------------------------------------------------


def _is_cons(w: str, i: int) -> bool:
    c = w[i]
    if c in "aeiou":
        return False
    if c == "y":
        return i == 0 or not _is_cons(w, i - 1)
    return True


def _measure(stem: str) -> int:
    """The number of VC sequences ("m" in the paper)."""
    m = 0
    prev_vowel = False
    for i in range(len(stem)):
        cons = _is_cons(stem, i)
        if cons and prev_vowel:
            m += 1
        prev_vowel = not cons
    return m


def _has_vowel(stem: str) -> bool:
    return any(not _is_cons(stem, i) for i in range(len(stem)))


def _ends_double_cons(w: str) -> bool:
    return (
        len(w) >= 2 and w[-1] == w[-2] and _is_cons(w, len(w) - 1)
    )


def _cvc(w: str) -> bool:
    """Ends consonant-vowel-consonant, final consonant not w/x/y."""
    return (
        len(w) >= 3
        and _is_cons(w, len(w) - 3)
        and not _is_cons(w, len(w) - 2)
        and _is_cons(w, len(w) - 1)
        and w[-1] not in "wxy"
    )


def porter_stem(word: str) -> str:
    w = word
    if len(w) <= 2:
        return w

    # Step 1a.
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]

    # Step 1b.
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    else:
        flag = False
        if w.endswith("ed") and _has_vowel(w[:-2]):
            w = w[:-2]
            flag = True
        elif w.endswith("ing") and _has_vowel(w[:-3]):
            w = w[:-3]
            flag = True
        if flag:
            if w.endswith(("at", "bl", "iz")):
                w += "e"
            elif _ends_double_cons(w) and not w.endswith(("l", "s", "z")):
                w = w[:-1]
            elif _measure(w) == 1 and _cvc(w):
                w += "e"

    # Step 1c.
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"

    # Step 2.
    step2 = (
        ("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
        ("anci", "ance"), ("izer", "ize"), ("abli", "able"),
        ("alli", "al"), ("entli", "ent"), ("eli", "e"), ("ousli", "ous"),
        ("ization", "ize"), ("ation", "ate"), ("ator", "ate"),
        ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
        ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"),
        ("biliti", "ble"),
    )
    for suf, rep in step2:
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break

    # Step 3.
    step3 = (
        ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
        ("ical", "ic"), ("ful", ""), ("ness", ""),
    )
    for suf, rep in step3:
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break

    # Step 4.
    step4 = (
        "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
        "ment", "ent", "ion", "ou", "ism", "ate", "iti", "ous", "ive",
        "ize",
    )
    for suf in sorted(step4, key=len, reverse=True):
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if _measure(stem) > 1:
                if suf == "ion" and not stem.endswith(("s", "t")):
                    continue
                w = stem
            break

    # Step 5a.
    if w.endswith("e"):
        m = _measure(w[:-1])
        if m > 1 or (m == 1 and not _cvc(w[:-1])):
            w = w[:-1]

    # Step 5b.
    if _measure(w) > 1 and _ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]

    return w


# ---------------------------------------------------------------------------
# Krovetz inflectional candidates (kstem rule order; dictionary checks are
# supplied by the caller's vocabulary).
# ---------------------------------------------------------------------------


def krovetz_candidates(word: str) -> List[str]:
    """In-rule-order candidate reductions of kstem's inflectional steps:
    plural, past tense, aspect (Krovetz 1993 §3; lemur KrovetzStemmer's
    plural/past_tense/aspect steps)."""
    w = word
    n = len(w)
    cands: List[str] = []

    # Plural step.
    if w.endswith("ies") and n > 4:
        cands += [w[:-3] + "y", w[:-3] + "ie"]
    elif w.endswith("es") and n > 3:
        cands += [w[:-1], w[:-2]]
    elif w.endswith("s") and n > 3 and not w.endswith(("ss", "us", "is")):
        cands.append(w[:-1])

    # Past-tense step.
    if w.endswith("ied") and n > 4:
        cands += [w[:-3] + "y", w[:-1]]
    elif w.endswith("ed") and n > 4:
        base = w[:-2]
        cands.append(w[:-1])  # e-restoration: hoped -> hope
        cands.append(base)  # walked -> walk
        if len(base) > 2 and base[-1] == base[-2]:
            cands.append(base[:-1])  # hopped -> hop

    # Aspect step.
    if w.endswith("ing") and n > 5:
        base = w[:-3]
        cands.append(base)  # walking -> walk
        cands.append(base + "e")  # making -> make
        if len(base) > 2 and base[-1] == base[-2]:
            cands.append(base[:-1])  # running -> run

    return cands


def _derivational_candidates(w: str) -> List[str]:
    """kstem's derivational endings (KrovetzStemmer's ity/ness/ion/er/ly/
    al/ive/ize/ment/ble/ic/ful/ous steps), as candidate reductions.  Only
    meaningful vocabulary-gated: kstem accepts each of these only on a
    dictionary hit, and the caller's vocabulary plays the dictionary."""
    out: List[str] = []
    n = len(w)
    if w.endswith("ity") and n > 5:
        out += [w[:-3], w[:-3] + "e", w[:-3] + "y"]
    if w.endswith("ness") and n > 6:
        out.append(w[:-4])
    if w.endswith("ion") and n > 5:
        out += [w[:-3] + "e", w[:-3]]  # creation -> create
    if w.endswith(("er", "or")) and n > 4:
        out += [w[:-1], w[:-2], w[:-2] + "e"]
    if w.endswith("ly") and n > 4:
        out.append(w[:-2])
    if w.endswith("al") and n > 5:
        out += [w[:-2], w[:-2] + "e"]
    if w.endswith("ive") and n > 5:
        out += [w[:-3], w[:-3] + "e"]
    if w.endswith("ize") and n > 5:
        out += [w[:-3], w[:-3] + "e", w[:-3] + "y"]
    if w.endswith("ment") and n > 6:
        out.append(w[:-4])
    if w.endswith("ble") and n > 5:
        out += [w[:-3], w[:-3] + "e"]
    if w.endswith("ic") and n > 4:
        out += [w[:-2], w[:-2] + "e", w[:-2] + "y"]
    if w.endswith("ful") and n > 5:
        out.append(w[:-3])
    if w.endswith("ous") and n > 5:
        out.append(w[:-3])
    return out


class QueryStemmer:
    """Applies the repository's indexing-time stemmer to query tokens.

    ``name`` is the manifest's stemmer name (``krovetz``/``porter``; None
    or empty = identity).  ``vocab_terms`` is the model vocabulary —
    required for the dictionary-guided krovetz mode, used by porter only to
    keep tokens that are already in-vocabulary untransformed (Indri's query
    parser stems everything, but an exact-surface-form hit can only be the
    stemmer's own fixed point, so this is a no-op in practice and a
    safeguard against double-stemming drift).
    """

    def __init__(
        self,
        name: Optional[str],
        vocab_terms: Optional[Iterable[str]] = None,
        on_unknown: str = "raise",
    ):
        """``on_unknown``: 'raise' for explicit user-requested stemmers;
        'warn' for names read from a manifest/sidecar, where an
        unimplemented stemmer (e.g. Indri's 'arabic') must degrade to
        identity — matching the pre-stemming behavior — rather than
        crash the whole protocol at startup."""
        self.name = (name or "").strip().lower() or None
        if self.name is not None and self.name not in KNOWN_STEMMERS:
            if on_unknown == "warn":
                import logging

                logging.warning(
                    "Stemmer %r is not implemented (known: %s); query "
                    "terms will NOT be stemmed — inflected query terms "
                    "may miss the stemmed vocabulary.",
                    name, ", ".join(KNOWN_STEMMERS),
                )
                self.name = None
            else:
                raise ValueError(
                    f"unknown stemmer {name!r}; known: {KNOWN_STEMMERS}"
                )
        self._vocab = frozenset(vocab_terms) if vocab_terms else frozenset()
        if self.name == "krovetz" and not self._vocab:
            raise ValueError(
                "krovetz query stemming is vocabulary-guided: pass the "
                "model vocabulary terms"
            )

    def stem(self, token: str) -> str:
        if self.name is None or len(token) <= 2:
            return token
        if self.name == "porter":
            # Indri's Porter path stems EVERY query token, so stem
            # unconditionally — a surface form that is in the stemmed
            # vocabulary but is not its own Porter fixed point (e.g.
            # "university" in a vocabulary that also kept it verbatim)
            # must map to its stem like the reference's pyndri resolution
            # would.  Fall back to the raw token only when the stem is
            # out-of-vocabulary and the raw form is not (advisor finding,
            # round 4).
            stemmed = porter_stem(token)
            if (
                self._vocab
                and stemmed not in self._vocab
                and token in self._vocab
            ):
                return token
            return stemmed
        if token in self._vocab:
            # kstem: dictionary words are returned unchanged.
            return token
        # kstem: inflectional steps first, then derivational endings,
        # chained one level (plural strip feeding the -ion step, e.g.
        # investigations -> investigation -> investigate) — every
        # acceptance gated on the vocabulary-as-dictionary.
        inflected = krovetz_candidates(token)
        for cand in inflected:
            if cand in self._vocab:
                return cand
        for base in [token] + inflected:
            for cand in _derivational_candidates(base):
                if cand in self._vocab:
                    return cand
        return token

    def stem_tokens(self, tokens: Sequence[str]) -> List[str]:
        return [self.stem(t) for t in tokens]


def load_query_stemmer(
    prefix: str, vocab_terms: Iterable[str]
) -> QueryStemmer:
    """Build the QueryStemmer recorded by a checkpoint's stemmer sidecar
    (``<prefix>_stemmer.txt``, written at train time from the repository
    manifest); identity when no sidecar exists (unstemmed corpora)."""
    import os

    path = f"{prefix}_stemmer.txt"
    name = None
    if os.path.exists(path):
        with open(path) as f:
            name = f.read().strip() or None
    return QueryStemmer(
        name, vocab_terms if name else None, on_unknown="warn"
    )
