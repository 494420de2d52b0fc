"""Tokenizers, stoplists, and the predicate-filter pipe.

Mirrors the reference's MALLET pipe tokenizers, which classify Unicode
character categories into token chars / delimiters / transparent chars
(skipped *without* breaking the token — e.g. digits inside a word in
simple mode):

  - `mode="simple"`            — SimpleTokenizerLarge.java:67-118
  - `mode="numeric"`           — NumericAlsoTokenizer.java:38-110 (digits
                                 are token chars; `_` delimits)
  - `mode="connector"`         — KeepConnectorPunctuationTokenizerLarge
                                 .java:47-126 (Pc connector punctuation is
                                 a token char; `-` still delimits — it is
                                 DASH_PUNCTUATION; digits transparent)
  - `mode="connector_numeric"` — KeepConnectorPunctuationNumericAlso
                                 Tokenizer.java (both of the above; the
                                 keep_numbers x keep_connecting_punctuation
                                 composition at util/LDAUtils.java:531-560)

Category mapping (java.lang.Character.getType == unicodedata.category):
token chars are Ll/Lu plus the "obscure things that are technically part
of words" Lt/Lm/Lo/Mc/Me/Mn; delimiters are Zs/Zl/Zp/Ps/Pe/Pi/Pf/Pd/Po;
Nd and Pc switch per mode; everything else (math/currency symbols,
controls) is transparent. One deliberate divergence: MALLET leaves Cc
controls transparent, which would merge words across line breaks in
directory ingestion — ASCII whitespace controls (\\t\\n\\r\\f\\v) delimit
here instead.

Stoplist files are one word per line (reference: stoplist.txt at repo
root). Tokens shorter than `min_len` are dropped.

"""

from __future__ import annotations

import unicodedata
from typing import Callable, Iterable

_KEEP_CATS = frozenset({"Ll", "Lu", "Lt", "Lm", "Lo", "Mc", "Me", "Mn"})
_DELIM_CATS = frozenset({"Zs", "Zl", "Zp", "Ps", "Pe", "Pi", "Pf", "Pd",
                         "Po"})
_WS_CONTROLS = "\t\n\r\f\v"


class _TranslateTable(dict):
    """Lazy codepoint -> {kept char, ' ' delimiter, None transparent} map
    for str.translate; classifications cache on first sight."""

    def __init__(self, keep_numbers: bool, keep_connector: bool):
        super().__init__()
        self._keep_numbers = keep_numbers
        self._keep_connector = keep_connector

    def __missing__(self, cp: int):
        ch = chr(cp)
        cat = unicodedata.category(ch)
        if cat in _KEEP_CATS:
            out = ch
        elif cat == "Nd":
            out = ch if self._keep_numbers else None
        elif cat == "Pc":
            out = ch if self._keep_connector else " "
        elif cat in _DELIM_CATS or ch in _WS_CONTROLS:
            out = " "
        else:
            out = None
        self[cp] = out
        return out


_MODES = {
    "simple": (False, False),
    "numeric": (True, False),
    "connector": (False, True),
    "connector_numeric": (True, True),
}
_TABLES = {m: _TranslateTable(*flags) for m, flags in _MODES.items()}


def tokenizer_mode(keep_numbers: bool,
                   keep_connecting_punctuation: bool) -> str:
    """Config flags -> mode name (the tokenizer selection matrix at
    util/LDAUtils.java:531-560)."""
    if keep_connecting_punctuation:
        return "connector_numeric" if keep_numbers else "connector"
    return "numeric" if keep_numbers else "simple"


def load_stoplist(path: str | None) -> frozenset[str]:
    """Load a one-word-per-line stoplist; None/empty path -> empty set
    (reference ships stoplist-empty.txt for that case)."""
    if not path:
        return frozenset()
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        return frozenset(line.strip().lower() for line in f if line.strip())


def tokenize(text: str, stoplist: frozenset[str] = frozenset(),
             mode: str = "simple", min_len: int = 2,
             max_tokens: int | None = None) -> list[str]:
    """Lowercase, classify characters per `mode`, drop stopwords and short
    tokens. `max_tokens` mirrors `max_doc_buf_size` truncation
    (pipe/SimpleTokenizerLarge.java buffer limit)."""
    table = _TABLES[mode]
    out = []
    for tok in text.lower().translate(table).split():
        if len(tok) < min_len or tok in stoplist:
            continue
        out.append(tok)
        if max_tokens is not None and len(out) >= max_tokens:
            break
    return out


def tokenize_docs(texts: Iterable[str], **kw) -> list[list[str]]:
    """`tokenize` of every text, with the same keyword arguments."""
    return [tokenize(t, **kw) for t in texts]


def predicate_filter(doc_tokens: list[list[str]],
                     predicate: Callable[[str], bool]) -> list[list[str]]:
    """Keep only tokens the predicate accepts — the
    TokenSequencePredicateMatcher pipe
    (pipe/TokenSequencePredicateMatcher.java:22-34)."""
    return [[t for t in doc if predicate(t)] for doc in doc_tokens]
