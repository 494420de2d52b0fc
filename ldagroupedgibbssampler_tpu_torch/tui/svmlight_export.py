"""Corpus exporter: svmlight / token-index-per-row formats.

The port's counterpart of `ldagroupedgibbssampler_tpu/tui/
svmlight_export.py`: host code, the same files byte for byte.
Replaces ``cc.mallet.topics.tui.SvmLightExporter``
(tui/SvmLightExporter.java:19-88): for each run x subconfig, load the
configured dataset and write

  * ``<conf>-corpus.txt``     one doc per row as comma-separated token
                              ids (writeTokensPerRow -> LDAUtils.
                              instanceToTokenIndexString, LDAUtils.java:
                              1501-1516; empty docs -> ``<empty doc>``)
  * ``<conf>-vocabulary.txt`` one vocab surface form per row
                              (LDAUtils.extractVocabulaty)

and expose the svmlight writer the reference keeps alongside
(``writeSvnLight`` -> ``instanceToSvmLightString``, LDAUtils.java:
1518-1534): ``<num_tokens> idx:1 idx:1 ...`` per doc, one ``idx:1`` per
token POSITION (occurrences are not aggregated), ``0`` for empty docs.
"""

from __future__ import annotations

import os

from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus
from ldagroupedgibbssampler_tpu_torch.utils.logging_utils import RunLogger


def doc_token_index_string(tokens, no_words: int = -1) -> str:
    """instanceToTokenIndexString (LDAUtils.java:1501-1516)."""
    n = len(tokens) if no_words <= 0 else min(no_words, len(tokens))
    if n == 0:
        return "<empty doc>"
    return ", ".join(str(int(t)) for t in tokens[:n])


def doc_svmlight_string(tokens, no_words: int = -1) -> str:
    """instanceToSvmLightString (LDAUtils.java:1518-1534)."""
    n = len(tokens) if no_words <= 0 else min(no_words, len(tokens))
    if n == 0:
        return "0"
    return str(n) + " " + " ".join(f"{int(t)}:1" for t in tokens[:n])


def _doc_tokens(corpus: Corpus, d: int):
    return corpus.tokens[corpus.doc_offsets[d]: corpus.doc_offsets[d + 1]]


def write_tokens_per_row(corpus: Corpus, target_dir: str, corpus_fn: str,
                         no_words: int = -1) -> str:
    """writeTokensPerRow (SvmLightExporter.java:83-90)."""
    path = os.path.join(target_dir, corpus_fn)
    with open(path, "w", encoding="utf-8") as f:
        for d in range(corpus.num_docs):
            f.write(doc_token_index_string(_doc_tokens(corpus, d),
                                           no_words) + "\n")
    return path


def write_svmlight(corpus: Corpus, target_dir: str, corpus_fn: str,
                   no_words: int = -1) -> str:
    """writeSvnLight (SvmLightExporter.java:74-81)."""
    path = os.path.join(target_dir, corpus_fn)
    with open(path, "w", encoding="utf-8") as f:
        for d in range(corpus.num_docs):
            f.write(doc_svmlight_string(_doc_tokens(corpus, d),
                                        no_words) + "\n")
    return path


def write_vocabulary(corpus: Corpus, target_dir: str, vocab_fn: str) -> str:
    """LDAUtils.extractVocabulaty + writeStringArray
    (SvmLightExporter.java:66-68)."""
    path = os.path.join(target_dir, vocab_fn)
    with open(path, "w", encoding="utf-8") as f:
        for w in corpus.vocab:
            f.write(str(w) + "\n")
    return path


def export_corpus(corpus: Corpus, logger: RunLogger, conf_name: str,
                  svmlight: bool = False) -> dict:
    """The per-subconfig body of SvmLightExporter.main
    (tui/SvmLightExporter.java:62-68)."""
    out = {
        "corpus": write_tokens_per_row(
            corpus, logger.run_dir, f"{conf_name}-corpus.txt"),
        "vocabulary": write_vocabulary(
            corpus, logger.run_dir, f"{conf_name}-vocabulary.txt"),
    }
    if svmlight:
        out["svmlight"] = write_svmlight(
            corpus, logger.run_dir, f"{conf_name}-corpus.svmlight")
    return out


def read_token_index_corpus(path: str) -> list[list[int]]:
    """Round-trip reader for the token-index rows (test support)."""
    docs = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if line == "<empty doc>" or not line:
                docs.append([])
            else:
                docs.append([int(x) for x in line.split(", ")])
    return docs


def read_svmlight_corpus(path: str) -> list[list[int]]:
    """Round-trip reader for svmlight rows: expands idx:count pairs back
    to a token-id multiset (order preserved as written)."""
    docs = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0] == "0":
                docs.append([])
                continue
            toks = []
            for p in parts[1:]:
                idx, cnt = p.split(":")
                toks.extend([int(idx)] * int(cnt))
            docs.append(toks)
    return docs


def main(argv=None):
    from ldagroupedgibbssampler_tpu_torch.tui.common import iterate_runs

    def body(cfg, corpus, logger):
        return export_corpus(corpus, logger, cfg.active_subconfig,
                             svmlight=True)

    return iterate_runs(argv, body, "SvmLightExporter")


if __name__ == "__main__":
    main()
