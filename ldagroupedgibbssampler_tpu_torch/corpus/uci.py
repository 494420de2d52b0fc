"""Readers for the reference's input formats.

UCI-style single file, one document per line:
    docno:<id>\t<label>\t<text...>
(reference: src/main/resources/datasets/cats.txt:1-3, datasets/README.txt;
loaded by LDAUtils.loadDataset, util/LDAUtils.java:136-186). The `docno:`
prefix is optional; lines with fewer than three tab fields fall back to
treating everything after the first (or zeroth) tab as text.

Directory-of-files ingestion mirrors LDAUtils.loadInstanceDirectory/
Directories (util/LDAUtils.java:1915-2072): each matching file is one
document, label = parent directory name.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Iterator


@dataclass
class RawDoc:
    doc_id: str
    label: str
    text: str


def iter_uci_lines(path: str) -> Iterator[RawDoc]:
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for lineno, line in enumerate(f):
            line = line.rstrip("\n")
            if not line.strip():
                continue
            parts = line.split("\t")
            if len(parts) >= 3:
                doc_id, label, text = parts[0], parts[1], "\t".join(parts[2:])
            elif len(parts) == 2:
                doc_id, label, text = parts[0], "X", parts[1]
            else:
                doc_id, label, text = str(lineno), "X", parts[0]
            if doc_id.startswith("docno:"):
                doc_id = doc_id[len("docno:"):]
            yield RawDoc(doc_id=doc_id, label=label, text=text)


def read_uci_file(path: str) -> list[RawDoc]:
    return list(iter_uci_lines(path))


def read_directory(path: str, file_regex: str = r".*\.txt$") -> list[RawDoc]:
    """Recursive directory reader; label is the immediate parent directory
    (util/LDAUtils.java:1915-2072; `file_regex` config key)."""
    rx = re.compile(file_regex)
    docs: list[RawDoc] = []
    for root, _dirs, files in sorted(os.walk(path)):
        for fn in sorted(files):
            if not rx.match(fn):
                continue
            full = os.path.join(root, fn)
            with open(full, "r", encoding="utf-8", errors="replace") as f:
                text = f.read()
            docs.append(RawDoc(doc_id=os.path.relpath(full, path),
                               label=os.path.basename(root), text=text))
    return docs
