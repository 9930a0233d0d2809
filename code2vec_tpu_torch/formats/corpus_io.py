"""``corpus.txt``: the text corpus, read as a stream and written.

Own copy of the text half of ``code2vec_tpu/formats/corpus_io.py``
(the binary CSR container is not ported yet). Record format (reference
extractor, create_path_contexts.ipynb cell11; parsed at
model/dataset_reader.py:72-128)::

    #<int id>
    label:<original method name>
    class:<source file path>
    paths:
    <startIdx>\\t<pathIdx>\\t<endIdx>      (one per path-context)
    vars:
    <originalName>\\t<aliasName>           (e.g. counter\\t@var_0)

Records are separated by blank lines; a ``doc:`` line is kept apart.
Terminal indices are raw, as on disk: the ``@question`` +1 shift belongs
to ``data/reader.py``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import IO, Iterator

CSR_MAGIC = b"C2VCSR1\n"


@dataclass
class CorpusRecord:
    """One method of the corpus, indices raw as on disk."""

    id: int | None = None
    label: str | None = None
    source: str | None = None
    doc: str | None = None
    path_contexts: list[tuple[int, int, int]] = field(default_factory=list)
    aliases: list[tuple[str, str]] = field(default_factory=list)  # (original, alias)


_MODE_HEADER, _MODE_PATHS, _MODE_VARS = 0, 1, 2


def iter_corpus_records(path: str | os.PathLike) -> Iterator[CorpusRecord]:
    """Stream the records of a corpus file (the reference's three parse
    modes, model/dataset_reader.py:72-128)."""
    record: CorpusRecord | None = None
    mode = _MODE_HEADER
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip(" \r\n\t")
            if line == "":
                if record is not None:
                    yield record
                    record = None
                continue
            if record is None:
                record = CorpusRecord()
                mode = _MODE_HEADER
            if line.startswith("#"):
                record.id = int(line[1:])
            elif line.startswith("label:"):
                record.label = line[6:]
            elif line.startswith("class:"):
                record.source = line[6:]
            elif line.startswith("doc:"):
                record.doc = line[4:]
            elif line.startswith("paths:"):
                mode = _MODE_PATHS
            elif line.startswith("vars:"):
                mode = _MODE_VARS
            elif mode == _MODE_PATHS:
                # the first three fields; extra columns are tolerated
                fields = line.split("\t")
                record.path_contexts.append((int(fields[0]), int(fields[1]), int(fields[2])))
            elif mode == _MODE_VARS:
                fields = line.split("\t")
                record.aliases.append((fields[0], fields[1]))
    if record is not None:
        yield record


def write_corpus_record(f: IO[str], record: CorpusRecord) -> None:
    """One record followed by the blank separator line."""
    f.write(f"#{record.id}\n")
    f.write(f"label:{record.label}\n")
    if record.source is not None:
        f.write(f"class:{record.source}\n")
    if record.doc is not None:
        f.write(f"doc:{record.doc}\n")
    f.write("paths:\n")
    for start, p, end in record.path_contexts:
        f.write(f"{start}\t{p}\t{end}\n")
    f.write("vars:\n")
    for original, alias in record.aliases:
        f.write(f"{original}\t{alias}\n")
    f.write("\n")


def write_corpus(path: str | os.PathLike, records: list[CorpusRecord]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for record in records:
            write_corpus_record(f, record)


def is_csr_corpus(path: str | os.PathLike) -> bool:
    """True when ``path`` starts with the binary CSR container's magic."""
    try:
        with open(path, "rb") as f:
            return f.read(len(CSR_MAGIC)) == CSR_MAGIC
    except OSError:
        return False
