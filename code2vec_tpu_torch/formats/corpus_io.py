"""The corpus: ``corpus.txt`` read as a stream and written, and the
binary CSR container.

Own copy of ``code2vec_tpu/formats/corpus_io.py``, both halves. Text
record format (reference extractor, create_path_contexts.ipynb cell11;
parsed at model/dataset_reader.py:72-128)::

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

The CSR container (the out-of-core format, JAX ``:119-494``) holds the
same record stream as flat on-disk sections, so training gathers the rows
it touches through mmap views and a corpus larger than host RAM feeds in
bounded RSS. Layout, little-endian, sections 16-byte aligned::

    [0:8)     magic b"C2VCSR1\n"
    [8:16)    uint64 header length H
    [16:16+H) JSON header {version, n_items, n_contexts, terminal_shift,
                           sections: {name: [offset, dtype, n_elems]}}
    ...       sections: row_splits int64 [n+1]; starts/paths/ends int32
              [total]; ids int64 [n]; flags uint8 [n] (bit0 source, bit1
              doc, bit2 label, bit3 id present); (offsets int64, blob
              uint8) string tables for labels, sources, docs and vars; the
              footer histogram hist_lengths/hist_counts int64 of the
              context counts.

Start and end ids are stored shifted by ``terminal_shift`` (the reader's
``@question`` +1), so mmap feeding is zero-copy; the reverse conversion
subtracts it, and text -> CSR -> text is byte-faithful for corpora written
by :func:`write_corpus`. The bytes are JAX's: each package opens the
other's container.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import IO, Iterator

import numpy as np


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


CSR_MAGIC = b"C2VCSR1\n"
_CSR_ALIGN = 16
_ITEMSIZE = {"int64": 8, "int32": 4, "uint8": 1}
FLAG_SOURCE, FLAG_DOC, FLAG_LABEL, FLAG_ID = 1, 2, 4, 8


def _aligned(offset: int) -> int:
    return (offset + _CSR_ALIGN - 1) // _CSR_ALIGN * _CSR_ALIGN


class _StringTable:
    """An append-only UTF-8 string section: (offsets int64 [n+1], blob)."""

    def __init__(self):
        self._parts: list[bytes] = []
        self._offsets: list[int] = [0]

    def add(self, text: str) -> None:
        raw = text.encode("utf-8")
        self._parts.append(raw)
        self._offsets.append(self._offsets[-1] + len(raw))

    def arrays(self) -> tuple[np.ndarray, np.ndarray]:
        blob = b"".join(self._parts)
        return (np.asarray(self._offsets, np.int64),
                np.frombuffer(blob, np.uint8).copy() if blob else np.zeros(0, np.uint8))


class CsrCorpusWriter:
    """Text records -> a CSR container, streaming: the context columns
    spill to files as records arrive, so the writer's RSS is O(items +
    strings), never O(contexts). ``close()`` assembles the container."""

    def __init__(self, path: str | os.PathLike, terminal_shift: int = 0):
        self.path = os.fspath(path)
        self.terminal_shift = int(terminal_shift)
        self._tmp = [self.path + f".tmp{os.getpid()}.{k}" for k in "spe"]
        self._spill = [open(p, "wb") for p in self._tmp]
        self._counts: list[int] = []
        self._ids: list[int] = []
        self._flags: list[int] = []
        self._tables = {name: _StringTable() for name in ("label", "source", "doc", "var")}
        self._closed = False

    def add(self, record: CorpusRecord) -> None:
        contexts = np.asarray(record.path_contexts, np.int32).reshape(-1, 3)
        if self.terminal_shift:
            contexts = contexts + np.asarray([self.terminal_shift, 0, self.terminal_shift],
                                             np.int32)
        for col, f in enumerate(self._spill):
            f.write(np.ascontiguousarray(contexts[:, col]).tobytes())
        self._counts.append(len(contexts))
        self._flags.append((FLAG_SOURCE if record.source is not None else 0)
                           | (FLAG_DOC if record.doc is not None else 0)
                           | (FLAG_LABEL if record.label is not None else 0)
                           | (FLAG_ID if record.id is not None else 0))
        self._ids.append(record.id if record.id is not None else -1)
        self._tables["label"].add(record.label or "")
        self._tables["source"].add(record.source or "")
        self._tables["doc"].add(record.doc or "")
        self._tables["var"].add("".join(f"{orig}\t{alias}\n" for orig, alias in record.aliases))

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for f in self._spill:
            f.close()
        try:
            self._assemble()
        finally:
            for p in self._tmp:
                if os.path.exists(p):
                    os.remove(p)

    def _assemble(self) -> None:
        row_splits = np.zeros(len(self._counts) + 1, np.int64)
        np.cumsum(self._counts, out=row_splits[1:])
        total = int(row_splits[-1])
        lengths, weights = np.unique(np.asarray(self._counts, np.int64), return_counts=True)
        # name -> (array or spill path, dtype, n), in JAX's section order
        sections: dict[str, tuple[np.ndarray | str, str, int]] = {
            "row_splits": (row_splits, "int64", len(row_splits))}
        for name, tmp in zip(("starts", "paths", "ends"), self._tmp):
            sections[name] = (tmp, "int32", total)
        sections["ids"] = (np.asarray(self._ids, np.int64), "int64", len(self._ids))
        sections["flags"] = (np.asarray(self._flags, np.uint8), "uint8", len(self._flags))
        for prefix, table in self._tables.items():
            offsets, blob = table.arrays()
            sections[f"{prefix}_offsets"] = (offsets, "int64", len(offsets))
            sections[f"{prefix}_blob"] = (blob, "uint8", len(blob))
        sections["hist_lengths"] = (lengths.astype(np.int64), "int64", len(lengths))
        sections["hist_counts"] = (weights.astype(np.int64), "int64", len(weights))

        def render(table: dict) -> bytes:
            return json.dumps({"version": 1, "n_items": len(self._counts), "n_contexts": total,
                               "terminal_shift": self.terminal_shift, "sections": table},
                              sort_keys=True).encode("utf-8")

        # the header's length moves the first offset: lay out until stable
        header_len = len(render({n: [0, d, c] for n, (_, d, c) in sections.items()}))
        for _ in range(4):
            offset = _aligned(16 + header_len)
            table = {}
            for name, (_, dtype, n) in sections.items():
                table[name] = [offset, dtype, n]
                offset = _aligned(offset + n * _ITEMSIZE[dtype])
            header = render(table)
            if len(header) == header_len:
                break
            header_len = len(header)
        else:
            raise RuntimeError("csr header layout did not converge")

        tmp_out = self.path + f".tmp{os.getpid()}.out"
        with open(tmp_out, "wb") as out:
            out.write(CSR_MAGIC)
            out.write(np.uint64(header_len).tobytes())
            out.write(header)
            for name, (src, _, _) in sections.items():
                out.write(b"\0" * (table[name][0] - out.tell()))
                if isinstance(src, str):  # a context spill file: chunked copy
                    with open(src, "rb") as f:
                        while chunk := f.read(1 << 22):
                            out.write(chunk)
                else:
                    out.write(np.ascontiguousarray(src).tobytes())
        os.replace(tmp_out, self.path)

    def __enter__(self) -> "CsrCorpusWriter":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()


def write_corpus_csr(path: str | os.PathLike, records, terminal_shift: int = 0) -> None:
    """An iterable of :class:`CorpusRecord` written as a CSR container."""
    with CsrCorpusWriter(path, terminal_shift=terminal_shift) as writer:
        for record in records:
            writer.add(record)


def is_csr_corpus(path: str | os.PathLike) -> bool:
    """True when ``path`` starts with the binary CSR container's magic."""
    try:
        with open(path, "rb") as f:
            return f.read(len(CSR_MAGIC)) == CSR_MAGIC
    except OSError:
        return False


@dataclass
class CsrCorpus:
    """An open CSR container. ``starts``/``paths``/``ends`` are read-only
    views of one ``np.memmap`` (a gather pages only the rows it touches);
    ``row_splits``, ``ids``, ``flags`` and the histogram are small in-RAM
    copies."""

    path: str
    n_items: int
    n_contexts: int
    terminal_shift: int
    row_splits: np.ndarray  # int64 [n+1]
    starts: np.ndarray  # int32 [total], mmap view
    paths: np.ndarray  # int32 [total], mmap view
    ends: np.ndarray  # int32 [total], mmap view
    ids: np.ndarray  # int64 [n]
    flags: np.ndarray  # uint8 [n]
    hist_lengths: np.ndarray  # int64 [k]
    hist_counts: np.ndarray  # int64 [k]
    _mm: np.memmap = field(repr=False)
    _strings: dict = field(repr=False)

    def _string(self, prefix: str, i: int) -> str:
        offsets, blob = self._strings[prefix]
        return bytes(blob[offsets[i]:offsets[i + 1]]).decode("utf-8")

    def label(self, i: int) -> str | None:
        return self._string("label", i) if self.flags[i] & FLAG_LABEL else None

    def source(self, i: int) -> str | None:
        return self._string("source", i) if self.flags[i] & FLAG_SOURCE else None

    def doc(self, i: int) -> str | None:
        return self._string("doc", i) if self.flags[i] & FLAG_DOC else None

    def aliases(self, i: int) -> list[tuple[str, str]]:
        out = []
        for line in self._string("var", i).splitlines():
            original, alias = line.split("\t", 1)
            out.append((original, alias))
        return out

    def record(self, i: int) -> CorpusRecord:
        """Record ``i`` as the text layer has it (the shift removed)."""
        lo, hi = int(self.row_splits[i]), int(self.row_splits[i + 1])
        shift = self.terminal_shift
        return CorpusRecord(
            id=int(self.ids[i]) if self.flags[i] & FLAG_ID else None,
            label=self.label(i), source=self.source(i), doc=self.doc(i),
            path_contexts=[(int(s) - shift, int(p), int(e) - shift) for s, p, e in
                           zip(self.starts[lo:hi], self.paths[lo:hi], self.ends[lo:hi])],
            aliases=self.aliases(i),
        )

    def iter_records(self) -> Iterator[CorpusRecord]:
        for i in range(self.n_items):
            yield self.record(i)

    def close(self) -> None:
        """Nothing to release: the mapping goes with its last view (the
        views handed out keep it alive). Kept so a reader closes as JAX's
        does."""

    def __enter__(self) -> "CsrCorpus":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()


def open_corpus_csr(path: str | os.PathLike) -> CsrCorpus:
    """Open a CSR container, its context arrays mmap-backed."""
    path = os.fspath(path)
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    if bytes(mm[:len(CSR_MAGIC)]) != CSR_MAGIC:
        raise ValueError(f"{path!r} is not a CSR corpus container")
    header_len = int(mm[8:16].view(np.uint64)[0])
    try:
        header = json.loads(bytes(mm[16:16 + header_len]).decode("utf-8"))
    except ValueError as exc:
        raise ValueError(f"{path!r}: the CSR container's header does not parse ({exc})") from None
    if header.get("version") != 1:
        raise ValueError(f"unsupported CSR container version {header.get('version')!r}")

    def view(name: str) -> np.ndarray:
        offset, dtype, n = header["sections"][name]
        return mm[offset:offset + n * _ITEMSIZE[dtype]].view(dtype)

    strings = {prefix: (np.array(view(f"{prefix}_offsets")), view(f"{prefix}_blob"))
               for prefix in ("label", "source", "doc", "var")}
    return CsrCorpus(
        path=path, n_items=int(header["n_items"]), n_contexts=int(header["n_contexts"]),
        terminal_shift=int(header["terminal_shift"]), row_splits=np.array(view("row_splits")),
        starts=view("starts"), paths=view("paths"), ends=view("ends"),
        ids=np.array(view("ids")), flags=np.array(view("flags")),
        hist_lengths=np.array(view("hist_lengths")), hist_counts=np.array(view("hist_counts")),
        _mm=mm, _strings=strings,
    )


def read_csr_histogram(path: str | os.PathLike) -> tuple[np.ndarray, np.ndarray]:
    """``(lengths, counts)`` of the context counts, from the container's
    footer: no scan of the context sections."""
    with open_corpus_csr(path) as corpus:
        return corpus.hist_lengths, corpus.hist_counts
