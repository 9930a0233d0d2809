"""Vocab files (``terminal_idxs.txt`` / ``path_idxs.txt`` / labels).

Own copy of ``code2vec_tpu/formats/vocab_io.py`` and the parts of
``code2vec_tpu/data/vocab.py`` serving needs. Format: ``<index>\\t<name>``
per line; index 0 is the ``<PAD/>`` sentinel and blank names are
tolerated. ``extra_tokens`` occupy indices 1..k and every file index > 0
is shifted up by k: the terminal vocab is read with ``["@question"]``
(reference: model/dataset_reader.py:18-41).
"""

from __future__ import annotations

import os
from typing import Iterable, Sequence


class Vocab:
    """name <-> index maps. ``add`` ignores a name already present (the
    first index wins), like the reference Vocab (model/dataset.py:64-74)."""

    __slots__ = ("stoi", "itos")

    def __init__(self) -> None:
        self.stoi: dict[str, int] = {}
        self.itos: dict[int, str] = {}

    def __len__(self) -> int:
        return len(self.stoi)

    def add(self, name: str, index: int | None = None) -> int:
        existing = self.stoi.get(name)
        if existing is not None:
            return existing
        if index is None:
            index = len(self.stoi)
        self.stoi[name] = index
        self.itos[index] = name
        return index


def read_vocab(path: str | os.PathLike, extra_tokens: Sequence[str] = ()) -> Vocab:
    """Read a vocab file, injecting ``extra_tokens`` at indices 1..k and
    shifting file indices > 0 up by k."""
    vocab = Vocab()
    extra_size = len(extra_tokens)
    for offset, name in enumerate(extra_tokens):
        vocab.add(name, index=1 + offset)
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip(" \r\n")
            if not line:
                continue
            fields = line.split("\t")
            index = int(fields[0])
            if index > 0:
                index += extra_size
            vocab.add(fields[1] if len(fields) > 1 else "", index=index)
    return vocab


def write_vocab(path: str | os.PathLike, entries: Iterable[tuple[int, str]]) -> None:
    """Write ``index\\tname`` lines (callers emit ``0\\t<PAD/>`` first)."""
    with open(path, "w", encoding="utf-8") as f:
        for index, name in entries:
            f.write(f"{index}\t{name}\n")
