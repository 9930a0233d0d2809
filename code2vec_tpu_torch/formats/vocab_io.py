"""Vocab files (``terminal_idxs.txt`` / ``path_idxs.txt`` / labels).

Own copy of ``code2vec_tpu/formats/vocab_io.py``. Format: ``<index>\\t<name>``
per line; index 0 is the ``<PAD/>`` sentinel and blank names are
tolerated. ``extra_tokens`` occupy indices 1..k and every file index > 0
is shifted up by k: the terminal vocab is read with ``["@question"]``
(reference: model/dataset_reader.py:18-41).
"""

from __future__ import annotations

import os
from typing import Iterable, Sequence

from code2vec_tpu_torch.data.vocab import Vocab

__all__ = ["Vocab", "read_vocab", "write_vocab", "write_vocab_from_names"]


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


def write_vocab_from_names(path: str | os.PathLike, names: Iterable[str],
                           pad_name: str = "<PAD/>") -> None:
    """A vocab file with the PAD sentinel at 0 and ``names`` at 1..n."""
    def rows():
        yield 0, pad_name
        yield from enumerate(names, start=1)

    write_vocab(path, rows())
