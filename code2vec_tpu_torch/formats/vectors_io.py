"""``code.vec``: the exported code vectors, word2vec text format.

Own copy of ``code2vec_tpu/formats/vectors_io.py``'s readers and writers,
so the files interchange byte for byte with the JAX package's. Line 1 is
``<count>\t<dim>``, then one ``label\t<space-separated floats>`` row per
method (``str(float(e))`` of each element). Also the test-result TSV
the trainer's export writes beside it.
"""

from __future__ import annotations

import os
from typing import IO, Iterable, Sequence

import numpy as np


def write_code_vectors_header(path: str | os.PathLike, count: int, dim: int) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(f"{count}\t{dim}\n")


def append_code_vectors(path: str | os.PathLike, labels: Sequence[str],
                        vectors: np.ndarray) -> None:
    """Append label+vector rows."""
    with open(path, "a", encoding="utf-8") as f:
        for label, vec in zip(labels, vectors):
            f.write(label + "\t" + " ".join(str(float(e)) for e in vec) + "\n")


def read_code_vectors(path: str | os.PathLike) -> tuple[list[str], np.ndarray]:
    """``(labels, f32 [n, dim])``. The header's count may disagree with the
    rows (an exporter may append rows per best epoch); the rows win."""
    labels: list[str] = []
    rows: list[np.ndarray] = []
    with open(path, encoding="utf-8") as f:
        header = f.readline().strip().split("\t")
        dim = int(header[1])
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            label, values = line.split("\t")
            labels.append(label)
            rows.append(np.array([float(v) for v in values.split(" ")], np.float32))
    arr = np.stack(rows) if rows else np.zeros((0, dim), np.float32)
    return labels, arr


def write_test_results(f: IO[str], ids: Iterable[int], expected: Iterable[str],
                       predicted: Iterable[str], probs: Iterable[float]) -> None:
    """The test-result TSV: ``id\\tcorrect?\\texpected\\tpredicted\\tprob``
    per example (reference: main.py:418-420)."""
    for i, exp, pred, prob in zip(ids, expected, predicted, probs):
        f.write(f"{i}\t{exp == pred}\t{exp}\t{pred}\t{prob}\n")
