"""The native ``corpus.txt`` parser: ``c2v_parse_corpus`` of ``libc2v.so``.

Counterpart of JAX ``extractor.py:258-333`` (``parse_corpus_native``). The
library is the one ``extractor.build_extractor`` compiles from
``extractor/src`` with ``g++`` at first use (``capi.cc:134``); nothing else
is built. The path-triple lines are ~98% of a corpus's bytes, and the C++
state machine reads them ~20x faster than the Python one
(``formats/corpus_io.iter_corpus_records``), with the same records out.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

_lock = threading.Lock()


class _C2vCorpus(ctypes.Structure):
    """``C2vCorpus`` of ``extractor/src/capi.cc``."""

    _fields_ = [
        ("n_records", ctypes.c_int64),
        ("n_contexts", ctypes.c_int64),
        ("starts", ctypes.POINTER(ctypes.c_int32)),
        ("paths", ctypes.POINTER(ctypes.c_int32)),
        ("ends", ctypes.POINTER(ctypes.c_int32)),
        ("row_splits", ctypes.POINTER(ctypes.c_int64)),
        ("ids", ctypes.POINTER(ctypes.c_int64)),
        ("headers", ctypes.POINTER(ctypes.c_char)),
        ("headers_len", ctypes.c_int64),
        ("vars", ctypes.POINTER(ctypes.c_char)),
        ("vars_len", ctypes.c_int64),
    ]


def _library():
    """``libc2v.so`` (built first if need be) with the parser's signatures."""
    from code2vec_tpu_torch.extractor import load_library

    lib = load_library()
    with _lock:
        lib.c2v_parse_corpus.restype = ctypes.POINTER(_C2vCorpus)
        lib.c2v_parse_corpus.argtypes = [ctypes.c_char_p]
        lib.c2v_free_corpus.argtypes = [ctypes.POINTER(_C2vCorpus)]
    return lib


def parse_corpus_native(path: str | os.PathLike):
    """``(starts, paths, ends, row_splits, ids, headers, var_lists)`` of a
    ``corpus.txt``: numpy copies of the raw arrays (no ``@question`` shift;
    an id of -1 where a record has no ``#id`` line), the records' ``(label,
    source | None)`` and their ``[(original, alias), ...]``. Raises
    RuntimeError when the parse fails."""
    from code2vec_tpu_torch.obs.trace import get_tracer

    lib = _library()
    with get_tracer().span("parse_corpus_native", category="extract"):
        ptr = lib.c2v_parse_corpus(os.fspath(path).encode())
    if not ptr:
        raise RuntimeError("native corpus parse failed: " + lib.c2v_last_error().decode("utf-8"))
    try:
        c = ptr.contents
        n, total = int(c.n_records), int(c.n_contexts)

        def arr(p, count, dtype):
            if count == 0:
                return np.zeros(0, dtype)
            return np.ctypeslib.as_array(p, shape=(count,)).astype(dtype, copy=True)

        starts, paths, ends = (arr(c.starts, total, np.int32), arr(c.paths, total, np.int32),
                               arr(c.ends, total, np.int32))
        row_splits, ids = arr(c.row_splits, n + 1, np.int64), arr(c.ids, n, np.int64)
        headers_blob = ctypes.string_at(c.headers, c.headers_len).decode("utf-8")
        vars_blob = ctypes.string_at(c.vars, c.vars_len).decode("utf-8")
    finally:
        lib.c2v_free_corpus(ptr)
    headers = []
    for rec in headers_blob.split("\x1e")[:n]:
        label, _, flagged_source = rec.partition("\x1f")
        headers.append((label, flagged_source[1:] if flagged_source[:1] == "1" else None))
    var_lists = []
    for rec in vars_blob.split("\x1e")[:n]:
        pairs = []
        for item in rec.split("\x1d"):
            if item:
                original, _, alias = item.partition("\x1f")
                pairs.append((original, alias))
        var_lists.append(pairs)
    return starts, paths, ends, row_splits, ids, headers, var_lists
