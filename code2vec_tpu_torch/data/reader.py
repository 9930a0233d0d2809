"""Corpus -> flat CSR numpy arrays.

Own copy of ``code2vec_tpu/data/reader.py``: one flat int32 array per
field plus ``row_splits``, so per-epoch resampling is vectorized numpy.
Terminal indices are stored shifted (+1 for the injected ``@question``
token), as the reference shifts at parse time
(model/dataset_reader.py:113-115), and the label vocab is built record
by record in the reference's insertion order, one implementation for
every route:

- a text corpus goes through the native parser (``c2v_parse_corpus`` of
  the ``g++``-built ``libc2v.so``, ``data/corpus_parser.py``),
  or the Python parser when the native one cannot run (logged);
- the parsed arrays land in a sidecar cache beside the corpus
  (``<corpus>.cache-<digest>.npz`` / ``.json``, keyed on the inputs'
  size and mtime and the task flags), JAX's names and layout, so either
  package loads a cache the other wrote;
- a CSR container (``formats/corpus_io.py``) is detected by its magic and
  opened mmap-backed (:func:`load_corpus_csr`): no parse, no cache.

Host sharding (``shard=(index, count)``, JAX ``:73-106``, ``:372``): a
feed group of a mesh loads only the records ``i % count == index`` (the
label vocab still from every record, so it is the same on every rank);
a sharded CSR container keeps the whole mapped arrays and reaches its
items through ``row_base``.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import zipfile
from dataclasses import dataclass, field

import numpy as np

from code2vec_tpu_torch import QUESTION_TOKEN_INDEX, QUESTION_TOKEN_NAME
from code2vec_tpu_torch.data.vocab import Vocab
from code2vec_tpu_torch.formats.corpus_io import (
    FLAG_ID,
    is_csr_corpus,
    iter_corpus_records,
    open_corpus_csr,
)
from code2vec_tpu_torch.formats.vocab_io import read_vocab
from code2vec_tpu_torch.text import normalize_and_subtokenize

logger = logging.getLogger(__name__)


@dataclass
class CorpusData:
    """The whole corpus in structure-of-arrays form: method ``i`` owns the
    slice ``row_splits[i]:row_splits[i+1]`` of the flat context arrays."""

    starts: np.ndarray  # int32 [total_contexts], @question-shifted
    paths: np.ndarray  # int32 [total_contexts]
    ends: np.ndarray  # int32 [total_contexts], @question-shifted
    row_splits: np.ndarray  # int64 [n_items + 1]
    ids: np.ndarray  # int64 [n_items], corpus record ids
    labels: np.ndarray  # int32 [n_items], label vocab index (-1 without the method task)
    normalized_labels: list[str]
    sources: list[str | None]
    aliases: list[dict[str, str]]  # alias name -> normalized original name
    terminal_vocab: Vocab = field(repr=False)
    path_vocab: Vocab = field(repr=False)
    label_vocab: Vocab = field(repr=False)
    infer_method: bool = True
    infer_variable: bool = False
    # the sorted shifted ids of the terminals named "@var_*" (reference:
    # model/dataset_reader.py:54-56), the variable task's remap set
    variable_indexes: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    # True when starts/paths/ends are mmap views of a CSR container: a
    # gather pages only the rows it touches, and make_batch_source picks
    # the feed that never materializes an epoch
    mmap_backed: bool = False
    # each local item's first context in the flat arrays when it differs
    # from ``row_splits[:-1]``: a sharded mmap corpus keeps the whole mapped
    # arrays with LOCAL row_splits (None: contiguous)
    row_base: np.ndarray | None = None
    # host sharding: (index, count) when loaded with load_corpus(shard=...),
    # holding records i % count == index; vocabs stay global
    shard: tuple[int, int] | None = None
    global_n_items: int = -1

    @property
    def n_items(self) -> int:
        return len(self.row_splits) - 1

    def local_rows_of_global(self, global_idx: np.ndarray) -> np.ndarray:
        """A GLOBAL item-index array (a split every rank draws alike)
        filtered to this shard, in order, as LOCAL rows (JAX ``:91``)."""
        if self.shard is None:
            return np.asarray(global_idx)
        index, count = self.shard
        g = np.asarray(global_idx)
        return g[g % count == index] // count

    def global_of_local(self, local_idx: np.ndarray) -> np.ndarray:
        if self.shard is None:
            return np.asarray(local_idx)
        index, count = self.shard
        return np.asarray(local_idx) * count + index

    @property
    def n_contexts(self) -> int:
        return int(self.row_splits[-1])

    def context_counts(self) -> np.ndarray:
        return np.diff(self.row_splits)

    @property
    def method_token_index(self) -> int | None:
        """Shifted index of ``@method_0``, replaced by ``@question`` so the
        answer does not leak (model/dataset_builder.py:124)."""
        return self.terminal_vocab.stoi.get("@method_0")


def _build_label_state(headers, var_lists, infer_method, infer_variable):
    """Per-record labels and aliases, over every record in file order, so
    label indices are the reference's (model/dataset_reader.py:94-125)."""
    label_vocab = Vocab()
    labels: list[int] = []
    normalized_labels: list[str] = []
    sources: list[str | None] = []
    aliases: list[dict[str, str]] = []
    for (label, source), var_pairs in zip(headers, var_lists):
        sources.append(source)
        normalized_lower, _ = normalize_and_subtokenize(label)
        normalized_labels.append(normalized_lower)
        labels.append(label_vocab.add_label(label) if infer_method else -1)
        alias_map: dict[str, str] = {}
        for original, alias in var_pairs:
            alias_map[alias] = normalize_and_subtokenize(original)[0].lower()
            if infer_variable and alias.startswith("@var_"):
                label_vocab.add_label(original)
        aliases.append(alias_map)
    return label_vocab, labels, normalized_labels, sources, aliases


def _variable_indexes_of(terminal_vocab: Vocab) -> np.ndarray:
    return np.asarray(sorted(idx for name, idx in terminal_vocab.stoi.items()
                             if name.startswith("@var_")), dtype=np.int32)


def _cache_fingerprint(corpus_path, path_idx_path, terminal_idx_path, infer_method,
                       infer_variable, shard=None) -> dict:
    """What a cache is valid for (JAX ``reader.py:123``)."""
    def stat(p):
        st = os.stat(p)
        return [int(st.st_size), int(st.st_mtime_ns)]

    return {"version": 1, "corpus": stat(corpus_path), "path_idx": stat(path_idx_path),
            "terminal_idx": stat(terminal_idx_path), "infer_method": infer_method,
            "infer_variable": infer_variable,
            "shard": list(shard) if shard is not None else None}


_CACHE_ARRAY_KEYS = ("starts", "paths", "ends", "row_splits", "ids", "labels",
                     "variable_indexes")


def _cache_digest(fingerprint) -> str:
    return hashlib.sha1(json.dumps(fingerprint, sort_keys=True).encode()).hexdigest()[:16]


def _cache_file_paths(corpus_path, fingerprint) -> tuple[str, str]:
    """The ``(npz, json)`` sidecars, keyed by the digest, so runs with other
    task flags or another corpus version use other files."""
    digest = _cache_digest(fingerprint)
    return f"{corpus_path}.cache-{digest}.npz", f"{corpus_path}.cache-{digest}.json"


def _try_load_cache(corpus_path, fingerprint) -> dict | None:
    """The cached arrays and metadata, or None (absent, stale, or
    unreadable: a damaged cache means a re-parse, with a warning)."""
    npz_path, meta_path = _cache_file_paths(corpus_path, fingerprint)
    if not (os.path.exists(npz_path) and os.path.exists(meta_path)):
        return None
    try:
        with open(meta_path, encoding="utf-8") as f:
            meta = json.load(f)
        if meta.get("fingerprint") != fingerprint:
            return None
        with np.load(npz_path) as npz:
            arrays = {k: np.array(npz[k]) for k in _CACHE_ARRAY_KEYS}
        return {"meta": meta, "arrays": arrays}
    except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
        logger.warning("ignoring unreadable corpus cache: %s", e)
        return None


def _write_cache(corpus_path, fingerprint, data: CorpusData) -> None:
    """Both sidecars, each written to a per-process temp name and renamed
    into place; a failure is a warning, not an error."""
    npz_path, meta_path = _cache_file_paths(corpus_path, fingerprint)
    tmp_suffix = f".tmp{os.getpid()}"
    try:
        np.savez(npz_path + tmp_suffix + ".npz", **{k: getattr(data, k) for k in _CACHE_ARRAY_KEYS})
        os.replace(npz_path + tmp_suffix + ".npz", npz_path)
        with open(meta_path + tmp_suffix, "w", encoding="utf-8") as f:
            json.dump({"fingerprint": fingerprint, "label_vocab": data.label_vocab.to_state(),
                       "normalized_labels": data.normalized_labels, "sources": data.sources,
                       "aliases": data.aliases,
                       "shard": list(data.shard) if data.shard else None,
                       "global_n_items": data.global_n_items},
                      f)
        os.replace(meta_path + tmp_suffix, meta_path)
        logger.info("wrote corpus cache: %s", npz_path)
    except OSError as e:
        logger.warning("could not write corpus cache (continuing): %s", e)


def _read_vocabs(path_idx_path, terminal_idx_path):
    return (read_vocab(path_idx_path),
            read_vocab(terminal_idx_path, extra_tokens=[QUESTION_TOKEN_NAME]))


def load_corpus_csr(
    corpus_path: str | os.PathLike,
    path_idx_path: str | os.PathLike,
    terminal_idx_path: str | os.PathLike,
    infer_method: bool = True,
    infer_variable: bool = False,
    shard: tuple[int, int] | None = None,
) -> CorpusData:
    """A CSR container as an mmap-backed :class:`CorpusData` (JAX
    ``reader.py:263``): the context arrays stay views of the file (stored
    ``@question``-shifted, so they feed training as they are); only the
    O(items) bookkeeping and the label/alias pass materialize. A container
    written with another shift is shifted once into RAM (logged).
    ``shard=(index, count)`` keeps the whole mapped arrays and maps this
    shard's items onto them with local ``row_splits`` and ``row_base``."""
    corpus = open_corpus_csr(corpus_path)
    path_vocab, terminal_vocab = _read_vocabs(path_idx_path, terminal_idx_path)
    if corpus.terminal_shift == QUESTION_TOKEN_INDEX:
        starts, paths, ends = corpus.starts, corpus.paths, corpus.ends
        mmap_backed = True
    else:
        logger.warning("CSR container stores terminal_shift=%d (expected %d); materializing "
                       "shifted copies: re-run tools/corpus_convert.py for zero-copy feeding",
                       corpus.terminal_shift, QUESTION_TOKEN_INDEX)
        delta = np.int32(QUESTION_TOKEN_INDEX - corpus.terminal_shift)
        starts, ends = corpus.starts + delta, corpus.ends + delta
        paths = np.array(corpus.paths)
        mmap_backed = False
    n = corpus.n_items
    headers = [(corpus.label(i) or "", corpus.source(i)) for i in range(n)]
    var_lists = [corpus.aliases(i) for i in range(n)]
    label_vocab, labels, normalized_labels, sources, aliases = _build_label_state(
        headers, var_lists, infer_method, infer_variable)
    ids = corpus.ids.astype(np.int64)
    missing_id = (corpus.flags & FLAG_ID) == 0  # records without a #id line: positional
    if missing_id.any():
        ids = ids.copy()
        ids[missing_id] = np.nonzero(missing_id)[0]
    global_splits = corpus.row_splits
    row_splits, row_base = global_splits.astype(np.int64), None
    if shard is not None:
        index, count = shard
        local = np.arange(index, n, count)
        row_splits = np.zeros(len(local) + 1, np.int64)
        np.cumsum(np.diff(global_splits)[local], out=row_splits[1:])
        row_base = global_splits[local].astype(np.int64)
        ids = ids[local]
        labels, normalized_labels, sources, aliases = (
            x[index::count] for x in (labels, normalized_labels, sources, aliases))
    data = CorpusData(
        starts=starts, paths=paths, ends=ends, row_splits=row_splits,
        ids=ids, labels=np.asarray(labels, dtype=np.int32), normalized_labels=normalized_labels,
        sources=sources, aliases=aliases, terminal_vocab=terminal_vocab, path_vocab=path_vocab,
        label_vocab=label_vocab, infer_method=infer_method, infer_variable=infer_variable,
        variable_indexes=_variable_indexes_of(terminal_vocab), mmap_backed=mmap_backed,
        row_base=row_base, shard=shard, global_n_items=n,
    )
    logger.info("corpus (csr mmap): %d items, %d contexts", data.n_items, data.n_contexts)
    return data


def _parse_python(corpus_path, shard=None):
    """The Python parser: the arrays (raw ids) and the per-record fields;
    with ``shard`` only the shard's records' contexts are kept (ids
    too), every record's header read."""
    starts, paths, ends, counts, id_list, headers, var_lists = [], [], [], [], [], [], []
    for record in iter_corpus_records(corpus_path):
        index = len(headers)
        headers.append((record.label or "", record.source))
        var_lists.append(record.aliases)
        if shard is not None and index % shard[1] != shard[0]:
            continue  # the context arrays stay 1/count a rank
        id_list.append(record.id if record.id is not None else index)
        contexts = np.asarray(record.path_contexts, dtype=np.int32).reshape(-1, 3)
        starts.append(contexts[:, 0])
        paths.append(contexts[:, 1])
        ends.append(contexts[:, 2])
        counts.append(len(contexts))
    row_splits = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=row_splits[1:])

    def flat(parts):
        return np.concatenate(parts) if parts else np.zeros(0, np.int32)

    return (flat(starts), flat(paths), flat(ends), row_splits,
            np.asarray(id_list, dtype=np.int64), headers, var_lists)


def _parse_native(corpus_path):
    """The native parser's arrays, positional ids where a record has none;
    None (logged) when it cannot run, and the Python parser takes over (JAX
    ``reader.py:466-475``)."""
    try:
        from code2vec_tpu_torch.data.corpus_parser import parse_corpus_native

        starts, paths, ends, row_splits, ids, headers, var_lists = parse_corpus_native(
            corpus_path)
    except Exception as e:  # a missing compiler, a parse error, ...
        logger.warning("native corpus parser unavailable (%s); using Python parser", e)
        return None
    missing_id = ids < 0
    if missing_id.any():
        ids = ids.copy()
        ids[missing_id] = np.nonzero(missing_id)[0]
    return starts, paths, ends, row_splits, ids, headers, var_lists


def _shard_parsed(parsed, shard):
    """The native parse's arrays cut to the shard's records (a vectorized
    CSR row gather); the headers stay whole."""
    starts, paths, ends, row_splits, ids, headers, var_lists = parsed
    local = np.arange(shard[0], len(row_splits) - 1, shard[1])
    counts = np.diff(row_splits)[local]
    new_splits = np.zeros(len(local) + 1, np.int64)
    np.cumsum(counts, out=new_splits[1:])
    flat = np.repeat(row_splits[local] - new_splits[:-1], counts) + np.arange(int(counts.sum()))
    return (starts[flat], paths[flat], ends[flat], new_splits, ids[local], headers, var_lists)


def load_corpus(
    corpus_path: str | os.PathLike,
    path_idx_path: str | os.PathLike,
    terminal_idx_path: str | os.PathLike,
    infer_method: bool = True,
    infer_variable: bool = False,
    cache: bool = True,
    native: bool = True,
    shard: tuple[int, int] | None = None,
) -> CorpusData:
    """Vocabs + a corpus -> :class:`CorpusData` (JAX ``load_corpus``): a
    CSR container through :func:`load_corpus_csr`; a text corpus from the
    cache when it is valid, else parsed (``native``: the C++ parser, else
    or on its failure the Python one) and cached (``cache``). Every route
    gives the same arrays. ``shard=(index, count)`` keeps the records
    ``i % count == index`` (JAX ``load_corpus``): the Python parser skips
    the others' contexts as it reads, the native one parses all and slices;
    the label vocab comes from every record."""
    if is_csr_corpus(corpus_path):
        return load_corpus_csr(corpus_path, path_idx_path, terminal_idx_path,
                               infer_method=infer_method, infer_variable=infer_variable,
                               shard=shard)
    fingerprint = (_cache_fingerprint(corpus_path, path_idx_path, terminal_idx_path,
                                      infer_method, infer_variable, shard) if cache else None)
    cached = _try_load_cache(corpus_path, fingerprint) if cache else None
    path_vocab, terminal_vocab = _read_vocabs(path_idx_path, terminal_idx_path)
    if cached is not None:
        arrays, meta = cached["arrays"], cached["meta"]
        data = CorpusData(
            **{k: arrays[k] for k in _CACHE_ARRAY_KEYS},
            normalized_labels=meta["normalized_labels"], sources=meta["sources"],
            aliases=meta["aliases"], terminal_vocab=terminal_vocab, path_vocab=path_vocab,
            label_vocab=Vocab.from_state(meta["label_vocab"]), infer_method=infer_method,
            infer_variable=infer_variable,
            shard=tuple(meta["shard"]) if meta.get("shard") else None,
            global_n_items=meta.get("global_n_items", -1),
        )
        logger.info("corpus (cached): %d items, %d contexts", data.n_items, data.n_contexts)
        return data
    parsed = _parse_native(corpus_path) if native else None
    parser = "native parse" if parsed is not None else "python parse"
    if parsed is None:
        parsed = _parse_python(corpus_path, shard)
    elif shard is not None:
        parsed = _shard_parsed(parsed, shard)
    raw_starts, paths, raw_ends, row_splits, ids, headers, var_lists = parsed
    label_vocab, labels, normalized_labels, sources, aliases = _build_label_state(
        headers, var_lists, infer_method, infer_variable)
    if shard is not None:
        index, count = shard
        labels, normalized_labels, sources, aliases = (
            x[index::count] for x in (labels, normalized_labels, sources, aliases))
    data = CorpusData(
        starts=raw_starts + QUESTION_TOKEN_INDEX, paths=paths,
        ends=raw_ends + QUESTION_TOKEN_INDEX, row_splits=row_splits, ids=ids,
        labels=np.asarray(labels, dtype=np.int32), normalized_labels=normalized_labels,
        sources=sources, aliases=aliases, terminal_vocab=terminal_vocab, path_vocab=path_vocab,
        label_vocab=label_vocab, infer_method=infer_method, infer_variable=infer_variable,
        variable_indexes=_variable_indexes_of(terminal_vocab), shard=shard,
        global_n_items=len(headers),
    )
    logger.info("corpus (%s): %d items, %d contexts; vocabs: %d terminals, %d paths, "
                "%d labels", parser, data.n_items, data.n_contexts, len(terminal_vocab),
                len(path_vocab), len(label_vocab))
    if fingerprint is not None:
        _write_cache(corpus_path, fingerprint, data)
    return data
