"""Corpus -> flat CSR numpy arrays.

Own copy of ``code2vec_tpu/data/reader.py``'s Python parser: one flat
int32 array per field plus ``row_splits``, so per-epoch resampling is
vectorized numpy. Terminal indices are stored shifted (+1 for the
injected ``@question`` token), as the reference shifts at parse time
(model/dataset_reader.py:113-115), and the label vocab is built record
by record in the reference's insertion order.

Not ported yet, and refused when asked for: the native parser, the
sidecar digest cache, the binary CSR container and host sharding
(ROADMAP §A.2).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field

import numpy as np

from code2vec_tpu_torch import QUESTION_TOKEN_INDEX, QUESTION_TOKEN_NAME
from code2vec_tpu_torch.data.vocab import Vocab
from code2vec_tpu_torch.formats.corpus_io import is_csr_corpus, iter_corpus_records
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

    @property
    def n_items(self) -> int:
        return len(self.row_splits) - 1

    @property
    def n_contexts(self) -> int:
        return int(self.row_splits[-1])

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


def load_corpus(
    corpus_path: str | os.PathLike,
    path_idx_path: str | os.PathLike,
    terminal_idx_path: str | os.PathLike,
    infer_method: bool = True,
    infer_variable: bool = False,
    cache: bool = False,
    native: bool = False,
    shard: tuple[int, int] | None = None,
) -> CorpusData:
    """Vocabs + a text corpus -> :class:`CorpusData` (the JAX
    ``load_corpus`` with its Python parser). ``cache``, ``native``,
    ``shard`` and a CSR container are not ported and raise."""
    if cache or native or shard is not None:
        raise NotImplementedError(
            "load_corpus: the corpus cache, the native parser and host sharding "
            "are not ported yet (ROADMAP §A.2); the Python parser reads the text corpus"
        )
    if is_csr_corpus(corpus_path):
        raise NotImplementedError(
            f"{corpus_path} is a binary CSR container, which the port cannot read yet "
            "(ROADMAP §A.2); pass the text corpus"
        )
    path_vocab = read_vocab(path_idx_path)
    terminal_vocab = read_vocab(terminal_idx_path, extra_tokens=[QUESTION_TOKEN_NAME])
    starts, paths, ends, counts, id_list, headers, var_lists = [], [], [], [], [], [], []
    for record in iter_corpus_records(corpus_path):
        id_list.append(record.id if record.id is not None else len(headers))
        headers.append((record.label or "", record.source))
        var_lists.append(record.aliases)
        contexts = np.asarray(record.path_contexts, dtype=np.int32).reshape(-1, 3)
        starts.append(contexts[:, 0] + QUESTION_TOKEN_INDEX)
        paths.append(contexts[:, 1])
        ends.append(contexts[:, 2] + QUESTION_TOKEN_INDEX)
        counts.append(len(contexts))
    row_splits = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=row_splits[1:])

    def flat(parts):
        return np.concatenate(parts) if parts else np.zeros(0, np.int32)

    label_vocab, labels, normalized_labels, sources, aliases = _build_label_state(
        headers, var_lists, infer_method, infer_variable)
    data = CorpusData(
        starts=flat(starts), paths=flat(paths), ends=flat(ends), row_splits=row_splits,
        ids=np.asarray(id_list, dtype=np.int64), labels=np.asarray(labels, dtype=np.int32),
        normalized_labels=normalized_labels, sources=sources, aliases=aliases,
        terminal_vocab=terminal_vocab, path_vocab=path_vocab, label_vocab=label_vocab,
        infer_method=infer_method, infer_variable=infer_variable,
        variable_indexes=_variable_indexes_of(terminal_vocab),
    )
    logger.info("corpus: %d items, %d contexts; vocabs: %d terminals, %d paths, %d labels",
                data.n_items, data.n_contexts, len(terminal_vocab), len(path_vocab),
                len(label_vocab))
    return data
