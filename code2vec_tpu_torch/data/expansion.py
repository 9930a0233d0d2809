"""code2seq's expansion tables, built from the vocabularies the port reads.

code2seq (Alon et al., ICLR 2019) reads the same bag of path-contexts as
code2vec, but finer: a terminal as its subtokens, a path as its AST nodes
and a method name as its subtokens. The port's corpus holds one id a
terminal, a path and a label, so these tables map each id to its pieces
once, from the vocab strings, and the model expands a sampled batch on the
device (``models/code2seq.py``):

- a terminal's subtokens: the extractor's split of code2seq
  (``splitToSubtokens``: camelCase edges, ``_``, digits and white space cut;
  each piece lower-cased and reduced to its letters, empty pieces dropped),
  at most ``max_name_parts``; a name that yields none (``@question``, an
  operator) is one subtoken, its lower-cased self, as is every ``@``-name;
- a path's nodes: its string split at the ``↑``/``↓`` arrows the extractors
  write (``SimpleName↑MethodCallExpr↓NameExpr``), at most ``max_path_nodes``
  (the first ones; the extractors cap paths at 8 edges, so 9 nodes);
- a label's target subtokens: the label vocab's own subtokens (``text.py``),
  at most ``max_target_parts``.

The subtoken and target vocabularies rank each piece by the number of
names that hold it (ties in first-seen order) and keep the first
``subtoken_vocab`` / ``target_vocab``, code2seq's
``SUBTOKENS_VOCAB_MAX_SIZE`` / ``TARGET_VOCAB_MAX_SIZE``; a piece beyond is
UNK. Reserved ids: 0 is PAD (and, for targets, the end of a name, as in
code2seq's decoder), 1 UNK, and 2 the targets' start of sequence. The
vocab's PAD id maps to no piece at all.
"""

from __future__ import annotations

import re
from collections import Counter
from dataclasses import dataclass

import numpy as np

PAD, UNK, SOS = 0, 1, 2
SUBTOKEN_SPECIALS = 2  # PAD, UNK
NODE_SPECIALS = 2  # PAD, UNK
TARGET_SPECIALS = 3  # PAD (end of name), UNK, SOS
UP, DOWN = "↑", "↓"

_SPLIT = re.compile(r"(?<=[a-z])(?=[A-Z])|_|[0-9]|(?<=[A-Z])(?=[A-Z][a-z])|\s+")
_NOT_LETTER = re.compile(r"[^a-z]")
_ARROWS = re.compile(f"[{UP}{DOWN}]")


def split_subtokens(name: str) -> list[str]:
    """code2seq's subtokens of a terminal name (see the module docstring)."""
    if name.startswith("@"):
        return [name.lower()]
    pieces = [_NOT_LETTER.sub("", p.lower()) for p in _SPLIT.split(name.strip())]
    pieces = [p for p in pieces if p]
    return pieces or [name.lower()]


def split_nodes(path: str) -> list[str]:
    """A path string's nodes, at its ``↑``/``↓`` arrows."""
    return [n for n in _ARROWS.split(path) if n]


@dataclass
class Expansions:
    """The tables of one corpus's vocabularies (host int32 arrays), and the
    row counts of the three embedding tables they index."""

    term_subtokens: np.ndarray  # [terminal_count, max_name_parts]
    path_nodes: np.ndarray  # [path_count, max_path_nodes]
    path_lengths: np.ndarray  # [path_count]
    label_targets: np.ndarray  # [label_count, max_target_parts]
    label_lengths: np.ndarray  # [label_count]
    subtoken_count: int
    node_count: int
    target_count: int
    target_names: list  # each target id's subtoken; the reserved ids' names in brackets


def _ranked(pieces_of: dict, cap: int | None) -> dict:
    """``{piece: rank}`` by how many names hold it, ties first-seen first."""
    counts = Counter()
    for pieces in pieces_of.values():
        counts.update(list(dict.fromkeys(pieces)))
    ranked = sorted(counts, key=lambda p: -counts[p])  # stable: first-seen order on ties
    return {p: r for r, p in enumerate(ranked[:cap] if cap is not None else ranked)}


def _rows(vocab) -> int:
    return max(len(vocab), max(vocab.itos, default=-1) + 1)


def _table(vocab_size: int, pieces_of: dict, ids: dict, width: int,
           first_id: int) -> tuple[np.ndarray, np.ndarray]:
    out = np.zeros((vocab_size, width), np.int32)
    lengths = np.zeros(vocab_size, np.int32)
    for index, pieces in pieces_of.items():
        row = [first_id + ids[p] if p in ids else UNK for p in pieces[:width]]
        out[index, :len(row)] = row
        lengths[index] = len(row)
    return out, lengths


def build_expansions(terminal_vocab, path_vocab, label_vocab, *, max_name_parts: int = 5,
                     max_path_nodes: int = 9, max_target_parts: int = 6,
                     subtoken_vocab: int = 190_000, target_vocab: int = 27_000) -> Expansions:
    """The expansion tables of the port's three vocabularies (``data/vocab.
    Vocab``: terminal, path and label), index 0 of each being PAD."""
    terms = {i: split_subtokens(n) for i, n in terminal_vocab.itos.items() if i > 0}
    paths = {i: split_nodes(n) for i, n in path_vocab.itos.items() if i > 0}
    labels = {i: list(label_vocab.itosubtokens.get(i) or [n]) for i, n in
              label_vocab.itos.items()}
    sub_ids = _ranked(terms, subtoken_vocab)
    node_ids = _ranked(paths, None)
    tgt_ids = _ranked(labels, target_vocab)
    term_subtokens, _ = _table(_rows(terminal_vocab), terms, sub_ids, max_name_parts,
                               SUBTOKEN_SPECIALS)
    path_nodes, path_lengths = _table(_rows(path_vocab), paths, node_ids, max_path_nodes,
                                      NODE_SPECIALS)
    label_targets, label_lengths = _table(_rows(label_vocab), labels, tgt_ids, max_target_parts,
                                          TARGET_SPECIALS)
    return Expansions(term_subtokens=term_subtokens, path_nodes=path_nodes,
                      path_lengths=path_lengths, label_targets=label_targets,
                      label_lengths=label_lengths,
                      subtoken_count=SUBTOKEN_SPECIALS + len(sub_ids),
                      node_count=NODE_SPECIALS + len(node_ids),
                      target_count=TARGET_SPECIALS + len(tgt_ids),
                      target_names=["<PAD>", "<UNK>", "<SOS>", *tgt_ids])
