"""Synthetic corpora with a learnable label <-> context signal.

Own copy of ``code2vec_tpu/data/synth.py``, draw for draw, so the files it
writes are byte-identical to the JAX module's for the same spec:

- ``generate_corpus_files``: text corpora in the extractor's format, for
  tests and CLI runs (``--synthetic``);
- ``generate_corpus_data`` + ``corpus_data_from_raw``: array corpora at
  any scale (the top11 vocab widths) without writing text.

Each label owns a signature pool of path-contexts; a method's bag is
mostly drawn from its label's pool plus uniform noise, so attention over
contexts predicts the label and F1 climbs within a few epochs.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from code2vec_tpu_torch.formats.corpus_io import CorpusRecord, write_corpus
from code2vec_tpu_torch.formats.params_io import write_params
from code2vec_tpu_torch.formats.vocab_io import write_vocab_from_names

_SUBTOKENS = [
    "get", "set", "is", "add", "remove", "find", "create", "build", "parse",
    "read", "write", "copy", "clear", "init", "close", "open", "load", "save",
    "value", "count", "name", "index", "list", "node", "item", "path", "file",
    "text", "data", "key", "map", "size", "hash", "code", "type", "state",
]


@dataclass
class SynthSpec:
    n_methods: int = 2000
    n_terminals: int = 1500  # excluding PAD; includes @method_0 and @var_*
    n_paths: int = 1200  # excluding PAD
    n_labels: int = 60
    n_vars: int = 12  # @var_0..@var_{n-1} terminal tokens
    mean_contexts: float = 60.0  # per-method bag size (lognormal)
    length_sigma: float = 0.6  # lognormal sigma of the bag size
    max_contexts: int = 400
    signal: float = 0.8  # fraction of a bag drawn from the label's signature
    signature_size: int = 40
    vars_per_method: int = 3
    seed: int = 0


SPECS = {
    "tiny": SynthSpec(n_methods=200, n_terminals=300, n_paths=250, n_labels=12,
                      mean_contexts=30.0, signature_size=20),
    "small": SynthSpec(),
    "parity10k": SynthSpec(n_methods=10_000, n_terminals=4_000, n_paths=3_000, n_labels=600,
                           mean_contexts=60.0, signal=0.45, signature_size=30),
    "top11": SynthSpec(n_methods=605_945, n_terminals=360_631, n_paths=342_845,
                       n_labels=8_000, mean_contexts=120.0, max_contexts=1000,
                       signature_size=60),
}


def _label_names(n_labels: int, rng: np.random.Generator) -> list[str]:
    """Plausible camelCase method names, so the subtoken metrics mean something."""
    names: list[str] = []
    seen: set[str] = set()
    while len(names) < n_labels:
        k = int(rng.integers(1, 4))
        parts = [str(_SUBTOKENS[int(rng.integers(len(_SUBTOKENS)))]) for _ in range(k)]
        name = parts[0] + "".join(p.capitalize() for p in parts[1:])
        if name not in seen:
            seen.add(name)
            names.append(name)
    return names


def _terminal_names(spec: SynthSpec) -> list[str]:
    """@method_0, the @var_* family, then plain identifiers."""
    names = ["@method_0"] + [f"@var_{i}" for i in range(spec.n_vars)]
    names += [f"ident{i}" for i in range(spec.n_terminals - len(names))]
    return names


def _path_names(spec: SynthSpec) -> list[str]:
    """Path tokens in the extractor's up/hinge/down style."""
    kinds = ["SimpleName", "NameExpr", "BlockStmt", "MethodCallExpr",
             "ReturnStmt", "BinaryExpr:PLUS", "IfStmt", "AssignExpr:ASSIGN"]
    names = []
    for i in range(spec.n_paths):
        a = kinds[i % len(kinds)]
        b = kinds[(i // len(kinds)) % len(kinds)]
        names.append(f"{a}^{b}_{i}")
    return names


@dataclass
class RawCorpus:
    """An array corpus with raw on-disk indices (no @question shift)."""

    starts: np.ndarray
    paths: np.ndarray
    ends: np.ndarray
    row_splits: np.ndarray
    label_ids: np.ndarray  # per method, an index into label_names
    label_names: list[str]
    terminal_names: list[str]
    path_names: list[str]
    spec: SynthSpec


def corpus_data_from_raw(raw: RawCorpus):
    """A :class:`~code2vec_tpu_torch.data.reader.CorpusData` straight from
    a :class:`RawCorpus`, without the text round trip: the ``@question``
    shift applied and the special terminals registered (``@method_0`` at
    shifted index 2)."""
    from code2vec_tpu_torch.data.reader import CorpusData
    from code2vec_tpu_torch.data.vocab import Vocab
    from code2vec_tpu_torch.text import normalize_and_subtokenize

    n_methods = len(raw.row_splits) - 1
    label_vocab = Vocab()
    for name in raw.label_names:
        label_vocab.add_label(name)
    normalized = [normalize_and_subtokenize(raw.label_names[i])[0] for i in raw.label_ids]
    terminal_vocab = Vocab()
    terminal_vocab.add("<PAD/>", 0)
    terminal_vocab.add("@question", 1)
    for i, name in enumerate(raw.terminal_names):
        terminal_vocab.add(name, i + 2)
    path_vocab = Vocab()
    path_vocab.add("<PAD/>", 0)
    for i, name in enumerate(raw.path_names):
        path_vocab.add(name, i + 1)
    return CorpusData(
        starts=raw.starts + 1, paths=raw.paths, ends=raw.ends + 1, row_splits=raw.row_splits,
        ids=np.arange(n_methods, dtype=np.int64), labels=raw.label_ids.astype(np.int32),
        normalized_labels=normalized, sources=[None] * n_methods,
        aliases=[{} for _ in range(n_methods)], terminal_vocab=terminal_vocab,
        path_vocab=path_vocab, label_vocab=label_vocab,
    )


def generate_corpus_data(spec: SynthSpec) -> RawCorpus:
    rng = np.random.default_rng(spec.seed)
    label_names = _label_names(spec.n_labels, rng)
    terminal_names = _terminal_names(spec)
    path_names = _path_names(spec)

    # per label, a fixed pool of (start, path, end) triples
    sig_starts = rng.integers(1, spec.n_terminals + 1,
                              (spec.n_labels, spec.signature_size), dtype=np.int64)
    sig_paths = rng.integers(1, spec.n_paths + 1,
                             (spec.n_labels, spec.signature_size), dtype=np.int64)
    sig_ends = rng.integers(1, spec.n_terminals + 1,
                            (spec.n_labels, spec.signature_size), dtype=np.int64)

    label_ids = rng.integers(0, spec.n_labels, spec.n_methods, dtype=np.int64)
    counts = np.clip(
        rng.lognormal(np.log(spec.mean_contexts), spec.length_sigma,
                      spec.n_methods).astype(np.int64),
        3, spec.max_contexts,
    )
    total = int(counts.sum())
    row_splits = np.zeros(spec.n_methods + 1, np.int64)
    np.cumsum(counts, out=row_splits[1:])

    seg_label = np.repeat(label_ids, counts)
    from_sig = rng.random(total) < spec.signal
    sig_slot = rng.integers(0, spec.signature_size, total)

    starts = np.where(from_sig, sig_starts[seg_label, sig_slot],
                      rng.integers(1, spec.n_terminals + 1, total))
    paths = np.where(from_sig, sig_paths[seg_label, sig_slot],
                     rng.integers(1, spec.n_paths + 1, total))
    ends = np.where(from_sig, sig_ends[seg_label, sig_slot],
                    rng.integers(1, spec.n_terminals + 1, total))

    # @method_0 (raw index 1) in some bags, so the @question substitution runs
    is_method_tok = rng.random(total) < 0.02
    starts = np.where(is_method_tok, 1, starts)

    return RawCorpus(
        starts=starts.astype(np.int32), paths=paths.astype(np.int32),
        ends=ends.astype(np.int32), row_splits=row_splits, label_ids=label_ids,
        label_names=label_names, terminal_names=terminal_names, path_names=path_names,
        spec=spec,
    )


def generate_corpus_files(out_dir: str | os.PathLike, spec: SynthSpec) -> dict[str, str]:
    """Write the corpus, both vocab files and ``params.txt``; return their paths."""
    os.makedirs(out_dir, exist_ok=True)
    raw = generate_corpus_data(spec)
    rng = np.random.default_rng(spec.seed + 1)

    records = []
    for i in range(spec.n_methods):
        lo, hi = raw.row_splits[i], raw.row_splits[i + 1]
        contexts = list(zip(raw.starts[lo:hi].tolist(), raw.paths[lo:hi].tolist(),
                            raw.ends[lo:hi].tolist()))
        k = int(rng.integers(0, spec.vars_per_method + 1))
        aliases = [(f"local{j}Var", f"@var_{j}") for j in range(min(k, spec.n_vars))]
        # variable contexts: retarget a few starts to the aliases
        for j in range(len(aliases)):
            if contexts:
                slot = int(rng.integers(len(contexts)))
                _, p, e = contexts[slot]
                contexts[slot] = (2 + j, p, e)  # raw index of @var_j is 2+j
        records.append(CorpusRecord(
            id=i + 1, label=raw.label_names[raw.label_ids[i]],
            source=f"synthetic/Class{i % 97}.java", path_contexts=contexts, aliases=aliases,
        ))

    paths = {
        "corpus": os.path.join(out_dir, "corpus.txt"),
        "path_idx": os.path.join(out_dir, "path_idxs.txt"),
        "terminal_idx": os.path.join(out_dir, "terminal_idxs.txt"),
        "params": os.path.join(out_dir, "params.txt"),
    }
    write_corpus(paths["corpus"], records)
    write_vocab_from_names(paths["terminal_idx"], raw.terminal_names)
    write_vocab_from_names(paths["path_idx"], raw.path_names)
    write_params(paths["params"], {
        "max_length": 8,
        "max_width": 3,
        "terminal_vocab_count": len(raw.terminal_names),
        "path_vocab_count": len(raw.path_names),
        "method_count": spec.n_methods,
    })
    return paths
