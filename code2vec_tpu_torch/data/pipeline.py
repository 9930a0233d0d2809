"""The input pipeline: split, per-epoch resampling, batching, bag ladders.

Own copy of ``code2vec_tpu/data/pipeline.py``'s host path for both
tasks (``:47-455``), its ladder and bucketing
helpers (``:456-760``) and its in-RAM batch source (``:1057-1278``,
``:1530``). The same semantics as the reference's per-method loop
(model/dataset_builder.py:112-210) as vectorized numpy over the CSR
arrays, drawing from the caller's generator in the JAX module's exact
order, so both trainers see the same batches:

- a seeded train/test split;
- a fresh random subsample of up to ``max_contexts`` contexts per method
  every epoch (model/dataset_builder.py:134-135);
- ``@method_0 -> @question``, so the answer is not leaked;
- static ``[B, L]`` batches (PAD = 0) with an example mask, or bucketed
  ``[B, L_b]`` batches over a ladder of bag widths (each example in the
  narrowest width that holds its real contexts), so a skewed corpus stops
  paying for PAD slots.

PAD positions carry exactly-zero attention weight, so an example's
forward is identical at any width >= its real context count: the
ladders pad training and serving shapes to a small static set. The
variable-name task's epoch (one row per ``@var_*`` alias) follows the
method rows. Streaming and mmap-backed epochs are not ported yet
(ROADMAP §A.2).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

from code2vec_tpu_torch import PAD_INDEX, QUESTION_TOKEN_INDEX


@dataclass
class EpochArrays:
    """One epoch's examples, padded to the static shape [N, L]."""

    ids: np.ndarray  # int64 [N]
    starts: np.ndarray  # int32 [N, L]
    paths: np.ndarray  # int32 [N, L]
    ends: np.ndarray  # int32 [N, L]
    labels: np.ndarray  # int32 [N]

    def __len__(self) -> int:
        return len(self.labels)


def split_items(n_items: int, rng: np.random.Generator,
                split_ratio: float = 0.2) -> tuple[np.ndarray, np.ndarray]:
    """Seeded shuffle-then-slice split: the first ``split_ratio`` is test,
    the rest train (model/dataset_builder.py:23-26, made reproducible)."""
    perm = rng.permutation(n_items)
    test_count = int(n_items * split_ratio)
    return perm[test_count:], perm[:test_count]


def flat_context_indices(row_splits: np.ndarray, item_idx: np.ndarray
                         ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized CSR row gather: for the selected items, the flat indices
    of all their contexts and each one's (segment, position in segment)."""
    counts = (row_splits[item_idx + 1] - row_splits[item_idx]).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        empty = np.zeros(0, np.int64)
        return empty, empty, empty
    seg = np.repeat(np.arange(len(item_idx), dtype=np.int64), counts)
    seg_starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    within = np.arange(total, dtype=np.int64) - np.repeat(seg_starts, counts)
    flat = np.repeat(row_splits[item_idx], counts) + within
    return flat, seg, within


def _segment_subsample(row_splits: np.ndarray, item_idx: np.ndarray, max_contexts: int,
                       rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Up to ``max_contexts`` random contexts per selected item:
    ``(flat_idx, out_row, out_col)``. "Shuffle each method's contexts, keep
    the first L", vectorized: one uniform per context, a stable sort by
    (segment, uniform), the first L positions of each segment."""
    flat, seg, within = flat_context_indices(row_splits, item_idx)
    if len(flat) == 0:
        return flat, seg, within
    order = np.lexsort((rng.random(len(flat)), seg))
    keep = within < max_contexts
    return flat[order[keep]], seg[keep], within[keep]


def build_method_epoch(data, item_idx: np.ndarray, max_contexts: int,
                       rng: np.random.Generator) -> EpochArrays:
    """The method-name task's epoch: a fresh context subsample per method,
    the method's own ``@method_0`` replaced by ``@question``
    (model/dataset_builder.py:122-150)."""
    n = len(item_idx)
    flat, row, col = _segment_subsample(data.row_splits, item_idx, max_contexts, rng)
    starts = np.full((n, max_contexts), PAD_INDEX, np.int32)
    paths = np.full((n, max_contexts), PAD_INDEX, np.int32)
    ends = np.full((n, max_contexts), PAD_INDEX, np.int32)
    starts[row, col] = data.starts[flat]
    paths[row, col] = data.paths[flat]
    ends[row, col] = data.ends[flat]
    method_idx = data.method_token_index
    if method_idx is not None:
        np.putmask(starts, starts == method_idx, QUESTION_TOKEN_INDEX)
        np.putmask(ends, ends == method_idx, QUESTION_TOKEN_INDEX)
    return EpochArrays(ids=data.ids[item_idx], starts=starts, paths=paths, ends=ends,
                       labels=data.labels[item_idx])


def variable_items(data, item_idx: np.ndarray):
    """The variable task's expansion, shared by the host epoch and the
    device staging: per item with ``@var_*`` aliases, ``(item, alias
    names, alias ids, starts, paths, ends)`` of the contexts touching ANY
    of them (model/dataset_builder.py:152-177). The caller shuffles,
    selects and renames, so the generator is drawn in the reference's
    order."""
    terminal_stoi = data.terminal_vocab.stoi
    for i in item_idx:
        alias_names = [a for a in data.aliases[i] if a.startswith("@var_")]
        if not alias_names:
            continue
        alias_idx = np.asarray([terminal_stoi[a] for a in alias_names], dtype=np.int32)
        lo, hi = int(data.row_splits[i]), int(data.row_splits[i + 1])
        s, p, e = data.starts[lo:hi], data.paths[lo:hi], data.ends[lo:hi]
        touches = np.isin(s, alias_idx) | np.isin(e, alias_idx)
        yield i, alias_names, alias_idx, s[touches], p[touches], e[touches]


def build_variable_epoch(data, item_idx: np.ndarray, max_contexts: int,
                         rng: np.random.Generator,
                         shuffle_variable_indexes: bool = False) -> EpochArrays:
    """The variable-name task's epoch: one row per ``@var_*`` alias of each
    method. A method's contexts touching any of its variables are shuffled
    once (one ``rng.permutation``); each alias's row keeps the first
    ``max_contexts`` of those that touch it, with the alias renamed to
    ``@question``. With ``shuffle_variable_indexes`` the other ``@var_*``
    ids go through a permutation of the whole ``@var_*`` id set, one
    ``rng.shuffle`` per method drawn before its context permutation
    (model/dataset_builder.py:152-204). Every row is appended before its
    contexts are looked at, so an alias that no context touches gets an
    all-PAD row. JAX ``pipeline.py:225-355`` draw for draw."""
    variable_indexes = data.variable_indexes
    perm_map = None
    if not shuffle_variable_indexes and len(variable_indexes):
        # the identity remap outside shuffle mode (model/dataset_builder.py:155-156)
        perm_map = _index_remap(variable_indexes, variable_indexes)
    ids: list[int] = []
    labels: list[int] = []
    out_rows, out_cols, out_s, out_p, out_e = [], [], [], [], []
    label_stoi = data.label_vocab.stoi
    for i, alias_names, alias_idx, s, p, e in variable_items(data, item_idx):
        alias_map = data.aliases[i]
        if shuffle_variable_indexes:
            shuffled = variable_indexes.copy()
            rng.shuffle(shuffled)
            perm_map = _index_remap(variable_indexes, shuffled)
        order = rng.permutation(len(s))
        s, p, e = s[order], p[order], e[order]
        base = len(ids)
        for alias_name in alias_names:
            ids.append(int(data.ids[i]))
            labels.append(label_stoi[alias_map[alias_name]])
        # [A, C] membership, row-major: (alias, context in stream order)
        member = (s[None, :] == alias_idx[:, None]) | (e[None, :] == alias_idx[:, None])
        a_ids, c_ids = np.nonzero(member)
        if not len(a_ids):
            continue
        counts = member.sum(axis=1).astype(np.int64)
        seg_starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
        within = np.arange(len(a_ids), dtype=np.int64) - np.repeat(seg_starts, counts)
        keep = within < max_contexts  # the first L per alias
        a_kept, c_kept = a_ids[keep], c_ids[keep]
        targets = alias_idx[a_kept]
        out_rows.append(base + a_kept)
        out_cols.append(within[keep])
        out_s.append(_rename_target(s[c_kept], targets, perm_map))
        out_p.append(p[c_kept])
        out_e.append(_rename_target(e[c_kept], targets, perm_map))
    n = len(ids)
    starts = np.full((n, max_contexts), PAD_INDEX, np.int32)
    paths = np.full((n, max_contexts), PAD_INDEX, np.int32)
    ends = np.full((n, max_contexts), PAD_INDEX, np.int32)
    if out_rows:
        rows, cols = np.concatenate(out_rows), np.concatenate(out_cols)
        starts[rows, cols] = np.concatenate(out_s)
        paths[rows, cols] = np.concatenate(out_p)
        ends[rows, cols] = np.concatenate(out_e)
    return EpochArrays(ids=np.asarray(ids, np.int64), starts=starts, paths=paths, ends=ends,
                       labels=np.asarray(labels, np.int32))


def _index_remap(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """A lookup table of terminal id -> remapped id, the identity but for
    the ``@var_*`` ids ``src``, which go to ``dst``."""
    table = np.arange(int(src.max()) + 1, dtype=np.int32)
    table[src] = dst
    return table


def _rename_target(values: np.ndarray, target_idx, perm_map: np.ndarray | None) -> np.ndarray:
    """The target variable -> ``@question``; the other ids through the
    remap (model/dataset_builder.py:181-195). The table covers ids up to
    the largest ``@var_*`` id; larger ids pass through unchanged."""
    is_target = values == target_idx
    if perm_map is not None:
        in_table = values < len(perm_map)
        remapped = perm_map[np.where(in_table, values, 0)].astype(np.int32)
        values = np.where(in_table, remapped, values)
    return np.where(is_target, np.int32(QUESTION_TOKEN_INDEX), values)


def build_epoch(data, item_idx: np.ndarray, max_contexts: int, rng: np.random.Generator,
                shuffle_variable_indexes: bool = False) -> EpochArrays:
    """A full epoch of the tasks the corpus was loaded with: the method
    rows first, then the variable rows, drawn from ``rng`` in that order
    (the reference's concatenation, model/dataset_builder.py:122-204)."""
    parts: list[EpochArrays] = []
    if data.infer_method:
        parts.append(build_method_epoch(data, item_idx, max_contexts, rng))
    if data.infer_variable:
        parts.append(build_variable_epoch(data, item_idx, max_contexts, rng,
                                          shuffle_variable_indexes))
    if not parts:
        raise ValueError("the corpus was loaded with neither task (infer_method and "
                         "infer_variable both off)")
    if len(parts) == 1:
        return parts[0]
    return EpochArrays(*(np.concatenate([getattr(p, k) for p in parts])
                         for k in ("ids", "starts", "paths", "ends", "labels")))


def iter_batches(epoch: EpochArrays, batch_size: int, rng: np.random.Generator | None = None,
                 pad_final: bool = True) -> Iterator[dict[str, np.ndarray]]:
    """Static-shape batches of exactly ``batch_size`` rows. The final
    partial batch repeats epoch row 0 under a zero ``example_mask``; with
    ``pad_final=False`` it is dropped. ``rng`` shuffles the rows (one
    permutation draw)."""
    n = len(epoch)
    order = rng.permutation(n) if rng is not None else None
    stop = n if pad_final else (n - n % batch_size)
    for lo in range(0, stop, batch_size):
        hi = min(lo + batch_size, n)
        valid = hi - lo
        if order is None and valid == batch_size:
            def take(a, lo=lo, hi=hi):
                return a[lo:hi]
        else:
            idx = order[lo:hi] if order is not None else np.arange(lo, hi)
            if valid < batch_size:
                idx = np.concatenate([idx, np.zeros(batch_size - valid, idx.dtype)])

            def take(a, idx=idx):
                return a[idx]
        mask = np.zeros(batch_size, np.float32)
        mask[:valid] = 1.0
        yield {
            "ids": take(epoch.ids),
            "starts": take(epoch.starts),
            "paths": take(epoch.paths),
            "ends": take(epoch.ends),
            "labels": take(epoch.labels),
            "example_mask": mask,
        }


def derive_bucket_ladder_hist(
    lengths: np.ndarray,
    weights: np.ndarray,
    max_contexts: int,
    max_buckets: int = 4,
    min_fraction: float = 0.05,
    min_width: int = 8,
) -> tuple[int, ...]:
    """A geometric ladder (halving down from ``max_contexts``) pruned by a
    context-count histogram: ``weights[i]`` examples have ``lengths[i]``
    contexts; a narrow width stays only if ``min_fraction`` of the
    examples land in its bucket. The top width is always ``max_contexts``."""
    if max_buckets < 1:
        raise ValueError(f"max_buckets must be >= 1, got {max_buckets}")
    widths: list[int] = []
    w = int(max_contexts)
    while len(widths) < max_buckets and w >= min_width:
        widths.append(w)
        nxt = -(-w // 2)
        if nxt == w:
            break
        w = nxt
    if not widths:
        widths = [int(max_contexts)]
    widths = sorted(set(widths))
    lengths = np.minimum(np.asarray(lengths), max_contexts)
    weights = np.asarray(weights, np.int64)
    total = int(weights.sum())
    if total and len(widths) > 1:
        kept: list[int] = []
        prev = 0
        for width in widths[:-1]:
            frac = weights[(lengths > prev) & (lengths <= width)].sum() / total
            if frac >= min_fraction:
                kept.append(width)
                prev = width
        kept.append(widths[-1])
        widths = kept
    return tuple(widths)


def derive_bucket_ladder(
    counts: np.ndarray,
    max_contexts: int,
    max_buckets: int = 4,
    min_fraction: float = 0.05,
    min_width: int = 8,
) -> tuple[int, ...]:
    """:func:`derive_bucket_ladder_hist` from per-example context counts."""
    lengths, weights = np.unique(np.asarray(counts), return_counts=True)
    return derive_bucket_ladder_hist(
        lengths, weights, max_contexts,
        max_buckets=max_buckets, min_fraction=min_fraction, min_width=min_width,
    )


def derive_longbag_ladder(
    lengths: np.ndarray,
    weights: np.ndarray,
    base_top: int,
    chunk_l: int = 128,
    max_rungs: int = 4,
) -> tuple[int, ...]:
    """Long-bag rungs ABOVE a base ladder's top width.

    Widths double from ``base_top``, each rounded up to a multiple of
    ``chunk_l`` (the streamed softmax's chunk), until the longest observed
    bag is covered; if ``max_rungs`` doublings fall short, the last rung
    jumps to the (chunk-rounded) maximum. Rungs holding no examples are
    pruned, except the top one. Returns ``()`` when nothing exceeds
    ``base_top``. ``lengths``/``weights``: a context-count histogram."""
    if chunk_l < 1:
        raise ValueError(f"chunk_l must be >= 1, got {chunk_l}")
    lengths = np.asarray(lengths, np.int64)
    weights = np.asarray(weights, np.int64)
    over = lengths > base_top
    if not over.any():
        return ()
    max_len = int(lengths[over].max())

    def round_chunk(w: int) -> int:
        return -(-int(w) // chunk_l) * chunk_l

    rungs: list[int] = []
    w = int(base_top)
    while w < max_len and len(rungs) < max_rungs:
        w = round_chunk(w * 2)  # ceil-to-chunk of 2w: > w, so always advances
        rungs.append(w)
    if rungs and rungs[-1] < max_len:
        rungs[-1] = round_chunk(max_len)
    kept: list[int] = []
    prev = int(base_top)
    for width in rungs:
        occupied = int(weights[(lengths > prev) & (lengths <= width)].sum())
        if occupied or width == rungs[-1]:
            kept.append(width)
            prev = width
    return tuple(kept)


def nearest_bucket_width(count: int, ladder: tuple[int, ...]) -> int:
    """The smallest ladder width holding ``count`` contexts (the top width
    for anything longer)."""
    if not ladder:
        raise ValueError("bucket ladder must not be empty")
    for width in ladder:
        if count <= width:
            return int(width)
    return int(ladder[-1])


def parse_bucket_ladder(spec: str | None, max_contexts: int) -> tuple[int, ...] | None:
    """A ``--bucket_ladder`` comma list (``"25,50,100,200"``) as sorted
    widths; None for an empty spec (derive one from the corpus). The top
    width must equal ``max_contexts``: a lower top would truncate long bags
    that the fixed-width path keeps."""
    if spec is None or not spec.strip():
        return None
    try:
        widths = sorted({int(tok) for tok in spec.split(",") if tok.strip()})
    except ValueError as exc:
        raise ValueError(f"malformed bucket ladder {spec!r}: {exc}") from None
    if not widths or widths[0] < 1:
        raise ValueError(f"bucket ladder widths must be >= 1, got {spec!r}")
    if widths[-1] != max_contexts:
        raise ValueError(
            f"bucket ladder must end at max_contexts ({max_contexts}) so "
            f"long bags are not truncated; got top width {widths[-1]}"
        )
    return tuple(widths)


def truncated_fraction(lengths: np.ndarray, weights: np.ndarray, cap: int) -> float:
    """The fraction of REAL contexts that a per-example cap of ``cap``
    drops (``weights[i]`` examples hold ``lengths[i]`` contexts). 0.0 means
    nothing is truncated, as ``--max_contexts 0`` promises."""
    lengths = np.asarray(lengths, np.int64)
    weights = np.asarray(weights, np.int64)
    total = int((lengths * weights).sum())
    if total == 0:
        return 0.0
    dropped = int((np.maximum(lengths - int(cap), 0) * weights).sum())
    return dropped / total


def truncated_fraction_of_counts(counts: np.ndarray, cap: int) -> float:
    """:func:`truncated_fraction` from per-example context counts."""
    lengths, weights = np.unique(np.asarray(counts), return_counts=True)
    return truncated_fraction(lengths, weights, cap)


def assign_buckets(counts: np.ndarray, ladder: tuple[int, ...]) -> np.ndarray:
    """Each example's bucket: the index of the narrowest ladder width that
    holds its (top-capped) real context count."""
    arr = np.asarray(ladder)
    return np.searchsorted(arr, np.minimum(counts, arr[-1]), side="left")


def epoch_context_counts(epoch: EpochArrays) -> np.ndarray:
    """Real (non-PAD) contexts per example: epoch rows fill from position 0
    and a PAD path is index 0, so the count is exact."""
    return (epoch.paths != PAD_INDEX).sum(axis=1)


def pad_stats(counts: np.ndarray, ladder: tuple[int, ...], batch_size: int,
              pad_final: bool = True) -> tuple[int, int]:
    """``(real context slots, padded slots)`` of one epoch of bucketed
    batches, the ``pad_efficiency`` accounting; a one-width ladder gives
    the fixed-``L`` numbers."""
    counts = np.minimum(np.asarray(counts), ladder[-1])
    bucket_of = assign_buckets(counts, ladder)
    real = int(counts.sum())
    slots = 0
    for b, width in enumerate(ladder):
        n_b = int((bucket_of == b).sum())
        n_batches = -(-n_b // batch_size) if pad_final else n_b // batch_size
        slots += n_batches * batch_size * width
    return real, slots


def iter_bucketed_batches(epoch: EpochArrays, ladder: tuple[int, ...], batch_size: int,
                          rng: np.random.Generator | None = None,
                          pad_final: bool = True) -> Iterator[dict[str, np.ndarray]]:
    """Static-shape ``[B, L_b]`` batches, one ladder width per bucket.

    :func:`iter_batches`' contract (exactly ``batch_size`` rows, each
    bucket's final partial batch padded under a zero ``example_mask``)
    with a width that varies over the ladder. An example keeps its whole
    subsampled row (its bucket's width holds its real count), so its
    forward is the fixed-width one. ``rng`` draws one member permutation
    per bucket, in ladder order, then one permutation of the batch plan;
    ``rng=None`` (eval) emits the buckets in ladder order."""
    bucket_of = assign_buckets(epoch_context_counts(epoch), ladder)
    plans: list[tuple[int, np.ndarray]] = []
    for b, width in enumerate(ladder):
        members = np.flatnonzero(bucket_of == b)
        if rng is not None:
            members = members[rng.permutation(len(members))]
        stop = len(members) if pad_final else len(members) - len(members) % batch_size
        for lo in range(0, stop, batch_size):
            plans.append((width, members[lo:lo + batch_size]))
    if rng is not None:
        plans = [plans[i] for i in rng.permutation(len(plans))]
    for width, idx in plans:
        yield _bucket_batch(epoch, idx, width, batch_size)


def _bucket_batch(epoch: EpochArrays, idx: np.ndarray, width: int,
                  batch_size: int) -> dict[str, np.ndarray]:
    """One ``[B, width]`` batch of epoch rows ``idx``; a partial batch
    repeats its own first row under a zero ``example_mask``."""
    valid = len(idx)
    if valid < batch_size:
        idx = np.concatenate([idx, np.full(batch_size - valid, idx[0], idx.dtype)])
    mask = np.zeros(batch_size, np.float32)
    mask[:valid] = 1.0
    return {
        "ids": epoch.ids[idx],
        "starts": epoch.starts[idx, :width],
        "paths": epoch.paths[idx, :width],
        "ends": epoch.ends[idx, :width],
        "labels": epoch.labels[idx],
        "example_mask": mask,
    }


def bucket_batch_counts(counts: np.ndarray, ladder: tuple[int, ...],
                        batch_size: int) -> np.ndarray:
    """Batches per ladder width (ceil division) for examples with
    ``counts`` real contexts: an epoch's bucketed geometry."""
    arr = np.asarray(ladder)
    if not len(counts):
        return np.zeros(len(arr), np.int64)
    members = np.bincount(assign_buckets(np.asarray(counts), ladder), minlength=len(arr))
    return -(-members // batch_size)


class BatchSource:
    """A host epoch feed, the JAX package's ``BatchSource`` protocol:

    - ``ladder``: the static widths the source emits (one width is the
      fixed-``L`` case);
    - ``batches(rng, shuffle)``: one epoch's stream, a pure function of the
      generator's state at the call;
    - ``pad_stats()``: ``(real context slots, padded slots)`` of the last
      epoch built, None before any;
    - ``last_epoch``: the last :class:`EpochArrays` built, which the export
      and ``print_sample`` reuse instead of drawing anew.
    """

    ladder: tuple[int, ...] = ()
    last_epoch: EpochArrays | None = None

    def batches(self, rng: np.random.Generator,
                shuffle: bool = True) -> Iterator[dict[str, np.ndarray]]:
        raise NotImplementedError

    def pad_stats(self) -> tuple[int, int] | None:
        return None


class EpochSource(BatchSource):
    """The in-RAM source: one materialized :class:`EpochArrays` per epoch,
    batched at a fixed ``L`` or bucketed over ``ladder``. The epoch is
    built at the stream's first pull, not at :meth:`batches` time, so the
    generator is drawn in the JAX loop's order (subsample, then the batch
    order)."""

    def __init__(self, data, item_idx: np.ndarray, batch_size: int, max_contexts: int,
                 ladder: tuple[int, ...] | None = None, shuffle_variable_indexes: bool = False):
        self.data = data
        self.item_idx = np.asarray(item_idx)
        self.batch_size = int(batch_size)
        self.max_contexts = int(max_contexts)
        self.ladder = tuple(ladder) if ladder else (int(max_contexts),)
        self._bucketed = ladder is not None
        self._svi = bool(shuffle_variable_indexes)
        self.last_epoch: EpochArrays | None = None
        # (rows, real, slots): a row's count is min(its contexts, the cap)
        # whichever contexts the subsample drew, so it is reckoned once
        self._pad_cache: tuple[int, int, int] | None = None

    def batches(self, rng: np.random.Generator,
                shuffle: bool = True) -> Iterator[dict[str, np.ndarray]]:
        def gen():
            epoch = build_epoch(self.data, self.item_idx, self.max_contexts, rng, self._svi)
            self.last_epoch = epoch
            order = rng if shuffle else None
            if self._bucketed:
                yield from iter_bucketed_batches(epoch, self.ladder, self.batch_size,
                                                 rng=order, pad_final=True)
            else:
                yield from iter_batches(epoch, self.batch_size, rng=order, pad_final=True)

        return gen()

    def pad_stats(self) -> tuple[int, int] | None:
        if self.last_epoch is None:
            return None
        n_rows = len(self.last_epoch)
        if self._pad_cache is None or self._pad_cache[0] != n_rows:
            real, slots = pad_stats(epoch_context_counts(self.last_epoch), self.ladder,
                                    self.batch_size)
            self._pad_cache = (n_rows, real, slots)
        return self._pad_cache[1], self._pad_cache[2]


def make_batch_source(data, item_idx: np.ndarray, batch_size: int, max_contexts: int,
                      ladder: tuple[int, ...] | None = None, stream_chunk_items: int = 0,
                      shuffle_variable_indexes: bool = False) -> BatchSource:
    """The feed of one split: the in-RAM :class:`EpochSource`, fixed-``L``
    for ``ladder=None``. Streaming epochs (``stream_chunk_items > 0``) and
    mmap-backed corpora are not ported yet."""
    if stream_chunk_items:
        raise NotImplementedError(
            "streaming epochs (stream_chunk_items > 0) are not ported yet (ROADMAP §A.2)"
        )
    if getattr(data, "mmap_backed", False):
        raise NotImplementedError(
            "mmap-backed corpora are not ported yet (ROADMAP §A.2)"
        )
    return EpochSource(data, item_idx, batch_size, max_contexts, ladder=ladder,
                       shuffle_variable_indexes=shuffle_variable_indexes)


def oov_rate(data, train_idx: np.ndarray, test_idx: np.ndarray, exact: bool = False) -> float:
    """The share of test label (sub)tokens absent from the train split's
    label tokens, over the tasks the corpus was loaded with
    (model/dataset_builder.py:72-110); ``exact`` compares whole labels
    (the ``eval_method == 'exact'`` branch)."""

    def tokens_of(i: int) -> list[str]:
        out: list[str] = []
        if data.infer_method:
            out.extend(_label_tokens(data, data.normalized_labels[i], exact))
        if data.infer_variable:
            for alias, normalized in data.aliases[i].items():
                if alias.startswith("@var_"):
                    out.extend(_label_tokens(data, normalized, exact))
        return out

    train_vocab = {t for i in train_idx for t in tokens_of(int(i))}
    match = count = 0
    for i in test_idx:
        tokens = tokens_of(int(i))
        match += sum(1 for t in tokens if t in train_vocab)
        count += len(tokens)
    return 1.0 - match / count if count else 0.0


def _label_tokens(data, normalized_label: str, exact: bool) -> list[str]:
    if exact:
        return [normalized_label]
    index = data.label_vocab.stoi[normalized_label]
    return list(data.label_vocab.itosubtokens.get(index, ()))
