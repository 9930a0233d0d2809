"""The input pipeline: split, per-epoch resampling, batching, bag ladders.

Own copy of ``code2vec_tpu/data/pipeline.py``'s host path for both
tasks (``:47-455``), its ladder and bucketing helpers (``:456-760``), its
streaming epochs (``:801-954``), its batch sources (``:1057-1590``) and
its plan/build split (``:1593-1700``). The same semantics as the reference's per-method loop
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
method rows.

A split's feed is a :class:`BatchSource` (``make_batch_source`` picks
one): the in-RAM epoch, chunked streaming (``stream_chunk_items``, any
task, bounded RSS) or, for an mmap-backed CSR corpus and the method task,
batches gathered straight from the mapped arrays. Each method-task source
splits its stream into plans (every draw of the generator, made in the
stream's order) and a pure build (:func:`execute_plan`), which
``data/parallel_feed.py`` runs on worker processes. :func:`skip_batches`
replays an epoch's stream to a mid-epoch cursor (``:955-1000``). Not
ported yet: the host-sharded lockstep feed (``scheduled_batches``,
``empty_batch``, ``pad_batch_stream``; ROADMAP §A.2.9).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

from code2vec_tpu_torch import PAD_INDEX, QUESTION_TOKEN_INDEX
from code2vec_tpu_torch.obs.trace import get_tracer


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


CONTEXT_ORDERS = ("shuffled", "corpus")


def _segment_subsample(row_splits: np.ndarray, item_idx: np.ndarray, max_contexts: int,
                       rng: np.random.Generator, context_order: str = "shuffled"
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Up to ``max_contexts`` random contexts per selected item:
    ``(flat_idx, out_row, out_col)``. "Shuffle each method's contexts, keep
    the first L", vectorized: one uniform per context, a stable sort by
    (segment, uniform), the first L positions of each segment.
    ``context_order="corpus"`` puts the kept contexts back in corpus order:
    the same draws and the same kept subset, only their places in the row
    change, so rows built at different stream positions compare bitwise."""
    flat, seg, within = flat_context_indices(row_splits, item_idx)
    if len(flat) == 0:
        return flat, seg, within
    order = np.lexsort((rng.random(len(flat)), seg))
    keep = within < max_contexts
    kept_flat, kept_seg = flat[order[keep]], seg[keep]
    if context_order == "corpus":
        kept_flat = kept_flat[np.lexsort((kept_flat, kept_seg))]
    elif context_order != "shuffled":
        raise ValueError(f"unknown context_order: {context_order!r}")
    return kept_flat, kept_seg, within[keep]


def build_method_epoch(data, item_idx: np.ndarray, max_contexts: int,
                       rng: np.random.Generator, context_order: str = "shuffled") -> EpochArrays:
    """The method-name task's epoch: a fresh context subsample per method,
    the method's own ``@method_0`` replaced by ``@question``
    (model/dataset_builder.py:122-150). ``data`` is anything with the CSR
    arrays, ``ids``, ``labels`` and ``method_token_index`` (a worker's
    slim view too)."""
    with get_tracer().span("build_method_epoch", category="data", items=len(item_idx)):
        return _build_method_epoch(data, item_idx, max_contexts, rng, context_order)


def _build_method_epoch(data, item_idx, max_contexts, rng, context_order) -> EpochArrays:
    n = len(item_idx)
    flat, row, col = _segment_subsample(data.row_splits, item_idx, max_contexts, rng,
                                        context_order)
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
                         rng: np.random.Generator, shuffle_variable_indexes: bool = False,
                         context_order: str = "shuffled") -> EpochArrays:
    """The variable-name task's epoch: one row per ``@var_*`` alias of each
    method. A method's contexts touching any of its variables are shuffled
    once (one ``rng.permutation``); each alias's row keeps the first
    ``max_contexts`` of those that touch it, with the alias renamed to
    ``@question``. With ``shuffle_variable_indexes`` the other ``@var_*``
    ids go through a permutation of the whole ``@var_*`` id set, one
    ``rng.shuffle`` per method drawn before its context permutation
    (model/dataset_builder.py:152-204). Every row is appended before its
    contexts are looked at, so an alias that no context touches gets an
    all-PAD row. JAX ``pipeline.py:225-355`` draw for draw; under
    ``context_order="corpus"`` the permutation is drawn and not applied."""
    with get_tracer().span("build_variable_epoch", category="data", items=len(item_idx)):
        return _build_variable_epoch(data, item_idx, max_contexts, rng,
                                     shuffle_variable_indexes, context_order)


def _build_variable_epoch(data, item_idx, max_contexts, rng, shuffle_variable_indexes,
                          context_order) -> EpochArrays:
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
        if context_order == "shuffled":
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
                shuffle_variable_indexes: bool = False,
                context_order: str = "shuffled") -> EpochArrays:
    """A full epoch of the tasks the corpus was loaded with: the method
    rows first, then the variable rows, drawn from ``rng`` in that order
    (the reference's concatenation, model/dataset_builder.py:122-204)."""
    parts: list[EpochArrays] = []
    if data.infer_method:
        parts.append(build_method_epoch(data, item_idx, max_contexts, rng, context_order))
    if data.infer_variable:
        parts.append(build_variable_epoch(data, item_idx, max_contexts, rng,
                                          shuffle_variable_indexes, context_order))
    if not parts:
        raise ValueError("the corpus was loaded with neither task (infer_method and "
                         "infer_variable both off)")
    return parts[0] if len(parts) == 1 else _concat_epochs(parts)


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


def iter_streaming_batches(epoch_builder, item_idx: np.ndarray, batch_size: int,
                           rng: np.random.Generator, chunk_items: int = 65536,
                           pad_final: bool = True, shuffle: bool = True,
                           ladder: tuple[int, ...] | None = None
                           ) -> Iterator[dict[str, np.ndarray]]:
    """An epoch as static-shape batches without its ``[N, L]`` arrays: the
    item order is shuffled once (one permutation draw), then
    ``epoch_builder(chunk_idx)`` builds ``chunk_items`` items at a time,
    each chunk's sub-batch remainder carried into the next, so the batches
    have :func:`iter_batches`' shapes and padding. The variable task may
    give more rows than items; the carry absorbs it. ``ladder``: bucketed
    ``[B, L_b]`` batches (:func:`_iter_streaming_bucketed_batches`)."""
    if ladder is not None:
        yield from _iter_streaming_bucketed_batches(
            epoch_builder, item_idx, ladder, batch_size, rng, chunk_items=chunk_items,
            pad_final=pad_final, shuffle=shuffle)
        return
    order = rng.permutation(len(item_idx)) if shuffle else np.arange(len(item_idx))
    carry: EpochArrays | None = None

    def emit(epoch: EpochArrays, final: bool):
        n_full = len(epoch) // batch_size * batch_size
        yield from iter_batches(_slice_epoch(epoch, 0, n_full), batch_size, pad_final=False)
        rest = _slice_epoch(epoch, n_full, len(epoch))
        if final and len(rest) and pad_final:
            yield from iter_batches(rest, batch_size, pad_final=True)
            rest = None
        return rest

    for lo in range(0, len(order), chunk_items):
        chunk_idx = item_idx[order[lo:lo + chunk_items]]
        with get_tracer().span("stream_chunk", category="data", items=len(chunk_idx)):
            chunk = epoch_builder(chunk_idx)
        if carry is not None and len(carry):
            chunk = _concat_epochs([carry, chunk])
        # the remainder comes back as emit()'s return value
        carry = yield from emit(chunk, lo + chunk_items >= len(order))


def _iter_streaming_bucketed_batches(epoch_builder, item_idx: np.ndarray,
                                     ladder: tuple[int, ...], batch_size: int,
                                     rng: np.random.Generator, chunk_items: int = 65536,
                                     pad_final: bool = True, shuffle: bool = True
                                     ) -> Iterator[dict[str, np.ndarray]]:
    """The bucketed body of :func:`iter_streaming_batches`: per chunk,
    build, join each bucket's rows onto its carry, emit the full batches in
    a seeded interleave (one permutation draw a chunk) and carry each
    bucket's remainder; the last chunk flushes the remainders as padded,
    masked batches."""
    order = rng.permutation(len(item_idx)) if shuffle else np.arange(len(item_idx))
    carry: list[EpochArrays | None] = [None] * len(ladder)
    for lo in range(0, len(order), chunk_items):
        chunk_idx = item_idx[order[lo:lo + chunk_items]]
        with get_tracer().span("stream_chunk", category="data", items=len(chunk_idx)):
            chunk = epoch_builder(chunk_idx)
        final = lo + chunk_items >= len(order)
        bucket_of = assign_buckets(epoch_context_counts(chunk), ladder)
        plans: list[tuple[int, EpochArrays]] = []
        for b, width in enumerate(ladder):
            part = _gather_epoch_rows(chunk, np.flatnonzero(bucket_of == b))
            if carry[b] is not None and len(carry[b]):
                part = _concat_epochs([carry[b], part])
            n_full = len(part) // batch_size * batch_size
            for lo_b in range(0, n_full, batch_size):
                plans.append((width, _slice_epoch(part, lo_b, lo_b + batch_size)))
            rest = _slice_epoch(part, n_full, len(part))
            if final and len(rest) and pad_final:
                plans.append((width, rest))
                rest = None
            carry[b] = rest if rest is not None and len(rest) else None
        if shuffle:
            plans = [plans[i] for i in rng.permutation(len(plans))]
        for width, part in plans:
            yield _bucket_batch(part, np.arange(len(part)), width, batch_size)


_EPOCH_FIELDS = ("ids", "starts", "paths", "ends", "labels")


def _gather_epoch_rows(epoch: EpochArrays, idx: np.ndarray) -> EpochArrays:
    return EpochArrays(*(getattr(epoch, k)[idx] for k in _EPOCH_FIELDS))


def _slice_epoch(epoch: EpochArrays, lo: int, hi: int) -> EpochArrays:
    return EpochArrays(*(getattr(epoch, k)[lo:hi] for k in _EPOCH_FIELDS))


def _concat_epochs(parts: list[EpochArrays]) -> EpochArrays:
    return EpochArrays(*(np.concatenate([getattr(p, k) for p in parts])
                         for k in _EPOCH_FIELDS))


class BatchSource:
    """A host epoch feed, the JAX package's ``BatchSource`` protocol:

    - ``ladder``: the static widths the source emits (one width is the
      fixed-``L`` case);
    - ``batches(rng, shuffle)``: one epoch's stream, a pure function of the
      generator's state at the call;
    - ``plan_batches(rng, shuffle)``: the same stream as plans
      (:class:`BatchPlan`), every draw made as ``batches`` makes it
      (method task; the variable expansion stays on the coordinator);
    - ``pad_stats()``: ``(real context slots, padded slots)`` of the last
      epoch fed, None before any;
    - ``last_epoch``: the last :class:`EpochArrays` built (the in-RAM
      source; None for the others), which the export and ``print_sample``
      reuse instead of drawing anew.
    """

    ladder: tuple[int, ...] = ()
    last_epoch: EpochArrays | None = None
    _last_pad: tuple[int, int] | None = None

    def batches(self, rng: np.random.Generator,
                shuffle: bool = True) -> Iterator[dict[str, np.ndarray]]:
        raise NotImplementedError

    def plan_batches(self, rng: np.random.Generator,
                     shuffle: bool = True) -> "Iterator[BatchPlan]":
        raise NotImplementedError(
            f"{type(self).__name__} has no batch-plan split; --feed_workers supports the "
            "in-RAM, streaming and mmap-CSR method-task sources")

    def pad_stats(self) -> tuple[int, int] | None:
        return self._last_pad

    def _accounted(self, stream):
        """Tally ``(real context slots, slots)`` while ``stream`` is
        consumed, the streaming and mmap sources' ``pad_stats``: masked
        rows count as slots, never as real contexts."""
        real = slots = 0
        try:
            for batch in stream:
                valid = batch["example_mask"].astype(bool)
                real += int((batch["paths"][valid] != PAD_INDEX).sum())
                slots += int(batch["paths"].size)
                yield batch
        finally:
            self._last_pad = (real, slots)


def _method_task_only(data, what: str) -> None:
    if data.infer_variable:
        raise ValueError(f"{what} plans the method task only (the variable expansion draws "
                         "per-item rng on the coordinator); run variable-task corpora with "
                         "--feed_workers 0")


class EpochSource(BatchSource):
    """The in-RAM source: one materialized :class:`EpochArrays` per epoch,
    batched at a fixed ``L`` or bucketed over ``ladder``. The epoch is
    built at the stream's first pull, not at :meth:`batches` time, so the
    generator is drawn in the JAX loop's order (subsample, then the batch
    order)."""

    def __init__(self, data, item_idx: np.ndarray, batch_size: int, max_contexts: int,
                 ladder: tuple[int, ...] | None = None, shuffle_variable_indexes: bool = False,
                 context_order: str = "shuffled"):
        self.data = data
        self.item_idx = np.asarray(item_idx)
        self.batch_size = int(batch_size)
        self.max_contexts = int(max_contexts)
        self.ladder = tuple(ladder) if ladder else (int(max_contexts),)
        self._bucketed = ladder is not None
        self._svi = bool(shuffle_variable_indexes)
        self._context_order = context_order
        self.last_epoch: EpochArrays | None = None
        # (rows, real, slots): a row's count is min(its contexts, the cap)
        # whichever contexts the subsample drew, so it is reckoned once
        self._pad_cache: tuple[int, int, int] | None = None

    def batches(self, rng: np.random.Generator,
                shuffle: bool = True) -> Iterator[dict[str, np.ndarray]]:
        def gen():
            epoch = build_epoch(self.data, self.item_idx, self.max_contexts, rng, self._svi,
                                self._context_order)
            self.last_epoch = epoch
            order = rng if shuffle else None
            if self._bucketed:
                yield from iter_bucketed_batches(epoch, self.ladder, self.batch_size,
                                                 rng=order, pad_final=True)
            else:
                yield from iter_batches(epoch, self.batch_size, rng=order, pad_final=True)

        return gen()

    def plan_batches(self, rng: np.random.Generator, shuffle: bool = True):
        _method_task_only(self.data, "the in-RAM source")

        def gen():
            # batches()' draws: the whole epoch's subsample at the first
            # pull, then the batch order
            entries, counts_full = _uniform_entries(rng, self.data.row_splits, self.item_idx)
            built_counts = np.minimum(counts_full, self.max_contexts)
            b = self.batch_size
            if self._bucketed:
                # iter_bucketed_batches' draws: a member permutation per
                # bucket in ladder order, then the plan interleave; a
                # partial batch repeats its own first row
                bucket_of = assign_buckets(built_counts, self.ladder)
                plans: list[tuple[int, np.ndarray]] = []
                for k, width in enumerate(self.ladder):
                    members = np.flatnonzero(bucket_of == k)
                    if shuffle:
                        members = members[rng.permutation(len(members))]
                    for lo in range(0, len(members), b):
                        plans.append((int(width), members[lo:lo + b]))
                if shuffle:
                    plans = [plans[i] for i in rng.permutation(len(plans))]
                for width, rows in plans:
                    valid = len(rows)
                    if valid < b:
                        rows = np.concatenate([rows, np.full(b - valid, rows[0], rows.dtype)])
                    yield _plan_of(width, [entries[r] for r in rows], valid,
                                   self._context_order)
            else:
                # iter_batches' draws: one row permutation when shuffling;
                # the final partial batch repeats epoch row 0
                n = len(self.item_idx)
                order = rng.permutation(n) if shuffle else None
                for lo in range(0, n, b):
                    hi = min(lo + b, n)
                    valid = hi - lo
                    rows = order[lo:hi] if order is not None else np.arange(lo, hi)
                    if valid < b:
                        rows = np.concatenate([rows, np.zeros(b - valid, rows.dtype)])
                    yield _plan_of(self.max_contexts, [entries[r] for r in rows], valid,
                                   self._context_order)

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


class StreamingSource(BatchSource):
    """The bounded-RSS source: chunked epoch builds
    (:func:`iter_streaming_batches`), fixed-``L`` or bucketed. Works over
    any backing, an mmap-backed CSR corpus too, and is the out-of-core
    feed of the variable task."""

    def __init__(self, data, item_idx: np.ndarray, batch_size: int, max_contexts: int,
                 chunk_items: int, ladder: tuple[int, ...] | None = None,
                 shuffle_variable_indexes: bool = False, context_order: str = "shuffled"):
        self.data = data
        self.item_idx = np.asarray(item_idx)
        self.batch_size = int(batch_size)
        self.max_contexts = int(max_contexts)
        self.chunk_items = int(chunk_items)
        self.ladder = tuple(ladder) if ladder else (int(max_contexts),)
        self._bucket_ladder = tuple(ladder) if ladder else None
        self._svi = bool(shuffle_variable_indexes)
        self._context_order = context_order

    def batches(self, rng: np.random.Generator, shuffle: bool = True):
        def chunk_builder(idx):
            return build_epoch(self.data, idx, self.max_contexts, rng, self._svi,
                               self._context_order)

        return self._accounted(iter_streaming_batches(
            chunk_builder, self.item_idx, self.batch_size, rng, chunk_items=self.chunk_items,
            shuffle=shuffle, ladder=self._bucket_ladder))

    def plan_batches(self, rng: np.random.Generator, shuffle: bool = True):
        _method_task_only(self.data, "streaming")

        def gen():
            # iter_streaming_batches' draws: the item order, then one
            # subsample draw a chunk; the sub-batch remainders (a bucket's,
            # when laddered) carry over as (item, uniforms) entries
            n = len(self.item_idx)
            order = rng.permutation(n) if shuffle else np.arange(n)
            b, ladder = self.batch_size, self._bucket_ladder
            pending: list = []
            carry: list[list] = [[] for _ in (ladder or ())]
            for lo in range(0, n, self.chunk_items):
                chunk_idx = self.item_idx[order[lo:lo + self.chunk_items]]
                entries, counts_full = _uniform_entries(rng, self.data.row_splits, chunk_idx)
                final = lo + self.chunk_items >= n
                if ladder is None:
                    pending.extend(entries)
                    n_full = len(pending) // b * b
                    for s in range(0, n_full, b):
                        yield _plan_of(self.max_contexts, pending[s:s + b], b,
                                       self._context_order)
                    pending = pending[n_full:]
                    if final and pending:
                        yield _plan_of(self.max_contexts,
                                       pending + [pending[0]] * (b - len(pending)),
                                       len(pending), self._context_order)
                        pending = []
                    continue
                bucket_of = assign_buckets(np.minimum(counts_full, self.max_contexts), ladder)
                plans: list[tuple[int, list, int]] = []
                for k, width in enumerate(ladder):
                    part = carry[k] + [entries[j] for j in np.flatnonzero(bucket_of == k)]
                    n_full = len(part) // b * b
                    for s in range(0, n_full, b):
                        plans.append((int(width), part[s:s + b], b))
                    rest = part[n_full:]
                    if final and rest:
                        plans.append((int(width), rest + [rest[0]] * (b - len(rest)),
                                      len(rest)))
                        rest = []
                    carry[k] = rest
                if shuffle:
                    plans = [plans[i] for i in rng.permutation(len(plans))]
                for width, rows, valid in plans:
                    yield _plan_of(width, rows, valid, self._context_order)

        return gen()


class MmapCorpusSource(BatchSource):
    """The never-materialize source: each ``[B, L_b]`` batch gathered
    straight from the (mmap-backed) CSR arrays, so no ``[N, L]`` epoch
    exists and host RSS stays one batch at any corpus size. The bucket of
    an item is ``min(count, top width)``'s, known from ``row_splits``
    alone, so the epoch's batch plan is drawn up front and each batch's
    subsample when it is built. Method task only (the variable expansion
    depends on the data: :class:`StreamingSource` takes it)."""

    def __init__(self, data, item_idx: np.ndarray, batch_size: int, max_contexts: int,
                 ladder: tuple[int, ...] | None = None, context_order: str = "shuffled"):
        if data.infer_variable:
            raise ValueError("MmapCorpusSource supports the method task only (the variable "
                             "expansion is data-dependent per item); use stream_chunk_items "
                             "for variable-task out-of-core feeding")
        self.data = data
        self.item_idx = np.asarray(item_idx)
        self.batch_size = int(batch_size)
        self.max_contexts = int(max_contexts)
        self.ladder = tuple(ladder) if ladder else (int(max_contexts),)
        self._context_order = context_order
        counts = data.row_splits[self.item_idx + 1] - data.row_splits[self.item_idx]
        self._counts = np.minimum(counts, self.ladder[-1])

    def _plan(self, rng: np.random.Generator | None) -> list[tuple[int, np.ndarray]]:
        """The epoch's ``(width, items)`` plan: :func:`iter_bucketed_batches`'
        member permutations and interleave (one width: the fixed plan)."""
        bucket_of = assign_buckets(self._counts, self.ladder)
        plans: list[tuple[int, np.ndarray]] = []
        for k, width in enumerate(self.ladder):
            members = self.item_idx[bucket_of == k]
            if rng is not None:
                members = members[rng.permutation(len(members))]
            for lo in range(0, len(members), self.batch_size):
                plans.append((width, members[lo:lo + self.batch_size]))
        if rng is not None:
            plans = [plans[i] for i in rng.permutation(len(plans))]
        return plans

    def _batch_plan(self, items: np.ndarray, width: int,
                    rng: np.random.Generator) -> "BatchPlan":
        """One batch's subsample draw and padding (the batch's row 0
        repeated); :meth:`batches` executes these plans inline, so the
        worker stream is this stream by construction."""
        entries, _ = _uniform_entries(rng, self.data.row_splits, items)
        valid = len(items)
        if valid < self.batch_size:
            entries = entries + [entries[0]] * (self.batch_size - valid)
        return _plan_of(width, entries, valid, self._context_order)

    def batches(self, rng: np.random.Generator, shuffle: bool = True):
        def gen():
            for width, items in self._plan(rng if shuffle else None):
                yield execute_plan(self.data, self._batch_plan(items, width, rng))

        return self._accounted(gen())

    def plan_batches(self, rng: np.random.Generator, shuffle: bool = True):
        def gen():
            for width, items in self._plan(rng if shuffle else None):
                yield self._batch_plan(items, width, rng)

        return gen()


def skip_batches(batches: Iterator[dict[str, np.ndarray]], n: int,
                 expect_widths: dict[int, int] | None = None) -> Iterator[dict[str, np.ndarray]]:
    """Consume the first ``n`` batches of an epoch stream and return the
    rest: the mid-epoch resume's replay (JAX ``pipeline.py:955-1000``).

    Every source's stream is a pure function of the generator's state at
    :meth:`BatchSource.batches`, so the stream made again from the
    cursor's state, less its first ``n`` batches, is bitwise where the
    interrupted run stopped (the bucketed plans too, drawn up front from
    the same generator). Only host batches are built and dropped: nothing
    is enqueued on the card. A :class:`~code2vec_tpu_torch.data.
    parallel_feed.ParallelFeed` stream hands each skipped batch's arena
    slot back at the next pull, as it does for a consumed one.

    ``expect_widths``: the cursor's batches per bucket width; a mismatch
    means the ladder or the batch size changed since the save, and the
    cursor cannot be honoured."""
    it = iter(batches)
    seen: dict[int, int] = {}
    for i in range(n):
        try:
            batch = next(it)
        except StopIteration:
            raise ValueError(
                f"mid-epoch cursor points past the epoch: batch {i} of {n} does not exist — "
                "the corpus or batching config changed since the checkpoint was saved; "
                "restart without --resume (or restore the original config)") from None
        width = int(batch["paths"].shape[1])
        seen[width] = seen.get(width, 0) + 1
    if expect_widths is not None and seen != {int(w): c for w, c in expect_widths.items()}:
        raise ValueError(
            f"mid-epoch cursor bucket positions {expect_widths} do not match the replayed "
            f"stream {seen}; the bucket ladder or batch size changed since the checkpoint was "
            "saved — resume with the original settings or restart without --resume")
    return it


def make_batch_source(data, item_idx: np.ndarray, batch_size: int, max_contexts: int,
                      ladder: tuple[int, ...] | None = None, stream_chunk_items: int = 0,
                      shuffle_variable_indexes: bool = False,
                      context_order: str = "shuffled") -> BatchSource:
    """The feed of one split (JAX ``pipeline.py:1530``):
    ``stream_chunk_items > 0`` streams (any backing, any task); an
    mmap-backed corpus with the method task only gathers batches from the
    mapped arrays; otherwise the in-RAM epoch. ``ladder=None`` is the
    fixed-``L`` single-width ladder."""
    if stream_chunk_items:
        return StreamingSource(data, item_idx, batch_size, max_contexts, stream_chunk_items,
                               ladder=ladder, shuffle_variable_indexes=shuffle_variable_indexes,
                               context_order=context_order)
    if getattr(data, "mmap_backed", False) and not data.infer_variable:
        return MmapCorpusSource(data, item_idx, batch_size, max_contexts, ladder=ladder,
                                context_order=context_order)
    return EpochSource(data, item_idx, batch_size, max_contexts, ladder=ladder,
                       shuffle_variable_indexes=shuffle_variable_indexes,
                       context_order=context_order)


# ---------------------------------------------------------------------------
# The plan/build split (JAX ``pipeline.py:1593-1700``). A method-task
# batch is a pure function of its items, its width and the items'
# subsample uniforms: ``plan_batches`` draws every value ``batches`` would,
# in its order and sizes, and ``execute_plan`` rebuilds each batch from the
# corpus arrays alone, on a worker process if need be. Executing the k-th
# plan gives the k-th batch bit for bit, and the generator ends in the
# state ``batches`` leaves it in.
# ---------------------------------------------------------------------------


@dataclass
class BatchPlan:
    """One batch with every draw made: ``items`` one per output row
    (padded by repeating a real row), ``uniforms`` the rows' subsample
    draws back to back (the sum of their full context counts)."""

    width: int
    valid: int  # rows with example_mask 1.0
    items: np.ndarray  # int64 [batch_size]
    uniforms: np.ndarray  # float64 [sum counts(items)]
    context_order: str = "shuffled"


class _PlannedDraws:
    """A stand-in for ``np.random.Generator`` that hands back the planned
    uniforms, so :func:`execute_plan` runs :func:`build_method_epoch`
    itself: there is no second subsample to keep in step."""

    def __init__(self, uniforms: np.ndarray):
        self._uniforms = uniforms
        self._pos = 0

    def random(self, n: int) -> np.ndarray:
        out = self._uniforms[self._pos:self._pos + n]
        if len(out) != n:
            raise ValueError(
                f"batch plan carries {len(self._uniforms)} uniforms but the build asked for "
                f"{self._pos + n}: the plan and the corpus disagree (corpus changed since "
                "planning?)")
        self._pos += n
        return out


def execute_plan(data, plan: BatchPlan) -> dict[str, np.ndarray]:
    """The planned batch, built from the corpus arrays (all randomness is in
    ``plan.uniforms``); ``data`` is a :class:`CorpusData` or a worker's slim
    view of its arrays."""
    sub = build_method_epoch(data, plan.items, plan.width, _PlannedDraws(plan.uniforms),
                             plan.context_order)
    mask = np.zeros(len(plan.items), np.float32)
    mask[:plan.valid] = 1.0
    return {"ids": sub.ids, "starts": sub.starts, "paths": sub.paths, "ends": sub.ends,
            "labels": sub.labels, "example_mask": mask}


def plan_real_slots(plan: BatchPlan, row_splits: np.ndarray) -> tuple[int, int]:
    """``(real context slots, slots)`` of the plan's batch, from its
    geometry alone (the ``pad_stats`` of a worker-fed stream)."""
    items = plan.items[:plan.valid]
    counts = (row_splits[items + 1] - row_splits[items]).astype(np.int64)
    return int(np.minimum(counts, plan.width).sum()), len(plan.items) * int(plan.width)


def _plan_of(width: int, entries: list[tuple[int, np.ndarray]], valid: int,
             context_order: str) -> BatchPlan:
    """A plan from per-row ``(item, uniforms)`` entries, already padded."""
    segs = [e[1] for e in entries]
    return BatchPlan(width=int(width), valid=int(valid),
                     items=np.asarray([e[0] for e in entries], np.int64),
                     uniforms=np.concatenate(segs) if segs else np.zeros(0, np.float64),
                     context_order=context_order)


def _uniform_entries(rng, row_splits: np.ndarray, items: np.ndarray
                     ) -> tuple[list[tuple[int, np.ndarray]], np.ndarray]:
    """The subsample uniforms of ``items`` drawn as one ``build_method_epoch``
    call draws them (one ``rng.random(total)``, none for a total of 0), cut
    into per-item segments: ``(entries, full counts)``."""
    items = np.asarray(items)
    counts = (row_splits[items + 1] - row_splits[items]).astype(np.int64)
    seg = np.zeros(len(items) + 1, np.int64)
    np.cumsum(counts, out=seg[1:])
    total = int(seg[-1])
    u = rng.random(total) if total else np.zeros(0, np.float64)
    return [(int(items[k]), u[seg[k]:seg[k + 1]]) for k in range(len(items))], counts


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
