"""The input pipeline: split, per-epoch resampling, batching, bag ladders.

Own copy of ``code2vec_tpu/data/pipeline.py``'s host path for the
method-name task (``:47-180``, ``:357-455``) and its ladder helpers
(``:456-645``). The same semantics as the reference's per-method loop
(model/dataset_builder.py:112-210) as vectorized numpy over the CSR
arrays, drawing from the caller's generator in the JAX module's exact
order, so both trainers see the same batches:

- a seeded train/test split;
- a fresh random subsample of up to ``max_contexts`` contexts per method
  every epoch (model/dataset_builder.py:134-135);
- ``@method_0 -> @question``, so the answer is not leaked;
- static ``[B, L]`` batches (PAD = 0) with an example mask.

PAD positions carry exactly-zero attention weight, so an example's
forward is identical at any width >= its real context count: the
ladders pad serving shapes to a small static set. The variable-name task,
bucketed and streaming epochs are not ported yet (ROADMAP §A.2).
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


def build_epoch(data, item_idx: np.ndarray, max_contexts: int,
                rng: np.random.Generator) -> EpochArrays:
    """A full epoch of the tasks the corpus was loaded with: the method
    task (the variable task raises, ROADMAP §A.2)."""
    if data.infer_variable or not data.infer_method:
        raise NotImplementedError(
            "the port builds method-name epochs only; the variable-name task is "
            "not ported yet (ROADMAP §A.2)"
        )
    return build_method_epoch(data, item_idx, max_contexts, rng)


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
