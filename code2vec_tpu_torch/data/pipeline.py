"""Bag-width ladders: the padding rule every serving shape follows.

Own copy of ``derive_bucket_ladder_hist``, ``derive_bucket_ladder``,
``derive_longbag_ladder`` and ``nearest_bucket_width`` from
``code2vec_tpu/data/pipeline.py:456-645``.
PAD positions carry exactly-zero attention weight, so an example's
forward is identical at any width >= its real context count; padding to
a small static ladder keeps the set of shapes a server must warm small.
The rest of the pipeline comes with the training slice.
"""

from __future__ import annotations

import numpy as np


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
