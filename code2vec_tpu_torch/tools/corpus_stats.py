"""A corpus's context-length histogram and a suggested bucket ladder.

Counterpart of ``tools/corpus_stats.py``, the same arguments, table and
last JSON line. ``--bucketed`` training derives its ladder from the
corpus's ``row_splits`` histogram at startup; this runs the derivation
offline, to read the length distribution, the share of a fixed-``L`` feed
that is PAD, and pin a ``--bucket_ladder`` before a long run. It reads
the corpus alone (no vocab files): a text corpus by a line scan, a CSR
container (``tools/corpus_convert.py``) from its footer, with no scan of
the context sections at any size. Host only::

    python -m code2vec_tpu_torch.tools.corpus_stats dataset/corpus.txt --max_contexts 200
    python -m code2vec_tpu_torch.tools.corpus_stats dataset/corpus.csr --max_contexts 200
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from code2vec_tpu_torch.data.pipeline import (
    assign_buckets,
    derive_bucket_ladder,
    derive_longbag_ladder,
    pad_stats,
    truncated_fraction_of_counts,
)
from code2vec_tpu_torch.formats.corpus_io import is_csr_corpus, read_csr_histogram


def context_counts(corpus_path: str) -> np.ndarray:
    """The contexts of each method of a text corpus: a ``paths:`` line
    opens the block, every line after it is a context until ``vars:`` or
    the blank line that ends the record."""
    counts: list[int] = []
    n: int | None = None
    with open(corpus_path, encoding="utf-8") as f:
        for raw in f:
            line = raw.rstrip("\n")
            if n is None:
                if line.startswith("paths:"):
                    n = 0
            elif not line or line.startswith("vars:"):
                counts.append(n)
                n = None
            else:
                n += 1
    if n is not None:  # no blank line after the last record
        counts.append(n)
    return np.asarray(counts, np.int64)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="code2vec_tpu_torch.tools.corpus_stats",
                                     description="context-length histogram + suggested bucket "
                                     "ladder")
    parser.add_argument("corpus_path", help="L1 corpus.txt")
    parser.add_argument("--max_contexts", type=int, default=200,
                        help="the run's bag size (--max_path_length); the "
                             "ladder tops out here")
    parser.add_argument("--max_buckets", type=int, default=4,
                        help="ladder size cap (= expected step compiles)")
    parser.add_argument("--batch_size", type=int, default=1024,
                        help="batch size for the pad-efficiency estimate")
    parser.add_argument("--chunk_l", type=int, default=128,
                        help="chunk size of the fused kernel's streamed "
                        "softmax — longbag rung widths round up to a "
                        "multiple of it")
    args = parser.parse_args(argv)

    if is_csr_corpus(args.corpus_path):
        lengths, weights = read_csr_histogram(args.corpus_path)
        counts = np.repeat(lengths, weights)
        print(f"(histogram from CSR container footer: {args.corpus_path})")
    else:
        counts = context_counts(args.corpus_path)
    if not len(counts):
        print(json.dumps({"error": "no records found", "n_methods": 0}))
        return 0
    ladder = derive_bucket_ladder(counts, args.max_contexts, max_buckets=args.max_buckets)
    capped = np.minimum(counts, args.max_contexts)
    bucket_of = assign_buckets(capped, ladder)

    pcts = [50, 75, 90, 95, 99]
    percentiles = {str(p): int(np.percentile(counts, p)) for p in pcts}
    print(f"{len(counts)} methods, context counts "
          f"min={counts.min()} max={counts.max()} mean={counts.mean():.1f}")
    print("percentiles: " + "  ".join(f"p{p}={percentiles[str(p)]}" for p in pcts))
    print()
    print(f"{'bucket':>10} {'methods':>10} {'share':>7} {'real/slot':>10}")
    prev = 0
    for b, width in enumerate(ladder):
        members = capped[bucket_of == b]
        share = len(members) / len(counts)
        fill = members.mean() / width if len(members) else 0.0
        print(f"{prev + 1:>4}-{width:<5} {len(members):>10} {share:>6.1%} {fill:>9.1%}")
        prev = width

    real, fixed_slots = pad_stats(counts, (args.max_contexts,), args.batch_size)
    _, ladder_slots = pad_stats(counts, ladder, args.batch_size)
    fixed_eff = real / fixed_slots if fixed_slots else 1.0
    ladder_eff = real / ladder_slots if ladder_slots else 1.0
    print()
    print(f"pad efficiency at fixed L={args.max_contexts}: {fixed_eff:.1%}"
          f"  |  bucketed over {list(ladder)}: {ladder_eff:.1%}")

    # what the cap drops: every context past max_contexts; --max_contexts 0
    # (the long-bag rungs below) feeds them all
    trunc = truncated_fraction_of_counts(counts, args.max_contexts)
    lengths, weights = np.unique(counts, return_counts=True)
    longbag = derive_longbag_ladder(lengths, weights, args.max_contexts, chunk_l=args.chunk_l)
    n_truncated = int((counts > args.max_contexts).sum())
    print(f"truncated at L={args.max_contexts}: {trunc:.2%} of real "
          f"contexts dropped ({n_truncated} methods exceed the cap)")
    if longbag:
        print(f"longbag rungs for --max_contexts 0: {list(longbag)} (truncation -> 0)")
    print(f"suggested: --bucketed --bucket_ladder {','.join(str(w) for w in ladder)}")
    print(json.dumps({
        "n_methods": int(len(counts)),
        "total_contexts": int(counts.sum()),
        "percentiles": percentiles,
        "ladder": list(ladder),
        "pad_efficiency_fixed": round(fixed_eff, 4),
        "pad_efficiency_bucketed": round(ladder_eff, 4),
        "truncated_context_fraction": round(trunc, 6),
        "longbag_ladder": list(longbag),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
