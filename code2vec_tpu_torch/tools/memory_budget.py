"""Host memory of the epoch paths at top11 scale, and the java-large budget.

Counterpart of ``tools/memory_budget.py``, with its flags and its measured
line: by default a partial epoch is streamed (``iter_streaming_batches``,
``--batches`` batches of 1024) over the resident synthetic corpus (top11's
605,945 methods, vocabs and mean 120 contexts); ``--materialize`` builds
the whole ``[N, L]`` epoch instead (the path streaming replaces). The line
gives the corpus's RSS and the epoch's peak RSS above it. Run each mode in
a process of its own: RSS is process-wide. Host memory only: nothing here
touches the card.

Then it prints the java-large budget (BASELINE config 3: 16M methods at a
mean of 120 contexts) by the formulas of ``docs/ARCHITECTURE.md`` ("Memory
budget at java-large scale"), one JSON line a component::

    python -m code2vec_tpu_torch.tools.memory_budget [--materialize]
"""

from __future__ import annotations

import argparse
import json
import resource
import sys

import numpy as np

TOP11_METHODS = 605_945
JAVA_LARGE_METHODS = 16_000_000
MEAN_CONTEXTS = 120
CONTEXT_BYTES = 3 * 4  # (start, path, end) int32
N_HOSTS = 8
DATA_AXIS = 8


def rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def budget(bag: int = 200, chunk_items: int = 65_536) -> list[dict]:
    """The budget table's components in bytes (``docs/ARCHITECTURE.md``):
    java-large's 16M methods, and top11's staged on a device."""
    n_methods = JAVA_LARGE_METHODS
    corpus = n_methods * MEAN_CONTEXTS * CONTEXT_BYTES
    staged = TOP11_METHODS * MEAN_CONTEXTS * CONTEXT_BYTES
    rows = [
        ("CSR corpus (starts/paths/ends)", "total_ctx x 3 x 4 B", corpus),
        ("materialized epoch [N, L]", "N x L x 3 x 4 B", n_methods * bag * CONTEXT_BYTES),
        (f"streamed epoch chunk ({chunk_items:,} rows)", "chunk x L x 3 x 4 B",
         chunk_items * bag * CONTEXT_BYTES),
        (f"per-host CSR, {N_HOSTS} hosts with --host_shard_corpus", "corpus / n_hosts",
         corpus // N_HOSTS),
        ("staged corpus a device, replicated (top11)", "total_ctx x 12 B", staged),
        (f"staged corpus a device, --shard_staged_corpus (top11, data={DATA_AXIS})",
         "staged / data_axis", staged // DATA_AXIS),
    ]
    return [{"budget": name, "formula": formula, "bytes": int(b), "gb": round(b / 1e9, 2)}
            for name, formula, b in rows]


def measure(n_methods: int, bag: int, chunk_items: int, batches: int,
            materialize: bool) -> dict:
    """The measured line: RSS of the corpus, and of the epoch above it."""
    from code2vec_tpu_torch.data.pipeline import build_epoch, iter_streaming_batches
    from code2vec_tpu_torch.data.synth import SynthSpec, corpus_data_from_raw, \
        generate_corpus_data

    spec = SynthSpec(n_methods=n_methods, n_terminals=360_631, n_paths=342_845,
                     n_labels=8_000, mean_contexts=120.0, max_contexts=400, seed=0)
    data = corpus_data_from_raw(generate_corpus_data(spec))
    base = rss_mb()
    rng = np.random.default_rng(0)
    idx = np.arange(data.n_items)
    if materialize:
        epoch = build_epoch(data, idx, bag, rng)
        mode, touched = "materialize", len(epoch)
    else:
        it = iter_streaming_batches(lambda i: build_epoch(data, i, bag, rng), idx,
                                    batch_size=1024, rng=rng, chunk_items=chunk_items)
        touched = 0
        for _ in range(batches):
            next(it)
            touched += 1024
        mode = "stream"
    return {"mode": mode, "n_methods": n_methods, "bag": bag,
            "corpus_rss_mb": round(base, 1), "epoch_peak_delta_mb": round(rss_mb() - base, 1),
            "rows_touched": touched}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="code2vec_tpu_torch.tools.memory_budget",
                                 description="epoch host memory and the java-large budget")
    ap.add_argument("--materialize", action="store_true")
    ap.add_argument("--n_methods", type=int, default=TOP11_METHODS)
    ap.add_argument("--bag", type=int, default=200)
    ap.add_argument("--chunk_items", type=int, default=65_536)
    ap.add_argument("--batches", type=int, default=96, help="stream this many")
    args = ap.parse_args(argv)
    print(json.dumps(measure(args.n_methods, args.bag, args.chunk_items, args.batches,
                             args.materialize)), flush=True)
    for line in budget(bag=args.bag, chunk_items=args.chunk_items):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
