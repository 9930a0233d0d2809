"""Train and save an IVF-PQ index from an exported ``code.vec`` (or ``file.vec``).

Counterpart of ``tools/ann_build.py``, with the same flags, the same
defaults and the same one-line JSON summary. It is the offline half of the
server's ``--retrieval_backend ann``: read the vectors, train the coarse
k-means quantizer and the PQ codebooks (seeded: the same seed gives the
same container bytes), lay the codes out cell-major and write the
container (``formats/ann_io.py``, the JAX package's layout) with the
serving defaults (``n_probe``, ``shortlist``) in its header::

    python -m code2vec_tpu_torch.tools.ann_build --code_vec out/code.vec --out out/ann.index \\
        [--n_list 256] [--m 8] [--n_probe 8] [--shortlist 128] [--device cpu]

``--n_list 0`` (the default) picks ~sqrt(N) rounded up to a multiple of 8;
an ``--m`` that does not divide the vectors' width falls back to its
largest divisor below it. The distance work runs on the card unless
``--device cpu``; with no GPU visible and no ``--device`` the tool raises.
JAX's ``--accelerator`` is accepted and changes nothing: the port builds on
the card without it too.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="code2vec_tpu_torch.tools.ann_build",
                                     description="IVF-PQ ANN index builder (see module docstring)")
    parser.add_argument("--code_vec", required=True,
                        help="exported code.vec (word2vec text format)")
    parser.add_argument("--out", required=True, help="output container path (e.g. out/ann.index)")
    parser.add_argument("--n_list", type=int, default=0,
                        help="coarse cells; 0 = ~sqrt(N) rounded to 8")
    parser.add_argument("--m", type=int, default=8,
                        help="PQ subspaces (must divide the vector dim)")
    parser.add_argument("--kmeans_iters", type=int, default=25)
    parser.add_argument("--pq_iters", type=int, default=15)
    parser.add_argument("--batch_size", type=int, default=16384,
                        help="mini-batch rows per Lloyd's iteration")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--n_probe", type=int, default=8,
                        help="serving default baked into the container")
    parser.add_argument("--shortlist", type=int, default=128,
                        help="serving default baked into the container")
    parser.add_argument("--device", default=None,
                        help="torch device of the build (default cuda; 'cpu' builds on the CPU)")
    parser.add_argument("--accelerator", action="store_true", default=False,
                        help="JAX's flag for a build off the CPU, accepted so its command "
                        "lines run; the port builds on the card without it too, and "
                        "--device cpu still wins")
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    from code2vec_tpu_torch.ann.index import build_index, save_index
    from code2vec_tpu_torch.formats.vectors_io import read_code_vectors
    from code2vec_tpu_torch.ops.backend import resolve_device

    device = resolve_device(args.device)
    labels, rows = read_code_vectors(args.code_vec)
    n = len(labels)
    if n < 2:
        print(f"ann_build: {args.code_vec} holds {n} vectors; need >= 2", file=sys.stderr)
        return 2
    n_list = args.n_list
    if n_list <= 0:
        n_list = max(-(-int(round(n ** 0.5)) // 8) * 8, 8)
    m, dim = args.m, rows.shape[1]
    if dim % m:
        m = next(d for d in range(m, 0, -1) if dim % d == 0)
        print(f"ann_build: --m {args.m} does not divide dim {dim}; using m={m}", file=sys.stderr)

    t0 = time.perf_counter()
    index, unit = build_index(rows, n_list=n_list, m=m, seed=args.seed,
                              kmeans_iters=args.kmeans_iters, pq_iters=args.pq_iters,
                              batch_size=args.batch_size, device=device)
    build_seconds = time.perf_counter() - t0
    save_index(args.out, index, unit, labels,
               defaults={"n_probe": args.n_probe, "shortlist": args.shortlist})
    meta = index.meta
    slots = meta["n_list"] * meta["capacity"]
    print(json.dumps({
        "out": args.out, "n": meta["n"], "dim": meta["dim"], "n_list": meta["n_list"],
        "m": meta["m"], "capacity": meta["capacity"],
        "cell_pad_efficiency": round(meta["n"] / slots, 4), "n_probe": args.n_probe,
        "shortlist": args.shortlist, "seed": args.seed,
        "build_seconds": round(build_seconds, 2), "container_bytes": os.path.getsize(args.out),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
