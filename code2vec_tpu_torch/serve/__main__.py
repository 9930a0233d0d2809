"""``python -m code2vec_tpu_torch.serve`` — start the server on stdio.

Load the model dir (quantizing the tables once), warm every (batch,
width) shape of the ladder, load the retrieval backend, and only then
read requests::

    python -m code2vec_tpu_torch.serve --model_path out \\
        --terminal_idx_path ds/terminal_idxs.txt --path_idx_path ds/path_idxs.txt \\
        [--table_dtype int8] [--batch_sizes 1,8] [--device cpu] \\
        [--longbag_widths 512,1024,2048] \\
        [--code_vec_path out/code.vec | --retrieval_backend ann --ann_index_path out/ann.index]

Requests and responses are JSON lines (``serve/protocol.py``).
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import threading
import time

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="code2vec_tpu_torch.serve",
        description="code2vec online inference on PyTorch/CUDA (JSON lines on stdio)",
    )
    parser.add_argument("--model_path", required=True,
                        help="model dir: model_meta.json, label_vocab.txt, code2vec.model")
    parser.add_argument("--terminal_idx_path", required=True)
    parser.add_argument("--path_idx_path", required=True)
    parser.add_argument("--table_dtype", default=None, choices=("f32", "bf16", "int8"),
                        help="embedding-table storage (default: the model meta's)")
    parser.add_argument("--batch_sizes", default="1,8",
                        help="comma list of micro-batch sizes warmed at start")
    parser.add_argument("--deadline_ms", type=float, default=2.0,
                        help="how long the first request of a group waits for company")
    parser.add_argument("--max_pending", type=int, default=256,
                        help="queued-request bound; beyond it requests are shed")
    parser.add_argument("--pallas_impl", default="fused",
                        choices=("fused", "gather_split", "pool_only"),
                        help="kernel route of the forward: fused (K3), gather_split "
                        "(K2) or pool_only (K1)")
    parser.add_argument("--pallas_softmax", default="auto",
                        choices=("auto", "materialize", "online", "two_pass"),
                        help="bag softmax of the fused kernel: auto streams (online, K4) "
                        "only at long-bag widths above the training bag")
    parser.add_argument("--longbag_widths", default="",
                        help="comma list of long-bag rungs above the ladder's top (e.g. "
                        "512,1024,2048): requests up to the top rung then serve through "
                        "the streamed-softmax kernel instead of being subsampled")
    parser.add_argument("--code_vec_path", default=None,
                        help="exported code.vec for the exact neighbors backend (default: "
                        "<model_path>/code.vec when present)")
    parser.add_argument("--retrieval_backend", default="exact", choices=("exact", "ann"),
                        help="neighbors backend: 'exact' = one f32 matmul over code.vec; "
                        "'ann' = IVF-PQ index with exact re-rank")
    parser.add_argument("--ann_index_path", default=None,
                        help="ANN index container for --retrieval_backend ann (default: "
                        "<model_path>/ann.index when present)")
    parser.add_argument("--ann_n_probe", type=int, default=None,
                        help="cells probed per ANN query (default: the container's)")
    parser.add_argument("--ann_shortlist", type=int, default=None,
                        help="ANN shortlist re-ranked exactly per query (default: the "
                        "container's)")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' runs the plain versions)")
    return parser


def build_retrieval(args, device):
    """The neighbors backend of ``args`` (None when there is nothing to
    load: the op then answers bad_request)."""
    from code2vec_tpu_torch.serve.retrieval import RetrievalIndex, load_retrieval_index

    if args.retrieval_backend == "ann":
        path = args.ann_index_path
        if path is None:
            default = os.path.join(args.model_path, "ann.index")
            path = default if os.path.exists(default) else None
        return load_retrieval_index("ann", ann_index_path=path, n_probe=args.ann_n_probe,
                                    shortlist=args.ann_shortlist, device=device)
    path = args.code_vec_path
    if path is None:
        default = os.path.join(args.model_path, "code.vec")
        path = default if os.path.exists(default) else None
    return RetrievalIndex.from_code_vec(path, device=device) if path else None


def build_server(args):
    """Predictor -> warmed engine -> retrieval -> micro-batcher -> CodeServer, in
    process (tests and chip_smoke.py drive it without a subprocess)."""
    from code2vec_tpu_torch.extractor import load_library
    from code2vec_tpu_torch.predict import Predictor
    from code2vec_tpu_torch.serve.batcher import MicroBatcher
    from code2vec_tpu_torch.serve.engine import ServingEngine
    from code2vec_tpu_torch.serve.protocol import CodeServer

    batch_sizes = tuple(int(tok) for tok in str(args.batch_sizes).split(",") if tok.strip())
    longbag = tuple(int(tok) for tok in str(args.longbag_widths).split(",") if tok.strip())
    predictor = Predictor(
        args.model_path, args.terminal_idx_path, args.path_idx_path,
        table_dtype=args.table_dtype, device=args.device,
        pallas_impl=args.pallas_impl, pallas_softmax=args.pallas_softmax,
        longbag_widths=longbag,
    )
    engine = ServingEngine(predictor, batch_sizes=batch_sizes)
    warm = engine.prepare()
    logger.info("warmed %d shapes over ladder %s x batch sizes %s on %s",
                len(warm), list(engine.ladder), list(engine.batch_sizes), predictor.device)
    # the Java extractor, built at first use, is built and loaded here so
    # that no `source` request waits for g++
    t0 = time.perf_counter()
    load_library()
    extractor_ms = (time.perf_counter() - t0) * 1e3
    logger.info("Java extractor ready in %.1f ms", extractor_ms)
    retrieval = build_retrieval(args, predictor.device)
    batcher = MicroBatcher(engine, deadline_ms=args.deadline_ms, max_pending=args.max_pending)
    return CodeServer(predictor, engine, batcher, retrieval=retrieval, version=args.model_path,
                      extractor_ms=extractor_ms)


def main(argv: list[str] | None = None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s: %(message)s", stream=sys.stderr)
    args = build_parser().parse_args(argv)
    from code2vec_tpu_torch.serve.protocol import serve_stdio

    server = build_server(args)
    stop = threading.Event()
    previous = signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        serve_stdio(server, sys.stdin, sys.stdout, stop_event=stop)
    finally:
        signal.signal(signal.SIGTERM, previous)


if __name__ == "__main__":
    main()
