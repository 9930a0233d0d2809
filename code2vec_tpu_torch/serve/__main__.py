"""``python -m code2vec_tpu_torch.serve`` — start the server (stdio or HTTP).

Counterpart of ``code2vec_tpu/serve/__main__.py``. Load the model dir
(quantizing the tables once), warm every (batch, width) shape of the
ladder, load the retrieval backend, build and load the Java extractor,
and only then accept traffic::

    python -m code2vec_tpu_torch.serve --model_path out \\
        --terminal_idx_path ds/terminal_idxs.txt --path_idx_path ds/path_idxs.txt \\
        [--transport stdio | --transport http --host 127.0.0.1 --port 8080] \\
        [--table_dtype int8] [--batch_sizes 1,8] [--device cpu] \\
        [--longbag_widths 512,1024,2048] [--pallas_impl auto --autotune_cache at.json] \\
        [--code_vec_path out/code.vec | --retrieval_backend ann --ann_index_path out/ann.index]

Requests and responses are JSON (``serve/protocol.py``); ``reload`` with a
``model_path`` hot-swaps another model dir in (``serve/swap.py``), each
generation resolving its own ``code.vec`` / ``ann.index`` beside it.
SIGTERM drains: every accepted request is answered, then the process
exits 0. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import itertools
import logging
import os
import sys
import time

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="code2vec_tpu_torch.serve",
        description="code2vec online inference on PyTorch/CUDA (JSON lines on stdio, or HTTP)",
    )
    parser.add_argument("--model_path", required=True,
                        help="model dir: model_meta.json, label_vocab.txt, code2vec.model")
    parser.add_argument("--terminal_idx_path", required=True)
    parser.add_argument("--path_idx_path", required=True)
    parser.add_argument("--transport", default="stdio", choices=("stdio", "http"),
                        help="stdio = JSON lines over stdin/stdout; http = stdlib threading "
                        "server (POST /, GET /healthz, GET /metrics)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--table_dtype", default=None, choices=("f32", "bf16", "int8"),
                        help="embedding-table storage (default: the model meta's)")
    parser.add_argument("--batch_sizes", default="1,8",
                        help="comma list of micro-batch sizes warmed at start")
    parser.add_argument("--deadline_ms", type=float, default=2.0,
                        help="how long the first request of a group waits for company")
    parser.add_argument("--max_pending", type=int, default=256,
                        help="queued-request bound; beyond it requests are shed")
    parser.add_argument("--warmup_requests", type=int, default=64,
                        help="histogram-fallback sample size when the model meta has no "
                        "recorded bucket ladder")
    parser.add_argument("--pallas_impl", default="fused",
                        choices=("fused", "gather_split", "pool_only", "auto"),
                        help="kernel route of the forward: fused (K3), gather_split "
                        "(K2), pool_only (K1), or auto (each shape's route from the "
                        "schedule cache)")
    parser.add_argument("--autotune_cache", default="",
                        help="kernel-schedule cache consulted for every warmed shape "
                        "(ops/autotune.py; default $C2V_AUTOTUNE_CACHE or "
                        "~/.cache/code2vec_tpu/autotune_schedules.json)")
    parser.add_argument("--pallas_softmax", default="auto",
                        choices=("auto", "materialize", "online", "two_pass"),
                        help="bag softmax of the fused kernel: auto streams (online, K4) "
                        "only at long-bag widths above the training bag")
    parser.add_argument("--longbag_widths", default="",
                        help="comma list of long-bag rungs above the ladder's top (e.g. "
                        "512,1024,2048): requests up to the top rung then serve through "
                        "the streamed-softmax kernel instead of being subsampled")
    parser.add_argument("--golden_min_recall", type=float, default=0.9,
                        help="hot-swap validation: the neighbors recall@10 a reloaded "
                        "generation's retrieval backend must reach against a brute-force "
                        "reference before the reload may commit (serve/swap.py)")
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
    parser.add_argument("--accelerator", action="store_true", default=False,
                        help="JAX's flag for serving off the CPU, accepted so its command "
                        "lines run; the port serves on the card without it too, and "
                        "--device cpu still wins")
    parser.add_argument("--events_dir", default=None,
                        help="JSONL event log: the run manifest, then serve_executable, "
                        "swap and flight events")
    parser.add_argument("--trace_dir", default=None,
                        help="Chrome trace of the serve spans (queue_wait/pad/device/"
                        "postprocess), tagged with the request's trace id when one rides "
                        "its 'trace' field (the fleet router stamps it)")
    parser.add_argument("--flight_threshold_ms", type=float, default=0.0,
                        help="slow-request flight recorder: keep the span breakdown of "
                        "every request slower than this (0 = p99 sampling only); records "
                        "go out as flight events and flight_*.json under <events_dir>/flight")
    parser.add_argument("--sync_debug", action="store_true", default=False,
                        help="lock sanitizer (obs/sync.py): trace every factory-built lock; "
                        "the same as C2V_SYNC_DEBUG=1")
    parser.add_argument("--handle_debug", action="store_true", default=False,
                        help="handle ledger (obs/handles.py): track every lifecycle object, "
                        "report the open ones at exit; the same as C2V_HANDLE_DEBUG=1")
    return parser


def build_retrieval(args, model_path: str, device):
    """The neighbors backend of one generation, resolved against THAT
    generation's model dir (None when there is nothing to load: the op
    then answers bad_request)."""
    from code2vec_tpu_torch.serve.retrieval import RetrievalIndex, load_retrieval_index

    if args.retrieval_backend == "ann":
        path = args.ann_index_path
        if path is None:
            default = os.path.join(model_path, "ann.index")
            path = default if os.path.exists(default) else None
        return load_retrieval_index("ann", ann_index_path=path, n_probe=args.ann_n_probe,
                                    shortlist=args.ann_shortlist, device=device)
    path = args.code_vec_path
    if path is None:
        default = os.path.join(model_path, "code.vec")
        path = default if os.path.exists(default) else None
    return RetrievalIndex.from_code_vec(path, device=device) if path else None


def make_generation_factory(args, events=None, start: int = 0, flight=None):
    """``build(target) -> Generation``: load a model dir (``target``; None
    = ``--model_path``), warm its full ladder, load its retrieval backend,
    stand up a micro-batcher. Called once at start for generation 0 and
    again, on the swap controller's thread, for every ``reload``. Every
    generation's batcher feeds the process's one ``flight`` recorder."""
    from code2vec_tpu_torch.predict import Predictor
    from code2vec_tpu_torch.serve.batcher import MicroBatcher
    from code2vec_tpu_torch.serve.engine import ServingEngine
    from code2vec_tpu_torch.serve.swap import Generation

    batch_sizes = tuple(int(tok) for tok in str(args.batch_sizes).split(",") if tok.strip())
    longbag = tuple(int(tok) for tok in str(args.longbag_widths).split(",") if tok.strip())
    counter = itertools.count(start)

    def build(target: str | None) -> Generation:
        model_path = target or args.model_path
        if not os.path.isdir(model_path):
            raise ValueError(f"model_path {model_path!r} is not a directory")
        version = f"{model_path}#g{next(counter)}"
        predictor = Predictor(
            model_path, args.terminal_idx_path, args.path_idx_path,
            table_dtype=args.table_dtype, device=args.device,
            pallas_impl=args.pallas_impl, pallas_softmax=args.pallas_softmax,
            longbag_widths=longbag,
        )
        engine = ServingEngine(predictor, batch_sizes=batch_sizes,
                               warmup_requests=args.warmup_requests, events=events,
                               version=version)
        provenance = engine.prepare()
        logger.info("[%s] warmed %d shapes over ladder %s x batch sizes %s on %s", version,
                    len(provenance), list(engine.active_ladder), list(engine.batch_sizes),
                    predictor.device)
        retrieval = build_retrieval(args, model_path, predictor.device)
        batcher = MicroBatcher(engine, deadline_ms=args.deadline_ms,
                               max_pending=args.max_pending, flight=flight)
        return Generation(version=version, predictor=predictor, engine=engine,
                          batcher=batcher, retrieval=retrieval, provenance=provenance)

    return build


def build_server(args):
    """Everything between argument parsing and the transport loop, in
    process (tests and chip_smoke.py drive it without a subprocess). The
    server's ``events`` is the event log (None without --events_dir)."""
    from code2vec_tpu_torch.extractor import load_library
    from code2vec_tpu_torch.obs.runtime import FlightRecorder, global_health
    from code2vec_tpu_torch.ops.autotune import pin_cache
    from code2vec_tpu_torch.serve.protocol import CodeServer
    from code2vec_tpu_torch.serve.swap import GoldenSet

    # the debug switches flip BEFORE any lock or lifecycle object is built
    if getattr(args, "sync_debug", False):
        from code2vec_tpu_torch.obs.sync import SYNC_DEBUG_ENV

        os.environ[SYNC_DEBUG_ENV] = "1"
    if getattr(args, "handle_debug", False):
        from code2vec_tpu_torch.obs.handles import HANDLE_DEBUG_ENV

        os.environ[HANDLE_DEBUG_ENV] = "1"
    # pin the schedule cache before the first forward, as train() does
    pin_cache(getattr(args, "autotune_cache", ""))
    events = None
    if args.events_dir:
        from code2vec_tpu_torch.obs import handles, sync
        from code2vec_tpu_torch.obs.events import EventLog

        events = EventLog(args.events_dir)
        if sync.sync_debug_enabled():
            sync.register_event_log(events)
        if handles.handle_debug_enabled():
            handles.register_event_log(events)
    threshold = getattr(args, "flight_threshold_ms", 0.0)
    flight = FlightRecorder(threshold_ms=threshold if threshold > 0 else None,
                            health=global_health())
    # generation 0 is built without the event log (the manifest must stay
    # the log's first line); later generations log their shapes
    gen0 = make_generation_factory(args, flight=flight)(None)
    # the Java extractor, built at first use, is built and loaded here so
    # that no `source` request waits for g++
    t0 = time.perf_counter()
    load_library()
    extractor_ms = (time.perf_counter() - t0) * 1e3
    logger.info("Java extractor ready in %.1f ms", extractor_ms)
    factory = make_generation_factory(args, events=events, start=1, flight=flight)
    if events is not None:
        engine = gen0.engine
        events.write_manifest(serve={
            "model_path": args.model_path, "transport": args.transport,
            "version": gen0.version, "device": str(engine.device),
            "table_dtype": engine.table_dtype, "ladder": list(engine.active_ladder),
            "batch_sizes": list(engine.batch_sizes), "deadline_ms": args.deadline_ms,
            "executables": gen0.provenance,
            "retrieval": gen0.retrieval.describe() if gen0.retrieval is not None else None,
        })
        engine._events = events
        flight._events = events
    server = CodeServer(gen0.predictor, gen0.engine, gen0.batcher, retrieval=gen0.retrieval,
                        version=gen0.version, factory=factory,
                        golden=GoldenSet(min_recall=args.golden_min_recall), events=events,
                        flight=flight, generation=gen0, extractor_ms=extractor_ms)
    server.events = events
    global_health().gauge("serve_transport").set(args.transport)
    return server


def main(argv: list[str] | None = None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s: %(message)s", stream=sys.stderr)
    args = build_parser().parse_args(argv)
    from code2vec_tpu_torch.obs.trace import Tracer, set_tracer
    from code2vec_tpu_torch.serve.protocol import run_transport

    tracer = None
    if args.trace_dir:
        tracer = Tracer(process_name=f"serve-worker-{os.getpid()}")
        set_tracer(tracer)
    server = build_server(args)
    events = server.events
    try:
        # SIGTERM drains (run_transport), then closes every generation:
        # no batcher thread is launching while the interpreter tears down
        run_transport(server, args.transport, args.host, args.port)
    finally:
        if tracer is not None:
            set_tracer(None)
            try:
                tracer.export_dir(args.trace_dir)
            except Exception:
                logger.warning("could not write the chrome trace", exc_info=True)
        if args.events_dir and server.flight is not None:
            try:
                server.flight.dump(os.path.join(args.events_dir, "flight"))
            except Exception:
                logger.warning("could not dump the flight records", exc_info=True)
        # the server is closed (generations, batchers, flight recorder all
        # untracked): a handle still open here is a leak, named by its site
        from code2vec_tpu_torch.obs.handles import handle_debug_enabled, report_leaks

        if handle_debug_enabled():
            report_leaks("serve.shutdown", events=events,
                         exclude=(events,) if events is not None else ())
        if events is not None:
            events.close()


if __name__ == "__main__":
    main()
