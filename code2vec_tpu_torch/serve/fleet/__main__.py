"""``python -m code2vec_tpu_torch.serve.fleet`` — launch router + N replicas.

Counterpart of ``code2vec_tpu/serve/fleet/__main__.py``. The router
process imports no ``torch`` (it opens no CUDA context); each replica is a
full ``python -m code2vec_tpu_torch.serve --transport stdio`` subprocess
that warms its ladder on the card (or on the CPU with ``--device cpu``)
before the router counts it placeable.
Client-facing transports are the same stdio-JSONL/HTTP adapters the
single-process server uses — a client cannot tell a fleet from one
worker, except that ``health`` returns the fleet topology and ``reload``
performs a ROLLING hot-swap across the replicas.

    python -m code2vec_tpu_torch.serve.fleet --replicas 4 \\
        --model_path out \\
        --terminal_idx_path ds/terminal_idxs.txt \\
        --path_idx_path ds/path_idxs.txt \\
        --transport http --port 8080 \\
        --slo embed=512:1500,neighbors=64:8000 [--device cpu]

    # zero-downtime rollout + instant rollback (any transport):
    {"op": "reload", "model_path": "out_v2"}
    {"op": "swap_status"}
    {"op": "rollback"}
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="code2vec_tpu_torch.serve.fleet",
        description="fleet serving: replica router, tiered load shedding, "
        "rolling live checkpoint hot-swap",
    )
    parser.add_argument("--replicas", type=int, default=2,
                        help="worker subprocess count")
    parser.add_argument("--model_path", required=True)
    parser.add_argument("--terminal_idx_path", required=True)
    parser.add_argument("--path_idx_path", required=True)
    parser.add_argument("--transport", default="stdio",
                        choices=("stdio", "http"))
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--slo", default="",
                        help="per-class budget/deadline overrides: "
                        "class=budget:deadline_ms comma-separated over "
                        "defaults health=16:1000,embed=256:2000,"
                        "neighbors=64:5000")
    parser.add_argument("--per_replica_inflight", type=int, default=8,
                        help="max requests in flight per replica (the "
                        "per-replica bounded queue)")
    parser.add_argument("--probe_interval_s", type=float, default=2.0)
    parser.add_argument("--probe_timeout_s", type=float, default=60.0)
    parser.add_argument("--max_probe_failures", type=int, default=3,
                        help="consecutive missed health probes before a "
                        "replica is evicted and respawned")
    parser.add_argument("--boot_timeout_s", type=float, default=900.0,
                        help="per-replica load + warmup + readiness budget")
    parser.add_argument("--events_dir", default=None,
                        help="router event log (fleet manifest, spawn/"
                        "evict/swap events); replicas log under "
                        "<events_dir>/r<slot>")
    parser.add_argument("--trace_dir", default=None,
                        help="fleet-wide Chrome tracing: the router "
                        "writes its trace here and each replica writes "
                        "under <trace_dir>/r<slot>; every request is "
                        "stamped with a trace id at admission")
    parser.add_argument("--slo_objective", type=float, default=0.999,
                        help="per-class availability objective for "
                        "error-budget burn accounting (0.999 = 0.1%% "
                        "error budget over the rolling window)")
    parser.add_argument("--slo_window_s", type=float, default=60.0,
                        help="rolling error-budget window length")
    parser.add_argument("--result_cache_mb", type=float, default=0.0,
                        help="router-level content-addressed result cache "
                        "capacity in MB (0 = off): repeat requests for the "
                        "same canonical path-context bag are served from "
                        "router memory in O(1) — no queue budget, no "
                        "replica, no device call — with S3-FIFO eviction, "
                        "miss coalescing, and swap-versioned invalidation")
    parser.add_argument("--flight_threshold_ms", type=float, default=0.0,
                        help="capture a full per-request flight record "
                        "for any request slower than this (0 = p99 "
                        "sampling only)")
    # worker passthrough (same semantics as code2vec_tpu_torch.serve)
    parser.add_argument("--table_dtype", default=None,
                        choices=("f32", "bf16", "int8"))
    parser.add_argument("--batch_sizes", default="1,8")
    parser.add_argument("--deadline_ms", type=float, default=2.0,
                        help="per-worker micro-batcher coalescing window")
    parser.add_argument("--max_pending", type=int, default=256,
                        help="per-worker micro-batcher queue bound")
    parser.add_argument("--warmup_requests", type=int, default=64)
    parser.add_argument("--golden_min_recall", type=float, default=0.9)
    parser.add_argument("--pallas_impl", default="fused",
                        choices=("fused", "gather_split", "pool_only", "auto"))
    parser.add_argument("--autotune_cache", default="")
    parser.add_argument("--pallas_softmax", default="auto",
                        choices=("auto", "materialize", "online", "two_pass"))
    parser.add_argument("--longbag_widths", default="")
    parser.add_argument("--code_vec_path", default=None)
    parser.add_argument("--retrieval_backend", default="exact",
                        choices=("exact", "ann"))
    parser.add_argument("--ann_index_path", default=None)
    parser.add_argument("--ann_n_probe", type=int, default=None)
    parser.add_argument("--ann_shortlist", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="the workers' torch device (default cuda: a worker "
                        "without a GPU exits with an error; 'cpu' runs the plain "
                        "versions)")
    parser.add_argument("--sync_debug", action="store_true", default=False,
                        help="lock sanitizer on the router AND every "
                        "worker (the flag is forwarded down the replica "
                        "command line); equivalent to C2V_SYNC_DEBUG=1")
    parser.add_argument("--handle_debug", action="store_true", default=False,
                        help="handle ledger on the router AND every "
                        "worker (forwarded like --sync_debug): per-kind "
                        "open-handle gauges, per-replica handles health "
                        "blocks, open-handle counts on eviction events, "
                        "and a handle_leak shutdown report; equivalent "
                        "to C2V_HANDLE_DEBUG=1")
    return parser


def worker_argv(args, slot: int) -> list[str]:
    """The replica subprocess command line (one worker, stdio)."""
    argv = [
        sys.executable, "-m", "code2vec_tpu_torch.serve",
        "--transport", "stdio",
        "--model_path", args.model_path,
        "--terminal_idx_path", args.terminal_idx_path,
        "--path_idx_path", args.path_idx_path,
        "--batch_sizes", str(args.batch_sizes),
        "--deadline_ms", str(args.deadline_ms),
        "--max_pending", str(args.max_pending),
        "--warmup_requests", str(args.warmup_requests),
        "--golden_min_recall", str(args.golden_min_recall),
        "--retrieval_backend", args.retrieval_backend,
        "--pallas_impl", args.pallas_impl,
        "--pallas_softmax", args.pallas_softmax,
    ]
    if args.longbag_widths:
        argv += ["--longbag_widths", str(args.longbag_widths)]
    if args.autotune_cache:
        argv += ["--autotune_cache", args.autotune_cache]
    if args.table_dtype:
        argv += ["--table_dtype", args.table_dtype]
    if args.code_vec_path:
        argv += ["--code_vec_path", args.code_vec_path]
    if args.ann_index_path:
        argv += ["--ann_index_path", args.ann_index_path]
    if args.ann_n_probe is not None:
        argv += ["--ann_n_probe", str(args.ann_n_probe)]
    if args.ann_shortlist is not None:
        argv += ["--ann_shortlist", str(args.ann_shortlist)]
    if args.device:
        argv += ["--device", str(args.device)]
    if args.events_dir:
        argv += ["--events_dir", os.path.join(args.events_dir, f"r{slot}")]
    if getattr(args, "trace_dir", None):
        argv += ["--trace_dir", os.path.join(args.trace_dir, f"r{slot}")]
    threshold = getattr(args, "flight_threshold_ms", 0.0)
    if threshold:
        argv += ["--flight_threshold_ms", str(threshold)]
    if getattr(args, "sync_debug", False):
        argv += ["--sync_debug"]
    if getattr(args, "handle_debug", False):
        argv += ["--handle_debug"]
    return argv


def build_router(args):
    """Assemble the router (spawns + readies every replica); importable so
    tests can drive a real fleet without the transport loop."""
    from code2vec_tpu_torch.serve.fleet.replica import ReplicaHandle
    from code2vec_tpu_torch.serve.fleet.router import FleetRouter
    from code2vec_tpu_torch.serve.fleet.slo import parse_slo_spec

    # flip the sanitizer BEFORE the router/cache/SLO locks are built; the
    # replica subprocesses inherit the env AND get the explicit flag
    if getattr(args, "sync_debug", False):
        from code2vec_tpu_torch.obs.sync import SYNC_DEBUG_ENV

        os.environ[SYNC_DEBUG_ENV] = "1"
    # same ordering rule for the handle ledger: the env must be live before
    # the first lifecycle owner (event log, flight recorder, replicas)
    if getattr(args, "handle_debug", False):
        from code2vec_tpu_torch.obs.handles import HANDLE_DEBUG_ENV

        os.environ[HANDLE_DEBUG_ENV] = "1"

    events = None
    if args.events_dir:
        from code2vec_tpu_torch.obs.events import EventLog

        events = EventLog(args.events_dir)
        events.write_manifest(
            fleet={
                "replicas": args.replicas,
                "model_path": args.model_path,
                "transport": args.transport,
                "slo": args.slo or None,
                "per_replica_inflight": args.per_replica_inflight,
            }
        )
        from code2vec_tpu_torch.obs.sync import register_event_log, sync_debug_enabled

        if sync_debug_enabled():
            # router-side lock_order_violation events land in the fleet log
            register_event_log(events)
        from code2vec_tpu_torch.obs.handles import handle_debug_enabled
        from code2vec_tpu_torch.obs.handles import register_event_log as register_handle_log

        if handle_debug_enabled():
            # router-side handle_leak events land in the fleet log too
            register_handle_log(events)

    def factory(slot: int, incarnation: int) -> ReplicaHandle:
        return ReplicaHandle(
            slot, worker_argv(args, slot), incarnation=incarnation,
        )

    from code2vec_tpu_torch.obs.runtime import FlightRecorder, global_health

    threshold = getattr(args, "flight_threshold_ms", 0.0)
    flight = FlightRecorder(
        threshold_ms=threshold if threshold > 0 else None,
        events=events, health=global_health(),
    )
    cache = None
    cache_mb = getattr(args, "result_cache_mb", 0.0) or 0.0
    if cache_mb > 0:
        from code2vec_tpu_torch.serve.fleet.cache import ResultCache

        cache = ResultCache(
            int(cache_mb * 2**20), health=global_health()
        )
    router = FleetRouter(
        factory,
        args.replicas,
        slo=parse_slo_spec(args.slo),
        events=events,
        per_replica_inflight=args.per_replica_inflight,
        probe_interval_s=args.probe_interval_s,
        probe_timeout_s=args.probe_timeout_s,
        max_probe_failures=args.max_probe_failures,
        boot_timeout_s=args.boot_timeout_s,
        slo_objective=getattr(args, "slo_objective", 0.999),
        slo_window_s=getattr(args, "slo_window_s", 60.0),
        flight=flight,
        result_cache=cache,
    )
    return router, events


def main(argv: list[str] | None = None) -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s: %(message)s",
        datefmt="%m/%d/%Y %I:%M:%S %p",
    )
    args = build_parser().parse_args(argv)

    tracer = None
    if args.trace_dir:
        from code2vec_tpu_torch.obs.trace import Tracer, set_tracer

        # the router is torch-free: pin its trace pid/row explicitly instead
        # of letting export probe a backend that was never initialized
        tracer = Tracer(process_index=0, process_name="fleet-router")
        set_tracer(tracer)

    router, events = build_router(args)
    logger.info("fleet of %d replica(s) is ready", args.replicas)

    # same SIGTERM-draining transport loop as the single worker — a
    # client cannot tell a fleet from one process, shutdown included
    from code2vec_tpu_torch.serve.protocol import run_transport

    try:
        run_transport(router, args.transport, args.host, args.port)
    finally:
        if tracer is not None:
            from code2vec_tpu_torch.obs.trace import set_tracer

            set_tracer(None)
            try:
                tracer.export_dir(args.trace_dir)
            except Exception:
                logger.warning("could not write chrome trace", exc_info=True)
        if args.events_dir and router._flight is not None:
            try:
                router._flight.dump(os.path.join(args.events_dir, "flight"))
            except Exception:
                logger.warning("could not dump flight records", exc_info=True)
        from code2vec_tpu_torch.obs.handles import handle_debug_enabled, report_leaks

        if handle_debug_enabled():
            exclude = (events,) if events is not None else ()
            report_leaks("fleet.shutdown", events=events, exclude=exclude)
        if events is not None:
            try:
                events.close()
            except Exception:
                logger.warning("could not close event log", exc_info=True)


if __name__ == "__main__":
    main()
