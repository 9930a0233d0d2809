"""Transport-thin request handling: dict in, dict out.

Counterpart of ``code2vec_tpu/serve/protocol.py``. The protocol layer owns
everything between a parsed request object and a response object —
extraction, vocab mapping, batcher submission, softmax/top-k — and nothing
about bytes on a wire. Both transports are adapters over one
:class:`CodeServer`:

- **stdio-JSONL** (:func:`serve_stdio`): one JSON object per line in, one
  per line out, responses in request order; requests are submitted as
  they are read while responses resolve in order, so a pipelined client
  gets real micro-batch coalescing;
- **HTTP** (:func:`make_http_server`, :func:`serve_http`): stdlib
  ``ThreadingHTTPServer``; ``POST /`` (or ``/v1/<op>``) with a JSON body,
  ``GET /healthz`` (the health payload) and ``GET /metrics`` (Prometheus
  text); each concurrent POST blocks a handler thread on its future, so
  concurrency again becomes coalescing. Error kinds map to statuses by
  :attr:`CodeServer.HTTP_STATUS`.

:func:`run_transport` is the SIGTERM-draining loop both serve CLIs share
(this one's and the fleet router's): SIGTERM stops accepting, answers
every request already accepted, and the process exits 0.

Requests::

    {"op": "predict", "contexts": [[start, path, end], ...], "top_k": 5,
     "method_name": "*", "include_vector": false}
    {"op": "predict", "source": "class A { int f(int x) { ... } }", "language": "java"}
    {"op": "predict", "source": "def f(x):\\n    return x + 1\\n", "language": "python"}
    {"op": "embed",   "contexts": [[start, path, end], ...]}   (or "source")
    {"op": "embed_file", "source": "...", "language": "python"}   (or "contexts")
    {"op": "neighbors", "vector": [...], "top_k": 5}
    {"op": "neighbors", "contexts": [[start, path, end], ...], "top_k": 5}   (or "source")
    {"op": "neighbors", "source": "...", "granularity": "file", "top_k": 5}
    {"op": "health"}
    {"op": "reload", "model_path": "<dir>", "wait": false}   (hot-swap)
    {"op": "rollback"}
    {"op": "swap_status"}
    {"op": "flights"}
    {"op": "shutdown"}

The control ops drive live checkpoint hot-swap (``serve/swap.py``):
``reload`` builds and warms the target checkpoint on a background thread,
validates it against the golden request set and swaps the serving
pointer; ``rollback`` swaps back to the still-resident previous
generation; ``swap_status`` reports the state machine; ``flights``
returns the slow-request flight recorder's records. Every data request
snapshots its generation AT SUBMISSION, so in-flight requests drain
through the generation they were submitted to — a swap never drops them.

Responses echo an optional ``"id"`` and carry ``"error"`` +
``"error_kind"`` instead of results on failure. A ``source`` request (Java
or Python) is extracted and mapped into the training vocab on the request
thread, so the batcher only sees id arrays: one entry per matching method,
a method whose every context is OOV getting an entry with an ``error`` and
no device work, and the payload's ``extract_ms`` (extraction and mapping,
host work) apart from each entry's device timing. ``embed_file`` embeds
every method of the source through the batcher and pools the method
vectors on the host with the checkpoint's attention vector
(``models/hierarchical.pool_vectors``) into one ``file_vector``; a source
where no method embeds is a ``bad_request``. ``neighbors`` answers from
the generation's retrieval backend (``serve/retrieval.py``: exact or
IVF-PQ). Context triples are bounds-checked against the vocab tables
BEFORE they reach a kernel: an out-of-range id is the client's mistake,
never a device gather.

Every SLO-relevant op gets per-op metrics on the health registry
(``serve.op.<op>.e2e_ms``, ``serve.op.<op>.requests`` / ``.errors``: the
JAX names). This module imports no ``torch`` (what it needs of the model
side is imported when a request needs it), so the fleet router, which is
torch-free, uses its transports.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from typing import Callable

import numpy as np

from code2vec_tpu_torch.obs.handles import handles_snapshot
from code2vec_tpu_torch.obs.sync import sync_snapshot
from code2vec_tpu_torch.obs.trace import TraceContext, get_tracer, new_trace_id
from code2vec_tpu_torch.serve.batcher import ServeOverloaded, ServerClosed
from code2vec_tpu_torch.serve.swap import Generation, SwapController

logger = logging.getLogger(__name__)

__all__ = [
    "CodeServer",
    "make_http_server",
    "run_transport",
    "serve_http",
    "serve_stdio",
    "validate_context_rows",
]

# ops that get per-op obs metrics; unknown ops are excluded so garbage
# requests cannot grow the registry without bound
INSTRUMENTED_OPS = (
    "predict", "embed", "embed_file", "neighbors", "health",
    "reload", "rollback", "swap_status", "flights",
)


def validate_context_rows(rows, n_terminals: int, n_paths: int) -> list[tuple[int, int, int]]:
    """A pre-mapped ``"contexts"`` field: a non-empty list of integer
    ``[start, path, end]`` triples within the vocab tables."""
    if not isinstance(rows, (list, tuple)) or not rows:
        raise ValueError("'contexts' must be a non-empty list of [start, path, end] id triples")
    mapped = []
    for row in rows:
        if not isinstance(row, (list, tuple)) or len(row) != 3:
            raise ValueError(f"each context must be a [start, path, end] triple, got {row!r}")
        try:
            s, p, e = (int(v) for v in row)
        except (TypeError, ValueError):
            raise ValueError(f"context triple {row!r} is not integer-valued") from None
        if not (0 <= s < n_terminals and 0 <= p < n_paths and 0 <= e < n_terminals):
            raise ValueError(
                f"context triple {row!r} is outside the vocab tables "
                f"({n_terminals} terminals, {n_paths} paths)"
            )
        mapped.append((s, p, e))
    return mapped


class CodeServer:
    """The serving facade: extraction and mapping on the caller's thread,
    device work through the micro-batcher, postprocess on resolve.

    ``predictor``, ``engine``, ``batcher`` and ``retrieval`` live in one
    :class:`~code2vec_tpu_torch.serve.swap.Generation` behind a
    :class:`~code2vec_tpu_torch.serve.swap.SwapController`; ``factory`` (a
    ``build(target) -> Generation`` callable) plus ``golden`` enable the
    ``reload``/``rollback`` control ops. ``generation`` adopts a
    Generation the caller already built (the CLI's first one)."""

    def __init__(self, predictor, engine, batcher, retrieval=None, health=None, *,
                 version: str = "v0", factory=None, golden=None, events=None,
                 flight=None, generation=None, extractor_ms: float | None = None) -> None:
        from code2vec_tpu_torch.obs.runtime import global_health

        self.health = health or global_health()
        # the slow-request flight recorder the batchers feed (None: off)
        self.flight = flight
        self.extractor_ms = extractor_ms  # the warmup's build and load of the extractor
        if generation is None:
            generation = Generation(version=version, predictor=predictor, engine=engine,
                                    batcher=batcher, retrieval=retrieval)
        self.swap = SwapController(generation, build=factory, golden=golden,
                                   health=self.health, events=events)
        self._shutdown = threading.Event()

    # ---- the active generation (swap-aware accessors) -------------------
    # setters write into the CURRENT generation
    @property
    def predictor(self):
        return self.swap.active.predictor

    @predictor.setter
    def predictor(self, value) -> None:
        self.swap.active.predictor = value

    @property
    def engine(self):
        return self.swap.active.engine

    @engine.setter
    def engine(self, value) -> None:
        self.swap.active.engine = value

    @property
    def batcher(self):
        return self.swap.active.batcher

    @batcher.setter
    def batcher(self, value) -> None:
        self.swap.active.batcher = value

    @property
    def retrieval(self):
        return self.swap.active.retrieval

    @retrieval.setter
    def retrieval(self, value) -> None:
        self.swap.active.retrieval = value

    @property
    def version(self) -> str:
        return self.swap.active.version

    # ---- lifecycle ------------------------------------------------------
    @property
    def shutdown_requested(self) -> bool:
        return self._shutdown.is_set()

    def request_shutdown(self) -> None:
        """Mark the server as shutting down (the SIGTERM handler's hook:
        transports stop accepting, drain what was accepted, then exit)."""
        self._shutdown.set()

    def close(self) -> None:
        """Drain in-flight requests and stop every resident generation."""
        self.swap.close()
        if self.flight is not None:
            self.flight.close()

    # ---- request handling ----------------------------------------------
    def handle(self, request: dict) -> dict:
        """Submit and wait; resolve-time failures become error payloads."""
        resolver = self.handle_async(request)
        try:
            return resolver()
        except Exception as exc:  # noqa: BLE001 - protocol boundary
            return self._error_payload(exc)

    def handle_async(self, request: dict) -> Callable[[], dict]:
        """Submit any device work NOW; return a resolver that blocks for
        the results and builds the response."""
        req_id = request.get("id")

        def finish(payload: dict) -> dict:
            return {"id": req_id, **payload} if req_id is not None else payload

        op = request.get("op")
        # the request's trace context: the one the router (or a client)
        # stamped into "trace", or a new one while a tracer records
        trace = TraceContext.from_request(request)
        if trace is None and get_tracer().enabled and op in INSTRUMENTED_OPS:
            trace = TraceContext(trace_id=new_trace_id())
        try:
            # data requests snapshot the generation HERE: a swap that
            # commits between submission and resolve must not reroute an
            # in-flight request
            gen = self.swap.active
            if op == "health":
                resolver = self._health_payload  # the state when it resolves
            elif op == "shutdown":
                self._shutdown.set()
                payload = {"ok": True, "shutting_down": True}
                resolver = lambda: payload  # noqa: E731
            elif op in ("predict", "embed"):
                resolver = self._submit_methods(request, op, gen, trace)
            elif op == "embed_file":
                resolver = self._submit_file(request, gen, trace)
            elif op == "neighbors":
                resolver = self._submit_neighbors(request, gen, trace)
            elif op == "reload":
                status = self.swap.reload(request.get("model_path"),
                                          wait=bool(request.get("wait", False)))
                resolver = self._swap_resolver(status)
            elif op == "rollback":
                resolver = self._swap_resolver(self.swap.rollback())
            elif op == "swap_status":
                payload = {"ok": True, "swap": self.swap.status()}
                resolver = lambda: payload  # noqa: E731
            elif op == "flights":
                payload = self._flights_payload()
                resolver = lambda: payload  # noqa: E731
            else:
                payload = {"error": f"unknown op {op!r}", "error_kind": "bad_request"}
                resolver = lambda: payload  # noqa: E731
        except Exception as exc:  # noqa: BLE001 - protocol boundary
            payload = self._error_payload(exc)
            resolver = lambda: payload  # noqa: E731
        return self._instrument(op, resolver, finish, trace)

    def _instrument(self, op, resolver: Callable[[], dict], finish: Callable[[dict], dict],
                    trace: TraceContext | None = None) -> Callable[[], dict]:
        """Per-op metrics around the resolver: a latency histogram and
        request/error counters per SLO-relevant op, on the batcher's
        registry; with a trace context, the submit->resolve interval is a
        ``serve_request`` span tagged with the trace id."""
        if op not in INSTRUMENTED_OPS:
            return lambda: finish(resolver())
        t0 = time.perf_counter()
        self.health.counter(f"serve.op.{op}.requests").inc()

        def span_done(error: bool) -> None:
            tracer = get_tracer()
            if trace is not None and tracer.enabled:
                tracer.span_complete("serve_request", category="serve", start_s=t0,
                                     end_s=time.perf_counter(), trace_id=trace.trace_id,
                                     op=op, error=error)

        def run() -> dict:
            try:
                payload = resolver()
            except Exception:
                self.health.latency(f"serve.op.{op}.e2e_ms").record(
                    (time.perf_counter() - t0) * 1e3)
                self.health.counter(f"serve.op.{op}.errors").inc()
                span_done(error=True)
                raise
            self.health.latency(f"serve.op.{op}.e2e_ms").record((time.perf_counter() - t0) * 1e3)
            if "error" in payload:
                self.health.counter(f"serve.op.{op}.errors").inc()
            span_done(error="error" in payload)
            return finish(payload)

        return run

    @staticmethod
    def _swap_resolver(status: dict) -> Callable[[], dict]:
        # a swap still running (wait=false) is an accepted request; only an
        # idle state whose latest outcome is "failed" reports the error
        failed = (status.get("state") == "idle"
                  and (status.get("last_swap") or {}).get("outcome") == "failed")
        payload: dict = {"ok": not failed, "swap": status}
        if failed:
            payload["error"] = status["last_swap"].get("error", "swap failed")
            payload["error_kind"] = "swap_failed"
        return lambda: payload

    @staticmethod
    def _error_payload(exc: BaseException) -> dict:
        if isinstance(exc, ServeOverloaded):
            kind = "overloaded"
        elif isinstance(exc, ServerClosed):
            kind = "closed"
        elif isinstance(exc, (ValueError, KeyError, TypeError)):
            kind = "bad_request"
        else:
            kind = "internal"
            logger.exception("request failed")
        return {"error": f"{type(exc).__name__}: {exc}", "error_kind": kind}

    # transports map error kinds to HTTP statuses with this table; the
    # fleet router adds "deadline"/"unavailable" kinds of its own
    HTTP_STATUS = {
        None: 200,
        "bad_request": 400,
        "overloaded": 429,
        "deadline": 429,
        "closed": 503,
        "unavailable": 503,
        "swap_failed": 500,
        "internal": 500,
    }

    # ---- metrics --------------------------------------------------------
    def metrics_text(self) -> str:
        """Prometheus text exposition (0.0.4) of the health registry —
        what ``GET /metrics`` serves; touches no device state."""
        from code2vec_tpu_torch.obs.runtime import build_info_text, prometheus_text

        return build_info_text() + prometheus_text([({}, self.health.snapshot())])

    # ---- ops ------------------------------------------------------------
    def _flights_payload(self) -> dict:
        """The flight recorder's records, JSON-sanitized."""
        from code2vec_tpu_torch.obs.events import sanitize

        flight = self.flight
        if flight is None:
            return {"ok": True, "recorded": 0, "seen": 0, "flights": []}
        return {"ok": True, "recorded": flight.count, "seen": flight.seen,
                "threshold_ms": flight.threshold_ms,
                "flights": [sanitize(r) for r in flight.snapshot()]}

    def _health_payload(self) -> dict:
        from code2vec_tpu_torch.ops.backend import launch_counts

        gen = self.swap.active
        engine, config = gen.engine, gen.predictor.config
        return {
            "ok": True,
            "version": gen.version,
            "device": str(engine.device),
            "ladder": list(engine.active_ladder),
            "base_width": engine.base_width,
            "max_width": engine.max_width,
            "batch_sizes": list(engine.batch_sizes),
            "executables": engine.executables(),
            "post_warmup_compiles": engine.post_warmup_compiles,
            "extractor_ms": self.extractor_ms,
            "table_dtype": engine.table_dtype,
            "kernel_route": config.pallas_impl if config.use_pallas else "plain",
            "kernel_launches": launch_counts(),
            "retrieval": gen.retrieval.describe() if gen.retrieval is not None else None,
            "swap": self.swap.status(),
            "flight_recorded": self.flight.count if self.flight is not None else None,
            "perf": engine.perf_summary(),
            "sync": sync_snapshot(),
            "handles": handles_snapshot(),
            **self.health.snapshot(),
        }

    def _submit(self, batcher, arr: np.ndarray, trace: TraceContext | None):
        # the trace kwarg only with a context: duck-typed batchers keep
        # their one-argument submit
        return batcher.submit(arr, trace=trace) if trace is not None else batcher.submit(arr)

    def _submit_methods(self, request: dict, op: str, gen: Generation,
                        trace: TraceContext | None = None) -> Callable[[], dict]:
        from code2vec_tpu_torch.predict import softmax_top_k, subsample

        predictor, engine, batcher = gen.predictor, gen.engine, gen.batcher
        source = request.get("source")
        contexts_field = request.get("contexts")
        if contexts_field is None and (not isinstance(source, str) or not source.strip()):
            raise ValueError(f"{op!r} needs a non-empty 'source' string or a 'contexts' list "
                             "of [start, path, end] id triples")
        if op == "predict" and not predictor.meta.get("infer_method_name", True):
            raise ValueError(
                "this checkpoint was trained for the variable-name task only; "
                "'predict' is unavailable (embed and neighbors still work)"
            )
        method_name = request.get("method_name", "*")
        top_k = int(request.get("top_k", 5))
        include_vector = bool(request.get("include_vector", op == "embed"))
        # (label, n_oov, future or None, n_contexts): over-long bags take the
        # offline Predictor's seeded subsample
        submitted = []
        extract_ms = None
        if contexts_field is not None:
            mapped = validate_context_rows(
                contexts_field, int(predictor.meta["terminal_count"]),
                int(predictor.meta["path_count"]),
            )
            mapped = subsample(mapped, engine.max_width)
            label = (method_name if isinstance(method_name, str) and method_name != "*"
                     else "<contexts>")
            arr = np.asarray(mapped, np.int32).reshape(-1, 3)
            submitted.append((label, 0, self._submit(batcher, arr, trace), len(mapped)))
        else:
            language = request.get("language", "java")
            t0 = time.perf_counter()
            methods = []
            for label, contexts, _ in predictor._extract(source, method_name, language):
                mapped, n_oov = predictor._map_contexts(contexts)
                methods.append((label, subsample(mapped, engine.max_width), n_oov))
            extract_ms = (time.perf_counter() - t0) * 1e3
            for label, mapped, n_oov in methods:
                future = (self._submit(batcher, np.asarray(mapped, np.int32).reshape(-1, 3),
                                       trace) if mapped else None)
                submitted.append((label, n_oov, future, len(mapped)))
        label_vocab = predictor.label_vocab

        def resolve() -> dict:
            entries = []
            for label, n_oov, future, n_contexts in submitted:
                entry: dict = {"method_name": label, "n_contexts": n_contexts, "n_oov": n_oov}
                entries.append(entry)
                if future is None:
                    entry["error"] = "every context is OOV against the training vocab"
                    continue
                result = future.result()
                if op == "predict":
                    entry["predictions"] = [
                        {"name": label_vocab.itos[i], "prob": prob}
                        for i, prob in softmax_top_k(result.logits, len(label_vocab), top_k)
                    ]
                if include_vector:
                    entry["code_vector"] = [float(v) for v in result.code_vector]
                entry["timing"] = {
                    "queue_wait_ms": result.queue_wait_ms,
                    "device_ms": result.device_ms,
                    "coalesced": result.coalesced,
                    "batch": result.batch,
                    "width": result.width,
                }
            payload = {"ok": True, "methods": entries}
            if extract_ms is not None:
                payload["extract_ms"] = extract_ms
            return payload

        return resolve

    def _submit_file(self, request: dict, gen: Generation,
                     trace: TraceContext | None = None) -> Callable[[], dict]:
        """``embed_file``: every method of the request embedded through the
        batcher (as ``embed``), then the method vectors pooled on the host
        with the checkpoint's attention vector into one file vector."""
        embed_resolver = self._submit_methods({**request, "include_vector": True}, "embed",
                                              gen, trace)
        attn = gen.attention()  # read off the card once per generation

        def resolve() -> dict:
            from code2vec_tpu_torch.models.hierarchical import pool_vectors

            embedded = embed_resolver()
            names, vectors = [], []
            for entry in embedded["methods"]:
                if entry.get("code_vector") is not None:
                    names.append(entry["method_name"])
                    vectors.append(entry["code_vector"])
            if not vectors:
                return {"error": "no method in the source produced an embedding (nothing "
                                 "extracted, or every context is OOV against the training vocab)",
                        "error_kind": "bad_request"}
            file_vector = pool_vectors(np.asarray(vectors, np.float32), attn)
            payload = {"ok": True, "file_vector": [float(v) for v in file_vector],
                       "n_methods": len(vectors), "method_names": names}
            if "extract_ms" in embedded:
                payload["extract_ms"] = embedded["extract_ms"]
            return payload

        return resolve

    def _submit_neighbors(self, request: dict, gen: Generation,
                          trace: TraceContext | None = None) -> Callable[[], dict]:
        retrieval = gen.retrieval
        if retrieval is None:
            raise ValueError(
                "no retrieval index loaded: start the server with --code_vec_path "
                "(exact) or --retrieval_backend ann --ann_index_path"
            )
        top_k = int(request.get("top_k", 5))
        granularity = request.get("granularity", "method")
        if granularity not in ("method", "file"):
            raise ValueError(f"granularity must be 'method' or 'file', got {granularity!r}")
        trace_args = {"trace_id": trace.trace_id} if trace else {}

        def ranked(vec: np.ndarray) -> list[dict]:
            with get_tracer().span("serve_retrieval", category="serve", top_k=top_k,
                                   **trace_args):
                return [{"name": n, "similarity": s} for n, s in retrieval.top_k(vec, top_k)]

        vector = request.get("vector")
        if vector is not None:
            vec = np.asarray(vector, np.float32)
            if vec.shape != (retrieval.dim,):
                raise ValueError(f"'vector' must have dim {retrieval.dim}, got {vec.shape}")
            payload = {"ok": True, "neighbors": ranked(vec)}
            return lambda: payload
        # the client's include_vector decides whether the vector stays in
        want_vector = bool(request.get("include_vector", False))
        if granularity == "file":
            # pool the method vectors into one file vector, then retrieve
            file_resolver = self._submit_file(request, gen, trace)

            def resolve_file() -> dict:
                pooled = file_resolver()
                if "error" in pooled:
                    return pooled
                out = {"ok": True, "n_methods": pooled["n_methods"],
                       "neighbors": ranked(np.asarray(pooled["file_vector"], np.float32))}
                if want_vector:
                    out["file_vector"] = pooled["file_vector"]
                if "extract_ms" in pooled:
                    out["extract_ms"] = pooled["extract_ms"]
                return out

            return resolve_file
        # contexts and source forms: embed through the batcher, then retrieve
        embed_resolver = self._submit_methods({**request, "include_vector": True}, "embed",
                                              gen, trace)

        def resolve() -> dict:
            embedded = embed_resolver()
            for entry in embedded["methods"]:
                cv = entry.get("code_vector")
                if cv is not None:
                    entry["neighbors"] = ranked(np.asarray(cv, np.float32))
                if not want_vector:
                    entry.pop("code_vector", None)
            return embedded

        return resolve


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------


def serve_stdio(server, in_stream, out_stream, stop_event=None) -> None:
    """JSONL over a line-iterable / writable stream pair. Responses keep
    request order. With ``stop_event`` set (the SIGTERM path) the loop
    stops waiting for new requests but still resolves and writes every one
    already accepted before it returns (the drain fleet eviction relies
    on): the lines a client wrote before the signal are read and answered
    too, and the loop returns once the stream has been quiet for two polls
    (200 ms). A ``shutdown`` op stops the reading at once. ``server`` is
    anything with the CodeServer surface."""
    pending: queue.Queue = queue.Queue()
    eof = object()
    # set while the reader holds a line it has not enqueued a resolver for:
    # the drain must not call the stream empty while a read request (a
    # source request's extraction can take a while) is in its hands
    reader_busy = threading.Event()

    def reader() -> None:
        try:
            for line in in_stream:
                reader_busy.set()
                try:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        request = json.loads(line)
                        if not isinstance(request, dict):
                            raise ValueError("request must be a JSON object")
                    except ValueError as exc:
                        payload = {"error": f"bad request line: {exc}",
                                   "error_kind": "bad_request"}
                        pending.put(lambda payload=payload: payload)
                        continue
                    pending.put(server.handle_async(request))
                finally:
                    reader_busy.clear()
                # a shutdown op stops the reading; SIGTERM (stop_event)
                # lets the lines already written drain
                if server.shutdown_requested and not (stop_event is not None
                                                      and stop_event.is_set()):
                    break
        finally:
            pending.put(eof)

    thread = threading.Thread(target=reader, name="c2v-torch-stdin", daemon=True)
    thread.start()
    empty_strikes = 0
    try:
        while True:
            try:
                resolver = pending.get(timeout=0.1)
            except queue.Empty:
                if stop_event is not None and stop_event.is_set() and not reader_busy.is_set():
                    # the reader holds nothing and two polls in a row (200
                    # ms) found nothing: everything accepted was answered
                    empty_strikes += 1
                    if empty_strikes >= 2:
                        break
                continue
            empty_strikes = 0
            if resolver is eof:
                break
            try:
                response = resolver()
            except Exception as exc:  # noqa: BLE001 - keep serving
                response = CodeServer._error_payload(exc)
            out_stream.write(json.dumps(response) + "\n")
            out_stream.flush()
    finally:
        server.close()
        thread.join(timeout=5.0)


def make_http_server(server, host: str, port: int):
    """Build (not run) the stdlib threading HTTP server: ``POST /`` (or
    ``/v1/<op>``) with a JSON body; ``GET /healthz`` for the health
    payload; ``GET /metrics`` for the Prometheus text. Port 0 binds a free
    port (``httpd.server_address``)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _respond(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
            path = self.path.rstrip("/")
            if path in ("", "/healthz"):
                self._respond(200, server.handle({"op": "health"}))
            elif path == "/metrics":
                metrics_text = getattr(server, "metrics_text", None)
                if metrics_text is None:
                    self._respond(404, {"error": "no metrics exporter"})
                    return
                body = metrics_text().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._respond(404, {"error": "unknown path"})

        def do_POST(self):  # noqa: N802 - BaseHTTPRequestHandler API
            try:
                length = int(self.headers.get("Content-Length", 0))
                request = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(request, dict):
                    raise ValueError("request must be a JSON object")
                op = self.path.strip("/").split("/")[-1]
                if op and "op" not in request and op != "v1":
                    request["op"] = op
            except (ValueError, TypeError) as exc:
                self._respond(400, {"error": f"bad body: {exc}", "error_kind": "bad_request"})
                return
            response = server.handle(request)
            self._respond(CodeServer.HTTP_STATUS.get(response.get("error_kind"), 200), response)
            if server.shutdown_requested:
                threading.Thread(target=httpd.shutdown, daemon=True).start()

        def log_message(self, fmt, *args):  # quiet: obs carries the metrics
            logger.debug("http: " + fmt, *args)

    httpd = ThreadingHTTPServer((host, port), Handler)
    return httpd


def serve_http(server, host: str, port: int) -> None:
    """Run the HTTP transport until shutdown; drains the server on exit."""
    httpd = make_http_server(server, host, port)
    try:
        logger.info("serving HTTP on %s:%d", *httpd.server_address[:2])
        httpd.serve_forever(poll_interval=0.1)
    finally:
        server.close()
        httpd.server_close()


def run_transport(server, transport: str, host: str, port: int) -> None:
    """The SIGTERM-draining transport loop of the serve and fleet CLIs:
    SIGTERM stops ACCEPTING, answers everything already accepted (the
    stdio writer's drain, then the server's close, which drains every
    generation's batcher), and returns, so the process exits 0. ``server``
    is anything with the CodeServer surface (CodeServer, the router)."""
    import signal
    import sys

    stop_event = threading.Event()
    httpd_box: list = []

    def on_sigterm(signum, frame):  # noqa: ARG001 - signal API
        logger.info("SIGTERM: draining accepted requests, then exiting")
        stop_event.set()
        server.request_shutdown()
        for httpd in httpd_box:
            threading.Thread(target=httpd.shutdown, daemon=True).start()

    previous = signal.signal(signal.SIGTERM, on_sigterm)
    try:
        if transport == "stdio":
            serve_stdio(server, sys.stdin, sys.stdout, stop_event=stop_event)
        else:
            httpd = make_http_server(server, host, port)
            httpd_box.append(httpd)
            try:
                logger.info("serving HTTP on %s:%d", *httpd.server_address[:2])
                httpd.serve_forever(poll_interval=0.1)
            finally:
                server.close()
                httpd.server_close()
    finally:
        signal.signal(signal.SIGTERM, previous)
