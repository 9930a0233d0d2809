"""Continuous micro-batcher: coalesce concurrent requests into one forward.

Counterpart of ``code2vec_tpu/serve/batcher.py``: one background thread,
a bounded FIFO queue, explicit shutdown. The loop:

1. block until a request arrives;
2. coalesce more arrivals for at most ``deadline_ms`` (or until the
   engine's top micro-batch size fills) — under low load the deadline
   expires with a single request, which dispatches alone at batch 1;
3. pad the group to its nearest bucket width + micro-batch size
   (``ServingEngine.pad_requests``, so every group hits a warmed shape);
4. ONE forward; scatter rows back to per-request futures.

Batched and one-at-a-time execution are bitwise-equal per request on
every kernel route and on the CPU: every per-row step of the forward is
independent of the other rows — K2-K4 merge a row's softmax partials in
chunk order whatever the grid (``ops/fused_encode_pool.py``), K1's
cluster depends on the bag's length alone (``ops/pool_kernel.pool_ctas``),
the plain encode runs on the card in fixed-size slabs
(``models/code2vec.encode_matmul``) — and PAD lanes contribute exact
zeros. The plain route on the card (no kernels) pools with library
einsums and is not held to it.

Backpressure is explicit: the queue holds at most ``max_pending``
requests and :meth:`submit` raises :class:`ServeOverloaded` instead of
buffering unboundedly — the transport maps it to a retryable 429-class
error. Shutdown drains: queued and in-flight requests complete before
:meth:`close` returns; submissions after close raise
:class:`ServerClosed`.

Every phase is measured per request/group: ``serve_pad`` /
``serve_device`` / ``serve_postprocess`` spans on the tracer, latency
histograms on the health registry (``serve.queue_wait_ms``,
``serve.e2e_ms``, ``serve.pad_ms``, ``serve.device_ms``), the
``serve_requests`` / ``serve_batches`` / ``serve_coalesced`` /
``serve_rejected`` counters and a live ``serve_queue_depth`` gauge — the
JAX names, so the fleet router's shedding and one dashboard read both —
and each request's breakdown goes to the slow-request
:class:`~code2vec_tpu_torch.obs.runtime.FlightRecorder`.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from contextlib import nullcontext
from dataclasses import dataclass

import numpy as np

from code2vec_tpu_torch.obs.runtime import (
    FlightRecorder,
    RuntimeHealth,
    global_health,
)
from code2vec_tpu_torch.obs import handles
from code2vec_tpu_torch.obs.sync import make_lock
from code2vec_tpu_torch.obs.trace import TraceContext, get_tracer, trace_scope

__all__ = ["MicroBatcher", "ServeOverloaded", "ServerClosed", "ServeResult"]


class ServeOverloaded(RuntimeError):
    """The pending queue is full — shed load instead of buffering."""


class ServerClosed(RuntimeError):
    """submit() after close(): the server is shutting down."""


@dataclass
class ServeResult:
    """One request's slice of a device call, host-side."""

    logits: np.ndarray  # [label_count] f32
    code_vector: np.ndarray  # [encode_size] f32
    attention: np.ndarray  # [n_contexts] f32 (PAD lanes stripped)
    n_contexts: int
    batch: int  # the forward's micro-batch size
    width: int  # the forward's bucket width
    coalesced: int  # how many requests shared the forward
    queue_wait_ms: float
    device_ms: float  # the forward, host copies included


class _Pending:
    __slots__ = ("contexts", "future", "enqueued", "trace", "depth")

    def __init__(self, contexts: np.ndarray, trace=None):
        self.contexts = contexts
        self.future: Future = Future()
        self.enqueued = time.perf_counter()
        self.trace = trace  # TraceContext | None (cross-process tracing)
        self.depth = 0  # queue depth observed at admission


class MicroBatcher:
    """Bounded-queue request coalescer in front of a :class:`ServingEngine`.

    ``deadline_ms``: how long the first request of a group waits for
    company — the latency/efficiency dial (0 = dispatch immediately,
    strictly one request per device call). ``max_batch`` defaults to the
    engine's top micro-batch size; ``max_pending`` bounds queued (not yet
    dispatched) requests.
    """

    _POLL_S = 0.05  # close-check cadence while idle

    def __init__(
        self,
        engine,
        deadline_ms: float = 2.0,
        max_batch: int | None = None,
        max_pending: int = 256,
        health: RuntimeHealth | None = None,
        flight: FlightRecorder | None = None,
    ) -> None:
        if deadline_ms < 0:
            raise ValueError(f"deadline_ms must be >= 0, got {deadline_ms}")
        self._engine = engine
        self._deadline_s = float(deadline_ms) / 1e3
        # groups never exceed the top warmed micro-batch size — a larger
        # cap would force the engine onto an unwarmed shape
        top = max(engine.batch_sizes)
        self._max_batch = min(int(max_batch or top), top)
        if self._max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self._max_batch}")
        self._health = health or global_health()
        self._flight = flight
        self._queue: queue.Queue = queue.Queue(maxsize=int(max_pending))
        self._closed = threading.Event()
        # serializes submit's closed-check+enqueue against close's
        # flag-set: without it a submit could pass the check, lose the
        # CPU, and enqueue after close() already swept the queue —
        # leaving its future pending forever
        self._submit_lock = make_lock("batcher.submit")
        self._requests = self._health.counter("serve_requests")
        self._batches = self._health.counter("serve_batches")
        self._coalesced = self._health.counter("serve_coalesced")
        self._rejected = self._health.counter("serve_rejected")
        # live queue depth for the router's shedding decisions and
        # dashboards — same registry/schema as the shed counter and the
        # per-phase latency histograms (one obs schema, no ad-hoc state)
        self._depth = self._health.gauge("serve_queue_depth")
        self._depth.set(0)
        self._thread = threading.Thread(
            target=self._loop, name="c2v-torch-batcher", daemon=True
        )
        self._thread.start()
        handles.track(self, "batcher")

    # ---- caller side ----------------------------------------------------
    def submit(self, contexts, trace: TraceContext | None = None) -> Future:
        """Enqueue one request (an ``[n, 3]`` array of mapped
        (start, path, end) vocab ids); resolves to a :class:`ServeResult`.
        ``trace`` is the request's cross-process trace context: the
        coalesced device call's span records every member's trace id.
        Raises :class:`ServerClosed` after close, :class:`ServeOverloaded`
        when ``max_pending`` requests are already waiting."""
        pending = _Pending(
            np.asarray(contexts, np.int32).reshape(-1, 3), trace=trace
        )
        max_width = getattr(self._engine, "max_width", None)
        if max_width is not None and len(pending.contexts) > max_width:
            # reject loudly instead of silently truncating the bag: the
            # caller (the protocol layer, predict-style subsampling) owns
            # the decision of WHICH contexts to drop
            raise ValueError(
                f"request has {len(pending.contexts)} contexts, more than "
                f"the model's max bag width {max_width}; subsample before "
                "submitting"
            )
        with self._submit_lock:
            if self._closed.is_set():
                raise ServerClosed("micro-batcher is closed")
            # depth BEFORE this request joined: the flight recorder's
            # "what did the queue look like at admission" field
            pending.depth = self._queue.qsize()
            try:
                self._queue.put_nowait(pending)
            except queue.Full:
                self._rejected.inc()
                raise ServeOverloaded(
                    f"serving queue is full ({self._queue.maxsize} pending); "
                    "retry with backoff"
                ) from None
            self._depth.set(self._queue.qsize())
        self._requests.inc()
        return pending.future

    def close(self, timeout: float = 30.0) -> None:
        """Stop accepting requests, DRAIN everything already queued (every
        accepted future resolves), and join the thread. Idempotent."""
        with self._submit_lock:
            self._closed.set()
        self._thread.join(timeout)
        if self._thread.is_alive():  # pragma: no cover - hung device call
            raise TimeoutError("micro-batcher did not drain in time")
        # anything enqueued before the flag flipped but after the drain
        # loop's last empty poll — fail it loudly rather than leave its
        # future pending forever (the submit lock guarantees nothing can
        # enqueue after this sweep)
        while True:
            try:
                leftover = self._queue.get_nowait()
            except queue.Empty:
                break
            if not leftover.future.done():
                leftover.future.set_exception(
                    ServerClosed("micro-batcher closed before dispatch")
                )
        handles.untrack(self)

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()

    # ---- batcher thread -------------------------------------------------
    def _loop(self) -> None:
        while True:
            try:
                first = self._queue.get(timeout=self._POLL_S)
            except queue.Empty:
                if self._closed.is_set():
                    # closed observed: submit serializes its closed-check +
                    # enqueue against close's flag-set, so every ACCEPTED
                    # request is already visible in the queue — but an item
                    # can land in the gap between this poll's timeout
                    # expiring and the flag check. One final non-blocking
                    # drain before exiting, or that accepted request would
                    # be failed by close()'s sweep instead of served (the
                    # drop the fleet's SIGTERM-eviction path would hit).
                    try:
                        first = self._queue.get_nowait()
                    except queue.Empty:
                        return
                else:
                    continue
            self._depth.set(self._queue.qsize())
            group = [first]
            t_end = time.perf_counter() + self._deadline_s
            while len(group) < self._max_batch:
                if self._closed.is_set():
                    # draining: take whatever is already queued, never wait
                    try:
                        group.append(self._queue.get_nowait())
                        continue
                    except queue.Empty:
                        break
                remaining = t_end - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    group.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                self._run_group(group)
            except BaseException as exc:  # noqa: BLE001 - scattered to callers
                for pending in group:
                    if not pending.future.done():
                        pending.future.set_exception(exc)

    def _run_group(self, group: list[_Pending]) -> None:
        tracer = get_tracer()
        engine = self._engine
        t_start = time.perf_counter()
        # the coalesce-aware link: a batched device span records the N
        # trace ids it served, so a stitched trace can walk from any one
        # request's id into the shared device call (and see who else rode
        # it). Built only when someone traced — the untraced hot path
        # stays an empty-list comprehension.
        trace_ids = [p.trace.trace_id for p in group if p.trace is not None]
        span_trace = {"trace_ids": trace_ids} if trace_ids else {}
        observe = getattr(engine, "observe_width", None)  # duck-typed engines lack it
        if observe is not None:
            for pending in group:
                observe(len(pending.contexts))
        with tracer.span(
            "serve_pad", category="serve", requests=len(group), **span_trace
        ):
            t0 = time.perf_counter()
            starts, paths, ends, batch, width = engine.pad_requests(
                [p.contexts for p in group]
            )
            pad_ms = (time.perf_counter() - t0) * 1e3
        with tracer.span(
            "serve_device", category="serve",
            batch=batch, width=width, requests=len(group), **span_trace,
        ):
            t0 = time.perf_counter()
            # thread-local scope, not a signature change: the engine's own
            # device-call span picks the trace ids up without widening
            # run() (duck-typed engines keep their 3-arg surface)
            with trace_scope(**span_trace) if span_trace else nullcontext():
                logits, vectors, attention = engine.run(starts, paths, ends)
            # the engine returns host arrays: the device phase includes
            # the copies that fence it
            logits = np.asarray(logits)
            vectors = np.asarray(vectors)
            attention = np.asarray(attention)
            device_ms = (time.perf_counter() - t0) * 1e3
        # perf accounting rides the span we already timed — O(1) counter
        # math in the engine's accountant, guarded so duck-typed engines
        # without the hook keep working
        record_perf = getattr(engine, "record_device_time", None)
        if record_perf is not None:
            record_perf(batch, width, device_ms, requests=len(group))
        t_device_end = time.perf_counter()
        with tracer.span("serve_postprocess", category="serve", **span_trace):
            for i, pending in enumerate(group):
                n = int(pending.contexts.shape[0])
                queue_wait_ms = (t_start - pending.enqueued) * 1e3
                pending.future.set_result(
                    ServeResult(
                        logits=logits[i],
                        code_vector=vectors[i],
                        attention=attention[i, : min(n, width)],
                        n_contexts=n,
                        batch=batch,
                        width=width,
                        coalesced=len(group),
                        queue_wait_ms=round(queue_wait_ms, 3),
                        device_ms=round(device_ms, 3),
                    )
                )
                now = time.perf_counter()
                e2e_ms = (now - pending.enqueued) * 1e3
                self._health.latency("serve.queue_wait_ms").record(queue_wait_ms)
                self._health.latency("serve.e2e_ms").record(e2e_ms)
                if self._flight is not None:
                    # full span breakdown for the tail: the recorder
                    # decides (threshold / p99) whether to keep it
                    self._flight.observe(e2e_ms, {
                        "kind": "serve",
                        "trace_id": (
                            pending.trace.trace_id if pending.trace else None
                        ),
                        "n_contexts": n,
                        "queue_wait_ms": round(queue_wait_ms, 3),
                        "pad_ms": round(pad_ms, 3),
                        "device_ms": round(device_ms, 3),
                        "postprocess_ms": round(
                            (now - t_device_end) * 1e3, 3
                        ),
                        "batch": batch,
                        "width": width,
                        "coalesced": len(group),
                        "queue_depth_at_admission": pending.depth,
                    })
        self._health.latency("serve.pad_ms").record(pad_ms)
        self._health.latency("serve.device_ms").record(device_ms)
        self._batches.inc()
        if len(group) > 1:
            self._coalesced.inc(len(group))
