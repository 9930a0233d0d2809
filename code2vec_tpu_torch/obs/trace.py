"""Span tracing with Chrome ``trace_event`` export.

Counterpart of ``code2vec_tpu/obs/trace.py``. ``with tracer.span(
"serve_device", batch=8): ...`` records a complete ("X"-phase) event —
name, start, duration, process/thread track, args — into an in-memory
buffer; :meth:`Tracer.export_dir` writes the standard Chrome trace JSON
(``{"traceEvents": [...]}``), loadable in Perfetto or
``chrome://tracing``, one file per process (``trace-p<i>.json``) whose
events carry ``pid = process_index`` plus a ``process_name`` metadata
event, so merged traces keep one track per process.

Instrumented layers (the batcher, the engine, the server, the router,
the train step and device epochs) fetch the process-wide tracer via
:func:`get_tracer`; with no tracer installed they get the
:class:`NullTracer`, whose ``span`` returns a shared ``nullcontext`` —
cheap enough for per-request call sites.

**Device time.** ``tracer.span("forward", "train", device)`` on a CUDA
device also records a CUDA event at each edge on the current stream (from
a pool, never waited on): its ``device_ms`` is read once the work is done
(:meth:`Tracer.poll`, or at export), and ``drained`` says whether the card
had finished everything launched before it began. :meth:`Tracer.summary`
reads the spans of an interval back by name (count, host, self and device
ms, summed args); :meth:`Tracer.marks` names each instant by its innermost
span on the wall clock a profiler's trace is aligned to.

Thread-safe: spans may close concurrently on any thread; each thread gets
its own trace row (``tid``), named after ``threading.Thread.name`` via
``thread_name`` metadata events.

**Cross-process request tracing** (the fleet observability plane): a
:class:`TraceContext` rides an optional ``"trace"`` field in every serve
protocol request dict — the fleet router stamps one at admission (or
honors a client-supplied one, :func:`ensure_trace`), the replica pipe
forwards the dict verbatim, and the worker's resolver installs it so the
batcher-coalesce / engine-device-call / retrieval spans it triggers carry
the originating ``trace_id`` as a span arg. Per-request cost is O(1) dict
work — one 32-hex id, no locks, no allocation bursts. The per-process
trace files (already unix-epoch-anchored) then merge into one fleet-wide
view indexed by trace id — including the coalesce-aware link: a batched
device span records the N trace ids it served as ``trace_ids``.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import uuid
from dataclasses import dataclass

from code2vec_tpu_torch.obs.events import sanitize

__all__ = [
    "NullTracer",
    "TraceContext",
    "Tracer",
    "current_trace_scope",
    "ensure_trace",
    "get_tracer",
    "new_trace_id",
    "set_tracer",
    "trace_scope",
]


def new_trace_id() -> str:
    """A fresh 32-hex request trace id (uuid4; no coordination needed)."""
    return uuid.uuid4().hex


@dataclass
class TraceContext:
    """One request's trace identity as it crosses process boundaries.

    ``trace_id`` correlates every span the request touches — router
    admission, the replica worker's resolver, the micro-batcher's
    coalesced device call, retrieval — across separate trace files.
    ``parent_span_id`` names the span that forwarded the context (the
    router's request span), so a stitched trace can draw the handoff
    edge; it is optional and purely informational.
    """

    trace_id: str
    parent_span_id: str | None = None

    WIRE_KEY = "trace"

    @classmethod
    def from_request(cls, request: dict) -> "TraceContext | None":
        """Parse the optional ``"trace"`` field off a protocol request
        dict; malformed values are ignored (None), never fatal — a
        garbage trace field must not break serving."""
        raw = request.get(cls.WIRE_KEY)
        if not isinstance(raw, dict):
            return None
        trace_id = raw.get("trace_id")
        if not isinstance(trace_id, str) or not trace_id:
            return None
        parent = raw.get("parent_span_id")
        return cls(
            trace_id=trace_id[:64],
            parent_span_id=parent[:64] if isinstance(parent, str) else None,
        )

    def to_wire(self) -> dict:
        wire = {"trace_id": self.trace_id}
        if self.parent_span_id:
            wire["parent_span_id"] = self.parent_span_id
        return wire


def ensure_trace(request: dict, parent_span_id: str | None = None) -> TraceContext:
    """The admission hook: honor a client-supplied trace context or stamp
    a fresh one INTO ``request`` (the same dict then crosses the replica
    pipe, so downstream processes see the id without any extra wiring).
    O(1) per request."""
    ctx = TraceContext.from_request(request)
    if ctx is None:
        ctx = TraceContext(
            trace_id=new_trace_id(), parent_span_id=parent_span_id
        )
        request[TraceContext.WIRE_KEY] = ctx.to_wire()
    return ctx


# thread-local span tags: lets a caller scope trace ids over a callee's
# spans WITHOUT widening the callee's signature (the batcher wraps the
# engine's device call; duck-typed fake engines in tests keep their
# 3-arg run()). The batcher thread calls the engine synchronously, so
# thread-locality is exactly the right propagation boundary.
_scope = threading.local()


@contextlib.contextmanager
def trace_scope(**tags):
    """Attach ``tags`` (e.g. ``trace_ids=[...]``) to every span the
    wrapped block records via :func:`current_trace_scope` readers."""
    previous = getattr(_scope, "tags", None)
    _scope.tags = {**(previous or {}), **tags}
    try:
        yield
    finally:
        _scope.tags = previous


def current_trace_scope() -> dict:
    """The active :func:`trace_scope` tags for this thread ({} outside)."""
    tags = getattr(_scope, "tags", None)
    return dict(tags) if tags else {}


class _Span:
    """One span: the context manager :meth:`Tracer.span` hands out while
    the block runs, and the record the tracer keeps once it has closed.
    Times are ``time.perf_counter_ns()``; ``child`` is the time of the
    spans nested in it on its thread, so ``end - start - child`` is its
    self time. ``args`` may be added to until the span closes."""

    __slots__ = ("tracer", "name", "cat", "args", "device", "start", "end", "child",
                 "edges", "device_ms", "tid")

    def __init__(self, tracer, name, cat, args, device=None):
        self.tracer, self.name, self.cat, self.args = tracer, name, cat, args
        self.device = device
        self.start = self.end = None
        self.child = 0
        self.edges = None  # [entry event, exit event] until they are read
        self.device_ms = None
        self.tid = None

    def __enter__(self):
        self.tracer._open(self)
        return self

    def __exit__(self, *exc):
        self.tracer._close(self)
        return False


def _self_pieces(spans: list) -> list:
    """``[(start, end, name)]``: the intervals of one thread's nested spans
    cut so that each instant belongs to the innermost span that holds it
    (a parent's pieces are the time none of its children covers)."""
    out = []
    stack = []  # [span, where its uncovered time resumes]

    def close(top):
        span, at = top
        if span.end > at:
            out.append((at, span.end, span.name))
        if stack:
            stack[-1][1] = max(stack[-1][1], span.end)

    for span in sorted(spans, key=lambda s: (s.start, -s.end)):
        while stack and stack[-1][0].end <= span.start:
            close(stack.pop())
        if stack and span.start > stack[-1][1]:
            out.append((stack[-1][1], span.start, stack[-1][0].name))
        stack.append([span, span.start])
    while stack:
        close(stack.pop())
    return sorted(out)


class Tracer:
    """Collect spans; export once at end of run.

    ``process_index=None`` (the default) defers resolution to export time
    (the ``torch.distributed`` rank when a group is up, else 0).

    ``max_events`` bounds memory on long runs. Overflow is counted, not
    silent: the exported JSON carries ``dropped_events`` metadata.

    Spans are kept in nanoseconds of ``time.perf_counter_ns()``, anchored
    once to ``time.time_ns()`` (:meth:`wall_ns`); the export writes epoch
    microseconds. A span given ``edges`` (the device its block's work runs
    on) records, on a CUDA device, a timing event on the current stream at
    entry and at exit, taken from a pool; nothing waits for them.
    :meth:`poll` reads the pairs whose work is done (``device_ms``, the
    stream's time between the two) and returns their events to the pool;
    the export and :meth:`summary` wait for the rest. At entry an edged
    span also records ``drained``: whether the last edge recorded on each
    stream before it had completed, that is whether the card had run out of
    work the host had launched (:attr:`drained_edges` counts them). Edged
    spans are recorded from one thread. Their args may hold a 0-d device
    tensor: it is copied to pinned host memory before the exit edge and
    read when the span is polled. Once ``max_events`` spans are kept a span
    records no edges, and an edged span dropped at its close hands its
    events back to the pool.
    """

    enabled = True

    def __init__(
        self,
        process_index: int | None = None,
        process_name: str | None = None,
        max_events: int = 1_000_000,
    ):
        self.process_index = process_index
        self.process_name = process_name
        self.max_events = int(max_events)
        self._spans: list[_Span] = []
        # (os thread ident, thread name) -> synthetic trace tid. CPython
        # reuses idents as soon as a thread dies — and the prefetcher
        # spawns a fresh producer per epoch — so the raw ident would let a
        # later thread inherit a dead stranger's track label; keying by
        # (ident, name) gives every distinctly-named occupant its own row
        self._tids: dict[tuple[int, str], int] = {}
        self._dropped = 0
        # plain on purpose: hottest leaf lock in the process (every span);
        # never held across another acquire, so tracing it buys nothing
        self._lock = threading.Lock()
        self._local = threading.local()  # each thread's open spans
        self._t0_ns = time.perf_counter_ns()
        # wall-clock anchor for the monotonic span clock: exported ts are
        # µs since the unix epoch, so per-host trace files land on one
        # shared time axis (aligned up to NTP skew) when merged
        self._wall_t0_ns = time.time_ns()
        self._pool: list = []  # timing events free to record
        self._pending: list[_Span] = []  # closed edged spans not read yet
        self._last: dict = {}  # stream -> its last edge not known complete
        self.drained_edges = 0

    def _resolve_process_index(self) -> int:
        if self.process_index is None:
            from code2vec_tpu_torch.obs.events import resolve_process_index

            self.process_index = resolve_process_index()
        return int(self.process_index)

    def wall_ns(self, t_ns: int) -> int:
        """A span time (``perf_counter_ns``) on the ``time.time_ns()`` clock."""
        return t_ns - self._t0_ns + self._wall_t0_ns

    def span(self, name: str, category: str = "run", edges=None, **args) -> _Span:
        """Record the wrapped block as a complete trace event. Args are
        evaluated at entry (e.g. queue depth at enqueue time); ``with ...
        as span`` may add to ``span.args`` before the block ends.
        ``edges``: the block's device (timed on a CUDA device)."""
        return _Span(self, name, category, args, edges)

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _open(self, span: _Span) -> None:
        span.start = time.perf_counter_ns()
        if span.device is not None and span.device.type == "cuda" and not self._full():
            self._edge_in(span)
        self._stack().append(span)

    def _close(self, span: _Span) -> None:
        if span.edges is not None:
            if self._full():
                self._release(span)
            else:
                self._edge_out(span)
        span.end = time.perf_counter_ns()
        stack = self._stack()
        if stack and stack[-1] is span:
            stack.pop()
        elif span in stack:
            stack.remove(span)
        if stack:
            stack[-1].child += span.end - span.start
        self._keep(span)

    def _full(self) -> bool:
        return len(self._spans) >= self.max_events

    def _release(self, span: _Span) -> None:
        """Hand a dropped span's edges back to the pool, unread."""
        self._pool += [e for e in span.edges if e is not None]
        span.edges = None

    def _event(self):
        import torch

        return self._pool.pop() if self._pool else torch.cuda.Event(enable_timing=True)

    def _edge_in(self, span: _Span) -> None:
        import torch

        if self._last:
            waiting = {s: e for s, e in self._last.items() if not e.query()}
            span.args["drained"] = not waiting
            self.drained_edges += not waiting
            self._last = waiting
        stream = torch.cuda.current_stream(span.device)
        event = self._event()
        event.record(stream)
        span.edges = [event, None]
        self._last[stream] = event

    def _edge_out(self, span: _Span) -> None:
        import torch

        for key, value in span.args.items():
            if isinstance(value, torch.Tensor) and value.is_cuda:
                host = torch.empty(value.shape, dtype=value.dtype, pin_memory=True)
                span.args[key] = host.copy_(value, non_blocking=True)
        stream = torch.cuda.current_stream(span.device)
        event = self._event()
        event.record(stream)
        span.edges[1] = event
        self._last[stream] = event

    def poll(self, wait: bool = False) -> None:
        """Read the closed edged spans whose exit edges have completed, in
        the order they closed, up to the first that has not (a ``query()``
        each: no wait); ``wait`` synchronises on each instead (after the
        caller's own sync, as at export)."""
        with self._lock:
            pending, self._pending = self._pending, []
        done = 0
        for span in pending:
            start, end = span.edges
            if wait:
                end.synchronize()
                start.synchronize()
            elif not (end.query() and start.query()):
                break
            span.device_ms = start.elapsed_time(end)
            span.args = sanitize(span.args)
            span.edges = None
            self._pool += (start, end)
            done += 1
        with self._lock:
            self._pending = pending[done:] + self._pending

    def instant(self, name: str, category: str = "run", **args) -> None:
        """A zero-duration mark (Chrome "i" phase) — e.g. a recompile."""
        span = _Span(self, name, category, args)
        span.start = time.perf_counter_ns()
        self._keep(span)

    def span_complete(
        self,
        name: str,
        category: str = "run",
        start_s: float = 0.0,
        end_s: float = 0.0,
        track: str | None = None,
        **args,
    ) -> None:
        """Record a span measured OUTSIDE this thread — e.g. inside a feed
        worker process. ``start_s``/``end_s`` are ``time.perf_counter()``
        stamps (CLOCK_MONOTONIC is system-wide on Linux, so a forked
        child's stamps share this process's span clock). ``track`` names
        the trace row the span lands on (its own tid, e.g.
        ``feed-worker-3``) instead of the recording thread's."""
        span = _Span(self, name, category, args)
        span.start = round(start_s * 1e9)
        span.end = span.start + max(round((end_s - start_s) * 1e9), 0)
        # synthetic per-track row: the key shape matches the thread keys
        # ((unique, display-name)) so naming metadata just works
        self._keep(span, None if track is None else (f"__track__{track}", track))

    def _keep(self, span: _Span, thread_key=None) -> None:
        if thread_key is None:
            thread_key = (threading.get_ident(), threading.current_thread().name)
        if span.edges is None and span.args and not self._full():
            span.args = sanitize(span.args)
        with self._lock:
            tid = self._tids.get(thread_key)
            if tid is None:
                tid = len(self._tids)
                self._tids[thread_key] = tid
            span.tid = tid
            kept = not self._full()
            if kept:
                self._spans.append(span)
                if span.edges is not None:
                    self._pending.append(span)
            else:
                self._dropped += 1
        if not kept and span.edges is not None:
            self._release(span)

    # ---- read-out ------------------------------------------------------
    def _closed(self, start_ns: int | None, end_ns: int | None,
                overlap: bool = False) -> list[_Span]:
        """The closed spans within ``[start_ns, end_ns]`` (``overlap``: that
        overlap it)."""
        with self._lock:
            spans = list(self._spans)
        lo = -1 if start_ns is None else start_ns
        hi = float("inf") if end_ns is None else end_ns
        if overlap:
            return [s for s in spans if s.end is not None and s.end >= lo and s.start <= hi]
        return [s for s in spans if s.end is not None and s.start >= lo and s.end <= hi]

    def summary(self, start_ns: int | None = None, end_ns: int | None = None) -> dict:
        """``{name: {"count", "host_ms", "self_ms", "device_ms",
        "device_count", "args"}}`` of the spans that ran within ``[start_ns,
        end_ns]`` (``perf_counter_ns``; None leaves that side open).
        ``self_ms`` is ``host_ms`` less the spans nested in them on their
        thread; ``device_ms`` sums the ``device_count`` spans whose edges
        were read, after waiting for them (:meth:`poll`); ``args`` sums
        each numeric arg (``drained``: the spans that found the card
        drained)."""
        self.poll(wait=True)
        out: dict = {}
        for s in self._closed(start_ns, end_ns):
            row = out.get(s.name)
            if row is None:
                row = out[s.name] = {"count": 0, "host_ms": 0.0, "self_ms": 0.0,
                                     "device_ms": 0.0, "device_count": 0, "args": {}}
            row["count"] += 1
            row["host_ms"] += (s.end - s.start) / 1e6
            row["self_ms"] += (s.end - s.start - s.child) / 1e6
            if s.device_ms is not None:
                row["device_ms"] += s.device_ms
                row["device_count"] += 1
            for key, value in s.args.items():
                if isinstance(value, (int, float)):
                    row["args"][key] = row["args"].get(key, 0) + value
        return out

    def marks(self, start_ns: int | None = None, end_ns: int | None = None) -> list:
        """``[(start, end, name)]`` on the ``time.time_ns()`` clock: each
        thread's spans that overlap ``[start_ns, end_ns]``
        (``perf_counter_ns``), cut so that each instant is named by the
        innermost span that holds it (its self time), for a profiler that
        names what the host was doing."""
        by_tid: dict = {}
        for s in self._closed(start_ns, end_ns, overlap=True):
            by_tid.setdefault(s.tid, []).append(s)
        return [(self.wall_ns(a), self.wall_ns(b), name)
                for spans in by_tid.values() for a, b, name in _self_pieces(spans)]

    # ---- export --------------------------------------------------------
    def _chrome_event(self, s: _Span, pid: int) -> dict:
        event = {
            "name": s.name,
            "cat": s.cat,
            "ph": "X" if s.end is not None else "i",
            # epoch-anchored integer µs: whole-µs resolution is plenty (the
            # cross-host alignment bound is NTP skew), and it keeps the
            # offset exact in float64 JSON numbers
            "ts": (self.wall_ns(s.start) + 500) // 1000,
        }
        if s.end is not None:
            event["dur"] = round((s.end - s.start) / 1e3, 3)
        else:
            event["s"] = "t"
        args = s.args if s.edges is None else {}
        if s.device_ms is not None:
            args = {**args, "device_ms": round(s.device_ms, 6)}
        if args:
            event["args"] = args
        event["tid"] = s.tid
        event["pid"] = pid
        return event

    def chrome_trace(self) -> dict:
        """The full Chrome trace object: per-process / per-thread naming
        metadata first, then the recorded events in timestamp order (the
        device edges read first, waiting for any still in flight)."""
        self.poll(wait=True)
        pid = self._resolve_process_index()
        with self._lock:
            spans = list(self._spans)
            thread_names = {tid: key[1] for key, tid in self._tids.items()}
            dropped = self._dropped
        events = [self._chrome_event(s, pid) for s in spans]
        events.sort(key=lambda e: e["ts"])
        meta = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "args": {"name": self.process_name or f"process {pid}"},
            }
        ]
        for tid, tname in thread_names.items():
            meta.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": pid,
                    "tid": tid,
                    "args": {"name": tname},
                }
            )
        trace = {"traceEvents": meta + events, "displayTimeUnit": "ms"}
        if dropped:
            trace["dropped_events"] = dropped
        return trace

    def export(self, path: str) -> str:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.chrome_trace(), f)
        return path

    def export_dir(self, trace_dir: str) -> str:
        """Write ``<trace_dir>/trace-p<process_index>.json`` (one file per
        process on multi-host runs)."""
        os.makedirs(trace_dir, exist_ok=True)
        return self.export(
            os.path.join(
                trace_dir, f"trace-p{self._resolve_process_index()}.json"
            )
        )


class NullTracer:
    """The no-tracing default: ``span`` hands back one shared reusable
    ``nullcontext`` — per-batch call sites pay a method call, nothing
    else."""

    enabled = False
    drained_edges = 0
    _NULL = contextlib.nullcontext()

    def poll(self, wait: bool = False) -> None:
        return None

    def span(self, name: str, category: str = "run", edges=None, **args):
        return self._NULL

    def instant(self, name: str, category: str = "run", **args) -> None:
        return None

    def span_complete(
        self,
        name: str,
        category: str = "run",
        start_s: float = 0.0,
        end_s: float = 0.0,
        track: str | None = None,
        **args,
    ) -> None:
        return None


NULL_TRACER = NullTracer()
_current: Tracer | NullTracer = NULL_TRACER


def get_tracer() -> Tracer | NullTracer:
    """The process-wide tracer (NullTracer unless :func:`set_tracer` ran)."""
    return _current


def set_tracer(tracer: Tracer | NullTracer | None):
    """Install ``tracer`` (None restores the NullTracer); returns the
    previous tracer so tests/tools can restore it."""
    global _current
    previous = _current
    _current = tracer if tracer is not None else NULL_TRACER
    return previous
