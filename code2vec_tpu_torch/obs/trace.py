"""Span tracing with Chrome ``trace_event`` export.

Counterpart of ``code2vec_tpu/obs/trace.py``. ``with tracer.span(
"serve_device", batch=8): ...`` records a complete ("X"-phase) event —
name, start, duration, process/thread track, args — into an in-memory
buffer; :meth:`Tracer.export_dir` writes the standard Chrome trace JSON
(``{"traceEvents": [...]}``), loadable in Perfetto or
``chrome://tracing``, one file per process (``trace-p<i>.json``) whose
events carry ``pid = process_index`` plus a ``process_name`` metadata
event, so merged traces keep one track per process.

Instrumented layers (the batcher, the engine, the server, the router)
fetch the process-wide tracer via :func:`get_tracer`; with no tracer
installed they get the :class:`NullTracer`, whose ``span`` returns a
shared ``nullcontext`` — cheap enough for per-request call sites.

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


class Tracer:
    """Collect spans; export once at end of run.

    ``process_index=None`` (the default) defers resolution to export time
    (the ``torch.distributed`` rank when a group is up, else 0).

    ``max_events`` bounds memory on long runs. Overflow is counted, not
    silent: the exported JSON carries ``dropped_events`` metadata.
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
        self._events: list[dict] = []
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
        self._t0 = time.perf_counter()
        # wall-clock anchor for the monotonic span clock: exported ts are
        # µs since the unix epoch, so per-host trace files land on one
        # shared time axis (aligned up to NTP skew) when merged
        self._wall_t0_us = time.time() * 1e6

    def _resolve_process_index(self) -> int:
        if self.process_index is None:
            from code2vec_tpu_torch.obs.events import resolve_process_index

            self.process_index = resolve_process_index()
        return int(self.process_index)

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    @contextlib.contextmanager
    def span(self, name: str, category: str = "run", **args):
        """Record the wrapped block as a complete trace event. Args are
        evaluated at entry (e.g. queue depth at enqueue time)."""
        ts = self._now_us()
        try:
            yield self
        finally:
            self._record(name, category, ts, self._now_us() - ts, args)

    def instant(self, name: str, category: str = "run", **args) -> None:
        """A zero-duration mark (Chrome "i" phase) — e.g. a recompile."""
        self._record(name, category, self._now_us(), None, args)

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
        ts = (start_s - self._t0) * 1e6
        self._record(
            name, category, ts, max((end_s - start_s) * 1e6, 0.0), args,
            track=track,
        )

    def _record(self, name, category, ts, dur, args, track=None) -> None:
        if track is not None:
            # synthetic per-track row: the key shape matches the thread
            # keys ((unique, display-name)) so naming metadata just works
            thread_key = (f"__track__{track}", track)
        else:
            thread_key = (
                threading.get_ident(), threading.current_thread().name
            )
        # pid is stamped at export (one tracer = one process) so recording
        # never has to resolve the process index
        event = {
            "name": name,
            "cat": category,
            "ph": "X" if dur is not None else "i",
            "ts": round(ts, 3),
        }
        if dur is not None:
            event["dur"] = round(dur, 3)
        else:
            event["s"] = "t"
        if args:
            event["args"] = sanitize(args)
        with self._lock:
            tid = self._tids.get(thread_key)
            if tid is None:
                tid = len(self._tids)
                self._tids[thread_key] = tid
            event["tid"] = tid
            if len(self._events) < self.max_events:
                self._events.append(event)
            else:
                self._dropped += 1

    # ---- export --------------------------------------------------------
    def chrome_trace(self) -> dict:
        """The full Chrome trace object: per-process / per-thread naming
        metadata first, then the recorded events in timestamp order."""
        pid = self._resolve_process_index()
        with self._lock:
            # epoch-anchored integer µs: whole-µs resolution is plenty (the
            # cross-host alignment bound is NTP skew), and it keeps the
            # offset exact in float64 JSON numbers
            events = [
                dict(e, pid=pid, ts=round(self._wall_t0_us + e["ts"]))
                for e in self._events
            ]
            thread_names = {tid: key[1] for key, tid in self._tids.items()}
            dropped = self._dropped
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
    _NULL = contextlib.nullcontext()

    def span(self, name: str, category: str = "run", **args):
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
