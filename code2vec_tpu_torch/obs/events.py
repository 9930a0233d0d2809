"""Structured event log: one JSONL file per process.

Counterpart of ``code2vec_tpu/obs/events.py``. The log opens with a **run
manifest** (run id, process index/count, package version, and the
training run's config, corpus, costs and device blocks, or the server's or
fleet's topology block) and then carries
typed events with monotonic timestamps. Schema of every line::

    {"event": <type>, "seq": N, "t_ms": <monotonic ms since log open>,
     "unix_time": <wall clock>, ...event fields...}

``seq`` is strictly increasing per process — emitters on other threads
serialize through one lock, so the file order IS the emission order.

Event types written by the train loop (``train/loop.py``): ``manifest``,
``epoch`` (the full per-epoch metrics dict, a memory snapshot and the
health counters), ``best_f1``, ``step_sample`` (per profiled step: host
build / H2D / feed wait / compute ms and ``mfu``), ``eval``,
``checkpoint_saved`` (slot, path, step, whether the persist ran async),
``checkpoint_restored``, ``preempted`` (a clean SIGTERM exit),
``recompile`` (obs.runtime.RecompileDetector) and ``error``; the search
(``hpo.py``) adds ``trial`` and ``trial_result``.

The serving side (``serve/``) writes ``serve_executable`` (one per warmed
shape, with the model version), the hot-swap state machine's
``swap_started`` / ``swap_committed`` / ``swap_failed`` / ``rollback`` /
``generation_retired`` (``serve/swap.py`` — build/validate timings and the
golden-validation report ride the commit event), and the fleet router's
``fleet_replica_spawned`` / ``fleet_replica_evicted`` /
``fleet_swap_started`` / ``fleet_swap_committed`` / ``fleet_swap_failed``
/ ``fleet_rollback`` (``serve/fleet/router.py``). Also:

- ``flight`` (obs.runtime.FlightRecorder) — one slow/tail request's full
  span breakdown: ``flight_seq``, ``e2e_ms``, ``trace_id``, and per-kind
  fields (worker ``kind: "serve"``: queue_wait/pad/device/postprocess ms,
  batch/width/coalesced, queue_depth_at_admission; router ``kind:
  "router"``: op, slo_class, outcome, dispatch_wait_ms, replica_slot,
  attempts, queue_depth_at_admission). The same records dump as
  ``flight_<seq>.json`` files at process exit.
- ``slo_budget_exhausted`` (serve/fleet/slo.SloBurnTracker) —
  edge-triggered once per exhaustion episode.
- ``lock_order_violation`` (obs.sync, under ``C2V_SYNC_DEBUG``) and
  ``handle_leak`` (obs.handles, under ``C2V_HANDLE_DEBUG``).

**Sinks are consumers of this stream**: :func:`sink_consumer` adapts the
``(epoch, metrics)`` metric sinks (``code2vec_tpu_torch.sinks``) into an
event consumer, and the train loop emits metrics only as events, so the
sinks' output and the event log derive from one dict. The file gets the
strict-JSON form of each event: non-finite floats serialize as ``null``
plus a sibling ``<key>_raw`` string; consumers (:meth:`EventLog.subscribe`)
receive the raw record (see :func:`metric_record` for the per-metric line
the sinks print).
"""

from __future__ import annotations

import json
import math
import os
import sys
import threading
import time
import uuid
from typing import Callable

from code2vec_tpu_torch.obs import handles

__all__ = ["EventLog", "metric_record", "run_manifest", "sanitize", "sink_consumer"]


def resolve_process_index() -> int:
    """This process's rank in its ``torch.distributed`` group when one is
    up, else 0. Shared by the event-log filename, the tracer's pid track
    and the manifest, so the three can never disagree. Never imports torch
    itself: a torch-free process (the fleet router) is process 0."""
    dist = sys.modules.get("torch.distributed")
    try:
        if dist is not None and dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:  # pragma: no cover - a half-torn-down group
        pass
    return 0


def _process_count() -> int:
    dist = sys.modules.get("torch.distributed")
    try:
        if dist is not None and dist.is_available() and dist.is_initialized():
            return int(dist.get_world_size())
    except Exception:  # pragma: no cover - a half-torn-down group
        pass
    return 1


def _scalar(value):
    """Unwrap numpy scalars (``np.float32`` etc.) to Python scalars; pass
    everything else through."""
    if hasattr(value, "item") and not isinstance(
        value, (str, bytes, dict, list, tuple)
    ):
        try:
            return value.item()
        except (TypeError, ValueError):
            return value
    return value


def sanitize(obj):
    """Recursively convert ``obj`` into strict-JSON values.

    ``json.dumps`` happily prints bare ``NaN``/``Infinity`` — tokens the
    JSON grammar does not have, which strict parsers reject. Non-finite
    floats become ``null``; inside dicts a sibling ``<key>_raw`` string
    (``"nan"`` / ``"inf"`` / ``"-inf"``) preserves the original value.
    Unknown objects fall back to ``str``.
    """
    if isinstance(obj, dict):
        out = {}
        for key, value in obj.items():
            key = str(key)
            value = _scalar(value)
            if isinstance(value, float) and not math.isfinite(value):
                out[key] = None
                out[key + "_raw"] = repr(value)
            else:
                out[key] = sanitize(value)
        return out
    if isinstance(obj, (list, tuple)):
        return [sanitize(v) for v in obj]
    obj = _scalar(obj)
    if obj is None or isinstance(obj, (str, int, bool)):
        return obj
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    return str(obj)


def metric_record(name: str, value) -> dict:
    """The ``{"metric": name, "value": value}`` line the floyd and logging
    sinks print, strict JSON: a non-finite value serializes as ``null``
    with the original in a string ``"raw"`` field."""
    value = _scalar(value)
    record = {"metric": name, "value": value}
    if isinstance(value, float) and not math.isfinite(value):
        record["value"] = None
        record["raw"] = repr(value)
    return record


def _run_id() -> str:
    """``C2V_RUN_ID`` when set, else a timestamped random id."""
    pinned = os.environ.get("C2V_RUN_ID")
    if pinned:
        return pinned
    return f"{time.strftime('%Y%m%d-%H%M%S')}-{uuid.uuid4().hex[:8]}"


def run_manifest(config=None, **extra) -> dict:
    """The run manifest: package version, process identity, run id, and
    the caller's blocks (``serve={...}`` or ``fleet={...}``). A training
    run's manifest (``config`` given) also carries the config as a plain
    dict and ``mesh_shape`` (None: the port runs one device a process);
    the loop adds its corpus, costs and device blocks."""
    import dataclasses

    import code2vec_tpu_torch

    manifest = {
        "package": "code2vec-tpu-torch",
        "package_version": code2vec_tpu_torch.__version__,
        "started_unix": time.time(),
        "process_index": resolve_process_index(),
        "process_count": _process_count(),
        "run_id": _run_id(),
    }
    if config is not None:
        manifest["mesh_shape"] = None
        manifest["config"] = (dataclasses.asdict(config) if dataclasses.is_dataclass(config)
                              else dict(config))
    manifest.update(extra)
    return manifest


class EventLog:
    """Thread-safe JSONL event log + in-process event dispatcher.

    ``events_dir=None`` builds a dispatch-only log (no file, consumers
    only). The file opens lazily on the first emit, in APPEND mode: a
    restarted server extends the previous run's log — its new manifest
    line marks the new segment — instead of truncating it.
    """

    def __init__(
        self,
        events_dir: str | None = None,
        process_index: int | None = None,
        run_id: str | None = None,
    ):
        self.process_index = process_index
        self.run_id = run_id
        self.path: str | None = None
        self._events_dir = events_dir
        self._file = None
        self._closed = False
        # RLock: a consumer may emit follow-up events from inside dispatch.
        # Plain on purpose: the sanitizer reports violations THROUGH event
        # logs, so a traced lock here would re-enter the reporter
        self._lock = threading.RLock()
        self._consumers: list[Callable[[dict], None]] = []
        self._seq = 0
        self._t0 = time.monotonic()
        self._manifest_written = False

    def _ensure_open(self):
        """Open the per-process JSONL on first use (append mode)."""
        if self._events_dir is None or self._closed or self._file is not None:
            return self._file
        if self.process_index is None:
            self.process_index = resolve_process_index()
        os.makedirs(self._events_dir, exist_ok=True)
        self.path = os.path.join(
            self._events_dir, f"events-p{self.process_index}.jsonl"
        )
        self._file = open(self.path, "a", encoding="utf-8")
        handles.track(self, "event_log", name=self.path)
        return self._file

    @property
    def observed(self) -> bool:
        """Whether emissions go anywhere: a backing file or a consumer.
        The train loop builds no manifest when nobody would see it."""
        return self._events_dir is not None or bool(self._consumers)

    # ---- consumers -----------------------------------------------------
    def subscribe(self, consumer: Callable[[dict], None]) -> Callable:
        """Register ``consumer(event_dict)``; returns it for unsubscribe."""
        with self._lock:
            self._consumers.append(consumer)
        return consumer

    def unsubscribe(self, consumer: Callable[[dict], None]) -> None:
        with self._lock:
            if consumer in self._consumers:
                self._consumers.remove(consumer)

    # ---- emission ------------------------------------------------------
    def emit(self, event: str, **fields) -> dict:
        """Append one typed event; dispatch the RAW record to consumers,
        write the sanitized strict-JSON form to the file. Serialized under
        one lock so file order == emission order across threads."""
        with self._lock:
            record = {
                "event": event,
                "seq": self._seq,
                "t_ms": round((time.monotonic() - self._t0) * 1e3, 3),
                "unix_time": time.time(),
                **fields,
            }
            self._seq += 1
            out = self._ensure_open()
            if out is not None:
                out.write(json.dumps(sanitize(record), allow_nan=False) + "\n")
                out.flush()  # events are low-rate; survive crashes
            for consumer in tuple(self._consumers):
                consumer(record)
        return record

    def write_manifest(self, config=None, **extra) -> dict | None:
        """Emit the run manifest as the log's first event (idempotent —
        only the first call writes)."""
        with self._lock:
            if self._manifest_written:
                return None
            self._manifest_written = True
            manifest = run_manifest(config=config, **extra)
            if self.run_id is None:
                self.run_id = manifest["run_id"]
            else:
                manifest["run_id"] = self.run_id
            return self.emit("manifest", **manifest)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._file is not None:
                self._file.close()
                self._file = None
        handles.untrack(self)

    def __enter__(self) -> "EventLog":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()


def sink_consumer(sinks) -> Callable[[dict], None]:
    """Adapt ``(epoch, metrics)`` metric sinks into an event consumer: the
    ``epoch`` and ``best_f1`` events carry an ``epoch`` and a ``metrics``
    pair, and each sink sees exactly that dict (non-finite values intact:
    strict JSON is each sink's own concern)."""

    def consume(event: dict) -> None:
        if event.get("event") in ("epoch", "best_f1") and "metrics" in event:
            for sink in sinks:
                sink(event["epoch"], event["metrics"])

    return consume
