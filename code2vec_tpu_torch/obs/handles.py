"""Runtime handle ledger: open lifecycle objects, by kind and creation site.

Counterpart of ``code2vec_tpu/obs/handles.py``. Every lifecycle-bearing
object of the serving stack — micro-batchers, swap generations, replica
subprocesses, event logs, the flight recorder — registers with one ledger
through ``track(obj, kind)`` at acquisition and ``untrack(obj)`` at
release:

- **Default (``C2V_HANDLE_DEBUG`` unset): a zero-cost no-op.**
  ``track`` returns its argument unchanged (``track(x, k) is x``), adds no
  attributes, takes no locks, and leaves module state empty. The contract
  is pinned by tests the same way ``obs/sync.py`` pins its plain-primitive
  contract: production serving never pays for the ledger.
- **``--handle_debug`` / ``C2V_HANDLE_DEBUG=1``: a live open-handle
  ledger.** Each tracked object gets a record carrying its kind, a
  human-readable name, and the *creation-site* stack captured at
  ``track`` time. ``untrack`` removes the record; whatever is left is, by
  definition, an open handle.

Accounting (debug mode only) rides the existing obs registry
(:func:`code2vec_tpu_torch.obs.runtime.global_health`): per-kind
``handles.open.<kind>`` gauges (Prometheus: ``c2v_handles_open_<kind>``)
plus ``handles.opened`` / ``handles.closed`` / ``handles.leaked``
counters. The worker health payload carries a ``handles`` block
(:func:`handles_snapshot`) that the fleet router relays per-replica into
fleet health — so a replica leaking one fd per swap is visible from the
router *before* it dies, and :mod:`~code2vec_tpu_torch.serve.fleet.router`
stamps the dead incarnation's last-known open-handle count into
``fleet_replica_evicted`` events.

At shutdown, :func:`report_leaks` emits one ``handle_leak`` event per
still-open handle, naming the creation site.

The ledger keys records by ``id(obj)`` and never holds a strong reference
to the tracked object itself, so tracking cannot extend an object's
lifetime or break GC cycles. ``_state_lock`` is deliberately a PLAIN
``threading.Lock`` (not ``make_lock``): the ledger is observability
substrate, same tier as the metric primitives the lock sanitizer refuses
to trace.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import traceback

logger = logging.getLogger(__name__)

__all__ = [
    "HANDLE_DEBUG_ENV",
    "handle_debug_enabled",
    "handles_snapshot",
    "open_handles",
    "register_event_log",
    "report_leaks",
    "reset_handle_state",
    "track",
    "untrack",
]

HANDLE_DEBUG_ENV = "C2V_HANDLE_DEBUG"

_FALSY = {"", "0", "false", "no", "off"}


def handle_debug_enabled() -> bool:
    """Read the switch at call time (not import time) so tests and the
    ``--handle_debug`` CLI flag can flip it before constructing owners."""
    return os.environ.get(HANDLE_DEBUG_ENV, "").strip().lower() not in _FALSY


# ---------------------------------------------------------------------------
# global ledger state (touched only in debug mode)
# ---------------------------------------------------------------------------

# guards the open-handle table and event-log registration; deliberately a
# PLAIN lock — the ledger is observability substrate (see module docstring)
_state_lock = threading.Lock()

# id(obj) -> open-handle record (no strong ref to obj; see module docstring)
_open: dict[int, dict] = {}
_leaked: int = 0
_seq: int = 0
_event_logs: list = []


def register_event_log(events) -> None:
    """Attach an :class:`~code2vec_tpu_torch.obs.events.EventLog`; leak reports
    emit ``handle_leak`` events into every registered log (best-effort —
    a closed log never breaks a report)."""
    with _state_lock:
        if events not in _event_logs:
            _event_logs.append(events)


def reset_handle_state() -> None:
    """Drop all ledger state (tests)."""
    global _leaked, _seq
    with _state_lock:
        _open.clear()
        _event_logs.clear()
        _leaked = 0
        _seq = 0


def _health():
    # lazy: obs.runtime is stdlib-only but keeping the import out of module
    # scope keeps this module importable from anywhere without cycles
    from code2vec_tpu_torch.obs.runtime import global_health

    return global_health()


def _creation_site(skip: int = 2) -> str:
    """Trimmed stack text ending at the caller of ``track`` — the site the
    leak report names. ``skip`` drops this helper + the track frame."""
    frames = traceback.format_stack()
    return "".join(frames[max(0, len(frames) - 8 - skip) : len(frames) - skip])


def track(obj, kind: str, name: str | None = None):
    """Register ``obj`` as an open handle of ``kind``; ALWAYS returns
    ``obj`` itself (identity — callers can write
    ``self._proc = track(Popen(...), "replica")`` unconditionally).

    Off: returns immediately, no state touched. On: records
    {kind, name, creation site, open time} keyed by ``id(obj)`` and bumps
    the per-kind open gauge. Re-tracking an id (a dead object's id reused
    by a new allocation) replaces the stale record.
    """
    if not handle_debug_enabled():
        return obj
    global _seq
    now = time.time()
    site = _creation_site()
    record = {
        "kind": kind,
        "name": name if name is not None else type(obj).__name__,
        "site": site,
        "opened_unix": now,
        "thread": threading.current_thread().name,
    }
    with _state_lock:
        _seq += 1
        record["token"] = _seq
        stale = _open.pop(id(obj), None)
        _open[id(obj)] = record
    health = _health()
    if stale is not None:
        _gauge_delta(health, stale["kind"], -1)
    _gauge_delta(health, kind, +1)
    health.counter("handles.opened").inc()
    return obj


def untrack(obj) -> bool:
    """Mark ``obj`` closed. Returns True if it was ledger-open. Safe to
    call twice (idempotent close paths) and when the ledger is off."""
    if not handle_debug_enabled():
        return False
    with _state_lock:
        record = _open.pop(id(obj), None)
    if record is None:
        return False
    health = _health()
    _gauge_delta(health, record["kind"], -1)
    health.counter("handles.closed").inc()
    return True


def _gauge_delta(health, kind: str, delta: int) -> None:
    gauge = health.gauge(f"handles.open.{kind}")
    gauge.set((gauge.value or 0) + delta)


def open_handles(kind: str | None = None) -> list[dict]:
    """Copies of the currently-open records (optionally one kind), ordered
    by open time. Each carries ``token`` — a monotone per-process open
    sequence number the zero-leak pytest fixture diffs across a test."""
    with _state_lock:
        records = [dict(r) for r in _open.values()]
    if kind is not None:
        records = [r for r in records if r["kind"] == kind]
    records.sort(key=lambda r: r["token"])
    return records


def handles_snapshot() -> dict:
    """Health-payload block: enabled flag + open counts per kind. Cheap
    enough to ride every health probe."""
    if not handle_debug_enabled():
        return {"enabled": False}
    by_kind: dict[str, int] = {}
    with _state_lock:
        for record in _open.values():
            by_kind[record["kind"]] = by_kind.get(record["kind"], 0) + 1
        leaked = _leaked
    return {
        "enabled": True,
        "open_total": sum(by_kind.values()),
        "open": dict(sorted(by_kind.items())),
        "leaked": leaked,
    }


def report_leaks(where: str, events=None, exclude: tuple = ()) -> list[dict]:
    """Shutdown leak report: every handle still open is a leak. Emits one
    ``handle_leak`` event per leaked record (kind, name, age, creation
    site) into ``events`` plus every registered log, bumps the
    ``handles.leaked`` counter, and returns the records.

    ``exclude`` lists objects legitimately still open at report time —
    typically the event log the report itself writes into. Records are
    reported once: a second ``report_leaks`` call (e.g. two teardown
    paths racing) skips already-reported entries. The ledger is NOT
    cleared — post-report assertions still see the leaks.
    """
    global _leaked
    if not handle_debug_enabled():
        return []
    exclude_ids = {id(o) for o in exclude}
    fresh: list[dict] = []
    with _state_lock:
        for obj_id, record in _open.items():
            if obj_id in exclude_ids or record.get("reported"):
                continue
            record["reported"] = True
            fresh.append(dict(record))
        logs = list(_event_logs)
        _leaked += len(fresh)
    if not fresh:
        return []
    fresh.sort(key=lambda r: r["token"])
    now = time.time()
    health = _health()
    health.counter("handles.leaked").inc(len(fresh))
    if events is not None and events not in logs:
        logs.append(events)
    for record in fresh:
        logger.warning(
            "handle leak at %s: %s '%s' open %.1fs, created at\n%s",
            where,
            record["kind"],
            record["name"],
            now - record["opened_unix"],
            record["site"],
        )
        for log in logs:
            try:
                log.emit(
                    "handle_leak",
                    where=where,
                    kind=record["kind"],
                    name=record["name"],
                    age_s=round(now - record["opened_unix"], 3),
                    site=record["site"],
                )
            except Exception:  # pragma: no cover - closed/broken log
                pass
    logger.warning(
        "handle leak report at %s: %d leaked handle(s)", where, len(fresh)
    )
    return fresh
