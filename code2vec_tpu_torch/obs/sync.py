"""Traced synchronization primitives: the lock sanitizer.

Counterpart of ``code2vec_tpu/obs/sync.py``. Every lock of the serving
stack is built through one factory —
``make_lock(name)`` / ``make_rlock(name)`` / ``make_condition(name)`` —
so one switch turns the whole process's locking observable:

- **Default (``C2V_SYNC_DEBUG`` unset): plain ``threading`` primitives.**
  The factory returns the exact objects ``threading.Lock()`` etc. return —
  no wrapper, no extra attributes, zero hot-path cost. The contract is
  pinned by tests: production serving never pays for the sanitizer.
- **``--sync_debug`` / ``C2V_SYNC_DEBUG=1``: traced wrappers.** Each
  acquire/release maintains a per-thread held-lock stack; every *blocking*
  acquire taken while other locks are held adds ``held -> acquiring``
  edges to a process-global acquisition-order graph and checks for a
  cycle **at acquire time** — an inversion is reported the first time the
  orders disagree, not the one unlucky schedule where they actually
  deadlock. A detected inversion emits a ``lock_order_violation`` event
  carrying both threads' acquisition stacks and lock names, bumps the
  ``lock.order_violations`` counter, and is kept in an in-process list
  (:func:`violations`) that tests and the worker health payload read.

Accounting (debug mode only) rides the existing obs registry
(:func:`code2vec_tpu_torch.obs.runtime.global_health`): ``lock.hold_ms`` and
``lock.wait_ms`` latency histograms and a ``lock.contended`` counter,
which the Prometheus exporter surfaces as ``c2v_lock_hold_ms`` /
``c2v_lock_wait_ms`` summaries and ``c2v_lock_contended_total``.

Scope notes:

- Non-blocking ``acquire(blocking=False)`` never adds graph edges — a
  trylock cannot participate in a deadlock (and ``Condition``'s internal
  ``_is_owned`` probe uses exactly that pattern).
- A reentrant re-acquire of a :class:`TracedRLock` the thread already
  owns adds no edge and no stack entry — RLock reentrancy is not an
  inversion.
- The leaf locks inside ``obs.runtime`` itself (``Counter``,
  ``LatencyHistogram``, the registry) stay plain ``threading`` locks:
  they are the sanitizer's own recording substrate (routing them through
  the factory would recurse) and they guard single dict/list operations
  with no nested acquisition by construction.

:func:`guard_fork_safety`: call it immediately before requesting a
``fork`` start method (the feed pool, ``data/parallel_feed.py``), and it
reports (warning log + ``error`` event) any live non-daemon threads
whose held locks a forked child would inherit frozen.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import traceback

logger = logging.getLogger(__name__)

__all__ = [
    "SYNC_DEBUG_ENV",
    "TracedCondition",
    "TracedLock",
    "TracedRLock",
    "guard_fork_safety",
    "make_condition",
    "make_lock",
    "make_rlock",
    "register_event_log",
    "reset_sync_state",
    "sync_debug_enabled",
    "sync_snapshot",
    "violations",
]

SYNC_DEBUG_ENV = "C2V_SYNC_DEBUG"

_FALSY = {"", "0", "false", "no", "off"}


def sync_debug_enabled() -> bool:
    """Read the switch at call time (not import time) so tests and the
    ``--sync_debug`` CLI flag can flip it before constructing locks."""
    return os.environ.get(SYNC_DEBUG_ENV, "").strip().lower() not in _FALSY


# ---------------------------------------------------------------------------
# global sanitizer state (touched only in debug mode)
# ---------------------------------------------------------------------------

# guards the order graph, the violation list, and event-log registration;
# deliberately a PLAIN lock — it is the sanitizer's own substrate
_state_lock = threading.Lock()

# src lock name -> {dst lock name: provenance of the first src->dst edge}
_edges: dict[str, dict[str, dict]] = {}
_violations: list[dict] = []
_violation_pairs: set[tuple[str, str]] = set()
_event_logs: list = []

_tls = threading.local()


def _held_stack() -> list:
    """This thread's stack of currently-held traced locks (innermost last);
    entries are ``[lock, t_acquired]``."""
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def register_event_log(events) -> None:
    """Attach an :class:`~code2vec_tpu_torch.obs.events.EventLog`; detected
    inversions emit ``lock_order_violation`` events into every registered
    log (best-effort — a closed log never breaks an acquire)."""
    with _state_lock:
        if events not in _event_logs:
            _event_logs.append(events)


def reset_sync_state() -> None:
    """Drop the acquisition graph, recorded violations, and registered
    event logs (tests; also sensible after ``os.fork``)."""
    with _state_lock:
        _edges.clear()
        _violations.clear()
        _violation_pairs.clear()
        _event_logs.clear()


def violations() -> list[dict]:
    """Recorded lock-order violations (copies), oldest first."""
    with _state_lock:
        return [dict(v) for v in _violations]


def sync_snapshot() -> dict:
    """Health-payload block: sanitizer mode plus graph/violation sizes."""
    with _state_lock:
        return {
            "enabled": sync_debug_enabled(),
            "order_violations": len(_violations),
            "locks_tracked": len(
                {n for n in _edges} | {d for ds in _edges.values() for d in ds}
            ),
            "order_edges": sum(len(d) for d in _edges.values()),
        }


def _health():
    from code2vec_tpu_torch.obs.runtime import global_health

    return global_health()


def _path_exists(src: str, dst: str) -> bool:
    """Is there a path src ->* dst in the (small) acquisition graph?
    Caller holds ``_state_lock``."""
    seen = {src}
    frontier = [src]
    while frontier:
        node = frontier.pop()
        if node == dst:
            return True
        for nxt in _edges.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                frontier.append(nxt)
    return False


def _note_blocking_acquire(lock: "_TracedBase") -> None:
    """Record ``held -> lock`` order edges and detect inversions. Runs
    BEFORE the acquire blocks, so a cycle is reported even on schedules
    that happen not to deadlock."""
    held = [entry[0] for entry in _held_stack()]
    if not held:
        return
    me = threading.current_thread().name
    stack_text = "".join(traceback.format_stack(limit=12)[:-2])
    held_names = [h.name for h in held]
    reported: list[dict] = []
    with _state_lock:
        for h in held:
            if h.name == lock.name:
                continue  # same-name locks (e.g. per-instance) never self-edge
            if _path_exists(lock.name, h.name):
                pair = (h.name, lock.name)
                if pair in _violation_pairs:
                    continue
                _violation_pairs.add(pair)
                # provenance of the recorded reverse edge lock -> h (or,
                # for longer cycles, the first hop out of `lock`)
                reverse = _edges.get(lock.name, {})
                other = reverse.get(h.name) or next(iter(reverse.values()), {})
                record = {
                    "lock": lock.name,
                    "held": list(held_names),
                    "thread": me,
                    "stack": stack_text,
                    "other_thread": other.get("thread"),
                    "other_held": other.get("held"),
                    "other_stack": other.get("stack"),
                }
                _violations.append(record)
                reported.append(record)
            else:
                _edges.setdefault(h.name, {}).setdefault(
                    lock.name,
                    {
                        "thread": me,
                        "held": list(held_names),
                        "stack": stack_text,
                    },
                )
        logs = list(_event_logs)
    # report outside the state lock: EventLog.emit and the health counter
    # take their own leaf locks
    for record in reported:
        _health().counter("lock.order_violations").inc()
        logger.error(
            "lock-order violation: thread %r acquires %r while holding %r, "
            "but the reverse order %r -> %r is already on record "
            "(thread %r) — potential deadlock",
            record["thread"], record["lock"], record["held"],
            record["lock"], record["held"][-1], record["other_thread"],
        )
        for ev in logs:
            try:
                ev.emit("lock_order_violation", **record)
            except Exception:  # pragma: no cover - closed log
                logger.warning(
                    "could not emit lock_order_violation", exc_info=True
                )


class _TracedBase:
    """Shared acquire/release instrumentation for traced locks."""

    def __init__(self, name: str, inner) -> None:
        self.name = str(name)
        self._inner = inner

    # -- context manager ------------------------------------------------
    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc_info) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<{type(self).__name__} {self.name!r}>"

    # -- instrumentation hooks ------------------------------------------
    def _owned_count(self) -> int:
        return sum(1 for entry in _held_stack() if entry[0] is self)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        reentrant = self._reentrant and self._owned_count() > 0
        if blocking and not reentrant:
            _note_blocking_acquire(self)
        got = self._inner.acquire(False)
        if not got:
            if not blocking:
                # not counted as contention: trylock probes (Condition's
                # _is_owned) fail by design and never wait
                return False
            _health().counter("lock.contended").inc()
            t0 = time.perf_counter()
            got = self._inner.acquire(True, timeout)
            _health().latency("lock.wait_ms").record(
                (time.perf_counter() - t0) * 1e3
            )
        if got:
            _held_stack().append([self, time.perf_counter()])
        return got

    def release(self) -> None:
        stack = _held_stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] is self:
                _, t_acq = stack.pop(i)
                # hold time of the outermost hold only would need pairing;
                # each acquire/release pair records its own span
                _health().latency("lock.hold_ms").record(
                    (time.perf_counter() - t_acq) * 1e3
                )
                break
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()


class TracedLock(_TracedBase):
    """``threading.Lock`` with held-stack + acquisition-order tracing."""

    _reentrant = False

    def __init__(self, name: str) -> None:
        super().__init__(name, threading.Lock())


class TracedRLock(_TracedBase):
    """``threading.RLock`` with tracing; reentrant re-acquires add no
    order edges (reentrancy is not an inversion)."""

    _reentrant = True

    def __init__(self, name: str) -> None:
        super().__init__(name, threading.RLock())

    def locked(self) -> bool:  # RLock has no .locked() before 3.12
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True


class TracedCondition:
    """``threading.Condition`` over a :class:`TracedLock`: waiting releases
    the traced lock (popping it off the held stack — a waiter holds
    nothing) and re-acquires it through the traced path on wake."""

    def __init__(self, name: str, lock: _TracedBase | None = None) -> None:
        self.name = str(name)
        self._lock = lock if lock is not None else TracedLock(name)
        self._cond = threading.Condition(self._lock)

    def acquire(self, *args, **kwargs):
        return self._lock.acquire(*args, **kwargs)

    def release(self) -> None:
        self._lock.release()

    def __enter__(self):
        self._lock.acquire()
        return self

    def __exit__(self, *exc_info) -> None:
        self._lock.release()

    def wait(self, timeout: float | None = None) -> bool:
        return self._cond.wait(timeout)

    def wait_for(self, predicate, timeout: float | None = None):
        return self._cond.wait_for(predicate, timeout)

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()


# ---------------------------------------------------------------------------
# the factory
# ---------------------------------------------------------------------------


def make_lock(name: str):
    """A mutex named for diagnostics: plain ``threading.Lock()`` unless
    ``C2V_SYNC_DEBUG`` is set, then a :class:`TracedLock`."""
    if sync_debug_enabled():
        return TracedLock(name)
    return threading.Lock()


def make_rlock(name: str):
    """Reentrant variant of :func:`make_lock`."""
    if sync_debug_enabled():
        return TracedRLock(name)
    return threading.RLock()


def make_condition(name: str, lock=None):
    """Condition variant of :func:`make_lock`; ``lock`` may be a traced
    lock (debug mode) or any plain lock (default mode)."""
    if sync_debug_enabled():
        traced = lock if isinstance(lock, _TracedBase) else None
        return TracedCondition(name, traced)
    return threading.Condition(lock)


# ---------------------------------------------------------------------------
# fork safety
# ---------------------------------------------------------------------------


def guard_fork_safety(where: str, events=None) -> list[str]:
    """Report live non-daemon threads (other than the caller) right before
    a ``fork`` start method is requested: a forked child inherits every
    lock those threads hold, permanently locked, with no owner to release
    them. Returns the offending thread names; warns via the log and an
    ``error`` event rather than refusing — the caller may know its
    threads hold nothing (and says so at its call site)."""
    offenders = sorted(
        t.name
        for t in threading.enumerate()
        if t.is_alive()
        and not t.daemon
        and t is not threading.current_thread()
    )
    if offenders:
        message = (
            f"{where}: fork start-method requested while non-daemon "
            f"threads are alive ({', '.join(offenders)}); forked children "
            "inherit any locks those threads hold, permanently frozen — "
            "start worker pools before serving/training threads"
        )
        logger.warning(message)
        if events is not None:
            try:
                events.emit(
                    "error",
                    where=where,
                    kind="fork_after_threads",
                    message=message,
                    threads=offenders,
                )
            except Exception:  # pragma: no cover - closed log
                logger.warning("could not emit fork guard event", exc_info=True)
    return offenders
