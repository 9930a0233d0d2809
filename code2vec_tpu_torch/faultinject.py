"""Deterministic fault injection for elastic-training tests.

Own copy of ``code2vec_tpu/faultinject.py`` (the port imports nothing of
the JAX package): the same grammar, environment variable, points and
thread-safe counters.

Preemption-recovery code is exactly the code a healthy run never executes:
without a way to *schedule* a crash, the mid-save crash window, the SIGTERM
drain path, and mid-epoch resume are only ever exercised by production
incidents. This module lets tests (and brave operators) declare a **fault
plan** — "at the Nth hit of this named point, do X" — that the training
stack honors at a handful of instrumented points.

Plan grammar (``--fault_plan`` / ``C2V_FAULT_PLAN``)::

    plan    := clause ("," clause)*
    clause  := point ["@" occurrence] ":" action
    action  := "raise" | "kill" | "sigterm" | "sleep" millis

``occurrence`` is 1-based and counts hits of that point since
:func:`install_plan` (default 1). Examples::

    train_step@10:sigterm        # graceful preemption after the 10th step
    train_step@10:kill           # SIGKILL — the unceremonious preemption
    mid_save@1:raise             # fail the first persist mid-write
    mid_save@1:sleep500          # slow the first persist by 500 ms
    prefetch_produce@3:raise     # fail the producer thread on batch 3

Instrumented points (grep ``fault_point(`` for the authoritative list):

- ``train_step`` — after each optimizer step is enqueued (train/loop.py)
- ``epoch_start`` — top of each epoch (train/loop.py)
- ``pre_save`` — checkpoint save requested, before any write (checkpoint.py)
- ``mid_save`` — inside persist: the temp file written, not yet renamed
  over the slot (checkpoint.py — a ``kill`` here leaves a ``.tmp*`` file
  that restore ignores and the next writer sweeps)
- ``post_save`` — after the atomic publish (checkpoint.py)
- ``prefetch_produce`` — per batch built by the producer thread
  (train/prefetch.py)

Actions:

- ``raise``   — raise :class:`FaultInjected` at the point (exception paths)
- ``kill``    — ``SIGKILL`` the process (no cleanup runs; exit code -9)
- ``sigterm`` — send the process ``SIGTERM`` (exercises the graceful
  preemption handler, train/preempt.py)
- ``sleepN``  — sleep N milliseconds (widen overlap windows so tests can
  observe async behavior deterministically)

Counters are process-local and thread-safe (the producer and persist
threads hit points too). ``install_plan`` resets all counters, so each
``train()`` call replays the plan from scratch — occurrence numbers are
deterministic for a fixed config/seed.
"""

from __future__ import annotations

import logging
import os
import re
import signal
import threading
import time
from dataclasses import dataclass, field

logger = logging.getLogger(__name__)

__all__ = [
    "FaultInjected",
    "FaultPlan",
    "active_plan",
    "fault_point",
    "install_plan",
    "parse_plan",
]

ENV_VAR = "C2V_FAULT_PLAN"

_CLAUSE = re.compile(
    r"^(?P<point>[A-Za-z_][A-Za-z0-9_]*)"
    r"(?:@(?P<occurrence>[0-9]+))?"
    r":(?P<action>raise|kill|sigterm|sleep(?P<millis>[0-9]+))$"
)


class FaultInjected(RuntimeError):
    """Raised by a ``raise``-action clause at its fault point."""


@dataclass
class FaultPlan:
    """Parsed plan: ``(point, occurrence) -> action``, plus hit counters."""

    spec: str
    clauses: dict[tuple[str, int], str]
    _hits: dict[str, int] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def fire(self, point: str, **context) -> None:
        """Count a hit of ``point``; perform the matching action if any."""
        with self._lock:
            self._hits[point] = self._hits.get(point, 0) + 1
            action = self.clauses.get((point, self._hits[point]))
        if action is None:
            return
        logger.warning(
            "fault plan: %s@%d -> %s %s",
            point, self._hits[point], action, context or "",
        )
        if action == "raise":
            raise FaultInjected(
                f"fault plan fired: {point}@{self._hits[point]} {context}"
            )
        if action == "kill":
            # the point of SIGKILL is that NOTHING runs after it — no
            # finally blocks, no atexit, no flush; recovery must work
            # from whatever already reached disk
            os.kill(os.getpid(), signal.SIGKILL)
        if action == "sigterm":
            os.kill(os.getpid(), signal.SIGTERM)
            return
        if action.startswith("sleep"):
            time.sleep(int(action[len("sleep"):]) / 1e3)

    def hits(self, point: str) -> int:
        with self._lock:
            return self._hits.get(point, 0)


def parse_plan(spec: str) -> FaultPlan:
    """Parse a plan string; raises ``ValueError`` on malformed clauses."""
    clauses: dict[tuple[str, int], str] = {}
    for raw in spec.split(","):
        raw = raw.strip()
        if not raw:
            continue
        m = _CLAUSE.match(raw)
        if m is None:
            raise ValueError(
                f"malformed fault-plan clause {raw!r}; expected "
                "point[@occurrence]:raise|kill|sigterm|sleep<ms> "
                "(e.g. train_step@10:sigterm)"
            )
        occurrence = int(m.group("occurrence") or 1)
        if occurrence < 1:
            raise ValueError(f"occurrence must be >= 1 in {raw!r}")
        key = (m.group("point"), occurrence)
        if key in clauses:
            raise ValueError(f"duplicate fault-plan clause for {raw!r}")
        clauses[key] = m.group("action")
    return FaultPlan(spec=spec, clauses=clauses)


_plan: FaultPlan | None = None


def install_plan(spec: str | None) -> FaultPlan | None:
    """Install (or clear, for falsy ``spec``) the process-wide plan.

    Resets hit counters: each installation replays the plan from zero.
    Returns the installed plan (None when cleared).
    """
    global _plan
    _plan = parse_plan(spec) if spec else None
    return _plan


def install_plan_from_env() -> FaultPlan | None:
    """Install the plan from ``C2V_FAULT_PLAN`` if set; else leave the
    current plan alone (subprocess harnesses set the env var)."""
    spec = os.environ.get(ENV_VAR, "").strip()
    return install_plan(spec) if spec else _plan


def active_plan() -> FaultPlan | None:
    return _plan


def fault_point(point: str, **context) -> None:
    """Mark a named fault point. No-op (one global read) without a plan —
    cheap enough for per-step and per-batch call sites."""
    plan = _plan
    if plan is not None:
        plan.fire(point, **context)
