"""Graceful preemption: the trainer's SIGTERM contract.

Counterpart of ``code2vec_tpu/train/preempt.py``. A preempted machine
gets SIGTERM and a grace window before SIGKILL; Python's default
disposition ends the process in the middle of a step and loses every step
since the last save. Here SIGTERM sets a flag instead:

- :func:`install_sigterm_handler` (called by ``train()``) routes SIGTERM
  into the process-wide :class:`PreemptionGuard` and returns the previous
  disposition, which the loop's ``finally`` restores;
- the train loop reads :meth:`PreemptionGuard.requested` after every step:
  the step already enqueued finishes, a ``last``-slot save with a
  mid-epoch cursor lands (``checkpoint.py``) and ``train()`` returns
  normally, so the CLI exits 0;
- the prefetch producer (``train/prefetch.py``) reads the same guard and
  ends the train stream instead of building batches nobody will take.

The fault plan's ``sigterm`` action (``faultinject.py``) sends a real
SIGTERM, so the tests take the path a real preemption takes.

Signal handlers are a main-thread facility: when ``train()`` runs on
another thread, installing is a no-op and SIGTERM keeps its disposition
(preemption safety then rests on the periodic saves). This handler is the
trainer's own; the server's SIGTERM drain is ``serve/protocol.
run_transport``'s. :func:`coordinated_stop` is the local flag: the
multi-process agreement on it goes with ``torch.distributed`` (ROADMAP
§A.2.9).
"""

from __future__ import annotations

import logging
import signal
import threading
import time

logger = logging.getLogger(__name__)

__all__ = [
    "PreemptionGuard",
    "PreemptionStop",
    "coordinated_stop",
    "install_sigterm_handler",
    "preemption_guard",
    "restore_sigterm_handler",
]


class PreemptionStop(Exception):
    """Raised inside the train loop once the preemption save is on disk: it
    unwinds the epoch (the prefetch producer joined, the feed closed) and
    ``train()`` returns normally."""


class PreemptionGuard:
    """A sticky, thread-safe "preemption requested" flag."""

    def __init__(self) -> None:
        self._event = threading.Event()
        self.reason: str | None = None
        self.requested_at: float | None = None  # time.perf_counter() of the request

    def request(self, reason: str = "requested") -> None:
        """Mark preemption requested (the signal handler, or a test)."""
        if not self._event.is_set():
            self.reason = reason
            self.requested_at = time.perf_counter()
            self._event.set()

    def requested(self) -> bool:
        return self._event.is_set()

    def clear(self) -> None:
        """Reset for a fresh run (``train()``'s entry)."""
        self.reason = None
        self.requested_at = None
        self._event.clear()


_GUARD = PreemptionGuard()


def preemption_guard() -> PreemptionGuard:
    """The process-wide guard the loop, the prefetch producer and the
    signal handler share."""
    return _GUARD


def coordinated_stop(guard: PreemptionGuard) -> bool:
    """Whether to act on the guard: one process reads its own flag."""
    return guard.requested()


def install_sigterm_handler():
    """Route SIGTERM into the guard; return the previous handler (for
    :func:`restore_sigterm_handler`), or None off the main thread."""

    def _on_sigterm(signum, frame):  # noqa: ARG001 - the signal signature
        logger.warning("SIGTERM received: finishing the step in flight, then saving and "
                       "exiting cleanly")
        _GUARD.request("SIGTERM")

    try:
        return signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:  # signals are main-thread-only
        logger.debug("not installing the SIGTERM handler (train() is off the main thread); "
                     "preemption safety rests on the periodic saves")
        return None


def restore_sigterm_handler(previous) -> None:
    """Undo :func:`install_sigterm_handler` (a no-op for None)."""
    if previous is None:
        return
    try:
        signal.signal(signal.SIGTERM, previous)
    except ValueError:
        pass
