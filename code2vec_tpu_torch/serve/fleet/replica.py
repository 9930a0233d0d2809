"""One replica worker behind a JSONL pipe: spawn, send, match, stop.

Counterpart of ``code2vec_tpu/serve/fleet/replica.py``. A replica is ``python -m code2vec_tpu_torch.serve --transport stdio`` as a
subprocess. The stdio transport writes responses IN REQUEST ORDER, so the
client side needs no correlation ids: a FIFO deque of futures, appended
at write time and popped by the reader thread per response line, is the
whole matching protocol (the same discipline the stdio transport's own
tests pin). What this module owns:

- **spawn + readiness**: the worker warms its ladder before accepting
  traffic; :meth:`ReplicaHandle.wait_ready` rides a ``health`` request
  through the pipe so the router only counts a replica as placeable once
  every shape is warm.
- **bounded in-flight accounting**: ``in_flight`` is the pending-future
  count — the router's per-replica backpressure bound (the micro-batcher
  ``max_pending`` idea, one level up) and its least-loaded placement key.
- **death detection**: stdout EOF or a failed write marks the handle dead
  and fails every pending future with :class:`ReplicaDied` — the router
  retries those on a sibling and the prober respawns the slot.
- **graceful stop**: a ``shutdown`` op rides the FIFO behind everything
  already submitted (so the worker drains before exiting); a stubborn
  process gets SIGTERM (the worker's drain handler) and only then
  SIGKILL.

Trace contexts need no handling here: the router stamps the ``"trace"``
field into the request dict at admission and this client forwards the
dict verbatim over the pipe — the worker's resolver picks the id up on
the far side. ``last_health`` (refreshed by every probe) doubles as the
router's lock-light ``/metrics`` source for this replica;
``last_health_unix`` records when it was captured so scrapers can judge
staleness.

Per-replica metrics live under the ``fleet.r<slot>.`` namespace of the
shared obs registry (``RuntimeHealth.namespaced``): ``dispatched`` /
``responses`` / ``in_flight`` / ``deaths`` — one schema for the router's
decisions and the fleet health op.
"""

from __future__ import annotations

import collections
import json
import logging
import subprocess
import threading
import time
from concurrent.futures import Future

from code2vec_tpu_torch.obs import handles
from code2vec_tpu_torch.obs.runtime import RuntimeHealth, global_health
from code2vec_tpu_torch.obs.sync import make_lock

logger = logging.getLogger(__name__)

__all__ = ["ReplicaDied", "ReplicaHandle"]


class ReplicaDied(RuntimeError):
    """The worker process is gone; pending requests need a new home."""


class ReplicaHandle:
    """Pipe client for one worker subprocess (see module docstring)."""

    def __init__(
        self,
        slot: int,
        argv: list[str],
        *,
        incarnation: int = 0,
        env: dict | None = None,
        health: RuntimeHealth | None = None,
        stderr=None,
    ) -> None:
        self.slot = int(slot)
        self.incarnation = int(incarnation)
        self.argv = list(argv)
        self._health = (health or global_health()).namespaced(
            f"fleet.r{self.slot}"
        )
        self._pending: collections.deque[Future] = collections.deque()
        self._plock = make_lock(f"replica.r{self.slot}.pending")
        self._wlock = make_lock(f"replica.r{self.slot}.write")
        self._dead = threading.Event()
        self.death_reason: str | None = None
        # prober bookkeeping (owned by the router's probe thread)
        self.probe_failures = 0
        self.last_health: dict | None = None
        self.last_health_unix: float | None = None
        self.started_unix = time.time()
        self._dispatched = self._health.counter("dispatched")
        self._responses = self._health.counter("responses")
        self._deaths = self._health.counter("deaths")
        self._inflight_gauge = self._health.gauge("in_flight")
        self._inflight_gauge.set(0)
        self._proc = subprocess.Popen(
            self.argv,
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=stderr,
            text=True,
            bufsize=1,  # line-buffered pipes: one request/response per line
            env=env,
        )
        self._reader = threading.Thread(
            target=self._read_loop,
            name=f"c2v-fleet-r{self.slot}-reader",
            daemon=True,
        )
        self._reader.start()
        handles.track(
            self, "replica", name=f"r{self.slot}#i{self.incarnation}"
        )

    # ---- state ----------------------------------------------------------
    @property
    def alive(self) -> bool:
        return not self._dead.is_set() and self._proc.poll() is None

    @property
    def in_flight(self) -> int:
        return len(self._pending)

    @property
    def pid(self) -> int:
        return self._proc.pid

    # ---- request path ---------------------------------------------------
    def send(self, request: dict) -> Future:
        """Write one request line; returns a Future resolving to the
        worker's response dict. Raises :class:`ReplicaDied` if the worker
        is gone (including a write that discovers it just died)."""
        future: Future = Future()
        line = json.dumps(request)
        with self._wlock:
            if not self.alive:
                raise ReplicaDied(
                    f"replica r{self.slot} is not running"
                    f" ({self.death_reason or 'process exited'})"
                )
            # append BEFORE the write: the reader matches responses FIFO,
            # and a response cannot precede its request's write
            with self._plock:
                self._pending.append(future)
            try:
                # pipe write under _wlock is the point of _wlock: it exists
                # to serialize writers so request lines interleave whole.
                # Blocking is bounded by the pipe buffer and the worker's
                # reader, which drains continuously; nothing that resolves
                # this write ever needs _wlock.
                self._proc.stdin.write(line + "\n")  # torchlint: disable=CX003
                self._proc.stdin.flush()  # torchlint: disable=CX003
            except (BrokenPipeError, OSError, ValueError) as exc:
                # nothing was (fully) written for THIS request — it is the
                # newest pending entry; remove it before failing the rest
                with self._plock:
                    if self._pending and self._pending[-1] is future:
                        self._pending.pop()
                self._fail(f"stdin write failed: {exc}")
                raise ReplicaDied(
                    f"replica r{self.slot} died on write: {exc}"
                ) from exc
        self._dispatched.inc()
        self._inflight_gauge.set(self.in_flight)
        return future

    def wait_ready(self, timeout: float) -> dict:
        """Block until the worker answers a health probe (its ladder is
        warm and it is accepting traffic)."""
        payload = self.send({"op": "health"}).result(timeout)
        self.last_health = payload
        self.last_health_unix = time.time()
        return payload

    # ---- reader ---------------------------------------------------------
    def _read_loop(self) -> None:
        try:
            for line in self._proc.stdout:
                line = line.strip()
                if not line:
                    continue
                try:
                    payload = json.loads(line)
                    if not isinstance(payload, dict):
                        raise ValueError("not an object")
                except ValueError:
                    payload = {
                        "error": f"unparseable replica line: {line[:200]}",
                        "error_kind": "internal",
                    }
                with self._plock:
                    future = (
                        self._pending.popleft() if self._pending else None
                    )
                if future is None:
                    logger.warning(
                        "replica r%d wrote an unsolicited line: %.120s",
                        self.slot, line,
                    )
                    continue
                self._responses.inc()
                self._inflight_gauge.set(self.in_flight)
                if not future.done():
                    future.set_result(payload)
        finally:
            self._fail("stdout closed")

    def _fail(self, reason: str) -> None:
        if self._dead.is_set():
            return
        self._dead.set()
        self.death_reason = reason
        self._deaths.inc()
        # every path out of a replica's life funnels through here exactly
        # once (stop/kill/crash all set _dead) — the ledger close point
        handles.untrack(self)
        with self._plock:
            stranded = list(self._pending)
            self._pending.clear()
        self._inflight_gauge.set(0)
        for future in stranded:
            if not future.done():
                future.set_exception(
                    ReplicaDied(f"replica r{self.slot}: {reason}")
                )
        if stranded:
            logger.warning(
                "replica r%d died (%s) with %d request(s) in flight",
                self.slot, reason, len(stranded),
            )

    # ---- stop -----------------------------------------------------------
    def stop(self, timeout: float = 30.0) -> None:
        """Graceful: shutdown op (drains the FIFO ahead of it), then
        SIGTERM (the worker's drain handler), then SIGKILL."""
        try:
            self.send({"op": "shutdown"})
        except ReplicaDied:
            pass
        try:
            self._proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self.kill(timeout)
        self._fail("stopped")

    def kill(self, timeout: float = 10.0) -> None:
        """Eviction path: SIGTERM first — the worker drains accepted
        requests and exits 0 — escalate to SIGKILL only on a hang."""
        if self._proc.poll() is None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout)
            except subprocess.TimeoutExpired:  # pragma: no cover - hung worker
                self._proc.kill()
                self._proc.wait()
        self._fail("killed")
