"""Continuous micro-batcher: coalesce concurrent requests into one forward.

Counterpart of ``code2vec_tpu/serve/batcher.py`` (without the obs
registry and tracing): one background thread takes the first queued
request, waits at most ``deadline_ms`` for company (or until the engine's
top micro-batch size fills), pads the group to its nearest (batch, width)
shape, runs ONE forward and hands each request its row. Batched and
one-at-a-time execution give each request the same row: the forward is
row-independent and PAD lanes carry exactly-zero attention.

Backpressure is explicit: at most ``max_pending`` queued requests, beyond
that :meth:`MicroBatcher.submit` raises :class:`ServeOverloaded`.
:meth:`MicroBatcher.close` drains every accepted request.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass

import numpy as np

__all__ = ["MicroBatcher", "ServeOverloaded", "ServerClosed", "ServeResult"]


class ServeOverloaded(RuntimeError):
    """The pending queue is full — shed load instead of buffering."""


class ServerClosed(RuntimeError):
    """submit() after close()."""


@dataclass
class ServeResult:
    """One request's slice of a forward, on the host."""

    logits: np.ndarray  # [label_count] f32
    code_vector: np.ndarray  # [encode_size] f32
    attention: np.ndarray  # [n_contexts] f32
    n_contexts: int
    batch: int  # the forward's micro-batch size
    width: int  # the forward's bag width
    coalesced: int  # how many requests shared the forward
    queue_wait_ms: float
    device_ms: float  # the forward, host copies included


class _Pending:
    __slots__ = ("contexts", "future", "enqueued")

    def __init__(self, contexts: np.ndarray):
        self.contexts = contexts
        self.future: Future = Future()
        self.enqueued = time.perf_counter()


class MicroBatcher:
    """Bounded-queue request coalescer in front of a ``ServingEngine``."""

    _POLL_S = 0.05

    def __init__(self, engine, deadline_ms: float = 2.0, max_pending: int = 256) -> None:
        if deadline_ms < 0:
            raise ValueError(f"deadline_ms must be >= 0, got {deadline_ms}")
        self._engine = engine
        self._deadline_s = float(deadline_ms) / 1e3
        self._max_batch = max(engine.batch_sizes)
        self._queue: queue.Queue = queue.Queue(maxsize=int(max_pending))
        self._closed = threading.Event()
        # submit's closed-check + enqueue and close's flag-set serialize, so
        # no request can land after close() swept the queue
        self._submit_lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, name="c2v-torch-batcher", daemon=True)
        self._thread.start()

    def submit(self, contexts) -> Future:
        """Enqueue one ``[n, 3]`` array of (start, path, end) ids; the
        future resolves to a :class:`ServeResult`."""
        pending = _Pending(np.asarray(contexts, np.int32).reshape(-1, 3))
        if len(pending.contexts) > self._engine.max_width:
            raise ValueError(
                f"request has {len(pending.contexts)} contexts, more than the "
                f"model's max bag width {self._engine.max_width}; subsample first"
            )
        with self._submit_lock:
            if self._closed.is_set():
                raise ServerClosed("micro-batcher is closed")
            try:
                self._queue.put_nowait(pending)
            except queue.Full:
                raise ServeOverloaded(
                    f"serving queue is full ({self._queue.maxsize} pending); retry with backoff"
                ) from None
        return pending.future

    def close(self, timeout: float = 30.0) -> None:
        """Stop accepting, drain everything queued, join the thread."""
        with self._submit_lock:
            self._closed.set()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("micro-batcher did not drain in time")
        while True:
            try:
                leftover = self._queue.get_nowait()
            except queue.Empty:
                break
            if not leftover.future.done():
                leftover.future.set_exception(ServerClosed("closed before dispatch"))

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()

    def _loop(self) -> None:
        while True:
            try:
                first = self._queue.get(timeout=self._POLL_S)
            except queue.Empty:
                if not self._closed.is_set():
                    continue
                try:  # a request may land between the poll timeout and the flag check
                    first = self._queue.get_nowait()
                except queue.Empty:
                    return
            group = [first]
            t_end = time.perf_counter() + self._deadline_s
            while len(group) < self._max_batch:
                if self._closed.is_set():
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
            except Exception as exc:  # noqa: BLE001 - handed to every caller
                for pending in group:
                    if not pending.future.done():
                        pending.future.set_exception(exc)

    def _run_group(self, group: list[_Pending]) -> None:
        engine = self._engine
        t_start = time.perf_counter()
        starts, paths, ends, batch, width = engine.pad_requests([p.contexts for p in group])
        t0 = time.perf_counter()
        logits, vectors, attention = engine.run(starts, paths, ends)
        device_ms = round((time.perf_counter() - t0) * 1e3, 3)
        for i, pending in enumerate(group):
            n = int(pending.contexts.shape[0])
            pending.future.set_result(ServeResult(
                logits=logits[i], code_vector=vectors[i], attention=attention[i, :n],
                n_contexts=n, batch=batch, width=width, coalesced=len(group),
                queue_wait_ms=round((t_start - pending.enqueued) * 1e3, 3),
                device_ms=device_ms,
            ))
