"""The host feed's overlap: batches built and copied ahead of compute, and
where a step's wall time goes.

Counterpart of ``code2vec_tpu/train/prefetch.py`` in PyTorch's idiom.
:class:`HostPrefetcher` runs the batch build and ``to_device`` on one
background thread, ``depth`` batches ahead of the steps, behind a bounded
queue:

- **the same stream**: one producer pulls the batch iterator in order, so
  the batches, and every draw of the host generator behind them, are the
  synchronous loop's, bit for bit;
- **the card's streams**: with a ``stream`` (a CUDA stream of its own) the
  producer enqueues its copies there and records an event after them; the
  consumer makes its current stream wait on that event and marks every
  tensor it receives as used there (``record_stream``), so the caching
  allocator does not hand the memory back while a step still reads it;
- **failures**: an exception of the producer (the build or the copy)
  re-raises at the consumer's next pull, its traceback text attached as
  ``remote_traceback``;
- **backpressure**: the queue holds ``depth`` ready batches;
- **shutdown**: :meth:`HostPrefetcher.close` (or leaving the ``with``,
  on an exception too) stops the producer, closes the batch iterator (its
  ``finally`` blocks run) and joins the thread;
- **preemption** (``drain_on_preemption``, train streams only; JAX
  ``:223-283``): once the SIGTERM guard (``train/preempt.py``) is set the
  producer ends the stream instead of building batches nobody will take;
  the loop's cursor hook re-checks the guard at the stream's end, so a
  drained pass is never recorded as an epoch. An eval stream always runs
  to its end (a drained one would score a partial test split). The
  producer passes the ``prefetch_produce`` fault point once a batch.

:func:`device_batches` is the loops' one entry point: the prefetcher, or
:class:`_SyncBatches`, its synchronous twin with the same pairs and stamps.

:class:`StepProfiler` splits ~``sample_steps`` steps an epoch into
host-build / H2D / feed-wait / compute milliseconds, fencing only those
steps (the copy stream and the step are synchronized there). The split
feeds ``--profile_steps``' columns of the epoch line; with ``peak_flops``
set and each sampled step's analytic FLOPs recorded, a sampled step also
gets an ``mfu`` column (achieved FLOP/s over the card's peak).

Tracing (the process-wide tracer, ``obs/trace.py``): the first steps,
every 64th after and the profiler's sampled ones get ``host_build`` and
``h2d`` spans (on the producer's thread when prefetching, with the queue's
depth at the pull), never every step, so a long epoch does not flood the
tracer's buffer.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
import traceback
from typing import Callable, Iterable, Iterator

import torch

from code2vec_tpu_torch import faultinject
from code2vec_tpu_torch.obs.costs import _coerce_flops
from code2vec_tpu_torch.obs.trace import get_tracer
from code2vec_tpu_torch.train.preempt import preemption_guard

__all__ = ["HostPrefetcher", "StepProfiler", "device_batches"]

_SPAN_WARMUP_STEPS = 8
_SPAN_STRIDE = 64
_NO_SPAN = contextlib.nullcontext()


def _span_step(step: int, profiler: "StepProfiler | None") -> bool:
    """Whether this step's host_build and h2d get trace spans: the first
    steps, every ``_SPAN_STRIDE``-th after, and the profiler's sampled
    steps (JAX ``prefetch.py:59-70``)."""
    return (step < _SPAN_WARMUP_STEPS or step % _SPAN_STRIDE == 0
            or (profiler is not None and profiler.sampled(step)))


def _tensors(out) -> Iterator[torch.Tensor]:
    """The tensors in ``to_device``'s output (nested dicts, lists, tuples)."""
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _tensors(v)


def _sync_current_stream(out) -> None:
    """Wait for the copies of ``out`` enqueued on the current stream (a
    profiled step's H2D fence); nothing for CPU tensors."""
    for t in _tensors(out):
        if t.is_cuda:
            torch.cuda.current_stream(t.device).synchronize()
            return


class StepProfiler:
    """Per-step wall time: host build, H2D copy, feed wait, compute.

    ~``sample_steps`` steps an epoch are recorded: ``host_build_ms`` (the
    pull of the batch), ``feed_wait_ms`` (the part of it spent waiting on
    the feed workers, 0.0 without them), ``h2d_ms`` (``to_device`` up to
    the copies' end) and ``compute_ms`` (the step, synchronized before and
    after). The first epoch samples its first ``sample_steps`` steps; after
    :meth:`observe_epoch_length` the next :meth:`reset` spreads them over
    the whole epoch. :meth:`sampled` is a function of the step index alone,
    so the producer and consumer threads agree without a lock; they write
    different keys, and :meth:`summary` reads after the producer joined.
    ``peak_flops`` (``obs.costs.peak_flops`` of the run's card) with a
    step's ``flops`` gives that step an ``mfu`` column."""

    def __init__(self, sample_steps: int = 0, peak_flops: float | None = None):
        self.sample_steps = int(sample_steps)
        self.stride = 1
        self._next_stride = 1
        self._host: dict[int, tuple[float, float, float]] = {}
        self._compute: dict[int, tuple[float, float | None]] = {}
        self.peak_flops = peak_flops

    def sampled(self, step: int) -> bool:
        if self.sample_steps <= 0:
            return False
        return step % self.stride == 0 and step // self.stride < self.sample_steps

    def observe_epoch_length(self, n_steps: int) -> None:
        if self.sample_steps > 0 and n_steps > 0:
            self._next_stride = max(1, n_steps // self.sample_steps)

    def record_host(self, step: int, host_build_ms: float, h2d_ms: float,
                    feed_wait_ms: float = 0.0) -> None:
        self._host[step] = (host_build_ms, h2d_ms, feed_wait_ms)

    def record_compute(self, step: int, compute_ms: float, flops: float | None = None) -> None:
        """``flops``: the step's analytic forward + backward FLOPs."""
        self._compute[step] = (compute_ms, flops)

    def per_step(self) -> list[dict[str, float]]:
        out = []
        for step in sorted(self._compute):
            build, h2d, feed_wait = self._host.get(step, (0.0, 0.0, 0.0))
            compute_ms, flops = self._compute[step]
            rec = {"step": step, "host_build_ms": round(build, 3), "h2d_ms": round(h2d, 3),
                   "feed_wait_ms": round(feed_wait, 3), "compute_ms": round(compute_ms, 3)}
            flops = _coerce_flops(flops)
            if flops and self.peak_flops and compute_ms > 0:
                rec["mfu"] = round(flops / (compute_ms / 1e3) / self.peak_flops, 9)
            out.append(rec)
        return out

    def summary(self) -> dict[str, float] | None:
        """The mean of each column over the sampled steps; None before any."""
        steps = self.per_step()
        if not steps:
            return None
        n = len(steps)
        out = {key: round(sum(s[key] for s in steps) / n, 3)
               for key in ("host_build_ms", "h2d_ms", "feed_wait_ms", "compute_ms")}
        out["profiled_steps"] = n
        with_mfu = [s["mfu"] for s in steps if "mfu" in s]
        if with_mfu:
            out["mfu"] = round(sum(with_mfu) / len(with_mfu), 9)
        return out

    def reset(self) -> None:
        self._host.clear()
        self._compute.clear()
        self.stride = self._next_stride


class _End:
    """The end of the stream (the producer exhausted the iterator)."""


class _Raised:
    """A producer's exception and its formatted traceback."""

    def __init__(self, exc: BaseException, traceback_text: str):
        self.exc = exc
        self.traceback_text = traceback_text


class HostPrefetcher:
    """``(host_batch, device_batch)`` pairs, built ``depth`` ahead on a
    background thread. The host batch rides along for what the consumer
    reads on the host (labels, the example mask); ``to_device`` takes what
    the consumer needs of the ``[B, L]`` planes before the next pull, which
    may recycle them (``data/parallel_feed.py``)."""

    _PUT_POLL_S = 0.05  # how often a producer parked on a full queue checks for close()

    def __init__(self, batches: Iterable[dict], to_device: Callable[[dict], object],
                 depth: int = 2, profiler: StepProfiler | None = None,
                 stream: "torch.cuda.Stream | None" = None, drain_on_preemption: bool = False):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._batches = batches
        self._to_device = to_device
        self._profiler = profiler
        self._stream = stream
        self._drain = bool(drain_on_preemption)
        # lock-free: the handoff is the queue's own condition plus a stop event
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exhausted = False
        self._thread = threading.Thread(target=self._produce, name="c2v-host-prefetch",
                                        daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Queue ``item``, checking for close() while the queue is full;
        False when shutdown was asked for."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=self._PUT_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def _copy(self, batch):
        """``(device batch, event after its copies or None)``."""
        if self._stream is None:
            return self._to_device(batch), None
        with torch.cuda.stream(self._stream):
            out = self._to_device(batch)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return out, ready

    def _produce(self) -> None:
        it = iter(self._batches)
        step = 0
        guard = preemption_guard()
        tracer = get_tracer()
        try:
            while not self._stop.is_set():
                if self._drain and guard.requested():
                    self._put(_End)  # SIGTERM: end the train stream here
                    return
                faultinject.fault_point("prefetch_produce", step=step)
                # the queue's depth at this pull: how far ahead the producer runs
                spanned = _span_step(step, self._profiler)
                depth = self._queue.qsize()
                with (tracer.span("host_build", step=step, queue_depth=depth) if spanned
                      else _NO_SPAN):
                    t0 = time.perf_counter()
                    batch = next(it, _End)  # a yielded None must not end the stream
                if batch is _End:
                    self._put(_End)
                    return
                feed_wait_ms = getattr(it, "last_wait_ms", 0.0)
                t1 = time.perf_counter()
                with tracer.span("h2d", step=step, queue_depth=depth) if spanned else _NO_SPAN:
                    out, ready = self._copy(batch)
                    if self._profiler is not None and self._profiler.sampled(step):
                        if ready is not None:
                            ready.synchronize()
                        self._profiler.record_host(step, (t1 - t0) * 1e3,
                                                   (time.perf_counter() - t1) * 1e3,
                                                   feed_wait_ms)
                if not self._put((batch, out, ready)):
                    return
                step += 1
        except BaseException as exc:  # noqa: BLE001 - re-raised at the consumer
            self._put(_Raised(exc, traceback.format_exc()))
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()  # the generator's finally blocks run now

    def __iter__(self) -> Iterator[tuple[dict, object]]:
        return self

    def __next__(self) -> tuple[dict, object]:
        if self._exhausted:
            raise StopIteration
        item = self._queue.get()
        if item is _End:
            self._exhausted = True
            self._thread.join()
            raise StopIteration
        if isinstance(item, _Raised):
            self._exhausted = True
            self._thread.join()
            if not getattr(item.exc, "remote_traceback", None):
                try:
                    item.exc.remote_traceback = item.traceback_text
                except AttributeError:  # an exception type with __slots__
                    pass
            raise item.exc
        batch, out, ready = item
        if ready is not None:
            # the step's stream waits for the copies; the allocator learns
            # that stream reads the tensors
            current = torch.cuda.current_stream(self._stream.device)
            current.wait_event(ready)
            for t in _tensors(out):
                t.record_stream(current)
        return batch, out

    def close(self) -> None:
        """Stop the producer and join its thread; safe twice, and after
        the end of the stream (an early stop, a raising step)."""
        self._stop.set()
        while True:  # unblock a producer parked on put()
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=10.0)
        self._exhausted = True

    def __enter__(self) -> "HostPrefetcher":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()


class _SyncBatches:
    """The synchronous twin of :class:`HostPrefetcher`: the same pairs and
    profiler stamps, no thread."""

    def __init__(self, batches: Iterable[dict], to_device: Callable[[dict], object],
                 profiler: StepProfiler | None = None, device: torch.device | None = None):
        self._it = iter(batches)
        self._to_device = to_device
        self._profiler = profiler
        self._device = torch.device(device) if device is not None else None
        self._step = 0

    def __iter__(self) -> Iterator[tuple[dict, object]]:
        return self

    def __next__(self) -> tuple[dict, object]:
        tracer = get_tracer()
        spanned = _span_step(self._step, self._profiler)
        t0 = time.perf_counter()
        with tracer.span("host_build", step=self._step) if spanned else _NO_SPAN:
            batch = next(self._it)  # StopIteration ends the epoch
        feed_wait_ms = getattr(self._it, "last_wait_ms", 0.0)
        sampled = self._profiler is not None and self._profiler.sampled(self._step)
        if sampled and self._device is not None and self._device.type == "cuda":
            # the copies queue behind the steps already enqueued on this
            # stream: drain them first, so h2d_ms is the copy's own time
            torch.cuda.current_stream(self._device).synchronize()
        t1 = time.perf_counter()
        with tracer.span("h2d", step=self._step) if spanned else _NO_SPAN:
            out = self._to_device(batch)
            if sampled:
                _sync_current_stream(out)
                self._profiler.record_host(self._step, (t1 - t0) * 1e3,
                                           (time.perf_counter() - t1) * 1e3, feed_wait_ms)
        self._step += 1
        return batch, out

    def close(self) -> None:
        close = getattr(self._it, "close", None)
        if close is not None:
            close()

    def __enter__(self) -> "_SyncBatches":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()


def device_batches(batches: Iterable[dict], to_device: Callable[[dict], object],
                   prefetch: int = 0, profiler: StepProfiler | None = None,
                   device: torch.device | None = None, drain_on_preemption: bool = False):
    """The epoch loops' feed: a context manager iterating ``(host_batch,
    to_device(host_batch))`` pairs, prefetched ``prefetch`` deep on a
    thread (its copies on a CUDA stream of its own when ``device`` is a
    card) or synchronous for 0; the same pairs in the same order either
    way. ``drain_on_preemption`` lets the producer end a TRAIN stream
    early once the SIGTERM guard is set (JAX ``prefetch.py:436-456``)."""
    if prefetch > 0:
        stream = (torch.cuda.Stream(device) if device is not None
                  and torch.device(device).type == "cuda" else None)
        return HostPrefetcher(batches, to_device, depth=prefetch, profiler=profiler,
                              stream=stream, drain_on_preemption=drain_on_preemption)
    return _SyncBatches(batches, to_device, profiler=profiler, device=device)
