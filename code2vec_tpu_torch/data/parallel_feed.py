"""Parallel host ingest: batch builds on forked worker processes.

Own copy of ``code2vec_tpu/data/parallel_feed.py``. :class:`ParallelFeed`
wraps a :class:`~code2vec_tpu_torch.data.pipeline.BatchSource` behind the
same protocol and executes its batch plans on ``--feed_workers N``
processes of one :class:`FeedPool`:

- **The generator stays on the coordinator.** The source's
  ``plan_batches(rng, shuffle)`` makes every draw its ``batches()`` would,
  in order; a worker only runs the pure ``execute_plan``. The feed order,
  and so the loss history, is bit for bit that of ``--feed_workers 0``.
- **Shared-memory arenas.** A worker writes its batch into a slot of
  ``multiprocessing.shared_memory``; the consumer gets numpy views of the
  slot, no batch is pickled. The corpus arrays are
  inherited by the fork: an mmap-backed corpus stays one shared mapping,
  in-RAM arrays copy-on-write pages.
- **In order.** Results are resequenced, so the stream is the sync one.
- **Recycling.** A slot is reused at the consumer's next pull. The
  ``[B, L]`` planes are read by ``train/step.to_device`` before that pull
  (it copies them: into owned tensors on the CPU, into pinned memory on
  the card), and the small per-row fields are delivered as owned copies.
  A consumer that holds batches across pulls copies them (JAX's ``copy``
  delivery exists for a ``device_put`` that aliases host memory, which
  ``to_device`` never does).
- **Failures.** A worker's exception re-raises on the coordinator as
  :class:`FeedWorkerError` with the child's traceback; a killed worker is
  found by polling and fails the stream instead of hanging it.

The workers run numpy only: they touch no ``torch`` API, so forking a
process whose CUDA context is live is safe. Start the pool before any
thread of the run (the prefetcher's); ``obs.sync.guard_fork_safety`` warns
when a non-daemon thread is alive at that point.
"""

from __future__ import annotations

import collections
import multiprocessing
import os
import queue as queue_mod
import time
import traceback
import warnings
import weakref
from dataclasses import dataclass
from multiprocessing import shared_memory

import numpy as np

from code2vec_tpu_torch.data.pipeline import BatchSource, execute_plan, plan_real_slots
from code2vec_tpu_torch.obs.sync import guard_fork_safety

__all__ = ["FeedPool", "FeedWorkerError", "ParallelFeed", "guard_fork_safety"]

_POLL_S = 0.2  # how often a waiting pull checks that the workers live


class FeedWorkerError(RuntimeError):
    """A feed worker failed (an exception or its death).
    ``remote_traceback`` is the child's traceback when one crossed the
    process boundary (a killed worker has none)."""

    def __init__(self, message: str, remote_traceback: str | None = None):
        if remote_traceback:
            message = f"{message}\n--- feed worker traceback ---\n{remote_traceback.rstrip()}"
        super().__init__(message)
        self.remote_traceback = remote_traceback


@dataclass
class _CorpusArrays:
    """The slim corpus view a worker builds from, taken before the fork so
    the worker never touches the vocabs and string lists (refcounting
    would dirty their copy-on-write pages)."""

    starts: np.ndarray
    paths: np.ndarray
    ends: np.ndarray
    row_splits: np.ndarray
    ids: np.ndarray
    labels: np.ndarray
    method_token_index: int | None

    @classmethod
    def from_data(cls, data) -> "_CorpusArrays":
        return cls(starts=data.starts, paths=data.paths, ends=data.ends,
                   row_splits=data.row_splits, ids=data.ids, labels=data.labels,
                   method_token_index=data.method_token_index)


class _ArenaLayout:
    """The byte offsets of one slot: the per-row fields first, then three
    ``[B, max_width]`` int32 planes (64-byte aligned); a narrower batch
    is a C-contiguous ``[B, width]`` block at each plane's base."""

    def __init__(self, batch_size: int, max_width: int):
        self.batch_size = int(batch_size)
        self.max_width = int(max_width)
        plane = self.batch_size * self.max_width * 4
        self.off_ids = 0
        self.off_labels = self.off_ids + self.batch_size * 8
        self.off_mask = self.off_labels + self.batch_size * 4
        base = -(-(self.off_mask + self.batch_size * 4) // 64) * 64
        self.off_starts, self.off_paths, self.off_ends = base, base + plane, base + 2 * plane
        self.slot_bytes = base + 3 * plane

    def views(self, buf, width: int) -> dict[str, np.ndarray]:
        """The slot's numpy views at ``width`` (no copies)."""
        b = self.batch_size
        return {
            "ids": np.ndarray((b,), np.int64, buffer=buf, offset=self.off_ids),
            "labels": np.ndarray((b,), np.int32, buffer=buf, offset=self.off_labels),
            "example_mask": np.ndarray((b,), np.float32, buffer=buf, offset=self.off_mask),
            "starts": np.ndarray((b, width), np.int32, buffer=buf, offset=self.off_starts),
            "paths": np.ndarray((b, width), np.int32, buffer=buf, offset=self.off_paths),
            "ends": np.ndarray((b, width), np.int32, buffer=buf, offset=self.off_ends),
        }


def _feed_worker_main(arrays, shms, layout, task_q, result_q):
    """A worker: take ``(gen, seq, slot, plan)``, build, write the batch
    into the slot, post the result (or the error with its traceback)."""
    from code2vec_tpu_torch.obs.trace import set_tracer

    set_tracer(None)  # a forked copy of the parent's tracer is never exported
    bufs = [shm.buf for shm in shms]
    while True:
        task = task_q.get()
        if task is None:
            return
        gen, seq, slot, plan = task
        try:
            batch = execute_plan(arrays, plan)
            for key, view in layout.views(bufs[slot], int(plan.width)).items():
                view[...] = batch[key]
            result_q.put(("ok", gen, seq, slot, int(plan.width)))
        except BaseException as exc:  # noqa: BLE001 - shipped to the coordinator
            result_q.put(("error", gen, seq, slot, f"{type(exc).__name__}: {exc}",
                          traceback.format_exc()))


class FeedPool:
    """``n_workers`` forked builders and a shared-memory arena, shared by
    every :class:`ParallelFeed` of a run (the train and test splits). One
    stream runs at a time, as the epoch loop runs them. With ``health``
    (``obs.runtime.RuntimeHealth``) each pull sets the ``feed.queue_depth``
    gauge (batches built and waiting) and counts a pull that had to wait
    on the workers in ``feed.starved_steps``."""

    def __init__(self, data, n_workers: int, batch_size: int, max_width: int, slots: int = 0,
                 health=None):
        if n_workers < 1:
            raise ValueError(f"feed_workers must be >= 1, got {n_workers}")
        if os.name != "posix":
            raise ValueError("--feed_workers requires fork-capable multiprocessing (POSIX); "
                             "use --feed_workers 0 here")
        self.n_workers = int(n_workers)
        self._health = health
        # every worker can build while a full reorder window and the
        # delivered batch stay held
        self.slots = int(slots) if slots else 2 * self.n_workers + 2
        self._layout = _ArenaLayout(batch_size, max_width)
        guard_fork_safety("FeedPool")
        ctx = multiprocessing.get_context("fork")
        self._shms = [shared_memory.SharedMemory(create=True, size=self._layout.slot_bytes)
                      for _ in range(self.slots)]
        self._task_q = ctx.Queue()
        self._result_q = ctx.Queue()
        arrays = _CorpusArrays.from_data(data)
        self._procs = [ctx.Process(target=_feed_worker_main,
                                   args=(arrays, self._shms, self._layout, self._task_q,
                                         self._result_q),
                                   name=f"c2v-feed-worker-{wid}", daemon=True)
                       for wid in range(self.n_workers)]
        with warnings.catch_warnings():
            # Python warns on any fork of a threaded process (torch runs
            # thread pools); the workers run numpy only and take no lock of
            # the parent's, and guard_fork_safety above reports the threads
            # that could hold one
            warnings.filterwarnings("ignore", message=r".*fork\(\)", category=DeprecationWarning)
            for p in self._procs:
                p.start()
        self._free: collections.deque[int] = collections.deque(range(self.slots))
        self._gen = 0
        self._active: _FeedStream | None = None
        self._closed = False
        # a crash between the pool's creation and its owner's finally must
        # leak no worker and no shared-memory segment
        self._finalizer = weakref.finalize(self, _release_pool_resources, self._procs,
                                           self._shms)

    def run(self, plans, feed: "ParallelFeed | None" = None) -> "_FeedStream":
        if self._closed:
            raise RuntimeError("feed pool is closed")
        if self._active is not None and not self._active.finished:
            raise RuntimeError("a feed stream is already active on this pool; close or "
                               "exhaust it before starting another")
        self._gen += 1
        self._active = _FeedStream(self, plans, self._gen, feed)
        return self._active

    def worker_failed(self, wid_or_msg: str, tb_text: str) -> FeedWorkerError:
        """The error a failed build raises on the coordinator, with the
        worker's traceback."""
        return FeedWorkerError(f"feed worker build failed: {wid_or_msg}",
                               remote_traceback=tb_text)

    def check_workers(self) -> None:
        for wid, p in enumerate(self._procs):
            if not p.is_alive():
                raise FeedWorkerError(
                    f"feed worker {wid} died (exit code {p.exitcode}) without reporting an "
                    "error: killed or crashed hard; restart the run (the pool cannot "
                    "continue safely)")

    def close(self) -> None:
        """Stop the workers and release the arena; idempotent, and safe
        after a worker died (a straggler is terminated)."""
        if self._closed:
            return
        self._closed = True
        self._gen += 1  # orphans any result still in flight
        for p in self._procs:
            if p.is_alive():
                try:
                    self._task_q.put(None)
                except (OSError, ValueError):
                    break
        deadline = time.monotonic() + 5.0
        for p in self._procs:
            p.join(timeout=max(deadline - time.monotonic(), 0.1))
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
        for q in (self._task_q, self._result_q):
            q.cancel_join_thread()
            q.close()
        self._finalizer()

    def __enter__(self) -> "FeedPool":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()


def _release_pool_resources(procs, shms) -> None:
    """The last-resort teardown behind :meth:`FeedPool.close`: terminate
    stragglers, unlink the arena's segments."""
    for p in procs:
        if p.is_alive():
            p.terminate()
    for shm in shms:
        try:
            shm.unlink()
        except FileNotFoundError:
            pass
        try:
            shm.close()
        except BufferError:
            pass  # a delivered view still maps it; the mapping goes with the view


class _FeedStream:
    """One epoch's ordered stream off the pool, iterated as the wrapped
    source's ``batches()`` is. ``last_wait_ms``: how long the previous pull
    waited on the workers (the profiler's ``feed_wait_ms``)."""

    def __init__(self, pool: FeedPool, plans, gen: int, feed):
        self._pool = pool
        self._plans = iter(plans)
        self._gen = gen
        self._feed = feed
        self._next_seq = 0
        self._submit_seq = 0
        self._plans_done = False
        self._ready: dict[int, tuple] = {}
        self._delivered_slot: int | None = None
        self._real = 0
        self._slots_total = 0
        self.finished = False
        self.last_wait_ms = 0.0

    def __iter__(self) -> "_FeedStream":
        return self

    def _submit_more(self) -> None:
        pool = self._pool
        while not self._plans_done and pool._free:
            try:
                plan = next(self._plans)
            except StopIteration:
                self._plans_done = True
                self._close_plans()
                break
            slot = pool._free.popleft()
            if self._feed is not None:
                real, slots = plan_real_slots(plan, self._feed.row_splits)
                self._real += real
                self._slots_total += slots
            pool._task_q.put((self._gen, self._submit_seq, slot, plan))
            self._submit_seq += 1

    def _close_plans(self) -> None:
        close = getattr(self._plans, "close", None)
        if close is not None:
            close()

    def _recycle_delivered(self) -> None:
        if self._delivered_slot is not None:
            self._pool._free.append(self._delivered_slot)
            self._delivered_slot = None

    def _handle(self, msg) -> None:
        kind, gen = msg[0], msg[1]
        if gen != self._gen:  # a closed stream's straggler: reclaim its slot
            self._pool._free.append(msg[3])
            return
        if kind == "error":
            _, _, _, slot, summary, tb_text = msg
            self._pool._free.append(slot)
            self._fail()
            raise self._pool.worker_failed(summary, tb_text)
        _, _, seq, slot, width = msg
        self._ready[seq] = (slot, width)

    def _check_workers(self) -> None:
        try:
            self._pool.check_workers()
        except FeedWorkerError:
            self._fail()
            raise

    def __next__(self) -> dict[str, np.ndarray]:
        if self.finished:
            raise StopIteration
        self._recycle_delivered()
        self._submit_more()
        if self._plans_done and self._next_seq >= self._submit_seq:
            self._finish()
            raise StopIteration
        pool = self._pool
        self._check_workers()  # a dead worker fails the stream now
        waited = self._next_seq not in self._ready
        t0 = time.perf_counter()
        while self._next_seq not in self._ready:
            try:
                msg = pool._result_q.get(timeout=_POLL_S)
            except queue_mod.Empty:
                self._check_workers()
                continue
            self._handle(msg)
            self._submit_more()
        self.last_wait_ms = (time.perf_counter() - t0) * 1e3 if waited else 0.0
        if pool._health is not None:
            pool._health.gauge("feed.queue_depth").set(len(self._ready))
            if waited:
                pool._health.counter("feed.starved_steps").inc()
        slot, width = self._ready.pop(self._next_seq)
        self._next_seq += 1
        views = pool._layout.views(pool._shms[slot].buf, width)
        # the [B, L] planes stay views until the next pull; the per-row
        # fields are owned, for a consumer that reads them later
        self._delivered_slot = slot
        return dict(views, ids=np.array(views["ids"]), labels=np.array(views["labels"]),
                    example_mask=np.array(views["example_mask"]))

    def _publish_pad(self) -> None:
        if self._feed is not None and self._slots_total:
            self._feed._last_pad = (self._real, self._slots_total)

    def _finish(self) -> None:
        self.finished = True
        self._recycle_delivered()
        self._publish_pad()

    def _fail(self) -> None:
        """Abandon the stream: ready slots are freed now, slots still being
        built are reclaimed by the next stream's generation check."""
        self.finished = True
        self._recycle_delivered()
        for slot, _ in self._ready.values():
            self._pool._free.append(slot)
        self._ready.clear()
        self._publish_pad()

    def close(self) -> None:
        """An early end (the epoch aborted): free what the stream holds."""
        if self.finished:
            return
        self._close_plans()
        self._plans_done = True
        self._fail()


class ParallelFeed(BatchSource):
    """A :class:`BatchSource` whose wrapped source's plans run on a
    :class:`FeedPool`. ``ladder`` is the wrapped source's; ``last_epoch``
    stays None (no epoch exists on the coordinator), so the export and
    ``print_sample`` build theirs on demand."""

    def __init__(self, source: BatchSource, pool: FeedPool):
        self._source = source
        self._pool = pool
        self.ladder = source.ladder
        self.last_epoch = None
        self.row_splits = source.data.row_splits
        self._last_pad = None
        # fail when wrapping, not at the first epoch: a source without the
        # plan split (or with the variable task) raises here
        probe = source.plan_batches(np.random.default_rng(0))
        close = getattr(probe, "close", None)
        if close is not None:
            close()

    def batches(self, rng: np.random.Generator, shuffle: bool = True) -> _FeedStream:
        return self._pool.run(self._source.plan_batches(rng, shuffle), feed=self)
