"""The serving engine: every (micro-batch, bag width) shape warmed at start.

Counterpart of ``code2vec_tpu/serve/engine.py``. Request shapes are a
small static set — ``len(ladder) x len(batch_sizes)`` — and
:meth:`ServingEngine.prepare` runs one forward at each before traffic, so
the first request of a shape pays no first-launch costs (kernel builds
and module loads, cuBLAS handles, allocator growth). A shape first met
after warmup is counted in :attr:`post_warmup_compiles`, the number a
warmed server keeps at zero. CUDA graphs come in a later slice.

Ladder sources, in order:

1. the ladder recorded in ``model_meta.json`` at train time (plus any
   ``--longbag_widths`` rungs above it): the Predictor's;
2. absent that, a width histogram of the live request stream: until
   ``warmup_requests`` requests have been observed every request runs at
   the top width, then the ladder is derived from the observed histogram
   (``data/pipeline.derive_bucket_ladder_hist``) and warmed once
   (:meth:`ServingEngine.observe_width`).

``base_width`` is the training bag; rungs above it raise ``max_width`` to
the top rung, so a request of up to that many contexts serves through a
warmed long-bag shape (K4 on the card) and only a longer one is rejected.

Schedule provenance: before the warm runs the engine consults the
autotuner's cache for every (batch, width) shape (``ops/autotune
.consult_schedules``, JAX ``_consult``): each provenance record carries
the shape's ``schedule``, ``schedule_cached`` and ``kernel_backend``
(``"gpu"`` or ``"cpu"``). Misses are recorded, never searched. Under
``pallas_impl="auto"`` the forward then runs the route each shape's
cached schedule names.

Observability: ``serve_executable_compile`` (warmed shapes),
``serve_forward`` and ``serve_post_warmup_compile`` counters and the
``serve_executables`` gauge on the shared registry (the JAX names), a
``serve_executable`` event per warmed shape, an ``engine_run`` span per
forward, and per-shape device time folded into MFU by a
:class:`~code2vec_tpu_torch.obs.costs.CostAccountant` over the analytic
forward cost (:meth:`perf_summary`).
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from code2vec_tpu_torch import PAD_INDEX
from code2vec_tpu_torch.data.pipeline import derive_bucket_ladder_hist, nearest_bucket_width
from code2vec_tpu_torch.obs import costs as obs_costs
from code2vec_tpu_torch.obs.runtime import RuntimeHealth, global_health
from code2vec_tpu_torch.obs.sync import make_rlock
from code2vec_tpu_torch.obs.trace import current_trace_scope, get_tracer

logger = logging.getLogger(__name__)

DEFAULT_BATCH_SIZES = (1, 8)


class ServingEngine:
    """Warmed forwards for every (micro-batch size, bucket width) shape of
    one :class:`~code2vec_tpu_torch.predict.Predictor`. Device work is
    serialized behind one lock: the micro-batcher is the steady-state
    caller, warmup and ad-hoc calls must not interleave with it.

    ``ladder``: the widths to warm; by default the Predictor's when its
    meta recorded one or it carries long-bag rungs, else None — the
    request-histogram fallback."""

    _DEFAULT = object()

    def __init__(self, predictor, batch_sizes: tuple[int, ...] = DEFAULT_BATCH_SIZES, *,
                 ladder=_DEFAULT, warmup_requests: int = 64,
                 health: RuntimeHealth | None = None, events=None,
                 version: str = "v0", autotune_cache: str | None = None) -> None:
        if not batch_sizes or any(b < 1 for b in batch_sizes):
            raise ValueError(f"batch_sizes must be >= 1, got {batch_sizes!r}")
        self.predictor = predictor
        self.device = predictor.device
        self.table_dtype = predictor.table_dtype
        # which model version this engine serves: hot-swap builds one
        # engine per generation and the events must say whose shapes they are
        self.version = str(version)
        # the training bag (requests up to here always serve) and the top
        # rung (long-bag rungs raise it above the training bag)
        self.base_width = int(predictor.base_bag)
        self.max_width = int(predictor.bag)
        if ladder is ServingEngine._DEFAULT:
            known = predictor.ladder_recorded or self.max_width > self.base_width
            ladder = predictor.ladder if known else None
        self.ladder: tuple[int, ...] | None = tuple(int(w) for w in ladder) if ladder else None
        if self.ladder and self.ladder[-1] != self.max_width:
            raise ValueError(f"ladder must end at the top width {self.max_width}, got "
                             f"{self.ladder}")
        if self.max_width > self.base_width:
            logger.info("long-bag rungs above the training bag %d: requests up to %d contexts "
                        "serve through the streamed-softmax kernel", self.base_width,
                        self.max_width)
        self.batch_sizes = tuple(sorted({int(b) for b in batch_sizes}))
        self.warmup_requests = int(warmup_requests)
        self._health = health or global_health()
        # the schedule cache consulted at warmup (None = the process's pinned one)
        self._autotune_cache = autotune_cache or None
        self._events = events
        self._lock = make_rlock("engine")
        self._warm: set[tuple[int, int]] = set()
        self._width_histogram: dict[int, int] = {}
        self._warmed = False
        self._n_post_warmup = 0
        self.warmup_ms: dict[tuple[int, int], float] = {}
        self.provenance: list[dict] = []
        meta = predictor.meta
        self._costs = obs_costs.CostAccountant(
            device_kind=obs_costs.detect_device_kind(),
            health=self._health,
        )
        self._dims = (int(meta["terminal_embed_size"]), int(meta["path_embed_size"]),
                      int(meta["encode_size"]), int(meta["label_count"]))
        self._compile_counter = self._health.counter("serve_executable_compile")
        self._forward_counter = self._health.counter("serve_forward")
        self._post_warmup_counter = self._health.counter("serve_post_warmup_compile")

    @classmethod
    def from_predictor(cls, predictor, **kw) -> "ServingEngine":
        """The engine of a loaded Predictor (JAX ``engine.py:144``): only a
        ladder its checkpoint recorded flows through (None otherwise: the
        live requests' histogram picks one); ``kw`` overrides."""
        kw.setdefault("ladder", predictor.ladder if predictor.ladder_recorded else None)
        return cls(predictor, **kw)

    # ---- warmup ---------------------------------------------------------
    @property
    def post_warmup_compiles(self) -> int:
        return self._n_post_warmup

    def executables(self) -> int:
        return len(self._warm)

    @property
    def active_ladder(self) -> tuple[int, ...]:
        """The ladder requests pad to RIGHT NOW: the resolved ladder, or
        just the top width while the histogram fallback is observing."""
        return self.ladder if self.ladder else (self.max_width,)

    def observe_width(self, count: int) -> None:
        """Histogram fallback: record one request's context count; once
        ``warmup_requests`` are seen, derive the ladder from the histogram
        and warm its shapes."""
        if self.ladder is not None:
            return
        with self._lock:
            if self.ladder is not None:  # froze while we waited on the lock
                return
            width = min(int(count), self.max_width)
            self._width_histogram[width] = self._width_histogram.get(width, 0) + 1
            n_seen = sum(self._width_histogram.values())
            if n_seen < self.warmup_requests:
                return
            widths = sorted(self._width_histogram)
            ladder = derive_bucket_ladder_hist(
                np.asarray(widths, np.int64),
                np.asarray([self._width_histogram[w] for w in widths], np.int64),
                self.max_width,
            )
            logger.info("request-stream histogram froze the serving ladder at %s (%d samples)",
                        list(ladder), n_seen)
            self.ladder = ladder
            self._warmed = False
            self.prepare()

    def prepare(self) -> list[dict]:
        """Run one forward at every (batch, width) shape of the active
        ladder (idempotent); returns one record per warmed shape (its
        first run's synchronised milliseconds and analytic cost)."""
        with self._lock:
            shapes = [(b, w) for w in self.active_ladder for b in self.batch_sizes]
            schedules = self._consult(shapes)
            for b, w in shapes:
                if (b, w) not in self._warm:
                    self._first_run(b, w, schedules.get((b, w)))
            self._warmed = True
            self._health.gauge("serve_executables").set(len(self._warm))
            return list(self.provenance)

    def _consult(self, shapes: list[tuple[int, int]]) -> dict[tuple[int, int], dict]:
        """The schedule cache's record of every shape (JAX ``_consult``);
        misses are recorded, never searched."""
        from code2vec_tpu_torch.ops.autotune import ShapeKey, consult_schedules, device_kind, \
            get_cache

        te, pe, enc, _ = self._dims
        kind = device_kind(self.device)
        keys = [ShapeKey(device_kind=kind, batch=b, width=w, terminal_embed=te, path_embed=pe,
                         encode=enc, table_dtype=self.table_dtype) for b, w in shapes]
        records = consult_schedules(keys, cache=get_cache(self._autotune_cache),
                                    device=self.device)
        return dict(zip(shapes, records))

    def _first_run(self, b: int, w: int, schedule: dict | None = None) -> float:
        ids = np.full((b, w), PAD_INDEX, np.int32)
        t0 = time.perf_counter()
        with get_tracer().span("serve_compile", category="serve", batch=b, width=w):
            out = self.predictor.forward(ids, ids, ids)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        del out
        ms = round((time.perf_counter() - t0) * 1e3, 3)
        self._warm.add((b, w))
        self.warmup_ms[(b, w)] = ms
        self._compile_counter.inc()
        post = self._warmed
        if post:
            self._n_post_warmup += 1
            self._post_warmup_counter.inc()
            logger.warning(
                "post-warmup first run of shape (%d, %d): the ladder or batch "
                "sizes do not cover the traffic", b, w,
            )
        te, pe, enc, labels = self._dims
        cost = obs_costs.analytic_forward_cost(b, w, terminal_embed=te, path_embed=pe,
                                               encode=enc, labels=labels,
                                               table_dtype=self.table_dtype)
        self._costs.register((b, w), cost)
        schedule = schedule or {}
        record = {"batch": b, "width": w, "version": self.version,
                  "table_dtype": self.table_dtype,
                  "kernel_backend": "gpu" if self.device.type == "cuda" else "cpu",
                  "compile_ms": ms, "schedule": schedule.get("schedule"),
                  "schedule_cached": schedule.get("cached"), "cost": cost}
        if post:
            record["post_warmup"] = True
        self.provenance.append(record)
        if self._events is not None:
            self._events.emit("serve_executable", **record)
        return ms

    # ---- cost accounting ------------------------------------------------
    def record_device_time(self, batch: int, width: int, device_ms: float,
                           requests: int = 1) -> None:
        """Fold one fenced device span into the perf accounting (the
        batcher's ``device_ms``; O(1), no new timers or syncs)."""
        self._costs.record((batch, width), device_ms, requests=requests)

    def perf_summary(self) -> dict:
        """The perf block: device time, achieved FLOP/s, MFU, per shape."""
        return self._costs.snapshot()

    # ---- hot path -------------------------------------------------------
    def width_for(self, count: int) -> int:
        return nearest_bucket_width(min(max(int(count), 1), self.max_width), self.active_ladder)

    def batch_size_for(self, n_requests: int) -> int:
        for b in self.batch_sizes:
            if n_requests <= b:
                return b
        return self.batch_sizes[-1]

    def run(self, starts: np.ndarray, paths: np.ndarray, ends: np.ndarray):
        """One forward at an exact ``[B, L]`` shape; returns
        ``(logits, code_vector, attention)`` as host numpy arrays."""
        key = (int(starts.shape[0]), int(starts.shape[1]))
        with self._lock:
            if key not in self._warm:
                self._first_run(*key)
                self._health.gauge("serve_executables").set(len(self._warm))
            self._forward_counter.inc()
            with get_tracer().span("engine_run", category="serve", batch=key[0], width=key[1],
                                   version=self.version, **current_trace_scope()):
                logits, cv, attn = self.predictor.forward(starts, paths, ends)
                return logits.cpu().numpy(), cv.cpu().numpy(), attn.cpu().numpy()

    def pad_requests(self, contexts: list[np.ndarray]):
        """Pack per-request ``[n_i, 3]`` id arrays into one padded batch:
        ``(starts, paths, ends, batch, width)``; width is the nearest
        ladder width of the longest member, spare rows are all-PAD."""
        n = len(contexts)
        if n > self.batch_sizes[-1]:
            raise ValueError(
                f"{n} requests exceed the top micro-batch size {self.batch_sizes[-1]}"
            )
        longest = max(len(c) for c in contexts)
        if longest > self.max_width:
            raise ValueError(
                f"a request has {longest} contexts, more than the model's max bag "
                f"width {self.max_width}; subsample before packing"
            )
        width = self.width_for(longest)
        batch = self.batch_size_for(n)
        ids = np.full((3, batch, width), PAD_INDEX, np.int32)
        for i, arr in enumerate(contexts):
            arr = np.asarray(arr, np.int32).reshape(-1, 3)
            ids[:, i, : arr.shape[0]] = arr.T
        return ids[0], ids[1], ids[2], batch, width
