"""The serving engine: every (micro-batch, bag width) shape warmed at start.

Counterpart of ``code2vec_tpu/serve/engine.py``. Request shapes are a
small static set — ``len(ladder) x len(batch_sizes)`` — and
:meth:`ServingEngine.prepare` runs one forward at each before traffic, so
the first request of a shape pays no first-launch costs (kernel builds
and module loads, cuBLAS handles, allocator growth). A shape first met
after warmup is counted in :attr:`post_warmup_compiles`, the number a
warmed server keeps at zero. CUDA graphs come in a later slice.

The ladder is the Predictor's: the one recorded in ``model_meta.json``
(plus any ``--longbag_widths``), else the geometric ladder below the
training bag. ``base_width`` is the training bag; rungs above it raise
``max_width`` to the top rung, so a request of up to that many contexts
serves through a warmed long-bag shape (K4 on the card) and only a longer
one is rejected.
"""

from __future__ import annotations

import logging
import threading
import time

import numpy as np
import torch

from code2vec_tpu_torch import PAD_INDEX
from code2vec_tpu_torch.data.pipeline import nearest_bucket_width

logger = logging.getLogger(__name__)

DEFAULT_BATCH_SIZES = (1, 8)


class ServingEngine:
    """Warmed forwards for every (micro-batch size, bucket width) shape of
    one :class:`~code2vec_tpu_torch.predict.Predictor`. Device work is
    serialized behind one lock: the micro-batcher is the steady-state
    caller, warmup and ad-hoc calls must not interleave with it."""

    def __init__(self, predictor, batch_sizes: tuple[int, ...] = DEFAULT_BATCH_SIZES) -> None:
        if not batch_sizes or any(b < 1 for b in batch_sizes):
            raise ValueError(f"batch_sizes must be >= 1, got {batch_sizes!r}")
        self.predictor = predictor
        self.device = predictor.device
        self.table_dtype = predictor.table_dtype
        # the training bag (requests up to here always serve) and the top
        # rung (long-bag rungs raise it above the training bag)
        self.base_width = int(predictor.base_bag)
        self.max_width = int(predictor.bag)
        self.ladder: tuple[int, ...] = predictor.ladder
        if self.max_width > self.base_width:
            logger.info("long-bag rungs above the training bag %d: requests up to %d contexts "
                        "serve through the streamed-softmax kernel", self.base_width,
                        self.max_width)
        self.batch_sizes = tuple(sorted({int(b) for b in batch_sizes}))
        self._lock = threading.Lock()
        self._warm: set[tuple[int, int]] = set()
        self._warmed = False
        self._n_post_warmup = 0
        self.warmup_ms: dict[tuple[int, int], float] = {}

    # ---- warmup ---------------------------------------------------------
    @property
    def post_warmup_compiles(self) -> int:
        return self._n_post_warmup

    def executables(self) -> int:
        return len(self._warm)

    def prepare(self) -> dict[tuple[int, int], float]:
        """Run one forward at every (batch, width) shape; returns the
        milliseconds each first run took (synchronised)."""
        with self._lock:
            for w in self.ladder:
                for b in self.batch_sizes:
                    if (b, w) not in self._warm:
                        self.warmup_ms[(b, w)] = self._first_run(b, w)
            self._warmed = True
            return dict(self.warmup_ms)

    def _first_run(self, b: int, w: int) -> float:
        ids = np.full((b, w), PAD_INDEX, np.int32)
        t0 = time.perf_counter()
        out = self.predictor.forward(ids, ids, ids)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        del out
        self._warm.add((b, w))
        if self._warmed:
            self._n_post_warmup += 1
            logger.warning(
                "post-warmup first run of shape (%d, %d): the ladder or batch "
                "sizes do not cover the traffic", b, w,
            )
        return round((time.perf_counter() - t0) * 1e3, 3)

    # ---- hot path -------------------------------------------------------
    def width_for(self, count: int) -> int:
        return nearest_bucket_width(min(max(int(count), 1), self.max_width), self.ladder)

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
                self.warmup_ms[key] = self._first_run(*key)
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
