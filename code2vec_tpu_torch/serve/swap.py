"""Live checkpoint hot-swap: shadow-built generations, validated, atomic.

Counterpart of ``code2vec_tpu/serve/swap.py``. The serving unit of
rollout is a **generation**: one checkpoint's worth of serving state —
predictor (its tables resident on the card), warmed engine, micro-batcher,
retrieval index — bundled so it can be swapped as one pointer. A
``reload`` therefore:

1. **builds a shadow generation on a background thread** — loads the new
   checkpoint, warms its FULL bucket ladder (``ServingEngine.prepare``:
   every kernel it runs is built and launched once), loads its retrieval
   backend — while the active generation keeps serving untouched (its
   forwards and the shadow's share the card's default stream, so they
   interleave; the trickle's p99 during a swap says what that costs);
2. **validates it against a golden request set**
   (:func:`validate_generation`): every golden request must come out of
   the shadow engine's coalesced micro-batch BITWISE equal to its own
   batch-1 dispatch (the serving invariant: a row's reduction order is a
   function of its bag alone, ``ops/fused_encode_pool.py``), all outputs
   finite, ZERO post-warmup first runs during validation (the golden set
   sweeps every ladder rung, so a hole in the shadow ladder fails here,
   not in traffic), and — when a retrieval backend is present — recall@k
   against a brute-force NumPy reference over the same vectors bounded
   below (exact backends must hit 1.0; ANN backends their configured
   floor);
3. **swaps the serving pointer atomically** — one reference assignment
   under the controller lock. In-flight requests hold their OWN generation
   reference (``CodeServer.handle_async`` snapshots it at submission), so
   nothing is dropped: requests already submitted drain through the old
   generation's still-running batcher while new arrivals dispatch into the
   new one;
4. **keeps the old generation resident** — engine, tables on the card,
   batcher thread and all — so ``rollback`` is one pointer swap back and
   the next request reproduces the prior version's BITWISE-identical
   embeddings (same kernels, same quantized tables; nothing is rebuilt).
   Only when a LATER swap commits is the oldest generation finally
   drained and released: its batcher drains, and once the controller
   drops its last reference the caching allocator can hand its tables'
   blocks out again (``torch.cuda.memory_allocated`` returns to two
   generations' worth).

State machine (reported by the ``swap_status`` op)::

    idle --reload--> building --> validating --commit--> idle
                        |              |
                        +---failure----+--> idle (active unchanged,
                                            last_swap.outcome = "failed")

Failures never touch the active pointer: a build error or validation
miss closes the half-built shadow and records the error; serving
continues on the incumbent version.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from code2vec_tpu_torch.obs import handles
from code2vec_tpu_torch.obs.runtime import RuntimeHealth, global_health
from code2vec_tpu_torch.obs.sync import make_rlock

logger = logging.getLogger(__name__)

__all__ = [
    "Generation",
    "GoldenSet",
    "SwapController",
    "SwapValidationError",
    "validate_generation",
]


class SwapValidationError(RuntimeError):
    """The shadow generation failed golden validation — not swapped in."""


@dataclass
class Generation:
    """One checkpoint's worth of serving state, swappable as a unit."""

    version: str
    engine: object  # ServingEngine (full ladder warmed)
    batcher: object  # MicroBatcher bound to that engine
    predictor: object | None = None  # None for state-built benches/tests
    retrieval: object | None = None
    provenance: list = field(default_factory=list)
    created_unix: float = field(default_factory=time.time)
    # the file pool's direction [H] f32 on the host, read off the card once
    file_attention: np.ndarray | None = None

    def __post_init__(self) -> None:
        handles.track(self, "generation", name=str(self.version))

    def attention(self) -> np.ndarray:
        """The checkpoint's method-level attention vector (``embed_file``'s
        pool direction), cached."""
        if self.file_attention is None:
            self.file_attention = self.predictor.attention_vector()
        return self.file_attention

    def close(self, timeout: float | None = None) -> None:
        """Drain and stop this generation's batcher and release its
        retrieval backend (idempotent). Argument-free call keeps
        duck-typed batcher stand-ins (tests) working; MicroBatcher's own
        default drain timeout applies.
        """
        del timeout
        self.batcher.close()
        close_retrieval = getattr(self.retrieval, "close", None)
        if close_retrieval is not None:
            close_retrieval()
        handles.untrack(self)


@dataclass
class GoldenSet:
    """Deterministic validation workload swept across the shadow ladder.

    Requests are synthesized per-validated-generation (seeded rng, ids
    bounded by THAT generation's vocab tables) with ``n_per_width``
    requests at and just under every ladder rung — so every shadow
    shape the traffic could hit is exercised before it serves.
    ``n_terminals``/``n_paths`` override the id bounds for generations
    without a predictor (bench/tests build engines straight from a train
    state); with a predictor they come from its ``model_meta.json``.
    """

    n_per_width: int = 2
    seed: int = 0
    min_recall: float = 0.9
    recall_k: int = 10
    n_queries: int = 8
    n_terminals: int | None = None
    n_paths: int | None = None

    def requests_for(self, gen: Generation) -> list[np.ndarray]:
        """The ``[n, 3]`` mapped-context arrays to validate ``gen`` with."""
        n_terminals = self.n_terminals
        n_paths = self.n_paths
        if n_terminals is None or n_paths is None:
            if gen.predictor is None:
                raise ValueError(
                    "GoldenSet needs n_terminals/n_paths when the "
                    "generation has no predictor to read them from"
                )
            n_terminals = n_terminals or int(
                gen.predictor.meta["terminal_count"]
            )
            n_paths = n_paths or int(gen.predictor.meta["path_count"])
        rng = np.random.default_rng(self.seed)
        requests = []
        for width in gen.engine.active_ladder:
            for j in range(self.n_per_width):
                n = max(1, int(width) - j)
                requests.append(
                    np.stack(
                        [
                            rng.integers(1, n_terminals, n),
                            rng.integers(1, n_paths, n),
                            rng.integers(1, n_terminals, n),
                        ],
                        axis=1,
                    ).astype(np.int32)
                )
        return requests


def _retrieval_recall(retrieval, k: int, n_queries: int) -> float:
    """Mean recall@k of the backend vs brute-force NumPy cosine over the
    SAME unit rows (both backends keep them: the exact index on the card,
    copied to the host here; the ANN index as the re-rank mmap)."""
    rows = retrieval.host_rows()[: retrieval.n]
    labels = retrieval.labels
    k = min(int(k), retrieval.n)
    rng = np.random.default_rng(0)
    queries = rng.choice(
        retrieval.n, size=min(int(n_queries), retrieval.n), replace=False
    )
    hits, total = 0, 0
    for qi in queries:
        got = {name for name, _ in retrieval.top_k(rows[qi], k)}
        reference = {
            labels[i] for i in np.argsort(-(rows @ rows[qi]))[:k]
        }
        hits += len(got & reference)
        total += k
    return hits / total if total else 1.0


def validate_generation(gen: Generation, golden: GoldenSet | None) -> dict:
    """Run the golden set through a freshly-built shadow generation.

    Returns a report dict for the swap event log; raises
    :class:`SwapValidationError` on any miss. Runs ONLY against the shadow
    engine directly (never its batcher), so a validating swap cannot
    contend with live traffic for the active generation's queue.
    """
    report: dict = {"golden_requests": 0, "checks": []}
    if golden is None:
        report["checks"].append("skipped: no golden set configured")
        return report
    requests = golden.requests_for(gen)
    engine = gen.engine

    # batch-1 reference pass: every golden request alone, at its own width
    singles = []
    for arr in requests:
        starts, paths, ends, _, _ = engine.pad_requests([arr])
        logits, vectors, _ = engine.run(starts, paths, ends)
        logits = np.asarray(logits)[0]
        vectors = np.asarray(vectors)[0]
        if not (np.isfinite(logits).all() and np.isfinite(vectors).all()):
            raise SwapValidationError(
                f"shadow engine produced non-finite outputs for a "
                f"{len(arr)}-context golden request"
            )
        singles.append((logits, vectors))

    # coalesced pass: the same requests grouped to the top micro-batch
    # size must reproduce the batch-1 EMBEDDINGS bitwise (a broken PAD
    # mask, or a kernel whose reduction order depends on the batch, fails
    # here). Logits get a tight tolerance instead: the label head's
    # library product may reduce in another order per batch size, shifting
    # the last bit — the embedding path is what the bitwise rollout
    # contract covers.
    top = engine.batch_sizes[-1]
    for base in range(0, len(requests), top):
        chunk = requests[base : base + top]
        starts, paths, ends, _, _ = engine.pad_requests(chunk)
        logits, vectors, _ = engine.run(starts, paths, ends)
        logits = np.asarray(logits)
        vectors = np.asarray(vectors)
        for i in range(len(chunk)):
            ref_logits, ref_vectors = singles[base + i]
            if not np.array_equal(vectors[i], ref_vectors):
                raise SwapValidationError(
                    "shadow engine's coalesced embeddings diverge bitwise "
                    f"from batch-1 dispatch (request {base + i}, width "
                    f"{len(chunk[i])})"
                )
            if not np.allclose(
                logits[i], ref_logits, rtol=1e-5, atol=1e-6
            ):
                raise SwapValidationError(
                    "shadow engine's coalesced logits diverge beyond "
                    "reduction-order noise from batch-1 dispatch (request "
                    f"{base + i}, width {len(chunk[i])})"
                )
    report["golden_requests"] = len(requests)
    report["checks"].append(
        "embeddings: coalesced == batch-1 bitwise (logits within "
        "reduction-order tolerance), all finite"
    )

    if engine.post_warmup_compiles:
        raise SwapValidationError(
            f"golden validation triggered {engine.post_warmup_compiles} "
            "post-warmup first run(s): the shadow ladder does not cover its "
            "own rungs"
        )
    report["checks"].append("zero post-warmup compiles across validation")

    if gen.retrieval is not None:
        recall = _retrieval_recall(
            gen.retrieval, golden.recall_k, golden.n_queries
        )
        report["recall"] = round(recall, 4)
        if recall < golden.min_recall:
            raise SwapValidationError(
                f"shadow retrieval recall@{golden.recall_k} = {recall:.4f} "
                f"below the {golden.min_recall} floor"
            )
        report["checks"].append(
            f"neighbors: recall@{golden.recall_k} = {recall:.4f} >= "
            f"{golden.min_recall}"
        )
    return report


class SwapController:
    """Owns the active/previous generation pointers and the swap thread.

    ``build(target) -> Generation`` is the generation factory (loads a
    checkpoint, warms the full ladder, builds batcher + retrieval); it
    runs on the controller's background thread so the reload control op
    returns immediately and the active generation never stalls. At most
    one swap runs at a time; ``rollback`` is pointer-swap-instant and
    refuses to race an in-progress swap.
    """

    def __init__(
        self,
        active: Generation,
        *,
        build=None,
        golden: GoldenSet | None = None,
        health: RuntimeHealth | None = None,
        events=None,
        close_timeout: float = 30.0,
    ) -> None:
        self.active = active
        self.previous: Generation | None = None
        self._build = build
        self.golden = golden
        self._health = health or global_health()
        self._events = events
        self._close_timeout = close_timeout
        self._lock = make_rlock("swap.controller")
        self._state = "idle"  # idle | building | validating
        self._target: str | None = None
        self._last: dict | None = None
        self._thread: threading.Thread | None = None
        self._swaps = self._health.counter("serve_swaps_committed")
        self._failed = self._health.counter("serve_swaps_failed")
        self._rollbacks = self._health.counter("serve_rollbacks")
        self._health.gauge("serve_active_version").set(active.version)

    # ---- status ---------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def status(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "target": self._target,
                "active_version": self.active.version,
                "previous_version": (
                    self.previous.version if self.previous else None
                ),
                "last_swap": dict(self._last) if self._last else None,
            }

    def _emit(self, event: str, **fields) -> None:
        if self._events is not None:
            try:
                self._events.emit(event, **fields)
            except Exception:  # pragma: no cover - closed log mid-swap
                logger.warning("could not emit %s event", event, exc_info=True)

    # ---- reload ---------------------------------------------------------
    def reload(self, target: str | None, wait: bool = False) -> dict:
        """Start a shadow build + validate + swap toward ``target`` (a
        model path, or whatever token the factory understands). Returns
        the status snapshot — final when ``wait``, in-progress otherwise.
        """
        if self._build is None:
            raise ValueError(
                "this server has no generation factory — reload is only "
                "available through the serve CLI (or a SwapController "
                "constructed with build=...)"
            )
        with self._lock:
            if self._state != "idle":
                raise ValueError(
                    f"a swap is already in progress (state={self._state}, "
                    f"target={self._target!r}); wait for it or roll back "
                    "after it commits"
                )
            self._state = "building"
            self._target = target
            self._thread = threading.Thread(
                target=self._swap_thread, args=(target,),
                name="c2v-swap-build", daemon=True,
            )
            thread = self._thread
        self._emit("swap_started", target=target,
                   active_version=self.active.version)
        thread.start()
        if wait:
            thread.join()
        return self.status()

    def wait(self, timeout: float | None = None) -> dict:
        """Block until any in-progress swap finishes; returns status."""
        thread = self._thread
        if thread is not None and thread.is_alive():
            thread.join(timeout)
        return self.status()

    def _swap_thread(self, target: str | None) -> None:
        t0 = time.perf_counter()
        gen: Generation | None = None
        try:
            gen = self._build(target)
            build_ms = (time.perf_counter() - t0) * 1e3
            with self._lock:
                self._state = "validating"
            t1 = time.perf_counter()
            report = validate_generation(gen, self.golden)
            validate_ms = (time.perf_counter() - t1) * 1e3
        except BaseException as exc:  # noqa: BLE001 - recorded, not raised
            if gen is not None:
                try:
                    gen.close(self._close_timeout)
                except Exception:  # pragma: no cover - half-built batcher
                    pass
            with self._lock:
                self._state = "idle"
                self._target = None
                self._last = {
                    "target": target,
                    "outcome": "failed",
                    "error": f"{type(exc).__name__}: {exc}",
                }
            self._failed.inc()
            logger.warning("swap to %r failed: %s", target, exc)
            self._emit("swap_failed", target=target,
                       error=f"{type(exc).__name__}: {exc}",
                       active_version=self.active.version)
            return
        with self._lock:
            retired = self.previous
            self.previous = self.active
            self.active = gen
            self._state = "idle"
            self._target = None
            self._last = {
                "target": target,
                "outcome": "committed",
                "version": gen.version,
                "build_ms": round(build_ms, 1),
                "validate_ms": round(validate_ms, 1),
                **report,
            }
            last = dict(self._last)
        self._swaps.inc()
        self._health.gauge("serve_active_version").set(gen.version)
        logger.info(
            "swap committed: %s is live (built %.0f ms, validated %.0f ms "
            "over %d golden requests); %s resident for rollback",
            gen.version, build_ms, validate_ms, last.get("golden_requests", 0),
            self.previous.version,
        )
        self._emit("swap_committed", **last)
        if retired is not None:
            # only now does the oldest generation go away — and it drains:
            # anything still in its queue resolves before close returns
            retired.close(self._close_timeout)
            self._emit("generation_retired", version=retired.version)

    # ---- rollback -------------------------------------------------------
    def rollback(self) -> dict:
        """Instant pointer swap back to the previous resident generation —
        its warmed engine and tables were never torn down, so the next
        request reproduces that version's bitwise-identical outputs."""
        with self._lock:
            if self._state != "idle":
                raise ValueError(
                    f"cannot roll back while a swap is in progress "
                    f"(state={self._state})"
                )
            if self.previous is None:
                raise ValueError(
                    "no previous generation resident — nothing to roll "
                    "back to"
                )
            self.active, self.previous = self.previous, self.active
            self._last = {
                "target": self.active.version,
                "outcome": "rolled_back",
                "version": self.active.version,
            }
            # snapshot under the lock: a reload racing this rollback could
            # repoint active/previous between release and the log/emit below
            restored, demoted = self.active.version, self.previous.version
        self._rollbacks.inc()
        self._health.gauge("serve_active_version").set(restored)
        logger.info("rolled back to %s (%s stays resident)",
                    restored, demoted)
        self._emit("rollback", version=restored, demoted_version=demoted)
        return self.status()

    # ---- lifecycle ------------------------------------------------------
    def close(self) -> None:
        """Join any in-progress swap, then drain every resident
        generation's batcher."""
        thread = self._thread
        if thread is not None and thread.is_alive():
            thread.join(self._close_timeout)
        with self._lock:
            generations = (self.active, self.previous)
        for gen in generations:
            if gen is not None:
                try:
                    gen.close(self._close_timeout)
                except Exception:  # pragma: no cover - already closed
                    pass
