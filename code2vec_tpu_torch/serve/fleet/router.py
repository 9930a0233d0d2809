"""The fleet router: SLO-classed queues -> least-loaded healthy replica.

Counterpart of ``code2vec_tpu/serve/fleet/router.py``.

Request life cycle (all torch-free; the router moves dicts, never tensors):

0. **cache** (``--result_cache_mb``, cache.py): data requests first hit
   the content-addressed result cache — a repeat of a cached request
   (same canonical bag/source/vector + knobs, same generation version)
   resolves HERE, ahead of SLO admission: it consumes no queue budget and
   touches no replica. Concurrent identical misses coalesce onto the
   first one's future; a committed rolling swap flips the cache's active
   version (old entries stay resident) and ``rollback`` flips it back.
1. **admit**: ``handle_async`` classifies the op into its SLO class and
   enqueues into that class's bounded queue — a full queue sheds with a
   retryable ``overloaded`` error (the class's budget IS the admission
   bound; there is no global ``max_pending`` anymore).
2. **dispatch**: one dispatcher thread drains the class queues in tier
   priority (embed before neighbors; health-class control ops never
   queue — the router handles them inline at admission, which is how
   they cut through saturation), placing each request on the
   healthy replica with the fewest in-flight requests, bounded by
   ``per_replica_inflight`` (per-replica backpressure — the
   micro-batcher's bounded-queue idea one level up). A request still
   undispatched past its class deadline is shed with a ``deadline``
   error: serving it anyway would poison the queue for requests whose
   clients are still waiting.
3. **resolve**: the replica's FIFO future resolves the router future;
   per-class latency histograms and counters land in the shared obs
   registry (``slo.<class>.*``). A request stranded on a dying replica is
   retried on a sibling (inference ops are idempotent) up to
   ``retry_limit`` times before failing with ``unavailable``.

A **prober** thread health-checks every replica each
``probe_interval_s`` through the same pipes traffic uses (a probe stuck
behind a wedged queue is exactly the signal wanted); ``max_probe_failures``
consecutive misses evicts the replica — SIGTERM first, so its drain
handler resolves whatever it accepted — and respawns the slot with a
fresh incarnation.

**Rolling hot-swap**: the ``reload`` op walks replicas ONE AT A TIME,
driving each worker's in-process shadow-build/validate/commit
(``serve/swap.py``) and polling its ``swap_status`` until the commit —
each replica keeps serving its incumbent generation while its shadow
loads and warms, so fleet capacity never drops during a rollout; a replica that
fails validation aborts the roll with the rest of the fleet untouched.
``rollback`` fans the instant pointer-swap to every replica.
"""

from __future__ import annotations

import collections
import logging
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

from code2vec_tpu_torch.obs.runtime import (
    FlightRecorder,
    RuntimeHealth,
    global_health,
)
from code2vec_tpu_torch.obs.handles import handles_snapshot
from code2vec_tpu_torch.obs.sync import make_lock, sync_snapshot
from code2vec_tpu_torch.obs.trace import ensure_trace, get_tracer
from code2vec_tpu_torch.serve.fleet.cache import ResultCache
from code2vec_tpu_torch.serve.fleet.replica import ReplicaDied
from code2vec_tpu_torch.serve.fleet.slo import (
    DEFAULT_SLO,
    PRIORITY,
    SloBurnTracker,
    SloClass,
    classify_op,
)

logger = logging.getLogger(__name__)

__all__ = ["FleetRouter"]

# outcome kinds that burn SLO error budget: the fleet failed the client
# (shed, expired, unavailable, or a server-side error — wherever it arose);
# a bad_request is the client's mistake and burns nothing. Distinct from
# per-op error counting: the router only counts errors IT minted (the
# _Queued.router_error flag) — a worker-relayed error already counted in
# that replica's own registry, and counting it again here would make the
# aggregated /metrics series double-count
_BUDGET_BURNING_KINDS = frozenset(
    ("overloaded", "deadline", "unavailable", "closed", "internal",
     "swap_failed")
)


@dataclass
class _Queued:
    request: dict
    future: Future
    cls: str
    op: str | None = None
    trace_id: str | None = None
    enqueued: float = field(default_factory=time.perf_counter)
    depth: int = 0  # class-queue depth observed at admission
    dispatched: float | None = None
    slot: int | None = None
    attempts: int = 0
    # True when the ROUTER resolved this item with an error it minted
    # (deadline shed, unavailable, drain) — the per-op error counter
    # counts exactly these; worker-relayed errors are already counted in
    # the replica's own registry
    router_error: bool = False
    # result-cache bookkeeping: the versioned key this item leads or
    # coalesces on (None = cache off / uncacheable / mid-roll) and its
    # role — "miss" leads (fills on success), "coalesced" rides the
    # leader's future without ever touching a queue or replica
    cache_key: tuple | None = None
    cache_state: str | None = None

    @property
    def age_ms(self) -> float:
        return (time.perf_counter() - self.enqueued) * 1e3


class FleetRouter:
    """Fan requests over N replica slots (see module docstring).

    ``replica_factory(slot, incarnation) -> handle`` builds one worker
    client (:class:`~code2vec_tpu_torch.serve.fleet.replica.ReplicaHandle` in
    production; tests inject in-process fakes). The router exposes the
    same ``handle``/``handle_async``/``shutdown_requested``/``close``
    surface as :class:`~code2vec_tpu_torch.serve.protocol.CodeServer`, so the
    stdio/HTTP transport adapters work unchanged.
    """

    def __init__(
        self,
        replica_factory,
        n_replicas: int,
        *,
        slo: dict[str, SloClass] | None = None,
        health: RuntimeHealth | None = None,
        events=None,
        per_replica_inflight: int = 8,
        probe_interval_s: float = 2.0,
        probe_timeout_s: float = 60.0,
        max_probe_failures: int = 3,
        boot_timeout_s: float = 900.0,
        swap_timeout_s: float = 1800.0,
        retry_limit: int = 2,
        slo_objective: float = 0.999,
        slo_window_s: float = 60.0,
        flight: FlightRecorder | None = None,
        result_cache: ResultCache | None = None,
    ) -> None:
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        if per_replica_inflight < 1:
            raise ValueError(
                f"per_replica_inflight must be >= 1, got "
                f"{per_replica_inflight}"
            )
        self._factory = replica_factory
        self._slo = dict(slo if slo is not None else DEFAULT_SLO)
        self.health = health or global_health()
        self._events = events
        self._cap = int(per_replica_inflight)
        self._probe_interval_s = float(probe_interval_s)
        self._probe_timeout_s = float(probe_timeout_s)
        self._max_probe_failures = int(max_probe_failures)
        self._boot_timeout_s = float(boot_timeout_s)
        self._swap_timeout_s = float(swap_timeout_s)
        self._retry_limit = int(retry_limit)

        self._queues: dict[str, queue.Queue] = {
            name: queue.Queue(maxsize=cls.budget)
            for name, cls in self._slo.items()
        }
        self._heads: dict[str, _Queued | None] = {
            name: None for name in self._slo
        }
        self._retries: collections.deque[_Queued] = collections.deque()
        self._wake = threading.Event()
        self._closed = threading.Event()
        self._shutdown = threading.Event()
        self._stop_probe = threading.Event()

        self._swap_lock = make_lock("router.swap")
        self._rolling: dict = {"state": "idle", "target": None,
                               "outcome": None, "replicas": []}
        self._rolling_thread: threading.Thread | None = None

        self._evictions = self.health.counter("fleet.evictions")
        self._respawns = self.health.counter("fleet.respawns")
        self._retried = self.health.counter("fleet.retries")
        self.health.gauge("fleet.replicas").set(int(n_replicas))

        # SLO error-budget burn accounting: every finished data request
        # records good/bad into its class's rolling window (slo.py) —
        # burn-rate gauges + the slo_budget_exhausted event ride the same
        # registry/event log as everything else
        self._burn = SloBurnTracker(
            [name for name in self._slo if name != "health"],
            objective=slo_objective, window_s=slo_window_s,
            health=self.health, events=events,
        )
        # slow-request flight recorder: a shed or tail-latency request
        # leaves a concrete per-request timeline, not just a histogram
        self._flight = flight
        # content-addressed result cache (cache.py): hits resolve at
        # admission, ahead of SLO queues and replicas; None = disabled
        self._cache = result_cache
        self._version_seq = 0

        # ---- boot the fleet (parallel: each worker warms its ladder)
        self._slots: list = [None] * int(n_replicas)
        errors: list = [None] * int(n_replicas)

        def boot(slot: int) -> None:
            try:
                self._slots[slot] = self._spawn(slot, incarnation=0)
            except Exception as exc:  # noqa: BLE001 - re-raised below
                errors[slot] = exc

        threads = [
            threading.Thread(target=boot, args=(i,), daemon=True)
            for i in range(int(n_replicas))
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        failed = [i for i, e in enumerate(errors) if e is not None]
        if failed:
            for handle in self._slots:
                if handle is not None:
                    try:
                        handle.stop(timeout=10.0)
                    except Exception:  # noqa: BLE001 - teardown best-effort
                        pass
            raise RuntimeError(
                f"replica slot(s) {failed} failed to boot: "
                f"{[str(errors[i]) for i in failed]}"
            )

        if self._cache is not None:
            # seed the cache's version from the fleet's actual serving
            # generation (every replica booted the same checkpoint); a
            # factory whose readiness payload carries no version keeps
            # the cache's own default
            for handle in self._slots:
                version = (getattr(handle, "last_health", None) or {}).get(
                    "version"
                )
                if version:
                    self._cache.set_version(version)
                    break

        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="c2v-fleet-dispatch", daemon=True
        )
        self._dispatcher.start()
        self._prober = threading.Thread(
            target=self._probe_loop, name="c2v-fleet-probe", daemon=True
        )
        self._prober.start()

    # ---- spawn / respawn ------------------------------------------------
    def _spawn(self, slot: int, incarnation: int):
        handle = self._factory(slot, incarnation)
        handle.wait_ready(self._boot_timeout_s)
        logger.info(
            "replica r%d (incarnation %d) is ready", slot, incarnation
        )
        self._emit(
            "fleet_replica_spawned", slot=slot, incarnation=incarnation,
            pid=getattr(handle, "pid", None),
        )
        return handle

    def _emit(self, event: str, **fields) -> None:
        if self._events is not None:
            try:
                self._events.emit(event, **fields)
            except Exception:  # pragma: no cover - closed log
                logger.warning("could not emit %s", event, exc_info=True)

    # ---- CodeServer-compatible surface ----------------------------------
    @property
    def shutdown_requested(self) -> bool:
        return self._shutdown.is_set()

    def request_shutdown(self) -> None:
        self._shutdown.set()

    def handle(self, request: dict) -> dict:
        resolver = self.handle_async(request)
        try:
            return resolver()
        except Exception as exc:  # noqa: BLE001 - protocol boundary
            from code2vec_tpu_torch.serve.protocol import CodeServer

            return CodeServer._error_payload(exc)

    def handle_async(self, request: dict):
        req_id = request.get("id")

        def finish(payload: dict) -> dict:
            if req_id is not None:
                payload = {"id": req_id, **payload}
            return payload

        op = request.get("op")
        cls_name = classify_op(op)
        if cls_name is None:
            payload = {"error": f"unknown op {op!r}",
                       "error_kind": "bad_request"}
            return lambda: finish(payload)
        if self._closed.is_set():
            payload = {"error": "fleet router is shutting down",
                       "error_kind": "closed"}
            return lambda: finish(payload)

        # control plane handled in the router itself
        if op == "health":
            # resolve-time snapshot, like the single-process server
            return lambda: finish(self._fleet_health())
        if op == "shutdown":
            self._shutdown.set()
            return lambda: finish({"ok": True, "shutting_down": True})
        if op == "reload":
            try:
                payload = self._start_rolling(request)
            except ValueError as exc:
                payload = {"error": str(exc), "error_kind": "bad_request"}
            return lambda: finish(payload)
        if op == "rollback":
            payload = self._fleet_rollback()
            return lambda: finish(payload)
        if op == "swap_status":
            payload = self._fleet_swap_status()
            return lambda: finish(payload)
        if op == "flights":
            payload = self._fleet_flights()
            return lambda: finish(payload)

        # data plane: stamp (or honor) the request's trace context FIRST —
        # the same dict crosses the replica pipe, so the worker's spans
        # inherit the id with no extra wiring — then consult the result
        # cache AHEAD of SLO admission (a hit never consumes queue budget
        # or touches a replica; sheds cannot starve cacheable traffic) —
        # then admit into the class queue (budget = admission bound)
        t0 = time.perf_counter()
        trace = ensure_trace(request)
        self.health.counter(f"serve.op.{op}.requests").inc()
        cache_key = (
            self._cache.key_for(request) if self._cache is not None else None
        )
        cache_state = None
        if cache_key is not None:
            state, held = self._cache.begin(cache_key)
            if state == "hit":
                payload = held
                self.health.counter(f"slo.{cls_name}.cache_hits").inc()
                self._burn.record(cls_name, good=True)
                now = time.perf_counter()
                tracer = get_tracer()
                if tracer.enabled:
                    tracer.span_complete(
                        "fleet_request", category="fleet",
                        start_s=t0, end_s=now,
                        trace_id=trace.trace_id, op=op, slo_class=cls_name,
                        outcome="ok", cache_hit=True,
                        cache_version=cache_key[0],
                    )
                if self._flight is not None:
                    self._flight.observe((now - t0) * 1e3, {
                        "kind": "router",
                        "trace_id": trace.trace_id,
                        "op": op,
                        "slo_class": cls_name,
                        "outcome": "ok",
                        "cache_hit": True,
                        "cache_version": cache_key[0],
                    })
                return lambda: finish(payload)
            if state == "join":
                # coalesced miss: ride the leader's in-flight future —
                # no queue budget, no replica, one device call for the
                # whole herd. _finalize still runs for burn accounting
                # and the span/flight breakdown.
                item = _Queued(
                    request=request, future=Future(), cls=cls_name, op=op,
                    trace_id=trace.trace_id, cache_key=cache_key,
                    cache_state="coalesced",
                )
                item.future.add_done_callback(
                    lambda fut, item=item: self._finalize(item, fut)
                )
                held.add_done_callback(
                    lambda fut, item=item: (
                        item.future.set_result(fut.result())
                        if not item.future.done() else None
                    )
                )
                return lambda: finish(item.future.result())
            cache_state = "miss"  # this request leads; _finalize fills
        item = _Queued(
            request=request, future=Future(), cls=cls_name, op=op,
            trace_id=trace.trace_id,
            depth=self._queues[cls_name].qsize(),
            cache_key=cache_key, cache_state=cache_state,
        )
        self.health.counter(f"slo.{cls_name}.submitted").inc()
        try:
            self._queues[cls_name].put_nowait(item)
        except queue.Full:
            self.health.counter(f"slo.{cls_name}.shed_budget").inc()
            # the shed never reaches a worker's resolver: count it into
            # the per-op error counter HERE or 429s stay invisible per op
            self.health.counter(f"serve.op.{op}.errors").inc()
            self._burn.record(cls_name, good=False)
            slo = self._slo[cls_name]
            payload = {
                "error": (
                    f"{cls_name} queue budget ({slo.budget}) exhausted — "
                    "shed; retry with backoff"
                ),
                "error_kind": "overloaded",
                "slo_class": cls_name,
            }
            if item.cache_key is not None:
                # this item led a coalesced miss: hand joiners the shed
                # payload (they attached to THIS attempt) without caching
                self._cache.abandon(item.cache_key, payload)
            tracer = get_tracer()
            if tracer.enabled:
                tracer.span_complete(
                    "fleet_request", category="fleet",
                    start_s=item.enqueued, end_s=time.perf_counter(),
                    trace_id=trace.trace_id, op=op, slo_class=cls_name,
                    outcome="overloaded",
                )
            return lambda: finish(payload)
        item.future.add_done_callback(
            lambda fut, item=item: self._finalize(item, fut)
        )
        self.health.gauge(f"slo.{cls_name}.queued").set(
            self._queues[cls_name].qsize()
        )
        self._wake.set()
        return lambda: finish(item.future.result())

    def _finalize(self, item: _Queued, fut: Future) -> None:
        """One exit point for every admitted data request (served, shed on
        deadline, failed, drained): per-request router span tagged with
        the trace id, SLO burn accounting, per-op error visibility, and
        the flight-recorder breakdown. O(1) dict work per request."""
        payload = fut.result()  # router futures always resolve to a dict
        kind = payload.get("error_kind") if isinstance(payload, dict) else None
        now = time.perf_counter()
        if item.cache_key is not None and item.cache_state == "miss":
            # leader exit: cache the exact payload (pre-"id" — every
            # future hit re-stamps its own correlation id) or, on any
            # error, resolve joiners without caching so the next
            # identical request retries cold
            if kind is None and isinstance(payload, dict) and not payload.get(
                "error"
            ):
                self._cache.fill(item.cache_key, payload)
            else:
                self._cache.abandon(item.cache_key, payload)
        if item.router_error:
            # ROUTER-minted outcomes never reached a worker resolver —
            # without this the per-op error counters undercount sheds.
            # Worker-relayed errors are deliberately NOT counted here:
            # the replica already counted them in its own registry, and
            # the /metrics aggregation would otherwise show them twice
            self.health.counter(f"serve.op.{item.op}.errors").inc()
        self._burn.record(item.cls, good=kind not in _BUDGET_BURNING_KINDS)
        cache_tags = {}
        if self._cache is not None:
            cache_tags = {
                "cache_hit": False,
                "cache_version": (
                    item.cache_key[0] if item.cache_key is not None else None
                ),
            }
            if item.cache_state == "coalesced":
                cache_tags["cache_coalesced"] = True
        tracer = get_tracer()
        if tracer.enabled:
            tracer.span_complete(
                "fleet_request", category="fleet",
                start_s=item.enqueued, end_s=now,
                trace_id=item.trace_id, op=item.op, slo_class=item.cls,
                outcome=kind or "ok", slot=item.slot, **cache_tags,
            )
        if self._flight is not None:
            dispatch_wait_ms = (
                (item.dispatched - item.enqueued) * 1e3
                if item.dispatched is not None
                else None
            )
            self._flight.observe((now - item.enqueued) * 1e3, {
                "kind": "router",
                "trace_id": item.trace_id,
                "op": item.op,
                "slo_class": item.cls,
                "outcome": kind or "ok",
                "queue_depth_at_admission": item.depth,
                "dispatch_wait_ms": (
                    round(dispatch_wait_ms, 3)
                    if dispatch_wait_ms is not None else None
                ),
                "replica_slot": item.slot,
                "attempts": item.attempts,
                **cache_tags,
            })

    # ---- dispatch -------------------------------------------------------
    def _pick_replica(self):
        """Healthy replica with the fewest in-flight requests, below the
        per-replica bound; None when every replica is full or dead."""
        best = None
        for handle in self._slots:
            if handle is None or not handle.alive:
                continue
            if handle.in_flight >= self._cap:
                continue
            if best is None or handle.in_flight < best.in_flight:
                best = handle
        return best

    def _any_alive(self) -> bool:
        return any(h is not None and h.alive for h in self._slots)

    def _shed_deadline(self, item: _Queued) -> None:
        self.health.counter(f"slo.{item.cls}.shed_deadline").inc()
        slo = self._slo[item.cls]
        item.router_error = True
        item.future.set_result({
            "error": (
                f"{item.cls} deadline ({slo.deadline_ms:.0f} ms) exceeded "
                f"before dispatch (waited {item.age_ms:.0f} ms) — shed"
            ),
            "error_kind": "deadline",
            "slo_class": item.cls,
        })

    def _fail_item(
        self, item: _Queued, reason: str, kind: str = "unavailable"
    ) -> None:
        self.health.counter(f"slo.{item.cls}.failed").inc()
        item.router_error = True
        if not item.future.done():
            item.future.set_result({
                "error": reason,
                "error_kind": kind,
                "slo_class": item.cls,
            })

    def _next_item(self, cls: str) -> _Queued | None:
        head = self._heads[cls]
        if head is not None:
            return head
        try:
            item = self._queues[cls].get_nowait()
        except queue.Empty:
            return None
        self.health.gauge(f"slo.{cls}.queued").set(
            self._queues[cls].qsize()
        )
        self._heads[cls] = item
        return item

    def _dispatch_once(self) -> bool:
        """One placement attempt across the tiers; True if any progress
        (dispatch or shed) was made."""
        # stranded retries first — their original admission already waited
        while self._retries:
            item = self._retries.popleft()
            if item.age_ms > self._slo[item.cls].deadline_ms:
                self._shed_deadline(item)
                return True
            if item.attempts > self._retry_limit:
                self._fail_item(
                    item,
                    f"request failed on {item.attempts} replica(s) — "
                    "fleet unavailable",
                )
                return True
            replica = self._pick_replica()
            if replica is None:
                if self._closed.is_set() and not self._any_alive():
                    self._fail_item(item, "no replica alive during drain")
                    return True
                self._retries.appendleft(item)
                break
            if self._dispatch(item, replica):
                return True
            # the picked replica died at write time — it is no longer
            # `alive`, so the next pass picks a sibling
            self._retries.appendleft(item)
        for cls in PRIORITY:
            if cls not in self._heads:
                continue
            item = self._next_item(cls)
            if item is None:
                continue
            if item.age_ms > self._slo[cls].deadline_ms:
                self._heads[cls] = None
                self._shed_deadline(item)
                return True
            replica = self._pick_replica()
            if replica is None:
                if self._closed.is_set() and not self._any_alive():
                    # draining with a dead fleet: failing loudly beats a
                    # future that never resolves
                    self._heads[cls] = None
                    self._fail_item(item, "no replica alive during drain")
                    return True
                continue
            if self._dispatch(item, replica):
                self._heads[cls] = None
                return True
        return False

    def _dispatch(self, item: _Queued, replica) -> bool:
        try:
            inner = replica.send(item.request)
        except ReplicaDied:
            # no work reached a worker — not a retry attempt; the deadline
            # bounds how long the item can keep looking for a replica
            return False
        item.dispatched = time.perf_counter()
        item.slot = getattr(replica, "slot", None)
        inner.add_done_callback(
            lambda fut, item=item, replica=replica: self._on_reply(
                item, replica, fut
            )
        )
        return True

    def _on_reply(self, item: _Queued, replica, fut) -> None:
        exc = fut.exception()
        if exc is not None:
            # stranded on a dying replica — inference ops are idempotent,
            # so retry on a sibling instead of surfacing the eviction
            item.attempts += 1
            self._retried.inc()
            self._retries.append(item)
            self._wake.set()
            return
        payload = fut.result()
        self.health.latency(f"slo.{item.cls}.e2e_ms").record(item.age_ms)
        self.health.counter(f"slo.{item.cls}.completed").inc()
        if not item.future.done():
            item.future.set_result(payload)

    def _queues_empty(self) -> bool:
        return (
            not self._retries
            and all(h is None for h in self._heads.values())
            and all(q.qsize() == 0 for q in self._queues.values())
        )

    def _dispatch_loop(self) -> None:
        while True:
            if self._dispatch_once():
                continue
            if self._closed.is_set() and self._queues_empty():
                return
            self._wake.wait(0.005)
            self._wake.clear()

    # ---- health probing / eviction --------------------------------------
    def _probe_loop(self) -> None:
        # one probe thread PER SLOT per cycle: a wedged replica blocks its
        # own probe (up to probe_timeout_s) without delaying detection on
        # any sibling; a slot whose probe/respawn is still running is
        # simply skipped this cycle
        busy = [False] * len(self._slots)

        def probe(slot: int) -> None:
            try:
                self._probe_slot(slot)
            finally:
                busy[slot] = False

        while not self._stop_probe.wait(self._probe_interval_s):
            for slot in range(len(self._slots)):
                if self._stop_probe.is_set():
                    return
                if busy[slot]:
                    continue
                busy[slot] = True
                threading.Thread(
                    target=probe, args=(slot,),
                    name=f"c2v-fleet-probe-r{slot}", daemon=True,
                ).start()

    def _probe_slot(self, slot: int) -> None:
        handle = self._slots[slot]
        if handle is None:
            return
        if not handle.alive:
            self._evict(slot, reason=handle.death_reason or "process exited")
            return
        try:
            payload = handle.send({"op": "health"}).result(
                self._probe_timeout_s
            )
            handle.last_health = payload
            handle.last_health_unix = time.time()
            handle.probe_failures = 0
        except Exception as exc:  # noqa: BLE001 - timeout or death
            handle.probe_failures += 1
            logger.warning(
                "replica r%d missed health probe %d/%d: %s",
                slot, handle.probe_failures, self._max_probe_failures, exc,
            )
            if handle.probe_failures >= self._max_probe_failures:
                self._evict(slot, reason=f"missed {handle.probe_failures} "
                            "consecutive health probes")

    def _evict(self, slot: int, reason: str) -> None:
        handle = self._slots[slot]
        self._evictions.inc()
        # leak-on-crash preflight: the dead incarnation's last prober-cached
        # handle-ledger block rides the eviction event, so a replica that
        # died leaking shows its open-handle count without a log dive
        last = getattr(handle, "last_health", None) or {}
        dead_handles = last.get("handles") or {}
        if dead_handles.get("open_total"):
            logger.warning(
                "replica r%d died with %d ledger-open handle(s): %s",
                slot, dead_handles["open_total"], dead_handles.get("open"),
            )
        logger.warning("evicting replica r%d: %s", slot, reason)
        self._emit(
            "fleet_replica_evicted", slot=slot,
            incarnation=getattr(handle, "incarnation", None), reason=reason,
            open_handles=dead_handles.get("open_total"),
            open_handles_by_kind=dead_handles.get("open"),
        )
        try:
            handle.kill()  # SIGTERM first: the worker drains, then exits
        except Exception:  # noqa: BLE001 - already gone
            pass
        if self._closed.is_set():
            return
        incarnation = getattr(handle, "incarnation", 0) + 1
        try:
            self._slots[slot] = self._spawn(slot, incarnation)
            self._respawns.inc()
            self._wake.set()
        except Exception as exc:  # noqa: BLE001 - retried next probe cycle
            logger.error(
                "respawn of replica r%d failed (%s); retrying next probe "
                "cycle", slot, exc,
            )

    # ---- fleet control plane --------------------------------------------
    def _fleet_health(self) -> dict:
        replicas = []
        for slot, handle in enumerate(self._slots):
            if handle is None:
                replicas.append({"slot": slot, "alive": False})
                continue
            last = handle.last_health or {}
            replicas.append({
                "slot": slot,
                "incarnation": handle.incarnation,
                "pid": getattr(handle, "pid", None),
                "alive": handle.alive,
                "in_flight": handle.in_flight,
                "probe_failures": handle.probe_failures,
                "last_health_unix": getattr(
                    handle, "last_health_unix", None
                ),
                "version": last.get("version"),
                "post_warmup_compiles": last.get("post_warmup_compiles"),
                "executables": last.get("executables"),
                # device-time/MFU block (engine.perf_summary, cached by
                # the prober) — the per-replica truth behind fleet.capacity
                "perf": last.get("perf"),
                # lock-sanitizer block from the worker's own health
                # payload: enabled flag + order-violation count
                "sync": last.get("sync"),
                # handle-ledger block from the worker: per-kind open
                # counts — a count climbing across swaps is a leak
                "handles": last.get("handles"),
            })
        return {
            "ok": all(r.get("alive") for r in replicas),
            "fleet": {
                "replicas": replicas,
                "slo": {
                    name: {
                        "budget": cls.budget,
                        "deadline_ms": cls.deadline_ms,
                        "queued": self._queues[name].qsize(),
                    }
                    for name, cls in self._slo.items()
                },
                # rolling error-budget state per class: burn rate, window
                # good/bad, exhaustion — the numbers /metrics exports as
                # slo.<class>.burn_rate / budget_remaining gauges
                "slo_burn": self._burn.snapshot(),
                "rolling": self._rolling_status(),
                # result-cache block: hit/miss/coalesced counters, byte
                # accounting, and per-version resident entry counts (the
                # same numbers /metrics exports as c2v_cache_* series)
                "cache": (
                    self._cache.stats() if self._cache is not None else None
                ),
                "flight_recorded": (
                    self._flight.count if self._flight is not None else None
                ),
                # max-sustainable-QPS model from the replicas' perf blocks
                # (device-ms/request × observed mix) — the autoscaling
                # control signal; None until device time has been observed
                "capacity": self._capacity_block(),
                # the ROUTER's own lock-sanitizer snapshot (router.swap /
                # fleet.cache / fleet.slo locks); each replica row above
                # carries the worker-side block
                "sync": sync_snapshot(),
                # the ROUTER's own handle ledger (replica handles, the
                # flight recorder, the event log)
                "handles": handles_snapshot(),
            },
            **self.health.snapshot(),
        }

    def _capacity_block(self) -> dict | None:
        """Fleet capacity from the prober's cached per-replica ``perf``
        blocks — never crosses a pipe. Mirrored into router gauges so
        /metrics carries ``c2v_fleet_capacity_qps`` alongside health."""
        from code2vec_tpu_torch.obs.costs import fleet_capacity

        perfs = []
        alive = 0
        for handle in self._slots:
            if handle is None or not handle.alive:
                continue
            alive += 1
            last = handle.last_health
            perfs.append(last.get("perf") if isinstance(last, dict) else None)
        capacity = fleet_capacity(perfs, alive=alive)
        if capacity is not None:
            self.health.gauge("fleet.capacity_qps").set(
                capacity["max_qps_fleet"]
            )
            self.health.gauge("fleet.capacity_qps_per_replica").set(
                capacity["max_qps_per_replica"]
            )
            self.health.gauge("fleet.capacity_device_ms_per_request").set(
                capacity["device_ms_per_request"]
            )
        return capacity

    def metrics_text(self) -> str:
        """Prometheus text exposition for ``GET /metrics`` on the router:
        the router's own registry unlabeled, plus each replica's last
        health snapshot under a ``replica="r<slot>"`` label. Lock-light by
        construction — replica blocks come from the prober's cached
        ``last_health`` payloads (already plain dicts), so a scrape never
        crosses the pipe, takes a replica lock, or touches device state.
        Each replica block carries its own ``started_unix`` /
        ``snapshot_seq``, so scrapers can detect counter resets across
        respawns."""
        from code2vec_tpu_torch.obs.runtime import build_info_text, prometheus_text

        # refresh the capacity gauges from the cached perf blocks so a
        # metrics-only consumer sees the same signal as /health
        self._capacity_block()
        sources = [({}, self.health.snapshot())]
        for slot, handle in enumerate(self._slots):
            if handle is None:
                continue
            last = handle.last_health
            if not isinstance(last, dict) or "counters" not in last:
                continue
            snap = {
                key: last[key]
                for key in (
                    "started_unix", "snapshot_seq", "counters",
                    "gauges", "latencies_ms",
                )
                if key in last
            }
            captured_unix = getattr(handle, "last_health_unix", None)
            if captured_unix is not None:
                # when this replica's block was captured — the scrape's
                # staleness signal (probe-refreshed, not scrape-time)
                snap["gauges"] = {
                    **(snap.get("gauges") or {}),
                    "replica_last_health_unix": captured_unix,
                }
            sources.append(({"replica": f"r{slot}"}, snap))
        return build_info_text({"role": "router"}) + prometheus_text(sources)

    def _rolling_status(self) -> dict:
        with self._swap_lock:
            return {
                "state": self._rolling["state"],
                "target": self._rolling["target"],
                "outcome": self._rolling["outcome"],
                "replicas": list(self._rolling["replicas"]),
            }

    def _start_rolling(self, request: dict) -> dict:
        target = request.get("model_path")
        wait = bool(request.get("wait", False))
        with self._swap_lock:
            if (
                self._rolling_thread is not None
                and self._rolling_thread.is_alive()
            ):
                raise ValueError(
                    "a rolling swap is already in progress "
                    f"(target={self._rolling['target']!r})"
                )
            self._rolling = {"state": "running", "target": target,
                             "outcome": None, "replicas": []}
            if self._cache is not None:
                # mid-roll the fleet is mixed-version: the cache stands
                # down (no hits, no fills) until the outcome is known
                self._cache.begin_swap()
            self._rolling_thread = threading.Thread(
                target=self._rolling_swap, args=(target,),
                name="c2v-fleet-rolling-swap", daemon=True,
            )
            thread = self._rolling_thread
        self._emit("fleet_swap_started", target=target)
        thread.start()
        if wait:
            thread.join()
        status = self._rolling_status()
        payload: dict = {"ok": status["outcome"] != "failed",
                         "rolling": status}
        if status["outcome"] == "failed":
            failures = [
                r for r in status["replicas"] if r.get("outcome") == "failed"
            ]
            payload["error"] = (
                failures[0].get("error", "rolling swap failed")
                if failures else "rolling swap failed"
            )
            payload["error_kind"] = "swap_failed"
        return payload

    def _rolling_swap(self, target) -> None:
        """ONE replica at a time: drive its in-process hot-swap and poll
        its state machine to completion before touching the next — the
        fleet never has more than one replica building a shadow, and a
        validation failure stops the roll with the rest untouched."""
        outcome = "committed"
        per_replica: list[dict] = []
        for slot in range(len(self._slots)):
            handle = self._slots[slot]
            if handle is None or not handle.alive:
                per_replica.append({"slot": slot, "outcome": "skipped_dead"})
                continue
            entry: dict = {"slot": slot, "incarnation": handle.incarnation}
            try:
                response = handle.send(
                    {"op": "reload", "model_path": target}
                ).result(self._swap_timeout_s)
                if response.get("error"):
                    raise RuntimeError(response["error"])
                deadline = time.monotonic() + self._swap_timeout_s
                while True:
                    status = handle.send({"op": "swap_status"}).result(
                        self._swap_timeout_s
                    )
                    swap = status.get("swap", {})
                    if swap.get("state") == "idle":
                        last = swap.get("last_swap") or {}
                        if last.get("outcome") != "committed":
                            raise RuntimeError(
                                "replica swap failed: "
                                f"{last.get('error', 'unknown error')}"
                            )
                        entry["outcome"] = "committed"
                        entry["version"] = last.get("version")
                        entry["build_ms"] = last.get("build_ms")
                        entry["validate_ms"] = last.get("validate_ms")
                        break
                    if time.monotonic() > deadline:
                        raise RuntimeError(
                            f"swap did not finish within "
                            f"{self._swap_timeout_s:.0f} s"
                        )
                    time.sleep(0.25)
            except Exception as exc:  # noqa: BLE001 - abort the roll
                entry["outcome"] = "failed"
                entry["error"] = str(exc)
                per_replica.append(entry)
                outcome = "failed"
                logger.warning(
                    "rolling swap aborted at replica r%d: %s", slot, exc
                )
                break
            per_replica.append(entry)
            with self._swap_lock:
                self._rolling["replicas"] = list(per_replica)
        with self._swap_lock:
            self._rolling = {"state": "idle", "target": target,
                             "outcome": outcome, "replicas": per_replica}
        if self._cache is not None:
            if outcome == "committed":
                # flip the active version forward: the old generation's
                # entries stay resident (rollback revalidates them
                # bitwise) but stop being visible. A commit whose version
                # is unreported gets a fresh unique label — serving the
                # OLD entries against NEW weights would be wrong.
                versions = [
                    e.get("version") for e in per_replica if e.get("version")
                ]
                self._cache.end_swap(
                    version=versions[-1] if versions
                    else self._fresh_version(target)
                )
            else:
                # the roll failed with the incumbent generation intact:
                # its entries never stopped being true
                self._cache.end_swap()
        self._emit(
            "fleet_swap_committed" if outcome == "committed"
            else "fleet_swap_failed",
            target=target, replicas=per_replica,
        )

    def _fleet_rollback(self) -> dict:
        """Fan the instant pointer-swap to every live replica."""
        with self._swap_lock:
            if (
                self._rolling_thread is not None
                and self._rolling_thread.is_alive()
            ):
                return {
                    "error": "cannot roll back during a rolling swap",
                    "error_kind": "bad_request",
                }
        results = []
        ok = True
        for slot, handle in enumerate(self._slots):
            if handle is None or not handle.alive:
                results.append({"slot": slot, "outcome": "skipped_dead"})
                continue
            try:
                response = handle.send({"op": "rollback"}).result(
                    self._probe_timeout_s
                )
            except Exception as exc:  # noqa: BLE001 - per-replica report
                response = {"error": str(exc)}
            if response.get("error"):
                ok = False
                results.append({"slot": slot, "outcome": "failed",
                                "error": response["error"]})
            else:
                results.append({
                    "slot": slot,
                    "outcome": "rolled_back",
                    "version": (response.get("swap") or {}).get(
                        "active_version"
                    ),
                })
        if self._cache is not None:
            versions = {
                r.get("version")
                for r in results
                if r.get("outcome") == "rolled_back"
            }
            if ok and len(versions) == 1 and None not in versions:
                # the whole fleet agreed on the restored generation: flip
                # the cache back — that generation's entries (retained
                # across the commit) are instantly valid again, bitwise
                self._cache.set_version(versions.pop())
            else:
                # partial/ambiguous rollback: no version label is
                # truthful for the whole fleet — go cold under a fresh
                # unique version rather than risk a wrong hit
                self._cache.set_version(
                    self._fresh_version("post_rollback")
                )
        self._emit("fleet_rollback", replicas=results)
        return {"ok": ok, "replicas": results}

    def _fresh_version(self, hint) -> str:
        """A unique never-hits-anything version label for states where
        the fleet's true generation is unknown (unreported commit,
        partial rollback): correctness over hit rate."""
        self._version_seq += 1
        return f"{hint or 'unknown'}@seq{self._version_seq}"

    def _fleet_swap_status(self) -> dict:
        per_replica = []
        for slot, handle in enumerate(self._slots):
            if handle is None or not handle.alive:
                per_replica.append({"slot": slot, "alive": False})
                continue
            try:
                status = handle.send({"op": "swap_status"}).result(
                    self._probe_timeout_s
                )
                per_replica.append({"slot": slot,
                                    "swap": status.get("swap")})
            except Exception as exc:  # noqa: BLE001 - per-replica report
                per_replica.append({"slot": slot, "error": str(exc)})
        return {
            "ok": True,
            "rolling": self._rolling_status(),
            "replicas": per_replica,
        }

    def _fleet_flights(self) -> dict:
        """Live flight-recorder fan-out: the router's own captured
        records plus each alive replica's, fetched over the control pipe
        (same per-replica error isolation as ``swap_status``)."""
        per_replica = []
        for slot, handle in enumerate(self._slots):
            if handle is None or not handle.alive:
                per_replica.append({"slot": slot, "alive": False})
                continue
            try:
                payload = handle.send({"op": "flights"}).result(
                    self._probe_timeout_s
                )
                per_replica.append({
                    "slot": slot,
                    "recorded": payload.get("recorded"),
                    "seen": payload.get("seen"),
                    "flights": payload.get("flights") or [],
                })
            except Exception as exc:  # noqa: BLE001 - per-replica report
                per_replica.append({"slot": slot, "error": str(exc)})
        router_flights = (
            self._flight.snapshot() if self._flight is not None else []
        )
        return {
            "ok": True,
            "router": {
                "recorded": (
                    self._flight.count if self._flight is not None else 0
                ),
                "flights": router_flights,
            },
            "replicas": per_replica,
        }

    # ---- lifecycle ------------------------------------------------------
    def close(self, timeout: float = 60.0) -> None:
        """Drain the class queues through the fleet, then stop every
        replica gracefully. Idempotent."""
        self._closed.set()
        self._wake.set()
        self._dispatcher.join(timeout)
        self._stop_probe.set()
        self._prober.join(self._probe_interval_s + 5.0)
        rolling = self._rolling_thread
        if rolling is not None and rolling.is_alive():
            rolling.join(timeout)
        threads = []
        for handle in self._slots:
            if handle is None:
                continue
            t = threading.Thread(
                target=handle.stop, kwargs={"timeout": timeout}, daemon=True
            )
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout)
        # final sweep: an item admitted in the close race, or re-queued by
        # a late replica-death callback AFTER the dispatcher exited, can
        # never be dispatched — resolve it loudly instead of stranding its
        # caller on a future that never completes (the same poll-gap class
        # the micro-batcher's close fix covers one level down)
        leftovers = list(self._retries)
        self._retries.clear()
        # lockless by design: the dispatcher (the only other _heads writer)
        # was joined above, so this sweep runs single-threaded
        for cls, head in self._heads.items():
            if head is not None:
                leftovers.append(head)
                self._heads[cls] = None
        for q in self._queues.values():
            while True:
                try:
                    leftovers.append(q.get_nowait())
                except queue.Empty:
                    break
        for item in leftovers:
            self._fail_item(
                item, "fleet router closed before dispatch", kind="closed"
            )
        if self._flight is not None:
            self._flight.close()

    def __enter__(self) -> "FleetRouter":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()
