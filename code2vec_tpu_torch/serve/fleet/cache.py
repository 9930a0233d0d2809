"""Router-level content-addressed result cache.

Counterpart of ``code2vec_tpu/serve/fleet/cache.py``.

Real embedding traffic is heavily Zipfian — popular files re-indexed,
retried requests, fan-out consumers asking for the same method — yet
without this module every repeat request through the fleet costs a
device call. This is the "compute once, O(1) thereafter" serving thesis
applied at the REQUEST tier: the router already moves exact response
payloads (plain dicts, never tensors), so a repeat request can be served
from router memory without consuming SLO queue budget or touching a
replica. Three properties make that safe and effective:

- **content addressing, not request addressing.** The key is a canonical
  digest of what the request MEANS, not of its bytes: a path-context bag
  is digested as an order-invariant MULTISET of ``[start, path, end]``
  triples (sorted rows), so a permuted resend of the same method hits;
  op-relevant knobs (``top_k``, ``granularity``, ``include_vector``, …)
  fold into the key while correlation fields (``id``, ``trace``) never
  do — the router re-stamps those per response.

- **S3-FIFO eviction, byte-accounted.** A small probationary FIFO
  (~10% of capacity) absorbs new keys; only entries re-referenced while
  probationary promote into the main queue, so one-hit wonders — the
  bulk of a Zipf tail — wash through without displacing the hot set.
  Keys evicted from the small queue leave a GHOST (key only, no value);
  a ghost's return re-inserts directly into main. Main evicts lazily:
  a re-referenced entry gets its frequency decremented and re-queued
  instead of dying. Capacity is bytes of cached payloads
  (``--result_cache_mb``), not entry count — responses vary 100x in
  size and a count bound would be meaningless.

- **versioned invalidation, never a flush.** Every key embeds the fleet
  generation version active AT ADMISSION. A committed rolling swap flips
  the active version — old entries become instantly invisible (misses
  recompute against the new weights) but stay resident until eviction;
  ``rollback`` flips the version back and the old generation's entries
  are valid again BITWISE, because entries are the exact payloads those
  weights produced. While a roll is in progress the cache stands down
  entirely (no hits, no fills): mid-roll the fleet is mixed-version and
  no single version label would be truthful.

Concurrent identical misses COALESCE: the first becomes the leader (it
is the one that enqueues and reaches a replica), later arrivals attach
to the leader's future — a thundering herd of retries costs one device
call. Errors are never cached; the leader hands its error payload to
followers and the next request retries cold.

Everything here is torch-free, numpy-free, stdlib-only — it runs in the
router process and must add microseconds, not milliseconds. Metrics ride
the shared obs registry under the ``cache.`` namespace
(:meth:`~code2vec_tpu_torch.obs.runtime.RuntimeHealth.namespaced`), so
``/metrics`` exports ``c2v_cache_*`` series with no new schema.
"""

from __future__ import annotations

import hashlib
import json
import struct
from collections import OrderedDict, deque
from concurrent.futures import Future
from dataclasses import dataclass

from code2vec_tpu_torch.obs.sync import make_lock

__all__ = [
    "ResultCache",
    "canonical_bag_digest",
    "canonical_request_key",
    "payload_nbytes",
]

_DIGEST_SIZE = 16  # 128-bit blake2b: collision-safe at any realistic scale

# op-relevant knobs folded into the canonical key, per op. A knob absent
# from the request and a knob sent at its default value produce DIFFERENT
# keys — deliberately conservative: the worst case is a redundant miss,
# never a wrong hit. ``id`` and ``trace`` are correlation fields, not
# request content, and are excluded by construction (only listed fields
# are read).
_KNOB_FIELDS = {
    "predict": ("language", "method_name", "top_k", "include_vector"),
    "embed": ("language", "method_name", "include_vector"),
    "embed_file": ("language", "method_name"),
    "neighbors": (
        "language", "method_name", "top_k", "granularity", "include_vector",
    ),
}


def canonical_bag_digest(contexts) -> str:
    """Order-invariant MULTISET digest of a path-context bag.

    ``contexts`` is any iterable of ``[start, path, end]`` integer rows
    (lists, tuples, or an ``[n, 3]`` array — rows are coerced through
    ``int``). Rows are sorted lexicographically before hashing, so any
    permutation of the same bag digests identically, while duplicate
    rows (a legal multiset) still count: ``[a, a, b] != [a, b]``.
    """
    rows = sorted((int(r[0]), int(r[1]), int(r[2])) for r in contexts)
    h = hashlib.blake2b(digest_size=_DIGEST_SIZE)
    h.update(len(rows).to_bytes(8, "little"))
    for row in rows:
        for v in row:
            h.update(v.to_bytes(8, "little", signed=True))
    return h.hexdigest()


def _vector_digest(vector) -> str:
    floats = [float(v) for v in vector]
    return hashlib.blake2b(
        struct.pack(f"<{len(floats)}d", *floats), digest_size=_DIGEST_SIZE
    ).hexdigest()


def canonical_request_key(request: dict) -> str | None:
    """The version-free canonical key for one data-plane request, or
    ``None`` when the request is not cacheable (control ops, malformed
    bodies, unknown ops — the router then serves it uncached).

    Body identity, in precedence order (mirroring the protocol layer):
    a pre-mapped ``"contexts"`` bag digests as an order-invariant
    multiset; a ``"vector"`` (neighbors) digests its float64 wire values;
    a ``"source"`` string digests its UTF-8 bytes (extraction is
    deterministic, so source identity implies response identity).
    """
    op = request.get("op")
    knobs = _KNOB_FIELDS.get(op)
    if knobs is None:
        return None
    contexts = request.get("contexts")
    if contexts is not None:
        try:
            body = "bag:" + canonical_bag_digest(contexts)
        except (TypeError, ValueError, IndexError):
            return None
    elif isinstance(request.get("vector"), (list, tuple)):
        try:
            body = "vec:" + _vector_digest(request["vector"])
        except (TypeError, ValueError, struct.error):
            return None
    elif isinstance(request.get("source"), str):
        body = "src:" + hashlib.blake2b(
            request["source"].encode("utf-8"), digest_size=_DIGEST_SIZE
        ).hexdigest()
    else:
        return None
    try:
        knob_repr = json.dumps(
            {k: request[k] for k in knobs if k in request}, sort_keys=True
        )
    except (TypeError, ValueError):
        return None
    return f"{op}|{body}|{knob_repr}"


def payload_nbytes(payload) -> int | None:
    """Byte cost of one cached payload: its compact-JSON wire size (what
    a transport would actually send). ``None`` for non-serializable
    values — the caller skips caching those."""
    try:
        return len(
            json.dumps(payload, separators=(",", ":")).encode("utf-8")
        )
    except (TypeError, ValueError):
        return None


@dataclass
class _Entry:
    value: object
    nbytes: int
    freq: int = 0  # capped reference counter (S3-FIFO's 2-bit clock)
    in_main: bool = False


class ResultCache:
    """Bounded-memory S3-FIFO result cache with versioned keys and miss
    coalescing (see module docstring). One lock guards all state — every
    operation is O(1) dict/deque work plus amortized eviction.

    Admission protocol (the router's contract)::

        key = cache.key_for(request)          # None -> serve uncached
        state, held = cache.begin(key)
        # "hit"  -> held IS the cached payload; respond immediately
        # "join" -> held is the in-flight leader's Future; wait on it
        # "lead" -> dispatch, then EXACTLY ONE of:
        cache.fill(key, payload)              # cache + resolve joiners
        cache.abandon(key, payload)           # resolve joiners, no cache

    A leader that never calls ``fill``/``abandon`` strands its joiners —
    the router guarantees one of the two on every admitted request's
    single exit point (including close-time drains and admission sheds).
    """

    def __init__(
        self,
        capacity_bytes: int,
        *,
        small_fraction: float = 0.1,
        ghost_entries: int = 4096,
        health=None,
        version: str = "v0",
    ) -> None:
        if capacity_bytes <= 0:
            raise ValueError(
                f"capacity_bytes must be > 0, got {capacity_bytes}"
            )
        self._capacity = int(capacity_bytes)
        self._small_target = max(1, int(self._capacity * small_fraction))
        self._ghost_cap = int(ghost_entries)
        self._lock = make_lock("fleet.cache")
        self._entries: dict[tuple, _Entry] = {}
        self._small: deque[tuple] = deque()
        self._main: deque[tuple] = deque()
        self._ghost: OrderedDict[tuple, None] = OrderedDict()
        self._inflight: dict[tuple, Future] = {}
        self._bytes = 0
        self._small_bytes = 0
        self._version = str(version)
        self._swapping = False
        self._per_version: dict[str, int] = {}
        # plain ints for the health/stats() block; the namespaced obs
        # counters below feed /metrics — same numbers, two consumers
        self._hits = self._misses = self._coalesced = 0
        self._inserts = self._evictions = self._rejected = 0
        ns = health.namespaced("cache") if health is not None else None
        self._c_hits = ns.counter("hits") if ns else None
        self._c_misses = ns.counter("misses") if ns else None
        self._c_coalesced = ns.counter("coalesced") if ns else None
        self._c_evictions = ns.counter("evictions") if ns else None
        self._c_inserts = ns.counter("inserts") if ns else None
        self._c_rejected = ns.counter("rejected_oversize") if ns else None
        self._g_bytes = ns.gauge("bytes") if ns else None
        self._g_entries = ns.gauge("entries") if ns else None
        self._g_inflight = ns.gauge("in_flight") if ns else None
        self._g_versions = ns.gauge("versions_resident") if ns else None
        self._sync_gauges()

    # ---- version lifecycle ----------------------------------------------
    @property
    def active_version(self) -> str | None:
        """The version new keys are minted under; None mid-roll (the
        fleet is mixed-version — nothing is cacheable)."""
        with self._lock:
            return None if self._swapping else self._version

    def set_version(self, version: str) -> None:
        """Flip the active version (commit forward OR rollback — entries
        under every version stay resident; only visibility flips)."""
        with self._lock:
            self._version = str(version)
            self._swapping = False

    def begin_swap(self) -> None:
        """A rolling swap started: stand down (no hits, no fills) until
        :meth:`end_swap` — replicas disagree on weights mid-roll."""
        with self._lock:
            self._swapping = True

    def end_swap(self, version: str | None = None) -> None:
        """The roll finished. ``version`` is the committed generation
        (new keys mint under it); None means the roll failed and the
        incumbent version — whose entries never stopped being true —
        resumes."""
        with self._lock:
            if version is not None:
                self._version = str(version)
            self._swapping = False

    # ---- key derivation --------------------------------------------------
    def key_for(self, request: dict) -> tuple | None:
        """Full versioned key ``(version, canonical_key)`` for one
        request, or None when the request is uncacheable or the cache is
        standing down mid-roll. The version is captured HERE, at
        admission: a swap committing while the request is in flight must
        not relabel its eventual fill."""
        with self._lock:
            if self._swapping:
                return None
            version = self._version
        ckey = canonical_request_key(request)
        if ckey is None:
            return None
        return (version, ckey)

    # ---- admission / coalescing -----------------------------------------
    def begin(self, key: tuple):
        """See the class docstring: ``("hit", payload)``,
        ``("join", leader_future)``, or ``("lead", leader_future)``."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                entry.freq = min(entry.freq + 1, 3)
                self._hits += 1
                if self._c_hits:
                    self._c_hits.inc()
                return ("hit", entry.value)
            leader = self._inflight.get(key)
            if leader is not None:
                self._coalesced += 1
                if self._c_coalesced:
                    self._c_coalesced.inc()
                return ("join", leader)
            future: Future = Future()
            self._inflight[key] = future
            self._misses += 1
            if self._c_misses:
                self._c_misses.inc()
            if self._g_inflight:
                self._g_inflight.set(len(self._inflight))
            return ("lead", future)

    def fill(self, key: tuple, value, nbytes: int | None = None) -> None:
        """Leader completion: insert the payload and resolve joiners.
        ``nbytes`` defaults to the payload's JSON wire size; a payload
        that cannot be sized (non-JSON value without an explicit size)
        resolves joiners but is not cached."""
        if nbytes is None:
            nbytes = payload_nbytes(value)
        with self._lock:
            leader = self._inflight.pop(key, None)
            if nbytes is not None:
                self._insert(key, value, int(nbytes))
            if self._g_inflight:
                self._g_inflight.set(len(self._inflight))
        # resolve OUTSIDE the lock: joiner callbacks run synchronously
        # here and must be free to re-enter the cache
        if leader is not None and not leader.done():
            leader.set_result(value)

    def abandon(self, key: tuple, value) -> None:
        """Leader completion WITHOUT caching (error payloads, shed-at-
        admission, close-time drains): joiners still get the payload —
        they attached to this attempt and inherit its outcome verbatim —
        but the next identical request retries cold."""
        with self._lock:
            leader = self._inflight.pop(key, None)
            if self._g_inflight:
                self._g_inflight.set(len(self._inflight))
        if leader is not None and not leader.done():
            leader.set_result(value)

    # ---- S3-FIFO internals (lock held) ----------------------------------
    def _insert(self, key: tuple, value, nbytes: int) -> None:
        if nbytes > self._capacity:
            self._rejected += 1
            if self._c_rejected:
                self._c_rejected.inc()
            return
        entry = self._entries.get(key)
        if entry is not None:
            # refill of a resident key (race between two version flips):
            # update in place, keep queue position
            delta = nbytes - entry.nbytes
            entry.value, entry.nbytes = value, nbytes
            self._bytes += delta
            if not entry.in_main:
                self._small_bytes += delta
        else:
            in_main = self._ghost.pop(key, "__missing__") is None
            entry = _Entry(value=value, nbytes=nbytes, in_main=in_main)
            self._entries[key] = entry
            (self._main if in_main else self._small).append(key)
            self._bytes += nbytes
            if not in_main:
                self._small_bytes += nbytes
            self._per_version[key[0]] = self._per_version.get(key[0], 0) + 1
            self._inserts += 1
            if self._c_inserts:
                self._c_inserts.inc()
        while self._bytes > self._capacity:
            if self._small and (
                self._small_bytes > self._small_target or not self._main
            ):
                self._evict_small()
            elif self._main:
                self._evict_main()
            else:  # pragma: no cover - capacity > 0 guarantees progress
                break
        self._sync_gauges()

    def _evict_small(self) -> None:
        key = self._small.popleft()
        entry = self._entries[key]
        self._small_bytes -= entry.nbytes
        if entry.freq > 0:
            # re-referenced while probationary: promote (this is what
            # keeps one-hit wonders from ever displacing the hot set)
            entry.freq = 0
            entry.in_main = True
            self._main.append(key)
        else:
            self._drop(key, entry)
            self._ghost[key] = None
            while len(self._ghost) > self._ghost_cap:
                self._ghost.popitem(last=False)

    def _evict_main(self) -> None:
        key = self._main.popleft()
        entry = self._entries[key]
        if entry.freq > 0:
            entry.freq -= 1
            self._main.append(key)  # lazy promotion: second chance
        else:
            self._drop(key, entry)

    def _drop(self, key: tuple, entry: _Entry) -> None:
        del self._entries[key]
        self._bytes -= entry.nbytes
        remaining = self._per_version.get(key[0], 1) - 1
        if remaining > 0:
            self._per_version[key[0]] = remaining
        else:
            self._per_version.pop(key[0], None)
        self._evictions += 1
        if self._c_evictions:
            self._c_evictions.inc()

    def _sync_gauges(self) -> None:
        if self._g_bytes:
            self._g_bytes.set(self._bytes)
        if self._g_entries:
            self._g_entries.set(len(self._entries))
        if self._g_versions:
            self._g_versions.set(len(self._per_version))

    # ---- introspection ---------------------------------------------------
    def stats(self) -> dict:
        """The fleet-health cache block: counters, byte accounting, the
        active version, and per-version resident entry counts (the
        rollback story made visible — old generations' entries survive a
        commit)."""
        with self._lock:
            return {
                "capacity_bytes": self._capacity,
                "bytes": self._bytes,
                "entries": len(self._entries),
                "active_version": (
                    None if self._swapping else self._version
                ),
                "swapping": self._swapping,
                "hits": self._hits,
                "misses": self._misses,
                "coalesced": self._coalesced,
                "inserts": self._inserts,
                "evictions": self._evictions,
                "rejected_oversize": self._rejected,
                "in_flight": len(self._inflight),
                "ghost_entries": len(self._ghost),
                "versions": dict(self._per_version),
            }
