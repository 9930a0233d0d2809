"""Runtime health: counters, gauges, latency histograms, the Prometheus
exposition and the slow-request flight recorder.

Counterpart of ``code2vec_tpu/obs/runtime.py``: the registry
(:class:`RuntimeHealth`, :func:`global_health`) every serving and training
layer records into, its Prometheus text exposition
(:func:`prometheus_text`, :func:`parse_prometheus_text`, the
``c2v_build_info`` gauge naming torch, CUDA and the card), the
:class:`FlightRecorder`, and the training half: the
:class:`RecompileDetector` and the per-epoch memory sampler
(:func:`memory_snapshot`). Metric names are the JAX package's, so one
dashboard reads both.

Standard library only: the fleet router imports it without ``torch``
(the device memory sampler reads torch only when the process has it).
"""

from __future__ import annotations

import collections
import json
import logging
import os
import re
import threading
import time

# no cycle: obs.sync reaches back into this module only lazily (inside its
# metric-recording path), so the factory import is safe at module top
from code2vec_tpu_torch.obs import handles
from code2vec_tpu_torch.obs.sync import make_lock

logger = logging.getLogger(__name__)

__all__ = [
    "Counter",
    "FlightRecorder",
    "Gauge",
    "LatencyHistogram",
    "NamespacedHealth",
    "RecompileDetector",
    "RuntimeHealth",
    "build_info",
    "build_info_text",
    "device_memory_stats",
    "global_health",
    "host_cpu_fingerprint",
    "host_rss_bytes",
    "memory_snapshot",
    "parse_prometheus_text",
    "prometheus_metric_name",
    "prometheus_text",
]


class Counter:
    """A monotonically increasing count (thread-safe)."""

    def __init__(self) -> None:
        self._value = 0
        # plain on purpose: metric primitives are the lock sanitizer's own
        # recording substrate — tracing them would recurse
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """A last-written-wins measurement (thread-safe by assignment)."""

    def __init__(self) -> None:
        self._value: float | None = None

    def set(self, value) -> None:
        self._value = value

    @property
    def value(self):
        return self._value


class LatencyHistogram:
    """Latency samples with percentile summaries (thread-safe).

    The serving layer records one sample per request per phase
    (queue_wait / pad / device / postprocess plus end-to-end), and the
    p50/p99 are read from here. Exact samples, not buckets: serving test runs are
    10^3-10^5 requests, where a sorted copy per summary is cheap and
    bucket-boundary error would dominate a p99 over so few samples.
    ``max_samples`` bounds memory on long-lived servers: past the cap the
    buffer becomes a sliding window over the most recent samples (the
    regime a live server's percentiles should reflect anyway); ``count``
    keeps the true total.
    """

    def __init__(self, max_samples: int = 200_000) -> None:
        self._samples: list[float] = []
        self._count = 0
        self._sum = 0.0  # over ALL samples ever (Prometheus summary _sum)
        self._max = int(max_samples)
        self._lock = threading.Lock()  # plain on purpose: sanitizer substrate

    def record(self, value_ms: float) -> None:
        with self._lock:
            self._count += 1
            self._sum += float(value_ms)
            if len(self._samples) < self._max:
                self._samples.append(float(value_ms))
            else:
                # count is post-increment: sample #i lives at (i-1) % max,
                # so the overwrite must use the same 0-based index or the
                # oldest sample survives a full extra window
                self._samples[(self._count - 1) % self._max] = float(value_ms)

    @property
    def count(self) -> int:
        return self._count

    def summary(self) -> dict | None:
        # copy under the lock, sort OUTSIDE it: sorting 200k floats while
        # holding the lock would stall the batcher thread's record() calls
        # for the duration of every health poll
        with self._lock:
            samples = list(self._samples)
            count = self._count
            total = self._sum
        if not samples:
            return None
        ordered = sorted(samples)

        def at(q: float) -> float:
            rank = min(
                len(ordered) - 1,
                max(0, int(round(q / 100.0 * (len(ordered) - 1)))),
            )
            return round(ordered[rank], 3)

        return {
            "count": count,
            "p50_ms": at(50),
            "p90_ms": at(90),
            "p99_ms": at(99),
            "max_ms": round(ordered[-1], 3),
            "mean_ms": round(sum(ordered) / len(ordered), 3),
            # all-time sum (not just the window): with count it lets two
            # /metrics scrapes compute an honest rate — the Prometheus
            # summary contract (_sum/_count)
            "sum_ms": round(total, 3),
        }


class RuntimeHealth:
    """Named counters/gauges/latency-histograms registry; one per run,
    snapshot on demand."""

    def __init__(self) -> None:
        # plain on purpose: the registry hands out the sanitizer's metrics
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._latencies: dict[str, LatencyHistogram] = {}
        # identity fields every snapshot carries: process start time and a
        # strictly increasing snapshot sequence number. Two /metrics
        # scrapes (or two health polls) can then compute honest rates and
        # DETECT a counter reset — a respawned replica restarts both at
        # zero, which otherwise reads as a huge negative rate.
        self._started_unix = time.time()
        self._snapshot_seq = 0

    def counter(self, name: str) -> Counter:
        with self._lock:
            return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            return self._gauges.setdefault(name, Gauge())

    def latency(self, name: str) -> LatencyHistogram:
        with self._lock:
            return self._latencies.setdefault(name, LatencyHistogram())

    def namespaced(self, prefix: str) -> "NamespacedHealth":
        """A view of this registry that prefixes every metric name with
        ``prefix`` + '.'. One registry, one snapshot, one schema — but
        subsystems that exist N times per process (fleet replica slots,
        SLO classes) get distinct, greppable metric names instead of
        aliasing one counter."""
        return NamespacedHealth(self, prefix)

    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            latencies = dict(self._latencies)
            self._snapshot_seq += 1
            seq = self._snapshot_seq
        return {
            "started_unix": self._started_unix,
            "snapshot_seq": seq,
            "counters": {k: c.value for k, c in counters.items()},
            "gauges": {k: g.value for k, g in gauges.items()},
            **(
                {
                    "latencies_ms": {
                        k: h.summary() for k, h in latencies.items()
                    }
                }
                if latencies
                else {}
            ),
        }


class NamespacedHealth:
    """Name-prefixing facade over a :class:`RuntimeHealth` (see
    :meth:`RuntimeHealth.namespaced`); metrics land in the PARENT registry
    under ``<prefix>.<name>`` so its snapshot carries them all."""

    def __init__(self, parent: RuntimeHealth, prefix: str) -> None:
        self._parent = parent
        self.prefix = str(prefix)

    def _name(self, name: str) -> str:
        return f"{self.prefix}.{name}"

    def counter(self, name: str) -> Counter:
        return self._parent.counter(self._name(name))

    def gauge(self, name: str) -> Gauge:
        return self._parent.gauge(self._name(name))

    def latency(self, name: str) -> LatencyHistogram:
        return self._parent.latency(self._name(name))

    def namespaced(self, prefix: str) -> "NamespacedHealth":
        return NamespacedHealth(self._parent, self._name(prefix))

    def snapshot(self) -> dict:
        return self._parent.snapshot()


# ---------------------------------------------------------------------------
# Prometheus text exposition (text/plain; version=0.0.4)
# ---------------------------------------------------------------------------

_PROM_INVALID = re.compile(r"[^a-zA-Z0-9_:]")


def prometheus_metric_name(dotted: str, prefix: str = "c2v_") -> str:
    """Sanitize one of the registry's dotted metric names into a legal
    Prometheus metric name: ``serve.op.embed.e2e_ms`` ->
    ``c2v_serve_op_embed_e2e_ms``. The prefix namespaces the whole
    exporter; a leading digit after sanitization gets an underscore."""
    name = _PROM_INVALID.sub("_", str(dotted))
    name = prefix + name
    if not re.match(r"[a-zA-Z_:]", name):  # pragma: no cover - empty prefix
        name = "_" + name
    return name


def _prom_label_str(labels: dict) -> str:
    if not labels:
        return ""
    parts = []
    for key, value in sorted(labels.items()):
        # the exposition format's three label escapes: backslash, quote,
        # newline (an unescaped newline would split the sample line)
        value = (
            str(value)
            .replace("\\", r"\\")
            .replace('"', r"\"")
            .replace("\n", r"\n")
        )
        parts.append(f'{key}="{value}"')
    return "{" + ",".join(parts) + "}"


def _prom_number(value) -> str:
    # integers stay exact; floats use repr (full precision, strict JSON
    # numbers are valid Prometheus values)
    if isinstance(value, bool):  # pragma: no cover - gauges never store bools
        return "1" if value else "0"
    if isinstance(value, int):
        return str(value)
    return repr(float(value))


def prometheus_text(
    sources, prefix: str = "c2v_"
) -> str:
    """Serialize health snapshots as Prometheus text exposition 0.0.4.

    ``sources``: iterable of ``(labels_dict, snapshot_dict)`` pairs — one
    pair for a single process, one per replica (``{"replica": "r0"}``)
    for the fleet router's aggregated view. Snapshots are the plain
    dicts :meth:`RuntimeHealth.snapshot` returns (or the same block
    embedded in a replica's ``health`` payload), so serialization never
    touches live registries, locks, or device state — the lock-light
    scrape contract.

    Counters export as ``counter``, numeric gauges as ``gauge``
    (non-numeric gauges — e.g. the transport name — are skipped), and
    latency histograms as ``summary`` series: ``quantile`` labels for
    p50/p90/p99 plus ``_sum``/``_count``. ``started_unix`` becomes the
    conventional ``process_start_time_seconds`` and ``snapshot_seq`` a
    gauge, so scrapers can compute honest rates and detect counter
    resets across replica respawns.
    """
    # metric name -> {"type": t, "samples": [(labels, value)]}; insertion
    # order preserved so the output groups each metric's series under ONE
    # # TYPE header (the exposition format requires it)
    series: dict[str, dict] = {}

    def add(name: str, mtype: str, labels: dict, value) -> None:
        entry = series.setdefault(name, {"type": mtype, "samples": []})
        entry["samples"].append((labels, value))

    for labels, snapshot in sources:
        labels = dict(labels or {})
        started = snapshot.get("started_unix")
        if isinstance(started, (int, float)):
            add(
                prometheus_metric_name("process_start_time_seconds", prefix),
                "gauge", labels, float(started),
            )
        seq = snapshot.get("snapshot_seq")
        if isinstance(seq, (int, float)):
            add(
                prometheus_metric_name("health_snapshot_seq", prefix),
                "gauge", labels, seq,
            )
        for key, value in (snapshot.get("counters") or {}).items():
            if isinstance(value, (int, float)) and not isinstance(value, bool):
                add(
                    prometheus_metric_name(key, prefix) + "_total",
                    "counter", labels, value,
                )
        for key, value in (snapshot.get("gauges") or {}).items():
            if isinstance(value, (int, float)) and not isinstance(value, bool):
                add(prometheus_metric_name(key, prefix), "gauge", labels, value)
        for key, summary in (snapshot.get("latencies_ms") or {}).items():
            if not isinstance(summary, dict):
                continue
            base = prometheus_metric_name(key, prefix)
            for quantile, field in (
                ("0.5", "p50_ms"), ("0.9", "p90_ms"), ("0.99", "p99_ms"),
            ):
                if isinstance(summary.get(field), (int, float)):
                    add(
                        base, "summary",
                        {**labels, "quantile": quantile}, summary[field],
                    )
            if isinstance(summary.get("sum_ms"), (int, float)):
                add(base + "_sum", "summary:sum", labels, summary["sum_ms"])
            if isinstance(summary.get("count"), (int, float)):
                add(base + "_count", "summary:count", labels, summary["count"])

    lines = []
    emitted_type: set[str] = set()
    for name, entry in series.items():
        mtype = entry["type"]
        # _sum/_count ride their summary's TYPE header, not their own
        base = name
        if mtype.startswith("summary:"):
            base = name[: -len("_sum")] if mtype == "summary:sum" else (
                name[: -len("_count")]
            )
            mtype = "summary"
        if base not in emitted_type:
            lines.append(f"# TYPE {base} {mtype}")
            emitted_type.add(base)
        for labels, value in entry["samples"]:
            lines.append(f"{name}{_prom_label_str(labels)} {_prom_number(value)}")
    return "\n".join(lines) + ("\n" if lines else "")


def build_info(extra: dict | None = None) -> dict:
    """Build/runtime identity labels for the ``c2v_build_info`` gauge.

    torch's version comes from package metadata (no import), so a
    torch-free process — the fleet router — can report it without opening
    a CUDA context; ``cuda_version``/``device_kind`` appear only when the
    caller's process already imported torch and sees a card (workers).
    """
    import platform
    import sys as _sys

    info = {"python_version": platform.python_version()}
    try:
        import code2vec_tpu_torch

        info["package_version"] = getattr(code2vec_tpu_torch, "__version__", "unknown")
    except Exception:  # pragma: no cover - package always importable in-tree
        info["package_version"] = "unknown"
    try:
        from importlib import metadata as _im

        info["torch_version"] = _im.version("torch")
    except Exception:
        info["torch_version"] = "absent"
    torch = _sys.modules.get("torch")
    if torch is not None:
        try:
            info["cuda_version"] = str(torch.version.cuda)
            if torch.cuda.is_initialized():
                info["device_kind"] = str(torch.cuda.get_device_name(0))
        except Exception:  # pragma: no cover - a broken CUDA install
            pass
    if extra:
        info.update({k: str(v) for k, v in extra.items()})
    return info


def build_info_text(extra: dict | None = None, prefix: str = "c2v_") -> str:
    """The conventional Prometheus info-gauge: constant 1, identity in
    labels. Prepend to an exposition body (workers and the router both
    do) so every scrape carries version/backend provenance."""
    name = prometheus_metric_name("build_info", prefix)
    labels = _prom_label_str(build_info(extra))
    return f"# TYPE {name} gauge\n{name}{labels} 1\n"


_PROM_SAMPLE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r"\s+(?P<value>[^\s]+)\s*$"
)
# label values may contain escaped quotes/backslashes/newlines — match
# escape pairs atomically so \" does not terminate the value early
_PROM_LABEL = re.compile(
    r'(?P<key>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<value>(?:[^"\\]|\\.)*)"'
)


_PROM_ESCAPES = {"n": "\n", '"': '"', "\\": "\\"}


def _prom_unescape(value: str) -> str:
    # left-to-right over escape PAIRS: sequential str.replace would turn
    # the escaped-backslash-then-n sequence into a spurious newline
    return re.sub(
        r"\\(.)",
        lambda m: _PROM_ESCAPES.get(m.group(1), m.group(0)),
        value,
    )


def parse_prometheus_text(text: str) -> dict:
    """Parse exposition text back into
    ``{metric_name: [{"labels": {...}, "value": float}, ...]}`` plus a
    ``"# types"`` entry mapping metric -> declared type. Strict enough to
    catch a malformed exporter (the tests use it); raises ``ValueError``
    on an unparseable line."""
    metrics: dict = {}
    types: dict[str, str] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        match = _PROM_SAMPLE.match(line)
        if match is None:
            raise ValueError(f"bad exposition line {lineno}: {line!r}")
        labels = {
            m.group("key"): _prom_unescape(m.group("value"))
            for m in _PROM_LABEL.finditer(match.group("labels") or "")
        }
        try:
            value = float(match.group("value"))
        except ValueError:
            raise ValueError(
                f"bad sample value on line {lineno}: {line!r}"
            ) from None
        metrics.setdefault(match.group("name"), []).append(
            {"labels": labels, "value": value}
        )
    metrics["# types"] = types
    return metrics


# ---------------------------------------------------------------------------
# slow-request flight recorder
# ---------------------------------------------------------------------------


class FlightRecorder:
    """Bounded reservoir of full per-request span breakdowns for the tail.

    A latency histogram says *that* p99 spiked; a tail-latency incident
    needs to know *where one slow request spent its time*. The batcher
    and the fleet router feed every finished request's breakdown
    (queue-wait / pad / device / postprocess, queue depths at admission,
    trace id) through :meth:`observe`; a request is CAPTURED when its
    end-to-end latency exceeds ``threshold_ms`` (when set) or the
    recorder's own rolling p99 estimate — so roughly the worst ~1% of
    requests always leave a concrete per-request timeline behind.

    O(1) per request on the hot path: one deque append plus comparisons;
    the p99 estimate re-sorts a small recent-latency window only every
    ``_REFRESH`` observations (amortized O(1)). Captured records land in
    a bounded deque (oldest evicted), are emitted as ``flight`` events
    when an event log is attached, and :meth:`dump` writes them as
    ``flight_<seq>.json`` files for offline forensics.
    """

    _REFRESH = 64  # re-estimate p99 every this many observations
    _MIN_SAMPLES = 100  # p99 sampling stays off until this many seen

    def __init__(
        self,
        capacity: int = 256,
        threshold_ms: float | None = None,
        p99_window: int = 512,
        events=None,
        health: RuntimeHealth | None = None,
    ) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.threshold_ms = (
            float(threshold_ms) if threshold_ms is not None else None
        )
        self._records: collections.deque[dict] = collections.deque(
            maxlen=int(capacity)
        )
        self._recent: collections.deque[float] = collections.deque(
            maxlen=int(p99_window)
        )
        self._p99: float | None = None
        self._since_refresh = 0
        self._seen = 0
        self._capture_seq = 0
        self._events = events
        self._captured = (
            health.counter("flight.recorded") if health is not None else Counter()
        )
        self._lock = make_lock("obs.flight_recorder")
        handles.track(self, "flight_recorder")

    @property
    def count(self) -> int:
        """How many requests have been captured (all-time, not capacity)."""
        return self._captured.value

    @property
    def seen(self) -> int:
        return self._seen

    def observe(self, e2e_ms: float, record: dict) -> bool:
        """Feed one finished request; returns True when it was captured.
        ``record`` is the caller-built span breakdown (shallow-copied on
        capture, untouched otherwise)."""
        e2e_ms = float(e2e_ms)
        with self._lock:
            self._seen += 1
            self._recent.append(e2e_ms)
            self._since_refresh += 1
            if self._since_refresh >= self._REFRESH or (
                self._p99 is None and self._seen >= self._MIN_SAMPLES
            ):
                ordered = sorted(self._recent)
                rank = min(
                    len(ordered) - 1, int(round(0.99 * (len(ordered) - 1)))
                )
                self._p99 = ordered[rank]
                self._since_refresh = 0
            capture = (
                self.threshold_ms is not None and e2e_ms >= self.threshold_ms
            ) or (
                self._p99 is not None
                and self._seen >= self._MIN_SAMPLES
                and e2e_ms >= self._p99
            )
            if not capture:
                return False
            captured = {
                "flight_seq": self._capture_seq,
                "e2e_ms": round(e2e_ms, 3),
                **record,
            }
            self._capture_seq += 1
            self._records.append(captured)
        self._captured.inc()
        if self._events is not None:
            try:
                self._events.emit("flight", **captured)
            except Exception:  # pragma: no cover - closed log
                logger.warning("could not emit flight event", exc_info=True)
        return True

    def snapshot(self) -> list[dict]:
        """The captured records currently in the reservoir (oldest first)."""
        with self._lock:
            return [dict(r) for r in self._records]

    def dump(self, out_dir: str) -> list[str]:
        """Write every resident record as ``<out_dir>/flight_<seq>.json``;
        returns the paths (the ``flight_*.json`` artifacts a tail-latency
        incident is debugged from)."""
        records = self.snapshot()
        os.makedirs(out_dir, exist_ok=True)
        from code2vec_tpu_torch.obs.events import sanitize

        paths = []
        for record in records:
            path = os.path.join(
                out_dir, f"flight_{record['flight_seq']:06d}.json"
            )
            with open(path, "w", encoding="utf-8") as f:
                json.dump(sanitize(record), f, indent=1)
            paths.append(path)
        return paths

    def close(self) -> None:
        """Retire the recorder from the handle ledger. Resident records
        stay readable (``dump`` after close is fine — the teardown paths
        dump last); idempotent."""
        handles.untrack(self)


_global_health: RuntimeHealth | None = None
_global_health_lock = threading.Lock()  # plain on purpose: sanitizer substrate


def global_health() -> RuntimeHealth:
    """Process-wide counter/gauge registry: the serving layers (engine,
    batcher, swap controller, server, router) record here; it is never
    reset."""
    global _global_health
    with _global_health_lock:
        if _global_health is None:
            _global_health = RuntimeHealth()
        return _global_health


class RecompileDetector:
    """Count post-warmup first sightings of a new step input signature.

    JAX counts ``jax.jit`` cache misses of its train and eval steps. The
    port compiles nothing at run time, but a new ``(batch, width, dtype)``
    of a step is what a miss would be there: a shape the run did not plan
    for (a cuBLAS heuristic, a kernel grid, an allocator bucket met for the
    first time). The loop reports each step's signature through
    :meth:`observe`; :meth:`check` (once an epoch) compares the count of
    distinct signatures with the last check's. The first check is the
    warmup, unless ``expected_compiles`` (the ladder's rungs) gives the
    budget: growth within it is silent at every check. Growth beyond fires
    the ``recompiles`` counter, a ``recompile`` trace mark and event, as
    JAX's does. A steady-shape run stays at 0."""

    def __init__(self, events=None, health: RuntimeHealth | None = None):
        self._events = events
        self._counter = health.counter("recompiles") if health is not None else Counter()
        # name -> [set of signatures seen, last checked count or None (pre-warmup)]
        self._tracked: dict[str, list] = {}

    def track(self, name: str, expected_compiles: int | None = None) -> None:
        baseline = None
        if expected_compiles is not None:
            if expected_compiles < 1:
                raise ValueError(f"expected_compiles must be >= 1, got {expected_compiles}")
            baseline = int(expected_compiles)
        self._tracked[name] = [set(), baseline]

    def observe(self, name: str, signature) -> None:
        """Record one call's input signature (a set insert: per step)."""
        slot = self._tracked.get(name)
        if slot is not None:
            slot[0].add(signature)

    @property
    def recompile_count(self) -> int:
        return self._counter.value

    def check(self, epoch: int | None = None) -> int:
        """Compare every tracked step's signature count with the last
        check's; return the new post-warmup signatures found."""
        new = 0
        for name, slot in self._tracked.items():
            size, last = len(slot[0]), slot[1]
            if last is None:
                slot[1] = size  # warmup: the expected first shapes
                continue
            if size > last:
                delta = size - last
                new += delta
                self._counter.inc(delta)
                from code2vec_tpu_torch.obs.trace import get_tracer

                get_tracer().instant("recompile", category="health", fn=name, delta=delta)
                logger.warning("recompile detected: %s saw %d new input signatures (%d -> %d; "
                               "batch shape/dtype churn?)", name, delta, last, size)
                if self._events is not None:
                    fields = {"fn": name, "cache_size": size, "delta": delta, "lint_hints": []}
                    if epoch is not None:
                        fields["epoch"] = epoch
                    self._events.emit("recompile", **fields)
                slot[1] = size
        return new


def host_cpu_fingerprint() -> str:
    """8-hex digest of the host's CPU feature set (ISA flags + arch):
    stable within a host, different across CPU populations. Standard
    library only."""
    import hashlib
    import platform

    parts = [platform.machine()]
    try:
        with open("/proc/cpuinfo", encoding="utf-8") as f:
            for line in f:
                # x86 exposes "flags", arm64 "Features"; sorted so the
                # kernel's ordering does not churn the digest
                if line.startswith(("flags", "Features")):
                    parts.append(" ".join(sorted(line.split(":", 1)[1].split())))
                    break
    except OSError:
        parts.append(platform.processor() or "")
    return hashlib.sha1("|".join(parts).encode()).hexdigest()[:8]


def host_rss_bytes() -> int | None:
    """Current resident set size, or None off Linux."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):  # pragma: no cover - non-Linux
        return None


def _host_peak_rss_bytes() -> int | None:
    try:
        import resource
        import sys

        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        # Linux reports ru_maxrss in KiB; macOS/BSD in bytes
        return peak * 1024 if sys.platform.startswith("linux") else peak
    except Exception:  # pragma: no cover - a platform without resource
        return None


def device_memory_stats(device=None) -> dict | None:
    """The card's allocator numbers for ``device`` (a ``torch.device`` or
    its string; the current card when None): ``bytes_in_use`` and
    ``peak_bytes_in_use`` from ``torch.cuda.memory_stats``, ``bytes_limit``
    the card's memory. None on the CPU, or when the process has not
    imported torch or initialized CUDA (never imports torch itself)."""
    import sys

    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        if device is not None and torch.device(device).type != "cuda":
            return None
        if not torch.cuda.is_initialized():
            return None
        index = torch.device(device).index if device is not None else None
        index = torch.cuda.current_device() if index is None else index
        stats = torch.cuda.memory_stats(index)
        return {
            "device_kind": torch.cuda.get_device_name(index),
            "n_devices": 1,
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(index).total_memory),
        }
    except Exception:  # the per-epoch sampler must never end a run
        return None


def memory_snapshot(health: RuntimeHealth | None = None, device=None) -> dict:
    """One host and device memory sample (``device``: the run's card);
    mirrored into ``health`` gauges when given. Taken at epoch ends."""
    snap: dict = {
        "host_rss_bytes": host_rss_bytes(),
        "host_peak_rss_bytes": _host_peak_rss_bytes(),
    }
    stats = device_memory_stats(device)
    if stats is not None:
        snap["device"] = stats
    if health is not None:
        for key in ("host_rss_bytes", "host_peak_rss_bytes"):
            if snap[key] is not None:
                health.gauge(key).set(snap[key])
        if stats is not None:
            health.gauge("device_bytes_in_use").set(stats["bytes_in_use"])
    return snap
