"""SLO classes: per-op queue budgets and deadlines, tiered shedding.

Counterpart of ``code2vec_tpu/serve/fleet/slo.py``.

The single-process batcher bounds load with ONE global ``max_pending`` —
correct for one queue, wrong for a fleet where a burst of expensive
``neighbors`` scans must not starve cheap ``embed`` calls or the health
probes that decide evictions. Every op maps to one of three classes:

==========  ======================================  ==================
class       ops                                      default budget/deadline
==========  ======================================  ==================
health      health, swap_status, reload, rollback,   16 queued / 1000 ms
            shutdown (the control plane)
embed       predict, embed                           256 queued / 2000 ms
neighbors   neighbors                                 64 queued / 5000 ms
==========  ======================================  ==================

Each DATA class owns a bounded router queue (its **budget** — admission
control: a full queue sheds new arrivals with a retryable ``overloaded``
error) and a **deadline**: a request still undispatched past its
deadline is shed with a ``deadline`` error instead of being served
uselessly late (its client has typically given up — serving it anyway is
pure queue poison). Dispatch priority is the tier order above; under
sustained overload the lowest tier backs up and sheds first. The
``health`` tier is how the control plane cuts through saturated traffic:
the router answers/orchestrates those ops INLINE at admission — they
never enter a data queue, so no data-plane backlog can delay a probe or
a swap (its budget/deadline numbers are accepted for config symmetry but
currently have nothing to bound).

``--slo`` grammar: ``class=budget:deadline_ms`` comma-separated, e.g.
``embed=512:1500,neighbors=32:8000`` (unnamed classes keep defaults).

**Error-budget burn accounting** (:class:`SloBurnTracker`): each class
additionally carries a rolling availability window. Every finished
request is recorded as *good* or *bad* (bad = shed on budget, shed on
deadline, or a server-side failure — client mistakes like
``bad_request`` do not burn budget); the tracker maintains per-second
ring buckets over ``window_s`` with running totals, so recording is O(1)
and a snapshot never scans history. The **burn rate** is the SRE
convention: observed error fraction divided by the allowed error
fraction ``1 - objective`` — burn 1.0 means the window is consuming its
budget exactly as fast as allowed; above 1.0 the budget depletes.
Crossing into exhaustion (burn >= 1 with enough traffic to mean it)
emits one ``slo_budget_exhausted`` event per episode and flips the
``slo.<class>.budget_exhausted`` gauge; recovery flips it back. Gauges
(``burn_rate`` / ``budget_remaining``) land in the shared registry on
every record, so ``health`` and ``GET /metrics`` surface them with no
extra bookkeeping.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from code2vec_tpu_torch.obs.sync import make_lock

__all__ = [
    "DEFAULT_SLO",
    "PRIORITY",
    "SloBurnTracker",
    "SloClass",
    "classify_op",
    "parse_slo_spec",
]


@dataclass(frozen=True)
class SloClass:
    """One service tier: admission budget + usefulness deadline."""

    name: str
    budget: int  # max queued (not yet dispatched) requests router-wide
    deadline_ms: float  # shed instead of dispatching past this age

    def __post_init__(self) -> None:
        if self.budget < 1:
            raise ValueError(f"{self.name}: budget must be >= 1, got "
                             f"{self.budget}")
        if self.deadline_ms <= 0:
            raise ValueError(f"{self.name}: deadline_ms must be > 0, got "
                             f"{self.deadline_ms}")


DEFAULT_SLO: dict[str, SloClass] = {
    "health": SloClass("health", budget=16, deadline_ms=1000.0),
    "embed": SloClass("embed", budget=256, deadline_ms=2000.0),
    "neighbors": SloClass("neighbors", budget=64, deadline_ms=5000.0),
}

# dispatch order under contention: control plane > embed > neighbors
PRIORITY: tuple[str, ...] = ("health", "embed", "neighbors")

_OP_CLASS = {
    "predict": "embed",
    "embed": "embed",
    "neighbors": "neighbors",
    "health": "health",
    "swap_status": "health",
    "reload": "health",
    "rollback": "health",
    "shutdown": "health",
    "flights": "health",
}


def classify_op(op) -> str | None:
    """SLO class name for one request op; None = unknown op."""
    return _OP_CLASS.get(op)


def parse_slo_spec(
    spec: str | None, base: dict[str, SloClass] | None = None
) -> dict[str, SloClass]:
    """Parse ``class=budget:deadline_ms,...`` over ``base`` defaults."""
    classes = dict(base if base is not None else DEFAULT_SLO)
    if not spec:
        return classes
    for clause in spec.split(","):
        clause = clause.strip()
        if not clause:
            continue
        try:
            name, rest = clause.split("=", 1)
            budget, deadline = rest.split(":", 1)
        except ValueError:
            raise ValueError(
                f"bad --slo clause {clause!r}: expected "
                "class=budget:deadline_ms"
            ) from None
        name = name.strip()
        if name not in classes:
            raise ValueError(
                f"unknown SLO class {name!r}; have {sorted(classes)}"
            )
        classes[name] = SloClass(
            name, budget=int(budget), deadline_ms=float(deadline)
        )
    return classes


class _BurnWindow:
    """One class's rolling availability window: per-second (good, bad)
    ring buckets + running totals, advanced lazily on record/snapshot."""

    __slots__ = (
        "good", "bad", "_buckets", "_head", "_head_second", "exhausted",
    )

    def __init__(self, n_buckets: int) -> None:
        self.good = 0
        self.bad = 0
        self._buckets = [[0, 0] for _ in range(n_buckets)]
        self._head = 0
        self._head_second: int | None = None
        self.exhausted = False

    def advance(self, now_second: int) -> None:
        if self._head_second is None:
            self._head_second = now_second
            return
        steps = now_second - self._head_second
        if steps <= 0:
            return
        # expire at most a full ring of buckets (amortized O(1): each
        # recorded second is expired exactly once)
        for _ in range(min(steps, len(self._buckets))):
            self._head = (self._head + 1) % len(self._buckets)
            expired = self._buckets[self._head]
            self.good -= expired[0]
            self.bad -= expired[1]
            expired[0] = expired[1] = 0
        self._head_second = now_second

    def record(self, now_second: int, good: bool) -> None:
        self.advance(now_second)
        bucket = self._buckets[self._head]
        if good:
            bucket[0] += 1
            self.good += 1
        else:
            bucket[1] += 1
            self.bad += 1


class SloBurnTracker:
    """Rolling error-budget accounting per SLO class (module docstring).

    ``classes``: the class names to track (the keys of an SLO dict, or
    any iterable of names). ``objective`` is the
    availability target (0.999 = 0.1% error budget); ``window_s`` the
    rolling window; ``min_requests`` stops a single early failure from
    declaring a near-empty window exhausted. ``health``/``events`` are
    the shared obs registry and event log the gauges/exhaustion events
    land on; ``clock`` is injectable for tests.
    """

    def __init__(
        self,
        classes,
        *,
        objective: float = 0.999,
        window_s: float = 60.0,
        min_requests: int = 10,
        health=None,
        events=None,
        clock=time.monotonic,
    ) -> None:
        if not 0.0 < objective < 1.0:
            raise ValueError(
                f"objective must be in (0, 1), got {objective}"
            )
        if window_s < 1.0:
            raise ValueError(f"window_s must be >= 1, got {window_s}")
        self.objective = float(objective)
        self.window_s = float(window_s)
        self.min_requests = int(min_requests)
        self._health = health
        self._events = events
        self._clock = clock
        self._lock = make_lock("fleet.slo")
        n_buckets = int(window_s) + 1
        self._windows: dict[str, _BurnWindow] = {
            name: _BurnWindow(n_buckets) for name in classes
        }
        if not self._windows:
            raise ValueError("SloBurnTracker needs at least one class")

    def _burn(self, window: _BurnWindow) -> tuple[float, int]:
        total = window.good + window.bad
        if total == 0:
            return 0.0, 0
        error_fraction = window.bad / total
        return error_fraction / (1.0 - self.objective), total

    def record(self, cls: str, good: bool) -> None:
        """O(1) per finished request: bucket update + two gauge writes;
        emits ``slo_budget_exhausted`` on the transition into burn >= 1."""
        window = self._windows.get(cls)
        if window is None:
            return
        newly_exhausted = False
        with self._lock:
            window.record(int(self._clock()), good)
            burn, total = self._burn(window)
            exhausted = burn >= 1.0 and total >= self.min_requests
            if exhausted and not window.exhausted:
                newly_exhausted = True
            window.exhausted = exhausted
            good_n, bad_n = window.good, window.bad
        if self._health is not None:
            self._health.gauge(f"slo.{cls}.burn_rate").set(round(burn, 4))
            self._health.gauge(f"slo.{cls}.budget_remaining").set(
                round(max(0.0, 1.0 - burn), 4)
            )
            self._health.gauge(f"slo.{cls}.budget_exhausted").set(
                1 if exhausted else 0
            )
        if newly_exhausted and self._events is not None:
            try:
                self._events.emit(
                    "slo_budget_exhausted", slo_class=cls,
                    burn_rate=round(burn, 4), objective=self.objective,
                    window_s=self.window_s, good=good_n, bad=bad_n,
                )
            except Exception:  # pragma: no cover - closed log
                pass

    def snapshot(self) -> dict:
        """Per-class burn block for ``health`` payloads:
        window totals, burn rate, remaining budget, exhaustion flag."""
        out = {}
        with self._lock:
            for cls, window in self._windows.items():
                window.advance(int(self._clock()))
                burn, total = self._burn(window)
                out[cls] = {
                    "good": window.good,
                    "bad": window.bad,
                    "burn_rate": round(burn, 4),
                    "budget_remaining": round(max(0.0, 1.0 - burn), 4),
                    "exhausted": bool(
                        burn >= 1.0 and total >= self.min_requests
                    ),
                    "objective": self.objective,
                    "window_s": self.window_s,
                }
        return out
