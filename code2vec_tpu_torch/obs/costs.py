"""Cost accounting: FLOPs, bytes, device time, MFU, capacity (serving half).

Counterpart of ``code2vec_tpu/obs/costs.py``. Three layers, deliberately
cheap:

**Static costs** — every warmed (batch, width) shape of the serving
engine gets a cost record from :func:`analytic_forward_cost`, a
closed-form model of the gather→encode→attend→pool forward (the JAX
package reads XLA's cost analysis first; the port has no compiler cost
model to read). Every record carries ``cost_source: "analytic"``.

**Dynamic accounting** — :class:`CostAccountant` accumulates device-ms per
shape, riding the batcher's existing fenced ``device_ms`` span. Each
``record()`` is O(1) dict arithmetic — no device syncs, no new timers —
and folds static FLOPs into achieved-FLOP/s, MFU against a per-device-kind
peak table, and a busy fraction, exported as ``perf.*`` gauges
(``c2v_perf_*`` in the Prometheus exposition).

**Capacity** — :func:`fleet_capacity` turns per-replica perf snapshots
into a max-sustainable-QPS estimate: per-rung device-ms/request,
mix-weighted into a per-replica serial-device throughput bound, times
alive replicas.

Override the peak with ``C2V_PEAK_FLOPS`` (an absolute per-device FLOP/s
number). Standard library only: the fleet router imports it without
``torch``; :func:`detect_device_kind` reads torch only when the caller's
process already initialized CUDA.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any, Callable

from code2vec_tpu_torch.obs.sync import make_lock

__all__ = [
    "PEAK_FLOPS",
    "CostAccountant",
    "analytic_forward_cost",
    "detect_device_kind",
    "fleet_capacity",
    "peak_flops",
    "train_step_cost",
]

# Per-device-kind peak FLOP/s in the precision the port's encode runs in:
# TF32 on the tensor cores, dense (K2-K4's 3xTF32 split). Matched by
# lowercase substring against ``device_kind``; first hit wins.
PEAK_FLOPS: dict[str, float] = {
    "h100": 495e12,  # H100 SXM data sheet, TF32 dense
}

# Generous per-core f32 peak for a CPU: 2xFMA x 16-lane AVX-512 x ~4 GHz
# ~ 256 GFLOP/s/core; real sustained throughput is far lower, which keeps
# measured MFU <= 1 on any host.
_CPU_PEAK_PER_CORE = 256e9

_PEAK_ENV = "C2V_PEAK_FLOPS"


def peak_flops(device_kind: str | None) -> float:
    """Peak FLOP/s for a device kind string (``C2V_PEAK_FLOPS`` wins)."""
    env = os.environ.get(_PEAK_ENV)
    if env:
        try:
            value = float(env)
            if value > 0:
                return value
        except ValueError:
            pass
    kind = (device_kind or "").lower()
    for needle, value in PEAK_FLOPS.items():
        if needle in kind:
            return value
    return _CPU_PEAK_PER_CORE * float(os.cpu_count() or 1)


def detect_device_kind() -> str:
    """The card's name when this process already imported torch and
    initialized CUDA, ``"cpu"`` when it imported torch without CUDA, else
    ``"unknown"`` (never imports torch itself)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return "unknown"
    try:
        if torch.cuda.is_initialized():
            return str(torch.cuda.get_device_name(torch.cuda.current_device()))
    except Exception:
        return "unknown"
    return "cpu"


# ---------------------------------------------------------------------------
# static costs


def analytic_forward_cost(
    batch: int,
    width: int,
    *,
    terminal_embed: int,
    path_embed: int,
    encode: int,
    labels: int,
    table_dtype: str = "f32",
) -> dict[str, Any]:
    """Closed-form cost of the fused code2vec forward at one (batch, width).

    FLOP terms (B = batch, L = width/bag, E = encode size; the JAX
    package's model, calibrated there against XLA's cost analysis):

    - encode matmul: ``2·B·L·(2·te+pe)·E`` (Dense, no bias)
    - label head:    ``2·B·E·labels``
    - attention:     ``2·B·L·E`` (context · attention vector)
    - pool:          ``2·B·L·E`` (weighted sum)
    - layernorm:     ``10·B·L·E`` (f32 mean/var/normalize/affine)
    - tanh:          ``B·L·E``
    - softmax:       ``5·B·L`` (max, sub, exp, sum, div over the bag)

    Bytes are a roofline-style estimate (embedding-gather reads + weight
    reads + activation traffic) — good enough for arithmetic intensity,
    not a bus-accurate model.
    """
    b, l = float(batch), float(width)
    concat = 2.0 * terminal_embed + path_embed
    flops = (
        2.0 * b * l * concat * encode  # encode matmul
        + 2.0 * b * encode * labels  # label head
        + 2.0 * b * l * encode  # attention logits
        + 2.0 * b * l * encode  # attention-weighted pool
        + 10.0 * b * l * encode  # layernorm (f32)
        + 1.0 * b * l * encode  # tanh
        + 5.0 * b * l  # masked softmax over the bag
    )
    table_bytes = {"int8": 1.0, "bf16": 2.0}.get(table_dtype, 4.0)
    bytes_accessed = (
        b * l * concat * table_bytes  # embedding gathers
        + (concat * encode + encode * labels + encode) * 4.0  # weights
        + 3.0 * b * l * encode * 4.0  # encoded/ln/tanh activations
        + b * l * concat * 4.0  # concat activation
        + (b * encode + b * labels) * 4.0  # pooled vector + logits
        + b * l * 3.0 * 4.0  # int32 token ids
    )
    return {
        "flops": flops,
        "bytes_accessed": bytes_accessed,
        "arithmetic_intensity": flops / bytes_accessed if bytes_accessed else None,
        "cost_source": "analytic",
    }


def train_step_cost(forward_cost: dict[str, Any], multiplier: float = 3.0) -> dict[str, Any]:
    """A train step's cost from its forward's (forward + backward ~ 3x
    the forward's FLOPs and bytes)."""
    flops = forward_cost.get("flops")
    bytes_accessed = forward_cost.get("bytes_accessed")
    flops = flops * multiplier if flops else None
    bytes_accessed = bytes_accessed * multiplier if bytes_accessed else None
    intensity = flops / bytes_accessed if flops and bytes_accessed else None
    return {
        "flops": flops,
        "bytes_accessed": bytes_accessed,
        "arithmetic_intensity": intensity,
        "cost_source": "analytic",
    }


def _coerce_flops(value: Any) -> float | None:
    """A positive finite FLOP count, or None."""
    try:
        value = float(value)
    except (TypeError, ValueError):
        return None
    if value != value or value <= 0 or value == float("inf"):  # NaN, <= 0, inf
        return None
    return value


# ---------------------------------------------------------------------------
# dynamic accounting


def _exec_key(key: Any) -> str:
    if isinstance(key, tuple):
        return "b{}w{}".format(*key) if len(key) == 2 else "_".join(map(str, key))
    return str(key)


class CostAccountant:
    """Per-executable device-time → achieved-FLOP/s → MFU accumulator.

    ``record()`` is the hot-path entry: a handful of dict additions and
    (optionally) gauge sets under one lock — O(1), no device interaction.
    Static costs arrive via ``register()`` at warmup; shapes that record
    time without a registered cost still get device-ms
    accounting (their FLOPs just don't contribute to MFU).

    Gauges land in the supplied health registry under ``perf.*`` — i.e.
    ``c2v_perf_mfu``, ``c2v_perf_achieved_flops_per_s``,
    ``c2v_perf_busy_fraction``, ``c2v_perf_device_ms_total``,
    ``c2v_perf_peak_flops_per_s`` in the /metrics exposition.  With
    hot-swap, accountants of co-resident engine generations share the
    process registry (last writer wins, same as the other serve gauges);
    per-generation truth lives in each engine's ``perf_summary()``.
    """

    def __init__(
        self,
        device_kind: str | None = None,
        *,
        peak: float | None = None,
        health: Any = None,
        clock: Callable[[], float] = time.perf_counter,
    ) -> None:
        self.device_kind = device_kind or "unknown"
        self.peak = float(peak) if peak else peak_flops(self.device_kind)
        self._health = health
        self._clock = clock
        self._t0 = clock()
        self._lock = make_lock("obs.costs")
        self._execs: dict[str, dict[str, Any]] = {}
        self._device_ms = 0.0
        self._flops_done = 0.0
        self._calls = 0
        self._requests = 0
        if health is not None:
            health.gauge("perf.peak_flops_per_s").set(self.peak)
            health.gauge("perf.device_kind").set(self.device_kind)

    def register(self, key: Any, cost: dict[str, Any] | None) -> None:
        """Attach a static cost record to an executable key."""
        with self._lock:
            entry = self._execs.setdefault(_exec_key(key), self._fresh_entry())
            if cost:
                entry["flops"] = cost.get("flops")
                entry["bytes_accessed"] = cost.get("bytes_accessed")
                entry["arithmetic_intensity"] = cost.get("arithmetic_intensity")
                entry["cost_source"] = cost.get("cost_source")

    @staticmethod
    def _fresh_entry() -> dict[str, Any]:
        return {
            "flops": None,
            "bytes_accessed": None,
            "arithmetic_intensity": None,
            "cost_source": None,
            "device_ms": 0.0,
            "calls": 0,
            "requests": 0,
        }

    def record(self, key: Any, device_ms: float, requests: int = 1) -> None:
        """Fold one fenced device span into the accounting.  O(1)."""
        if device_ms < 0:
            return
        with self._lock:
            entry = self._execs.setdefault(_exec_key(key), self._fresh_entry())
            entry["device_ms"] += device_ms
            entry["calls"] += 1
            entry["requests"] += int(requests)
            self._device_ms += device_ms
            self._calls += 1
            self._requests += int(requests)
            if entry["flops"]:
                self._flops_done += entry["flops"]
            achieved, mfu, busy = self._derived_locked()
        health = self._health
        if health is not None:
            health.gauge("perf.device_ms_total").set(round(self._device_ms, 3))
            health.gauge("perf.busy_fraction").set(busy)
            if achieved is not None:
                health.gauge("perf.achieved_flops_per_s").set(achieved)
                health.gauge("perf.mfu").set(mfu)

    def _derived_locked(self) -> tuple[float | None, float | None, float]:
        device_s = self._device_ms / 1e3
        wall_s = max(self._clock() - self._t0, 1e-9)
        busy = round(min(device_s / wall_s, 1.0), 6)
        if device_s <= 0 or self._flops_done <= 0:
            return None, None, busy
        achieved = self._flops_done / device_s
        return round(achieved, 3), round(achieved / self.peak, 9), busy

    def snapshot(self) -> dict[str, Any]:
        """Perf block: totals + per-executable breakdown (JSON-safe)."""
        with self._lock:
            achieved, mfu, busy = self._derived_locked()
            per_exec = {}
            for key, entry in self._execs.items():
                rec = dict(entry)
                rec["device_ms"] = round(rec["device_ms"], 3)
                if rec["requests"] > 0:
                    rec["device_ms_per_request"] = round(
                        entry["device_ms"] / entry["requests"], 4
                    )
                else:
                    rec["device_ms_per_request"] = None
                if entry["flops"] and entry["device_ms"] > 0 and entry["calls"] > 0:
                    exec_achieved = entry["flops"] * entry["calls"] / (
                        entry["device_ms"] / 1e3
                    )
                    rec["mfu"] = round(exec_achieved / self.peak, 9)
                else:
                    rec["mfu"] = None
                per_exec[key] = rec
            return {
                "device_kind": self.device_kind,
                "peak_flops_per_s": self.peak,
                "device_ms": round(self._device_ms, 3),
                "device_calls": self._calls,
                "requests": self._requests,
                "flops_total": round(self._flops_done, 1),
                "achieved_flops_per_s": achieved,
                "mfu": mfu,
                "busy_fraction": busy,
                "per_executable": per_exec,
            }


# ---------------------------------------------------------------------------
# fleet capacity


def fleet_capacity(
    replica_perfs: list[dict[str, Any] | None], alive: int | None = None
) -> dict[str, Any] | None:
    """Max-sustainable-QPS estimate from per-replica perf snapshots.

    Device work inside one replica is serial (one engine lock, one
    device), so a replica saturates when the mix-weighted device time per
    request fills a second of device time:

        qps_replica = 1 / Σ_rung share_rung · device_s_per_request_rung

    where ``share`` is the observed arrival mix (requests per rung).  The
    fleet bound is that times the number of alive replicas — an upper
    bound that ignores host-side overhead (padding, transport), which is
    the right shape for a scale-up control signal: when observed QPS
    approaches ``max_qps_fleet``, there is no headroom left to absorb it.

    Returns ``None`` until some replica has recorded device time.
    """
    rungs: dict[str, dict[str, float]] = {}
    observed = 0
    for perf in replica_perfs:
        if not perf:
            continue
        for key, entry in (perf.get("per_executable") or {}).items():
            try:
                requests = int(entry.get("requests") or 0)
                device_ms = float(entry.get("device_ms") or 0.0)
            except (TypeError, ValueError):
                continue
            if requests <= 0 or device_ms <= 0:
                continue
            agg = rungs.setdefault(key, {"requests": 0.0, "device_ms": 0.0})
            agg["requests"] += requests
            agg["device_ms"] += device_ms
            observed += requests
    if not rungs or observed <= 0:
        return None
    if alive is None:
        alive = sum(1 for perf in replica_perfs if perf)
    weighted_s_per_request = 0.0
    per_rung = []
    for key in sorted(rungs):
        agg = rungs[key]
        per_request_ms = agg["device_ms"] / agg["requests"]
        share = agg["requests"] / observed
        weighted_s_per_request += share * per_request_ms / 1e3
        per_rung.append(
            {
                "rung": key,
                "requests": int(agg["requests"]),
                "share": round(share, 4),
                "device_ms_per_request": round(per_request_ms, 4),
                "max_qps_per_replica": round(1e3 / per_request_ms, 2),
            }
        )
    qps_replica = 1.0 / max(weighted_s_per_request, 1e-12)
    return {
        "alive_replicas": int(alive),
        "requests_observed": int(observed),
        "device_ms_per_request": round(weighted_s_per_request * 1e3, 4),
        "max_qps_per_replica": round(qps_replica, 2),
        "max_qps_fleet": round(qps_replica * max(int(alive), 0), 2),
        "per_rung": per_rung,
    }
