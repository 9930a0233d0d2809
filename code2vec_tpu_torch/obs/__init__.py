"""Telemetry: events, spans, runtime health, costs, locks, handles.

Counterpart of ``code2vec_tpu/obs``, for serving and training. Standard
library only (no ``torch``), so the fleet router imports it too:

- :mod:`events` — a per-process JSONL event log opened with a run manifest;
- :mod:`trace` — spans exportable as Chrome ``trace_event`` JSON, and the
  cross-process request trace context;
- :mod:`runtime` — the counters/gauges/latency registry, its Prometheus
  exposition, the slow-request flight recorder, and the trainer's
  recompile detector and memory sampler;
- :mod:`costs` — analytic forward and train-step costs, device-time
  accounting, MFU and fleet capacity;
- :mod:`sync` — the lock factory and its opt-in order sanitizer
  (``C2V_SYNC_DEBUG``);
- :mod:`handles` — the opt-in open-handle ledger (``C2V_HANDLE_DEBUG``).
"""

from code2vec_tpu_torch.obs.events import EventLog, run_manifest
from code2vec_tpu_torch.obs.runtime import FlightRecorder, RuntimeHealth, global_health
from code2vec_tpu_torch.obs.trace import NullTracer, Tracer, get_tracer, set_tracer

__all__ = [
    "EventLog",
    "FlightRecorder",
    "NullTracer",
    "RuntimeHealth",
    "Tracer",
    "get_tracer",
    "global_health",
    "run_manifest",
    "set_tracer",
]
