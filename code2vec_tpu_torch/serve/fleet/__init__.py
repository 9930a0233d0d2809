"""Fleet serving: one router, N replica workers, zero-downtime rollouts.

Counterpart of ``code2vec_tpu/serve/fleet``. ``python -m
code2vec_tpu_torch.serve`` is one process pinned to one model generation;
this package is the layer that makes it a FLEET:

- :mod:`replica` — one worker subprocess (``python -m code2vec_tpu_torch.serve
  --transport stdio``) behind a JSONL pipe client: FIFO request/response
  matching (the stdio transport guarantees response order), bounded
  in-flight accounting, and a graceful stop that rides the worker's
  SIGTERM drain contract (every accepted request gets its response before
  the process exits).
- :mod:`slo` — per-op SLO classes (``embed`` / ``neighbors`` /
  ``health``) with DISTINCT queue budgets and deadlines, replacing the
  single global ``max_pending``: tiered load shedding means overload
  degrades the cheap-to-retry tiers first while the control plane stays
  responsive.
- :mod:`cache` — router-level content-addressed result cache: repeat
  requests (order-invariant canonical bag digest + op knobs + generation
  version) are served from router memory in O(1), ahead of SLO admission
  — S3-FIFO eviction with byte-accounted capacity, concurrent-miss
  coalescing, and swap-versioned invalidation (a committed rolling swap
  flips the active version key; ``rollback`` flips it back and the old
  generation's entries are instantly valid again, bitwise).
- :mod:`router` — the fan-out: per-class bounded queues feed a dispatcher
  that places each request on the least-loaded healthy replica (bounded
  per-replica in-flight — the micro-batcher backpressure idea, one level
  up), sheds on budget exhaustion or deadline expiry, health-probes every
  replica and evicts/respawns the unresponsive, retries requests stranded
  on a dead replica, and orchestrates ROLLING hot-swaps: ``reload`` walks
  the replicas one at a time (each keeps serving while its shadow
  generation loads and warms — that is the point of in-process hot-swap), so a
  fleet-wide model rollout never takes capacity below N-0.

The router is deliberately **torch-free**: it moves JSON dicts, never
tensors, opens no CUDA context, and adds microseconds — all device work
stays in the workers. ``python -m code2vec_tpu_torch.serve.fleet``
launches router + replicas; the client-facing transports are the same
stdio-JSONL/HTTP adapters single-process serving uses.
"""

from code2vec_tpu_torch.serve.fleet.cache import (
    ResultCache,
    canonical_bag_digest,
    canonical_request_key,
)
from code2vec_tpu_torch.serve.fleet.replica import ReplicaDied, ReplicaHandle
from code2vec_tpu_torch.serve.fleet.router import FleetRouter
from code2vec_tpu_torch.serve.fleet.slo import (
    DEFAULT_SLO,
    SloClass,
    classify_op,
    parse_slo_spec,
)

__all__ = [
    "DEFAULT_SLO",
    "FleetRouter",
    "ReplicaDied",
    "ReplicaHandle",
    "ResultCache",
    "SloClass",
    "canonical_bag_digest",
    "canonical_request_key",
    "classify_op",
    "parse_slo_spec",
]
