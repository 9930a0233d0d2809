"""The port's fleet (``code2vec_tpu_torch/serve/fleet``) against the JAX one.

Each scenario of JAX ``tests/test_fleet.py`` (and its cache scenarios,
``tests/test_rcache.py``) runs against JAX's ``FleetRouter`` and the
port's, over the same in-process fake replicas (no subprocess, no model),
and the two routers' observable outcomes must be equal: placements,
per-class shedding, deadline shedding, retries after a replica dies,
respawn, the rolling swap's order and abort, cache hits and coalescing,
the cache's version flips on commit and rollback, and the SLO / cache
helpers. Then one real 2-replica fleet of the port on the CPU (subprocess
workers, ``--device cpu``) rolls a swap and a rollback under a trickle
with no failed request.
"""

from __future__ import annotations

import json
import threading
import time
from concurrent.futures import Future
from types import SimpleNamespace

import numpy as np
import pytest

import code2vec_tpu.obs.runtime as jax_runtime
import code2vec_tpu.serve.fleet.cache as jax_cache
import code2vec_tpu.serve.fleet.replica as jax_replica
import code2vec_tpu.serve.fleet.router as jax_router
import code2vec_tpu.serve.fleet.slo as jax_slo
import code2vec_tpu_torch.obs.runtime as port_runtime
import code2vec_tpu_torch.serve.fleet.cache as port_cache
import code2vec_tpu_torch.serve.fleet.replica as port_replica
import code2vec_tpu_torch.serve.fleet.router as port_router
import code2vec_tpu_torch.serve.fleet.slo as port_slo

IMPLS = {
    "jax": SimpleNamespace(Router=jax_router.FleetRouter, Health=jax_runtime.RuntimeHealth,
                           Cache=jax_cache.ResultCache, Died=jax_replica.ReplicaDied,
                           slo=jax_slo),
    "port": SimpleNamespace(Router=port_router.FleetRouter, Health=port_runtime.RuntimeHealth,
                            Cache=port_cache.ResultCache, Died=port_replica.ReplicaDied,
                            slo=port_slo),
}


class FakeReplica:
    """In-process stand-in for ReplicaHandle (JAX tests/test_fleet.py:99):
    resolves each request on a thread after ``latency_s``; scriptable
    behavior and death."""

    def __init__(self, impl, slot, incarnation=0, latency_s=0.0, behavior=None):
        self.died_cls = impl.Died
        self.slot = slot
        self.incarnation = incarnation
        self.latency_s = latency_s
        self.behavior = behavior or (lambda req: {"ok": True, "op": req.get("op"),
                                                  "slot": self.slot})
        self._alive = True
        self._inflight = 0
        self._lock = threading.Lock()
        self.probe_failures = 0
        self.last_health = None
        self.death_reason = None
        self.pid = 40000 + slot
        self.sent: list[dict] = []

    @property
    def alive(self):
        return self._alive

    @property
    def in_flight(self):
        return self._inflight

    def send(self, request):
        if not self._alive:
            raise self.died_cls(f"fake r{self.slot} dead")
        self.sent.append(dict(request))
        future: Future = Future()
        with self._lock:
            self._inflight += 1

        def run():
            if self.latency_s:
                time.sleep(self.latency_s)
            with self._lock:
                self._inflight -= 1
            if not self._alive:
                future.set_exception(self.died_cls(f"fake r{self.slot} died"))
                return
            try:
                future.set_result(self.behavior(request))
            except Exception as exc:  # noqa: BLE001 - scripted failure
                future.set_exception(exc)

        threading.Thread(target=run, daemon=True).start()
        return future

    def wait_ready(self, timeout):
        return {"ok": True}

    def stop(self, timeout=10.0):
        self._alive = False

    def kill(self, timeout=10.0):
        self._alive = False
        self.death_reason = "killed"

    def die(self):
        self._alive = False
        self.death_reason = "scripted death"


def make_router(impl, replicas, **kw):
    kw.setdefault("health", impl.Health())
    kw.setdefault("probe_interval_s", 60.0)  # probing off unless asked
    spawned = []

    def factory(slot, incarnation):
        handle = replicas(slot, incarnation) if callable(replicas) else replicas[slot]
        spawned.append(handle)
        return handle

    n = kw.pop("n_replicas", None) or (2 if callable(replicas) else len(replicas))
    router = impl.Router(factory, n, **kw)
    router.spawned = spawned
    return router


def both(scenario):
    """The scenario's outcome under each router: equal, and returned."""
    results = {name: scenario(impl) for name, impl in IMPLS.items()}
    assert results["port"] == results["jax"], results
    return results["port"]


def counting_behavior():
    """JAX tests/test_rcache.py:261: data ops answer a counter."""
    calls = {"n": 0}
    lock = threading.Lock()

    def behavior(req):
        op = req.get("op")
        if op in ("embed", "predict", "neighbors"):
            with lock:
                calls["n"] += 1
                return {"ok": True, "vector": [float(calls["n"])]}
        if op == "reload":
            return {"ok": True}
        if op == "swap_status":
            return {"swap": {"state": "idle", "last_swap": {
                "outcome": "committed", "version": "m#g1"}}}
        if op == "rollback":
            return {"swap": {"active_version": "m#g0"}}
        return {"ok": True, "op": op}

    return behavior, calls


def swappable_fake(impl, slot, poll_count=2):
    """A fake running the worker's swap state machine (JAX
    tests/test_fleet.py:333): ``reload`` answers ok, then ``swap_status``
    reports building for ``poll_count`` polls before committing."""
    state = {"version": "v0#g0", "building": 0}

    def behavior(req):
        op = req.get("op")
        if op == "reload":
            state["building"] = poll_count
            state["target"] = req.get("model_path")
            return {"ok": True, "swap": {"state": "building"}}
        if op == "swap_status":
            if state["building"] > 0:
                state["building"] -= 1
                return {"ok": True, "swap": {"state": "building"}}
            if state.get("target"):
                state["version"] = f"{state.pop('target')}#g1"
            return {"ok": True, "swap": {
                "state": "idle", "active_version": state["version"],
                "last_swap": {"outcome": "committed", "version": state["version"],
                              "build_ms": 1.0, "validate_ms": 1.0}}}
        if op == "rollback":
            state["version"] = "v0#g0"
            return {"ok": True, "swap": {"state": "idle", "active_version": state["version"]}}
        return {"ok": True, "op": op, "slot": slot}

    return FakeReplica(impl, slot, behavior=behavior)


# ---------------------------------------------------------------------------
# SLO classes and cache keys: the same answers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["predict", "embed", "embed_file", "neighbors", "health",
                                "swap_status", "reload", "rollback", "shutdown", "flights",
                                "nope", None])
def test_classify_op_equal(op):
    assert port_slo.classify_op(op) == jax_slo.classify_op(op)


@pytest.mark.parametrize("spec", ["", "embed=512:1500, neighbors=8:9000", "health=4:100"])
def test_parse_slo_spec_equal(spec):
    got, want = port_slo.parse_slo_spec(spec), jax_slo.parse_slo_spec(spec)
    assert {k: (v.budget, v.deadline_ms) for k, v in got.items()} == \
        {k: (v.budget, v.deadline_ms) for k, v in want.items()}


@pytest.mark.parametrize("spec", ["turbo=1:1", "embed=12"])
def test_parse_slo_spec_rejects_garbage_alike(spec):
    with pytest.raises(ValueError):
        jax_slo.parse_slo_spec(spec)
    with pytest.raises(ValueError):
        port_slo.parse_slo_spec(spec)


@pytest.mark.parametrize("request_", [
    {"op": "embed", "contexts": [[1, 2, 3], [4, 5, 6], [1, 2, 3]]},
    {"op": "embed", "contexts": [[4, 5, 6], [1, 2, 3], [1, 2, 3]], "id": 9},
    {"op": "predict", "contexts": [[1, 2, 3]], "top_k": 3},
    {"op": "neighbors", "source": "def f(): pass", "top_k": 5, "granularity": "file"},
    {"op": "embed", "source": "def f(): pass", "language": "python"},
    {"op": "neighbors", "vector": [0.5, -1.0, 2.0], "top_k": 3},
    {"op": "health"},
])
def test_cache_keys_equal(request_):
    assert port_cache.canonical_request_key(request_) == \
        jax_cache.canonical_request_key(request_)


# ---------------------------------------------------------------------------
# the router's scenarios, under both routers
# ---------------------------------------------------------------------------


def test_placements_equal():
    def scenario(impl):
        fakes = [FakeReplica(impl, 0), FakeReplica(impl, 1)]
        router = make_router(impl, fakes)
        try:
            slots = [router.handle({"op": "embed", "source": "x", "id": i})["slot"]
                     for i in range(6)]
            return {"slots": slots}
        finally:
            router.close()

    out = both(scenario)
    assert set(out["slots"]) <= {0, 1}


def test_concurrent_requests_spread_over_replicas_alike():
    def scenario(impl):
        fakes = [FakeReplica(impl, 0, latency_s=0.02), FakeReplica(impl, 1, latency_s=0.02)]
        router = make_router(impl, fakes)
        try:
            resolvers = [router.handle_async({"op": "embed", "source": "x", "id": i})
                         for i in range(12)]
            payloads = [r() for r in resolvers]
            snap = router.health.snapshot()
            return {"ok": all(p["ok"] for p in payloads), "ids": [p["id"] for p in payloads],
                    "both_used": all(len(f.sent) > 0 for f in fakes),
                    "completed": snap["counters"]["slo.embed.completed"]}
        finally:
            router.close()

    assert both(scenario) == {"ok": True, "ids": list(range(12)), "both_used": True,
                              "completed": 12}


def test_budget_shedding_is_per_class_alike():
    def scenario(impl):
        slo = {"health": impl.slo.DEFAULT_SLO["health"],
               "embed": impl.slo.SloClass("embed", budget=2, deadline_ms=10_000.0),
               "neighbors": impl.slo.SloClass("neighbors", budget=4, deadline_ms=10_000.0)}
        router = make_router(impl, [FakeReplica(impl, 0, latency_s=0.2)], slo=slo,
                             per_replica_inflight=1)
        try:
            payloads = [r() for r in [router.handle_async({"op": "embed", "source": "x"})
                                      for _ in range(8)]]
            shed = [p for p in payloads if p.get("error_kind") == "overloaded"]
            neighbors = router.handle({"op": "neighbors", "vector": [1.0]})
            counters = router.health.snapshot()["counters"]
            return {"shed_some": bool(shed), "served_some": any(p.get("ok") for p in payloads),
                    "shed_classes": sorted({p["slo_class"] for p in shed}),
                    "counted": counters["slo.embed.shed_budget"] == len(shed),
                    "neighbors_ok": neighbors["ok"]}
        finally:
            router.close()

    assert both(scenario) == {"shed_some": True, "served_some": True,
                              "shed_classes": ["embed"], "counted": True, "neighbors_ok": True}


def test_deadline_shedding_alike():
    def scenario(impl):
        slo = {"health": impl.slo.DEFAULT_SLO["health"],
               "embed": impl.slo.SloClass("embed", budget=64, deadline_ms=80.0),
               "neighbors": impl.slo.DEFAULT_SLO["neighbors"]}
        router = make_router(impl, [FakeReplica(impl, 0, latency_s=0.3)], slo=slo,
                             per_replica_inflight=1)
        try:
            payloads = [r() for r in [router.handle_async({"op": "embed", "source": "x"})
                                      for _ in range(4)]]
            counters = router.health.snapshot()["counters"]
            return {"first_ok": bool(payloads[0].get("ok")),
                    "deadline": "deadline" in [p.get("error_kind") for p in payloads],
                    "counted": counters["slo.embed.shed_deadline"] >= 1}
        finally:
            router.close()

    assert both(scenario) == {"first_ok": True, "deadline": True, "counted": True}


def test_retry_after_a_replica_dies_alike():
    def scenario(impl):
        sick, healthy = FakeReplica(impl, 0, latency_s=0.05), FakeReplica(impl, 1)
        real_send = FakeReplica.send

        def dying_send(self, request):
            future = real_send(self, request)
            self.die()  # dies with the request in flight
            return future

        sick.send = dying_send.__get__(sick)
        router = make_router(impl, [sick, healthy])
        try:
            payload = router.handle({"op": "embed", "source": "x"})
            return {"ok": payload["ok"], "slot": payload["slot"],
                    "retried": router.health.snapshot()["counters"]["fleet.retries"] >= 1}
        finally:
            router.close()

    assert both(scenario) == {"ok": True, "slot": 1, "retried": True}


def test_evict_and_respawn_alike():
    def scenario(impl):
        incarnations = []

        def factory(slot, incarnation):
            incarnations.append((slot, incarnation))
            return FakeReplica(impl, slot, incarnation=incarnation)

        router = make_router(impl, factory, n_replicas=2, probe_interval_s=0.05,
                             probe_timeout_s=0.5, max_probe_failures=1)
        try:
            router.spawned[0].die()
            deadline = time.time() + 10.0
            while time.time() < deadline and (0, 1) not in incarnations:
                time.sleep(0.05)
            counters = router.health.snapshot()["counters"]
            health = router.handle({"op": "health"})
            return {"respawned": (0, 1) in incarnations,
                    "evicted": counters["fleet.evictions"] >= 1,
                    "respawns": counters["fleet.respawns"] >= 1,
                    "serves": router.handle({"op": "embed", "source": "x"})["ok"],
                    "all_alive": all(r["alive"] for r in health["fleet"]["replicas"])}
        finally:
            router.close()

    assert both(scenario) == {"respawned": True, "evicted": True, "respawns": True,
                              "serves": True, "all_alive": True}


def test_rolling_swap_order_and_rollback_alike():
    def scenario(impl):
        fakes = [swappable_fake(impl, 0), swappable_fake(impl, 1)]
        router = make_router(impl, fakes, swap_timeout_s=30.0)
        try:
            payload = router.handle({"op": "reload", "model_path": "v1", "wait": True})
            rolling = payload["rolling"]
            status = router.handle({"op": "swap_status"})
            back = router.handle({"op": "rollback"})
            # the walk: replica 1 gets its reload only after replica 0 committed
            r0_last = max(i for i, q in enumerate(fakes[0].sent) if q["op"] == "swap_status")
            ops = [[q["op"] for q in f.sent] for f in fakes]
            return {"ok": payload["ok"], "outcome": rolling["outcome"],
                    "order": [r["slot"] for r in rolling["replicas"]],
                    "versions": [r["version"] for r in rolling["replicas"]],
                    "status": status["rolling"]["outcome"], "ops": ops,
                    "r0_polled_before_r1": r0_last < len(fakes[0].sent),
                    "rolled_back": [r["outcome"] for r in back["replicas"]]}
        finally:
            router.close()

    out = both(scenario)
    assert out["outcome"] == "committed" and out["order"] == [0, 1]
    assert out["versions"] == ["v1#g1", "v1#g1"]
    assert out["rolled_back"] == ["rolled_back", "rolled_back"]


def test_rolling_swap_abort_alike():
    def scenario(impl):
        def failing(req):
            if req.get("op") == "reload":
                return {"ok": True, "swap": {"state": "building"}}
            if req.get("op") == "swap_status":
                return {"ok": True, "swap": {"state": "idle", "last_swap": {
                    "outcome": "failed", "error": "validation miss"}}}
            return {"ok": True}

        fakes = [FakeReplica(impl, 0, behavior=failing), swappable_fake(impl, 1)]
        router = make_router(impl, fakes)
        try:
            payload = router.handle({"op": "reload", "model_path": "v1", "wait": True})
            return {"ok": payload["ok"], "kind": payload["error_kind"],
                    "miss": "validation miss" in payload["error"],
                    "r1_asked": bool([q for q in fakes[1].sent if q["op"] == "reload"])}
        finally:
            router.close()

    assert both(scenario) == {"ok": False, "kind": "swap_failed", "miss": True,
                              "r1_asked": False}


def test_cache_hit_skips_the_replica_alike():
    def scenario(impl):
        behavior, calls = counting_behavior()
        fake = FakeReplica(impl, 0, behavior=behavior)
        health = impl.Health()
        router = make_router(impl, [fake], health=health,
                             result_cache=impl.Cache(1 << 20, health=health))
        try:
            req = {"op": "embed", "contexts": [[1, 2, 3], [4, 5, 6]]}
            first, second = router.handle(dict(req)), router.handle(dict(reversed_bag(req)))
            block = router.handle({"op": "health"})["fleet"]["cache"]
            counters = health.snapshot()["counters"]
            return {"first": first, "second": second, "calls": calls["n"],
                    "hits": block["hits"], "entries": block["entries"],
                    "cache_hits": counters["slo.embed.cache_hits"]}
        finally:
            router.close()

    assert both(scenario) == {"first": {"ok": True, "vector": [1.0]},
                              "second": {"ok": True, "vector": [1.0]}, "calls": 1,
                              "hits": 1, "entries": 1, "cache_hits": 1}


def reversed_bag(req):
    return {**req, "contexts": list(reversed(req["contexts"]))}


def test_cache_coalesces_a_herd_alike():
    def scenario(impl):
        behavior, calls = counting_behavior()
        router = make_router(impl, [FakeReplica(impl, 0, latency_s=0.15, behavior=behavior)],
                             result_cache=impl.Cache(1 << 20))
        try:
            req = {"op": "embed", "source": "def f(): pass"}
            payloads = [r() for r in [router.handle_async(dict(req)) for _ in range(6)]]
            stats = router._cache.stats()
            return {"payloads": payloads, "calls": calls["n"], "coalesced": stats["coalesced"],
                    "misses": stats["misses"]}
        finally:
            router.close()

    out = both(scenario)
    assert out["calls"] == 1 and out["coalesced"] == 5 and out["misses"] == 1


def test_cache_version_flips_on_commit_and_rollback_alike():
    def scenario(impl):
        behavior, calls = counting_behavior()
        fakes = [FakeReplica(impl, 0, behavior=behavior), FakeReplica(impl, 1, behavior=behavior)]
        for fake in fakes:
            fake.last_health = {"version": "m#g0"}  # the boot-time version
        router = make_router(impl, fakes, result_cache=impl.Cache(1 << 20))
        try:
            cache = router._cache
            req = {"op": "embed", "source": "def f(): pass", "language": "python"}
            seen = [cache.active_version]
            warm = router.handle(dict(req))
            router.handle(dict(req))
            rolled = router.handle({"op": "reload", "model_path": "v2", "wait": True})
            seen.append(cache.active_version)
            fresh = router.handle(dict(req))
            back = router.handle({"op": "rollback"})
            seen.append(cache.active_version)
            again = router.handle(dict(req))
            return {"versions": seen, "rolled": rolled["rolling"]["outcome"],
                    "fresh": fresh, "back": back["ok"], "again_is_warm": again == warm,
                    "calls": calls["n"]}
        finally:
            router.close()

    assert both(scenario) == {"versions": ["m#g0", "m#g1", "m#g0"], "rolled": "committed",
                              "fresh": {"ok": True, "vector": [2.0]}, "back": True,
                              "again_is_warm": True, "calls": 2}


def test_unknown_op_and_closed_alike():
    def scenario(impl):
        router = make_router(impl, [FakeReplica(impl, 0)])
        unknown = router.handle({"op": "nope"})["error_kind"]
        router.close()
        return [unknown, router.handle({"op": "embed", "source": "x"})["error_kind"]]

    assert both(scenario) == ["bad_request", "closed"]


def test_router_metrics_label_the_replicas_alike():
    def scenario(impl):
        fakes = [FakeReplica(impl, 0), FakeReplica(impl, 1)]
        for fake in fakes:
            fake.last_health = {"counters": {"serve_requests": 3}, "gauges": {},
                                "latencies_ms": {}}
        router = make_router(impl, fakes)
        try:
            text = router.metrics_text()
            return sorted(line.split(" ")[0] for line in text.splitlines()
                          if line.startswith("c2v_serve_requests_total"))
        finally:
            router.close()

    assert both(scenario) == ['c2v_serve_requests_total{replica="r0"}',
                              'c2v_serve_requests_total{replica="r1"}']


# ---------------------------------------------------------------------------
# a real port fleet on the CPU
# ---------------------------------------------------------------------------


def test_port_fleet_rolls_a_swap_and_back_under_a_trickle(tmp_path):
    """Two subprocess workers (``--device cpu``) behind the port's router:
    a rolling reload to another model dir and a rollback while a trickle
    runs, with no failed request; the replicas answer the new weights
    after the roll and the old ones, bitwise, after the rollback."""
    from test_torch_serve import bag, make_model_dir

    from code2vec_tpu_torch.serve.fleet.__main__ import build_parser, build_router, worker_argv

    (tmp_path / "a").mkdir()
    a, _, _ = make_model_dir(tmp_path / "a")
    b = tmp_path / "b"
    b.mkdir()
    from test_torch_swap import write_other_weights

    write_other_weights(a, b, seed=11)
    args = build_parser().parse_args([
        "--replicas", "2", "--model_path", str(a),
        "--terminal_idx_path", str(a / "terminal_idxs.txt"),
        "--path_idx_path", str(a / "path_idxs.txt"), "--device", "cpu",
        "--batch_sizes", "1,8", "--probe_interval_s", "0.5", "--boot_timeout_s", "120",
        "--result_cache_mb", "8",
    ])
    assert worker_argv(args, 0)[worker_argv(args, 0).index("--device") + 1] == "cpu"
    router, events = build_router(args)
    failures, stop = [], threading.Event()

    def trickle():
        i = 0
        while not stop.is_set():
            resp = router.handle({"op": "embed", "contexts": bag(1 + i % 16, 500 + i).tolist()})
            if not resp.get("ok"):
                failures.append(resp)
            i += 1

    probe = {"op": "embed", "contexts": bag(9, 7).tolist()}
    thread = threading.Thread(target=trickle, daemon=True)
    try:
        before = router.handle(dict(probe))["methods"][0]["code_vector"]
        thread.start()
        rolled = router.handle({"op": "reload", "model_path": str(b), "wait": True})
        assert rolled["ok"], json.dumps(rolled)[:2000]
        assert [r["slot"] for r in rolled["rolling"]["replicas"]] == [0, 1]
        after = router.handle(dict(probe))["methods"][0]["code_vector"]
        assert not np.array_equal(after, before)
        back = router.handle({"op": "rollback"})
        assert back["ok"], back
        assert router.handle(dict(probe))["methods"][0]["code_vector"] == before
        health = router.handle({"op": "health"})
        assert all(r["alive"] for r in health["fleet"]["replicas"])
    finally:
        stop.set()
        thread.join(30)
        router.close()
        if events is not None:
            events.close()
    assert not failures, failures[:3]
