"""The port's serving telemetry (``code2vec_tpu_torch/obs``) against JAX's.

After the same sequence of records the two registries expose the same
Prometheus text, byte for byte (the ``c2v_build_info`` labels aside: the
port names torch and CUDA where JAX names jax), and each side parses the
other's text alike; the flight recorder captures the same records; the
lock sanitizer finds the same inversion and the handle ledger counts the
same open handles (both off by default, at no cost); the event log, the
trace context and the analytic costs agree.
"""

from __future__ import annotations

import json
import threading

import pytest

import code2vec_tpu.obs.costs as jax_costs
import code2vec_tpu.obs.events as jax_events
import code2vec_tpu.obs.handles as jax_handles
import code2vec_tpu.obs.runtime as jax_runtime
import code2vec_tpu.obs.sync as jax_sync
import code2vec_tpu.obs.trace as jax_trace
import code2vec_tpu_torch.obs.costs as port_costs
import code2vec_tpu_torch.obs.events as port_events
import code2vec_tpu_torch.obs.handles as port_handles
import code2vec_tpu_torch.obs.runtime as port_runtime
import code2vec_tpu_torch.obs.sync as port_sync
import code2vec_tpu_torch.obs.trace as port_trace

SIDES = {"jax": (jax_runtime, jax_sync, jax_handles), "port": (port_runtime, port_sync,
                                                              port_handles)}


def record(runtime):
    """One sequence of records into a fresh registry; two snapshots."""
    h = runtime.RuntimeHealth()
    h._started_unix = 1_700_000_000.25
    h.counter("serve_requests").inc(7)
    h.counter("serve.op.predict.errors").inc()
    h.gauge("serve_queue_depth").set(3)
    h.gauge("serve_active_version").set("model#g1")  # a string: not exported
    h.gauge("perf.mfu").set(0.125)
    for v in (1.5, 2.0, 0.25, 40.0, 3.125):
        h.latency("serve.op.predict.e2e_ms").record(v)
    ns = h.namespaced("fleet.r0")
    ns.counter("dispatched").inc(4)
    ns.latency("e2e_ms").record(9.0)
    other = runtime.RuntimeHealth()
    other._started_unix = 1_700_000_001.0
    other.counter("serve_requests").inc(2)
    return [({}, h.snapshot()), ({"replica": "r1"}, other.snapshot())]


def test_prometheus_text_byte_equal():
    texts = {name: mods[0].prometheus_text(record(mods[0])) for name, mods in SIDES.items()}
    assert texts["port"] == texts["jax"]
    assert 'c2v_serve_requests_total{replica="r1"} 2' in texts["port"]


@pytest.mark.parametrize("reader", ["jax", "port"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_parse_prometheus_text_round_trips(writer, reader):
    text = SIDES[writer][0].prometheus_text(record(SIDES[writer][0]))
    parsed = SIDES[reader][0].parse_prometheus_text(text)
    assert parsed == SIDES["jax"][0].parse_prometheus_text(text)
    assert parsed  # non-empty: every sample line parsed


def test_build_info_names_torch_not_jax():
    port = port_runtime.build_info_text()
    jax_ = jax_runtime.build_info_text()
    assert port.splitlines()[0] == jax_.splitlines()[0] == "# TYPE c2v_build_info gauge"
    assert 'torch_version="' in port and "jax_version" not in port
    labels = port_runtime.parse_prometheus_text(port)
    assert labels  # the gauge parses back, labels and all
    assert port_runtime.build_info({"role": "router"})["role"] == "router"


def flights(runtime, threshold):
    rec = runtime.FlightRecorder(capacity=16, threshold_ms=threshold,
                                 health=runtime.RuntimeHealth())
    for i in range(300):
        e2e = 5.0 + (i % 17) + (100.0 if i % 97 == 0 else 0.0)
        rec.observe(e2e, {"kind": "serve", "n_contexts": i, "batch": 1 + i % 8})
    return rec.count, rec.seen, rec.snapshot()


@pytest.mark.parametrize("threshold", [None, 20.0])
def test_flight_recorder_captures_the_same(threshold):
    assert flights(port_runtime, threshold) == flights(jax_runtime, threshold)


def sanitizer_run(sync):
    sync.reset_sync_state()
    a, b = sync.make_lock("test.a"), sync.make_lock("test.b")
    with a:
        with b:
            pass

    def other():
        with b:
            with a:
                pass

    t = threading.Thread(target=other)
    t.start()
    t.join()
    found = [(v["lock"], tuple(v["held"])) for v in sync.violations()]
    snap = sync.sync_snapshot()
    sync.reset_sync_state()
    return found, snap["order_violations"], snap["enabled"]


def test_lock_sanitizer_finds_the_same_inversion(monkeypatch):
    monkeypatch.setenv("C2V_SYNC_DEBUG", "1")
    got, want = sanitizer_run(port_sync), sanitizer_run(jax_sync)
    assert got == want == ([("test.a", ("test.b",))], 1, True)
    assert isinstance(port_sync.make_lock("x"), port_sync.TracedLock)


def test_lock_factory_is_plain_by_default(monkeypatch):
    monkeypatch.delenv("C2V_SYNC_DEBUG", raising=False)
    assert type(port_sync.make_lock("x")) is type(threading.Lock())
    assert type(port_sync.make_rlock("x")) is type(threading.RLock())
    assert isinstance(port_sync.make_condition("x"), threading.Condition)


def ledger_run(handles):
    handles.reset_handle_state()

    class Thing:
        pass

    kept, gone = Thing(), Thing()
    handles.track(kept, "generation", name="g0")
    handles.track(gone, "batcher")
    handles.untrack(gone)
    snap = handles.handles_snapshot()
    leaks = handles.report_leaks("test")
    handles.untrack(kept)
    after = handles.handles_snapshot()
    handles.reset_handle_state()
    return (snap["open"], snap["open_total"], [(r["kind"], r["name"]) for r in leaks],
            after["open_total"])


def test_handle_ledger_counts_the_same(monkeypatch):
    monkeypatch.setenv("C2V_HANDLE_DEBUG", "1")
    assert ledger_run(port_handles) == ledger_run(jax_handles) == (
        {"generation": 1}, 1, [("generation", "g0")], 0)


def test_handle_ledger_is_a_no_op_by_default(monkeypatch):
    monkeypatch.delenv("C2V_HANDLE_DEBUG", raising=False)
    port_handles.reset_handle_state()
    obj = object()
    assert port_handles.track(obj, "generation") is obj
    assert port_handles.handles_snapshot() == jax_handles.handles_snapshot() == {"enabled": False}
    assert port_handles.open_handles() == []


@pytest.mark.parametrize("value", [
    {"a": float("nan"), "b": [1.0, float("inf")], "c": {"d": -float("inf")}},
    {"x": 1, "y": "s", "z": None, "w": (1, 2)},
])
def test_sanitize_equal(value):
    assert port_events.sanitize(value) == jax_events.sanitize(value)


def test_event_log_manifest_first_then_events(tmp_path):
    log = port_events.EventLog(str(tmp_path))
    log.write_manifest(serve={"version": "m#g0"})
    log.emit("swap_committed", version="m#g1", build_ms=float("nan"))
    log.close()
    lines = [json.loads(line) for line in
             (tmp_path / "events-p0.jsonl").read_text().splitlines()]
    assert [e["event"] for e in lines] == ["manifest", "swap_committed"]
    assert lines[0]["serve"] == {"version": "m#g0"} and lines[0]["process_index"] == 0
    assert lines[1]["build_ms"] is None and lines[1]["build_ms_raw"] == "nan"
    assert [e["seq"] for e in lines] == [0, 1]


@pytest.mark.parametrize("request_", [
    {"trace": {"trace_id": "ab" * 16, "parent_span_id": "cd"}},
    {"trace": {"trace_id": ""}}, {"trace": "garbage"}, {},
])
def test_trace_context_equal(request_):
    got = port_trace.TraceContext.from_request(request_)
    want = jax_trace.TraceContext.from_request(request_)
    assert (got and got.to_wire()) == (want and want.to_wire())


def test_tracer_chrome_trace_spans(tmp_path):
    tracer = port_trace.Tracer(process_name="serve-worker")
    port_trace.set_tracer(tracer)
    try:
        with port_trace.trace_scope(trace_ids=["t1"]):
            with port_trace.get_tracer().span("engine_run", category="serve",
                                              **port_trace.current_trace_scope()):
                pass
    finally:
        port_trace.set_tracer(None)
    path = tracer.export_dir(str(tmp_path))
    events = json.loads(open(path).read())["traceEvents"]
    span = next(e for e in events if e.get("name") == "engine_run")
    assert span["ph"] == "X" and span["args"]["trace_ids"] == ["t1"]
    assert isinstance(port_trace.get_tracer(), port_trace.NullTracer)


def test_analytic_costs_and_capacity_equal():
    kw = dict(terminal_embed=100, path_embed=100, encode=100, labels=8000)
    for b, w, dt in ((1, 25, "f32"), (64, 200, "int8"), (8, 2048, "bf16")):
        assert port_costs.analytic_forward_cost(b, w, table_dtype=dt, **kw) == \
            jax_costs.analytic_forward_cost(b, w, table_dtype=dt, **kw)
    perfs = [{"per_executable": {"b1w25": {"requests": 10, "device_ms": 5.0},
                                 "b8w200": {"requests": 40, "device_ms": 8.0}}},
             {"per_executable": {"b1w25": {"requests": 6, "device_ms": 2.4}}}, None]
    assert port_costs.fleet_capacity(perfs) == jax_costs.fleet_capacity(perfs)


def test_cost_accountant_equal():
    snaps = []
    for costs in (port_costs, jax_costs):
        clock = iter([0.0] + [1.0] * 10)
        acc = costs.CostAccountant(device_kind="H100", peak=495e12, clock=lambda: next(clock))
        acc.register((1, 25), {"flops": 2e9, "bytes_accessed": 1e6,
                               "arithmetic_intensity": 2e3, "cost_source": "analytic"})
        acc.record((1, 25), 0.5)
        acc.record((8, 200), 1.5, requests=8)
        snaps.append(acc.snapshot())
    assert snaps[0] == snaps[1]
    assert port_costs.peak_flops("NVIDIA H100 80GB HBM3") == 495e12
