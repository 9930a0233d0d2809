"""The training half of the port's telemetry against the JAX package's,
on the CPU (the counterpart of JAX ``tests/test_obs.py``
``TestTrainTelemetryEndToEnd`` and ``TestRecompileDetector``, and of
``tests/test_perfobs.py`` ``test_train_step_cost_is_three_forwards`` and
``TestStepProfilerMfu``):

- one tiny run through both packages (prefetched, profiled steps, a
  checkpoint every epoch): the same sequence of event types, equal
  ``config`` and ``costs`` blocks in the manifests, the sinks' metrics
  equal to the ``epoch`` events', and the port's span names a superset of
  JAX's with the producer's thread apart from the step's;
- a raising run emits ``error``, unsubscribes the sink consumer and closes
  closable sinks;
- ``floyd_sink`` and ``logging_sink`` print byte-equal lines to JAX's,
  NaN and inf included; ``tensorboard_sink`` writes scalars;
- the recompile detector on input signatures, the step cost, the
  profiler's ``mfu``; ``--profile_dir`` writes a trace on the CPU.
"""

import dataclasses
import json
import logging
import math
import os

import numpy as np
import pytest

from code2vec_tpu import sinks as jax_sinks
from code2vec_tpu.data import reader as jax_reader
from code2vec_tpu.obs.events import EventLog as JaxEventLog
from code2vec_tpu.obs.trace import Tracer as JaxTracer
from code2vec_tpu.obs.trace import set_tracer as jax_set_tracer
from code2vec_tpu.train import loop as jax_loop
from code2vec_tpu.train.config import TrainConfig as JaxTrainConfig
from code2vec_tpu_torch import sinks
from code2vec_tpu_torch.data import reader, synth
from code2vec_tpu_torch.obs.costs import analytic_forward_cost, train_step_cost
from code2vec_tpu_torch.obs.events import EventLog
from code2vec_tpu_torch.obs.runtime import RecompileDetector, RuntimeHealth
from code2vec_tpu_torch.obs.trace import Tracer, set_tracer
from code2vec_tpu_torch.train import loop
from code2vec_tpu_torch.train.config import TrainConfig
from code2vec_tpu_torch.train.prefetch import StepProfiler

RUN = dict(max_epoch=2, batch_size=32, encode_size=16, terminal_embed_size=8,
           path_embed_size=8, max_path_length=16, print_sample_cycle=0, prefetch_batches=2,
           profile_steps=2, checkpoint_cycle=1)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    paths = synth.generate_corpus_files(tmp_path_factory.mktemp("tiny"), synth.SPECS["tiny"])
    args = (paths["corpus"], paths["path_idx"], paths["terminal_idx"])
    return paths, reader.load_corpus(*args), jax_reader.load_corpus(*args, cache=False,
                                                                      native=False)


class Recorder:
    """A closable sink that keeps what it saw."""

    def __init__(self):
        self.calls, self.closed = [], False

    def __call__(self, epoch, metrics):
        self.calls.append((epoch, dict(metrics)))

    def close(self):
        self.closed = True


def strict_lines(path):
    def bad(token):
        raise ValueError(f"non-JSON token {token}")

    return [json.loads(line, parse_constant=bad) for line in open(path, encoding="utf-8")]


def run_both(corpus, tmp_path):
    """The same tiny run through JAX ``train()`` and the port's, each with
    an event log, a tracer and a recording sink."""
    _, data, jax_data = corpus
    out = {}
    for name, train, cfg, log_cls, tracer_cls, install, d in (
            ("jax", jax_loop.train, JaxTrainConfig(**RUN), JaxEventLog, JaxTracer,
             jax_set_tracer, jax_data),
            ("port", loop.train, TrainConfig(**RUN), EventLog, Tracer, set_tracer, data)):
        events, tracer, sink = log_cls(str(tmp_path / name / "events")), tracer_cls(), Recorder()
        (tmp_path / name / "ckpt").mkdir(parents=True)
        kw = {"device": "cpu"} if name == "port" else {}
        previous = install(tracer)
        try:
            train(cfg, d, out_dir=str(tmp_path / name / "ckpt"), sinks=(sink,), events=events,
                  tracer=tracer, **kw)
        finally:
            install(previous)
        events.close()
        out[name] = (strict_lines(events.path), tracer.chrome_trace()["traceEvents"], sink)
    return out


@pytest.fixture(scope="module")
def both(corpus, tmp_path_factory):
    return run_both(corpus, tmp_path_factory.mktemp("both"))


def test_the_same_event_types_in_the_same_order(both):
    types = {name: [e["event"] for e in lines] for name, (lines, _, _) in both.items()}
    assert types["port"] == types["jax"]
    for expected in ("manifest", "epoch", "step_sample", "eval", "best_f1",
                     "checkpoint_saved"):
        assert expected in types["port"], expected
    assert types["port"][0] == "manifest"


def test_the_manifests_config_and_costs_blocks_are_equal(both):
    (port, *_), (jax_lines, *_) = both["port"], both["jax"]
    config, jax_config = port[0]["config"], jax_lines[0]["config"]
    assert {k: config[k] for k in jax_config} == jax_config
    # the port's own settings (code2seq's) stay at their defaults
    defaults = dataclasses.asdict(TrainConfig())
    assert {k: v for k, v in config.items() if k not in jax_config} == {
        k: v for k, v in defaults.items() if k not in jax_config}
    assert port[0]["costs"] == jax_lines[0]["costs"]
    assert port[0]["costs"]["device_kind"] == port[0]["device_kind"] == "cpu"
    assert port[0]["corpus"] == jax_lines[0]["corpus"]


def test_sinks_see_the_epoch_events_metrics(both):
    lines, _, sink = both["port"]
    epochs = [e for e in lines if e["event"] == "epoch"]
    assert len(epochs) == 2 and sink.closed
    for event in epochs:
        seen = next(m for e, m in sink.calls if e == event["epoch"] and "train_loss" in m)
        assert event["metrics"] == seen
        assert event["memory"]["host_rss_bytes"] > 0
        assert event["health"]["counters"].get("recompiles", 0) == 0
        assert event["health"]["gauges"]["host_rss_bytes"] > 0
    samples = [e for e in lines if e["event"] == "step_sample"]
    assert samples and all(0 < e["mfu"] <= 1 for e in samples)
    assert not [e for e in lines if e["event"] == "recompile"]


def test_the_ports_spans_include_jaxs(both):
    names = {}
    for name, (_, trace, _) in both.items():
        spans = [e for e in trace if e.get("ph") == "X"]
        names[name] = {s["name"] for s in spans}
        if name == "port":
            producer = {s["tid"] for s in spans if s["name"] == "host_build"}
            step = {s["tid"] for s in spans if s["name"] == "train_step"}
            assert producer and step and not producer & step
            assert all(s["dur"] >= 0 and s["ts"] >= 0 for s in spans)
    assert names["jax"] <= names["port"], names["jax"] - names["port"]
    assert {"host_build", "h2d", "train_step", "train_pass", "eval_pass",
            "checkpoint_save"} <= names["port"]


def test_a_raising_run_reports_and_cleans_up(corpus):
    _, data, _ = corpus
    cfg = TrainConfig(**{**RUN, "max_epoch": 1, "prefetch_batches": 0})
    sink = Recorder()
    events, seen = EventLog(), []
    events.subscribe(seen.append)

    def boom(epoch, f1):
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        loop.train(cfg, data, sinks=(sink,), report_fn=boom, events=events, device="cpu")
    assert any(e["event"] == "error" for e in seen)
    assert events._consumers == [seen.append]  # only this test's observer
    assert sink.closed
    # a setup failure leaves no consumer either
    events2 = EventLog()
    with pytest.raises(ValueError, match="task flags"):
        loop.train(cfg.with_updates(infer_method_name=False, infer_variable_name=True), data,
                   events=events2, device="cpu")
    assert events2._consumers == []


METRICS = {"train_loss": float("nan"), "test_loss": float("inf"), "accuracy": -float("inf"),
           "f1": 0.25, "train_steps": 7, "mfu": np.float32(0.5)}


def test_floyd_sink_prints_jaxs_lines(capsys):
    jax_sinks.floyd_sink(3, METRICS)
    want = capsys.readouterr().out
    sinks.floyd_sink(3, METRICS)
    assert capsys.readouterr().out == want
    assert '"raw": "nan"' in want and "NaN" not in want


def test_logging_sink_logs_jaxs_lines(caplog):
    out = {}
    for name, sink in (("jax", jax_sinks.logging_sink), ("port", sinks.logging_sink)):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            sink(2, METRICS)
        out[name] = [r.getMessage() for r in caplog.records]
    assert out["port"] == out["jax"] and len(out["port"]) == len(METRICS) + 1


def test_tensorboard_sink_writes_scalars(tmp_path):
    pytest.importorskip("tensorboardX")
    sink = sinks.tensorboard_sink(str(tmp_path / "tb"))
    sink(0, {"f1": 0.5, "train_loss": 1.25})
    sink(1, {"f1": 0.75, "train_loss": 1.0})
    sink.close()
    files = [f for f in os.listdir(tmp_path / "tb") if f.startswith("events.out.tfevents")]
    assert files and os.path.getsize(tmp_path / "tb" / files[0]) > 0
    data = (tmp_path / "tb" / files[0]).read_bytes()
    assert b"train_loss" in data and b"f1" in data


def test_recompile_detector_fires_on_a_new_signature_only():
    events, seen = EventLog(), []
    events.subscribe(seen.append)
    health = RuntimeHealth()
    detector = RecompileDetector(events=events, health=health)
    detector.track("train_step")
    detector.observe("train_step", (32, 16, "torch.float32"))
    assert detector.check(epoch=0) == 0  # the warmup baseline
    detector.observe("train_step", (32, 16, "torch.float32"))
    assert detector.check(epoch=1) == 0  # steady shapes: silent
    tracer = Tracer(process_index=0)
    previous = set_tracer(tracer)
    try:
        detector.observe("train_step", (32, 24, "torch.float32"))
        assert detector.check(epoch=2) == 1
    finally:
        set_tracer(previous)
    marks = [e for e in tracer.chrome_trace()["traceEvents"]
             if e.get("ph") == "i" and e["name"] == "recompile"]
    assert len(marks) == 1 and marks[0]["args"]["fn"] == "train_step"
    assert health.snapshot()["counters"]["recompiles"] == detector.recompile_count == 1
    (event,) = [e for e in seen if e["event"] == "recompile"]
    assert event["fn"] == "train_step" and event["epoch"] == 2
    assert detector.check(epoch=3) == 0
    detector.observe("untracked", (1,))  # ignored


def test_recompile_budget_stays_silent_up_to_the_ladder():
    detector = RecompileDetector()
    detector.track("bucketed_step", expected_compiles=3)
    detector.observe("bucketed_step", (32, 4))
    detector.observe("bucketed_step", (32, 8))
    assert detector.check(epoch=0) == 0
    detector.observe("bucketed_step", (32, 16))
    assert detector.check(epoch=1) == 0
    detector.observe("bucketed_step", (32, 32))
    assert detector.check(epoch=2) == 1
    with pytest.raises(ValueError, match="expected_compiles"):
        detector.track("x", expected_compiles=0)


def test_train_step_cost_is_three_forwards():
    fwd = analytic_forward_cost(64, 200, terminal_embed=100, path_embed=100, encode=100,
                                labels=8000)
    step = train_step_cost(fwd)
    assert step["flops"] == pytest.approx(3.0 * fwd["flops"])
    assert step["cost_source"] == "analytic"


def test_step_profiler_mfu():
    prof = StepProfiler(sample_steps=4, peak_flops=1e9)
    prof.record_host(0, 1.0, 0.5)
    prof.record_compute(0, 10.0, flops=1e6)  # 1e8 FLOP/s -> mfu 0.1
    prof.record_compute(1, 10.0)  # no flops -> no mfu
    steps = prof.per_step()
    assert steps[0]["mfu"] == pytest.approx(0.1) and "mfu" not in steps[1]
    assert prof.summary()["mfu"] == pytest.approx(0.1)
    bare = StepProfiler(sample_steps=2)
    bare.record_compute(0, 10.0, flops=1e6)
    assert "mfu" not in bare.per_step()[0] and "mfu" not in bare.summary()


def test_cli_writes_every_telemetry_file_on_the_cpu(corpus, tmp_path, capsys):
    from code2vec_tpu_torch import cli

    paths, _, _ = corpus
    out = tmp_path / "run"
    rc = cli.main([
        "--device", "cpu", "--corpus_path", paths["corpus"], "--path_idx_path",
        paths["path_idx"], "--terminal_idx_path", paths["terminal_idx"], "--model_path",
        str(out), "--vectors_path", str(out / "code.vec"), "--terminal_embed_size", "8",
        "--path_embed_size", "6", "--encode_size", "12", "--max_path_length", "16",
        "--max_epoch", "2", "--use_pallas", "--pallas_impl", "pool_only", "--env", "floyd",
        "--events_dir", str(tmp_path / "ev"), "--trace_dir", str(tmp_path / "tr"),
        "--profile_dir", str(tmp_path / "pr"), "--profile_steps", "2",
        "--prefetch_batches", "2"])
    assert rc == 0
    lines = strict_lines(tmp_path / "ev" / "events-p0.jsonl")
    assert lines[0]["event"] == "manifest" and lines[0]["costs"]["peak_flops_per_s"] > 0
    stdout = [json.loads(x) for x in capsys.readouterr().out.splitlines()
              if x.startswith('{"metric"')]
    epochs = [e for e in lines if e["event"] == "epoch"]
    want = [{"metric": k, "value": v} for e in epochs for k, v in e["metrics"].items()]
    want += [{"metric": "best_f1", "value": e["metrics"]["best_f1"]}
             for e in lines if e["event"] == "best_f1"]
    assert sorted(map(json.dumps, stdout)) == sorted(map(json.dumps, want))
    trace = json.load(open(tmp_path / "tr" / "trace-p0.json"))
    assert {"train_step", "eval_pass"} <= {e["name"] for e in trace["traceEvents"]}
    (profile,) = os.listdir(tmp_path / "pr")
    events = json.load(open(tmp_path / "pr" / profile))["traceEvents"]
    assert events and math.isfinite(float(events[-1].get("ts", 0)))


def test_host_probes_match_jaxs():
    from code2vec_tpu.obs import runtime as jax_runtime
    from code2vec_tpu_torch.obs import runtime

    assert runtime.host_cpu_fingerprint() == jax_runtime.host_cpu_fingerprint()
    snap = runtime.memory_snapshot(RuntimeHealth(), device="cpu")
    assert snap["host_rss_bytes"] > 0 and snap["host_peak_rss_bytes"] > 0
    assert "device" not in snap and runtime.device_memory_stats("cpu") is None
