"""The port's spans inside training (``obs/trace.py``, ``train/step.py``,
``train/device_epoch.py``), on the CPU:

- one ``train_chunk`` on a tiny staged corpus: the span tree (names,
  nesting, order) and its args, dense and lazy, with and without
  ``sample_prefetch``; the lazy ``optimizer`` span's touched rows against
  a host recount of the distinct ids;
- span times inside a ``time.time_ns()`` bracket of the call;
- the ``NullTracer`` path makes no span and no event; on the CPU an
  installed tracer makes no CUDA event and writes no device args;
- host-fed steps span themselves and are not synchronised for it;
- the Chrome export keeps the JAX tracer's form;
- the read-out by name over an interval (count, host, self and device
  time, summed args) and the innermost-span marks, on a made-up clock;
- the per-layer readings the benchmark's tool derives from a read-out.

The card's side (device times, no added sync, ``drained``) is in
``tests/test_torch_cuda.py``.
"""

import json
import time

import numpy as np
import pytest
import torch

from code2vec_tpu.obs.trace import Tracer as JaxTracer
from code2vec_tpu_torch import PAD_INDEX
from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig
from code2vec_tpu_torch.obs import trace
from code2vec_tpu_torch.obs.trace import NULL_TRACER, Tracer, get_tracer, set_tracer
from code2vec_tpu_torch.train import device_epoch as de
from code2vec_tpu_torch.train.config import TrainConfig
from code2vec_tpu_torch.train.step import StepTally, make_optimizer

B, BAG, LABELS, VOCAB = 8, 12, 7, 1000
STEP_CHILDREN = ["forward", "backward", "optimizer"]


def chunk_case(update="dense", prefetch=False, n_items=40, seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 30, n_items)
    splits = np.zeros(n_items + 1, np.int32)
    np.cumsum(lens, out=splits[1:])
    ctx = rng.integers(1, VOCAB, (int(splits[-1]), 3)).astype(np.int32)
    labels = rng.integers(0, LABELS, n_items).astype(np.int32)
    corpus = de.StagedCorpus(torch.from_numpy(ctx), torch.from_numpy(splits),
                             torch.from_numpy(labels), n_items, lens.astype(np.int64))
    model = Code2Vec(Code2VecConfig(terminal_count=VOCAB, path_count=VOCAB, label_count=LABELS,
                                    terminal_embed_size=8, path_embed_size=6, encode_size=12,
                                    dropout_prob=0.0))
    model.reset_parameters(torch.Generator().manual_seed(3))
    opt = make_optimizer(model, TrainConfig(lr=0.01, table_update=update))
    runner = de.EpochRunner(torch.ones(LABELS), B, BAG, 3, prefetch)
    order = np.random.default_rng(1).permutation(n_items)
    return model, opt, corpus, runner, order


def run_chunk(update="dense", prefetch=False, tracer=None, n_valid=None):
    """One traced chunk of 3 steps: ``(tracer, batches, real, n_valid)``,
    the batches sampled again from the generator's state before it."""
    model, opt, corpus, runner, order = chunk_case(update, prefetch)
    n_valid = 3 * B if n_valid is None else n_valid
    g = de.sampler_generator(5, "cpu")
    state = g.get_state()
    tracer = Tracer() if tracer is None else tracer
    previous = set_tracer(tracer)
    try:
        runner.train_chunk(model, opt, corpus, order, 0, 3, n_valid, g, StepTally("cpu"))
    finally:
        set_tracer(previous)
    g.set_state(state)
    batches = list(runner._batches(corpus, order, 0, 3, n_valid, g))
    return tracer, batches, runner._real_contexts(corpus, order, 0, 3, n_valid), n_valid


def spans_of(tracer):
    return [e for e in tracer.chrome_trace()["traceEvents"] if e.get("ph") == "X"]


def tree(spans):
    """``[(name, args, children)]``, nesting by containment on one thread
    (1 us of slack for the export's rounding)."""
    roots, stack = [], []
    for e in sorted(spans, key=lambda e: (e["ts"], -e["dur"])):
        node = (e["name"], e.get("args", {}), [])
        while stack and e["ts"] + e["dur"] > stack[-1][0]["ts"] + stack[-1][0]["dur"] + 1:
            stack.pop()
        (stack[-1][1][2] if stack else roots).append(node)
        stack.append((e, node))
    return roots


def shape(nodes):
    return [(name, shape(children)) for name, _, children in nodes]


@pytest.mark.parametrize("prefetch", [False, True], ids=["plain", "prefetch"])
@pytest.mark.parametrize("update", ["dense", "lazy"])
def test_train_chunk_span_tree(update, prefetch):
    tracer, _, real, n_valid = run_chunk(update, prefetch, n_valid=3 * B - 3)
    (chunk,) = tree(spans_of(tracer))
    name, args, children = chunk
    assert name == "train_chunk"
    assert args == {"steps": 3, "rows": n_valid, "slots": 3 * B * BAG,
                    "real_contexts": sum(real), "late_steps": 0}
    step = ("train_step", [(c, []) for c in STEP_CHILDREN])
    sample = ("sample", [])
    # prefetched: batch i + 1 is sampled before step i
    want = ([sample, sample, step, sample, step, step] if prefetch
            else [sample, step, sample, step, sample, step])
    assert shape(children) == want


def test_lazy_optimizer_spans_count_the_touched_rows():
    tracer, batches, _, _ = run_chunk("lazy")
    opt = [e["args"] for e in spans_of(tracer) if e["name"] == "optimizer"]
    assert len(opt) == len(batches) == 3
    for args, batch in zip(opt, batches):
        terminals = torch.cat([batch["starts"], batch["ends"]], dim=1).numpy()
        assert args["terminal_rows_processed"] == terminals.size == B * 2 * BAG
        assert args["path_rows_processed"] == batch["paths"].numel() == B * BAG
        assert args["terminal_rows_touched"] == np.unique(terminals).size
        assert args["path_rows_touched"] == np.unique(batch["paths"].numpy()).size
        assert PAD_INDEX in terminals  # PAD's row is read and written like any other


def test_dense_optimizer_spans_carry_no_rows():
    tracer, _, _, _ = run_chunk("dense")
    assert all("args" not in e for e in spans_of(tracer) if e["name"] == "optimizer")


def test_span_times_lie_inside_a_wall_clock_bracket():
    t0 = time.time_ns()
    tracer, _, _, _ = run_chunk()
    t1 = time.time_ns()
    spans = spans_of(tracer)
    assert len(spans) == 1 + 3 * (2 + len(STEP_CHILDREN))
    for e in spans:
        assert t0 // 1000 - 1 <= e["ts"] and e["ts"] + e["dur"] <= t1 / 1000 + 1, e


def test_the_null_tracer_makes_no_span_and_no_event(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("created under the NullTracer")

    monkeypatch.setattr(trace._Span, "__init__", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert get_tracer() is NULL_TRACER
    run_chunk(tracer=NULL_TRACER)
    assert get_tracer() is NULL_TRACER


def test_on_the_cpu_a_tracer_makes_no_device_event(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CUDA event on the CPU")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    tracer, _, _, _ = run_chunk("lazy")
    for e in spans_of(tracer):
        assert not {"device_ms", "drained"} & set(e.get("args", {})), e
    summary = tracer.summary()
    assert all(row["device_count"] == 0 for row in summary.values())
    assert tracer.drained_edges == 0


def test_host_fed_steps_span_themselves_without_a_sync(monkeypatch, tmp_path):
    from code2vec_tpu_torch.data import reader, synth
    from code2vec_tpu_torch.train import loop

    paths = synth.generate_corpus_files(tmp_path, synth.SPECS["tiny"])
    data = reader.load_corpus(paths["corpus"], paths["path_idx"], paths["terminal_idx"])
    syncs = []
    monkeypatch.setattr(loop, "_sync", syncs.append)
    tracer = Tracer()
    cfg = TrainConfig(max_epoch=1, batch_size=32, encode_size=16, terminal_embed_size=8,
                      path_embed_size=8, max_path_length=16, print_sample_cycle=0)
    loop.train(cfg, data, device="cpu", tracer=tracer)
    assert syncs == []
    roots = tree([e for e in spans_of(tracer) if e["name"] in ("train_step", *STEP_CHILDREN)])
    assert roots and all(shape([r]) == [("train_step", [(c, []) for c in STEP_CHILDREN])]
                         for r in roots)


def record_alike(tracer, clock=None):
    """The same spans, mark, outside span and overflow through a tracer."""
    with tracer.span("outer", category="train", epoch=1, ratio=float("nan")):
        with tracer.span("inner", queue=np.int64(2)):
            pass
    tracer.instant("recompile", category="health", fn="train_step")
    now = time.perf_counter()
    tracer.span_complete("feed", category="data", start_s=now - 0.002, end_s=now,
                         track="feed-worker-0", items=3)
    with tracer.span("dropped"):
        pass
    return tracer.chrome_trace()


def test_the_chrome_export_keeps_the_jax_form():
    got = record_alike(Tracer(process_name="p", max_events=4))
    want = record_alike(JaxTracer(process_name="p", max_events=4))

    def form(trace_obj):
        events = trace_obj["traceEvents"]
        meta = [e for e in events if e["ph"] == "M"]
        assert events[:len(meta)] == meta  # the metadata first
        assert [e["ts"] for e in events[len(meta):]] == sorted(e["ts"] for e in events[len(meta):])
        return ({k: v for k, v in trace_obj.items() if k != "traceEvents"}, meta,
                sorted((e["name"], list(e), {k: type(v).__name__ for k, v in e.items()},
                        json.dumps(e.get("args"))) for e in events[len(meta):]))

    assert form(got) == form(want)
    assert got["dropped_events"] == 1
    json.dumps(got, allow_nan=False)


def test_summary_and_marks_on_a_made_up_clock(monkeypatch):
    now = [0]
    monkeypatch.setattr(time, "perf_counter_ns", lambda: now[0])
    tracer = Tracer()

    def at(t):
        now[0] = t

    at(100)
    with tracer.span("chunk", steps=2) as chunk:
        at(110)
        with tracer.span("step", drained=True):
            at(130)
        at(140)
        with tracer.span("step", drained=False, rows=torch.tensor(4)):
            at(150)
            with tracer.span("forward"):
                at(160)
            at(190)
        chunk.args["late_steps"] = 1
        at(200)
    at(300)
    with tracer.span("chunk", steps=5):
        at(400)
    summary = tracer.summary(end_ns=250)
    assert set(summary) == {"chunk", "step", "forward"}
    assert summary["chunk"] == {"count": 1, "host_ms": pytest.approx(100e-6),
                                "self_ms": pytest.approx(30e-6), "device_ms": 0.0,
                                "device_count": 0, "args": {"steps": 2, "late_steps": 1}}
    assert summary["step"]["count"] == 2
    assert summary["step"]["host_ms"] == pytest.approx(70e-6)
    assert summary["step"]["self_ms"] == pytest.approx(60e-6)
    assert summary["step"]["args"] == {"drained": 1, "rows": 4}
    assert tracer.summary(start_ns=250)["chunk"]["args"] == {"steps": 5}
    assert tracer.summary(start_ns=120, end_ns=180) == {
        "forward": {"count": 1, "host_ms": pytest.approx(10e-6),
                    "self_ms": pytest.approx(10e-6), "device_ms": 0.0, "device_count": 0,
                    "args": {}}}
    wall = tracer.wall_ns(0)
    got = [(a - wall, b - wall, n) for a, b, n in tracer.marks(end_ns=250)]
    assert got == [(100, 110, "chunk"), (110, 130, "step"), (130, 140, "chunk"),
                   (140, 150, "step"), (150, 160, "forward"), (160, 190, "step"),
                   (190, 200, "chunk")]
    # a span that overlaps the interval is cut from it whole
    assert [n for _, _, n in tracer.marks(start_ns=155, end_ns=158)] == \
        ["chunk", "step", "forward", "step", "chunk"]


def test_wall_clock_anchor_matches_time_ns():
    tracer = Tracer()
    assert abs(tracer.wall_ns(time.perf_counter_ns()) - time.time_ns()) < 50_000_000


def test_readings_of_a_made_up_summary():
    from c2vbench.program_spans import readings

    def row(count, device_ms=0.0, device_count=0, **args):
        return {"count": count, "host_ms": 1.0, "self_ms": 0.5, "device_ms": device_ms,
                "device_count": device_count, "args": args}

    summary = {
        "train_chunk": row(2, steps=32, late_steps=4),
        "train_step": row(32),
        "sample": row(32, 3.2, 32, drained=4),
        "forward": row(32, 64.0, 32),
        "backward": row(32, 128.0, 32),
        "optimizer": row(32, 16.0, 32, terminal_rows_processed=1000,
                         terminal_rows_touched=300, path_rows_processed=500,
                         path_rows_touched=200),
    }
    assert readings(summary) == pytest.approx({
        "train.sample_device_ms": 0.1, "train.forward_device_ms": 2.0,
        "train.backward_device_ms": 4.0, "train.optimizer_device_ms": 0.5,
        "train.host_late_pct": 12.5, "train.lazy_rows_useful_pct": 100.0 * 500 / 1500})
    # a dense run carries no rows; a run with no program spans, nothing
    summary["optimizer"] = row(32, 16.0, 32)
    assert "train.lazy_rows_useful_pct" not in readings(summary)
    assert readings({}) == {}
    # spans whose edges were never read (the CPU) give no device reading
    assert "train.forward_device_ms" not in readings({"train_step": row(2),
                                                      "forward": row(2)})


def test_a_tracer_past_its_cap_records_no_edges_and_reuses_its_events(monkeypatch):
    """Past ``max_events`` a span records no device edges, and an edged span
    that closes past the cap hands its events back: a long run makes no more
    timing events than its first step did, and leaves none unread. Stand-ins
    take the place of the card's events and stream."""
    made, sanitized = [], []

    class Event:
        def __init__(self, enable_timing=False):
            made.append(self)

        def record(self, stream=None):
            pass

        def query(self):
            return True

        def synchronize(self):
            pass

        def elapsed_time(self, other):
            return 1.0

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: "stream")
    sanitize = trace.sanitize
    monkeypatch.setattr(trace, "sanitize", lambda a: sanitized.append(a) or sanitize(a))
    dev = torch.device("cuda", 0)
    tracer = Tracer(max_events=5)
    for step in range(50):
        tracer.poll()
        with tracer.span("outer", "train", dev):
            with tracer.span("inner", "train", dev, rows=torch.tensor(3)):
                pass
        if step == 3:
            calls = len(sanitized)
    assert len(made) == 4  # the first step's two pairs
    assert len(sanitized) == calls  # a dropped span's args are not read
    got = tracer.chrome_trace()
    assert got["dropped_events"] == 2 * 50 - 5
    kept = [e for e in got["traceEvents"] if e.get("ph") == "X"]
    assert sorted(e["name"] for e in kept) == ["inner"] * 3 + ["outer"] * 2
    assert all(e["args"]["device_ms"] == 1.0 for e in kept)
    assert sorted(map(id, tracer._pool)) == sorted(map(id, made)) and not tracer._pending


def test_program_spans_reads_the_window_of_the_drivers_own_run(monkeypatch):
    """``c2vbench.program_spans`` installs the program's tracer around the
    cell's driver and reads the spans of its window alone (not set-up's),
    with the rates the benchmark's readers give the same run."""
    from c2vbench import program_spans
    from c2vbench.drivers import train_device
    from c2vbench.harness import Run

    def step(tracer):
        with tracer.span("train_step", "train"):
            with tracer.span("forward", "train"):
                pass

    def run(cell, seed, seconds, trace, device, t_start):
        tracer = get_tracer()
        step(tracer)  # set-up's step
        time.sleep(0.002)
        setup_s = time.perf_counter() - t_start
        for _ in range(3):
            step(tracer)
        window_s = time.perf_counter() - t_start - setup_s
        return Run(correct=True, attempted=3, failed=0, checks={},
                   counters={"setup_s": setup_s, "window_s": window_s, "steps": 3,
                             "contexts": 300, "enqueue_s": 0.003, "enqueue_steps": 3})

    monkeypatch.setattr(train_device, "run", run)
    tracer = Tracer()
    got, t0, t1, profiler_ns = program_spans._drive(None, 1, 1.0, "cpu", tracer)
    assert get_tracer() is NULL_TRACER and profiler_ns is None
    assert tracer.summary()["train_step"]["count"] == 4
    assert tracer.summary(t0, t1)["train_step"]["count"] == 3
    rates = program_spans._rates(got)
    assert rates["train_contexts_per_s"] == pytest.approx(300 / got.counters["window_s"])
    assert rates["train.enqueue_ms"] == pytest.approx(1.0)
    assert rates["correct"] and rates["steps"] == 3
