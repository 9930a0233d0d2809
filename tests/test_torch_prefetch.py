"""The port's host prefetcher and step profiler (``train/prefetch.py``).

The prefetcher may only overlap work, never change it: the same batches
in the same order, so the same losses under a fixed seed. Also: a
producer's exception (the build or the copy) re-raises at the next pull
with its traceback, a yielded None is not the end of the stream, the
queue bounds how far the producer runs ahead, ``close()`` joins the
thread and closes the iterator, no thread outlives an epoch; the
synchronous twin yields the same pairs; the profiler's split reaches the
epoch line; the CLI flags reach the config.
"""

import threading
import time

import numpy as np
import pytest
import torch

from code2vec_tpu_torch.data import reader, synth
from code2vec_tpu_torch.train import loop
from code2vec_tpu_torch.train.config import TrainConfig
from code2vec_tpu_torch.train.prefetch import HostPrefetcher, StepProfiler, device_batches
from code2vec_tpu_torch.train.step import to_device


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    paths = synth.generate_corpus_files(tmp_path_factory.mktemp("prefetch"), synth.SPECS["tiny"])
    return reader.load_corpus(paths["corpus"], paths["path_idx"], paths["terminal_idx"],
                              cache=False, native=False)


TINY = dict(max_epoch=2, batch_size=32, encode_size=16, terminal_embed_size=8,
            path_embed_size=8, max_path_length=16, print_sample_cycle=0, random_seed=3)
METRICS = ("train_loss", "test_loss", "accuracy", "precision", "recall", "f1")


def count_batches(n, events=None):
    """``n`` small dict batches, recording production and the close."""
    produced = events if events is not None else []
    try:
        for i in range(n):
            produced.append(i)
            yield {"x": np.full(4, i)}
    finally:
        produced.append("closed")


def test_batch_order_is_the_sync_order():
    with HostPrefetcher(count_batches(16), lambda b: b, depth=2) as pf:
        got = [dev["x"][0] for _, dev in pf]
    assert got == list(range(16))


def test_host_and_device_batches_pair_up():
    with HostPrefetcher(count_batches(5), lambda b: {"x": torch.from_numpy(b["x"] + 100)},
                        depth=2) as pf:
        for host, dev in pf:
            assert np.array_equal(host["x"] + 100, dev["x"].numpy())


@pytest.mark.parametrize("flags", [{}, dict(bucketed=True), dict(stream_chunk_items=48),
                                   dict(stream_chunk_items=48, bucketed=True)],
                         ids=["fixed", "bucketed", "stream", "stream-bucketed"])
def test_epochs_equal_the_sync_run_bitwise(tiny, flags):
    sync = loop.train(TrainConfig(**TINY, **flags), tiny, device="cpu")
    ahead = loop.train(TrainConfig(**TINY, **flags, prefetch_batches=2), tiny, device="cpu")
    assert len(sync.history) == len(ahead.history) == 2
    for a, b in zip(sync.history, ahead.history):
        assert all(a[k] == b[k] for k in METRICS)


def test_producer_exception_propagates_with_its_traceback():
    def bad():
        yield {"x": np.zeros(2)}
        raise RuntimeError("corrupt corpus row")

    with HostPrefetcher(bad(), lambda b: b, depth=2) as pf:
        next(pf)
        with pytest.raises(RuntimeError, match="corrupt corpus row") as err:
            next(pf)
    assert "Traceback (most recent call last)" in err.value.remote_traceback
    assert "bad" in err.value.remote_traceback


def test_to_device_exception_propagates():
    def exploding(batch):
        raise ValueError("bad copy")

    with HostPrefetcher(count_batches(3), exploding, depth=2) as pf:
        with pytest.raises(ValueError, match="bad copy"):
            next(pf)


def test_a_yielded_none_is_not_the_end_of_the_stream():
    def batches():
        yield {"x": np.zeros(2)}
        yield None

    with HostPrefetcher(batches(), lambda b: dict(b), depth=2) as pf:
        next(pf)
        with pytest.raises(TypeError):
            next(pf)


def test_the_queue_bounds_the_producer():
    events = []
    pf = HostPrefetcher(count_batches(100, events), lambda b: b, depth=2)
    try:
        deadline = time.time() + 5.0
        while time.time() < deadline and len(events) < 3:
            time.sleep(0.01)
        time.sleep(0.2)  # an unbounded producer would run on here
        assert 3 <= len(events) <= 4  # depth ready + one in hand
        assert sum(1 for _ in pf) == 100
    finally:
        pf.close()


def test_close_midway_joins_and_closes_the_iterator():
    events = []
    pf = HostPrefetcher(count_batches(1000, events), lambda b: b, depth=2)
    next(pf)
    pf.close()
    assert not pf._thread.is_alive()
    assert events[-1] == "closed"
    pf.close()
    with pytest.raises(StopIteration):
        next(pf)


def test_exhaustion_joins_the_thread_and_depth_must_be_positive():
    pf = HostPrefetcher(count_batches(3), lambda b: b, depth=1)
    assert sum(1 for _ in pf) == 3
    assert not pf._thread.is_alive()
    with pytest.raises(ValueError, match="depth"):
        HostPrefetcher(count_batches(1), lambda b: b, depth=0)


def test_no_thread_outlives_an_epoch(tiny):
    before = threading.active_count()
    for _ in range(8):
        with HostPrefetcher(count_batches(4), lambda b: b, depth=2) as pf:
            for _ in pf:
                pass
    loop.train(TrainConfig(**{**TINY, "max_epoch": 1}, prefetch_batches=2), tiny, device="cpu")
    assert threading.active_count() <= before


def test_the_sync_twin_yields_the_same_pairs_without_a_thread():
    before = threading.active_count()
    events = []
    with device_batches(count_batches(4, events), lambda b: b, prefetch=0) as st:
        assert [host["x"][0] for host, _ in st] == [0, 1, 2, 3]
    assert threading.active_count() == before and events[-1] == "closed"
    events = []
    with device_batches(count_batches(100, events), lambda b: b, prefetch=0) as st:
        next(st)
    assert events[-1] == "closed"


def test_to_device_owns_its_cpu_tensors():
    """A rebuilt host array (a recycled arena slot) leaves the copy as it was."""
    batch = {key: np.ones((2, 3), np.int32) for key in ("starts", "paths", "ends")}
    batch.update(labels=np.ones(2, np.int32), example_mask=np.ones(2, np.float32))
    out = to_device(batch, torch.device("cpu"))
    for array in batch.values():
        array[...] = 7
    assert all(int(t.flatten()[0]) == 1 for t in out.values())


def test_profiler_records_and_summarizes():
    prof = StepProfiler(sample_steps=2)
    with device_batches(count_batches(4), lambda b: b, prefetch=2, profiler=prof) as st:
        for step, _ in enumerate(st):
            if prof.sampled(step):
                prof.record_compute(step, 5.0)
    assert [s["step"] for s in prof.per_step()] == [0, 1]
    summary = prof.summary()
    assert summary["profiled_steps"] == 2 and summary["compute_ms"] == 5.0
    assert summary["host_build_ms"] >= 0.0 and summary["h2d_ms"] >= 0.0
    assert summary["feed_wait_ms"] == 0.0
    prof.observe_epoch_length(8)
    prof.reset()
    assert prof.summary() is None and prof.stride == 4
    assert [s for s in range(8) if prof.sampled(s)] == [0, 4]
    off = StepProfiler(0)
    assert not off.sampled(0) and off.summary() is None and off.per_step() == []


@pytest.mark.parametrize("feed_workers", [0, 2])
def test_profiled_run_reports_its_split(tiny, feed_workers):
    cfg = TrainConfig(**{**TINY, "max_epoch": 1}, profile_steps=3, prefetch_batches=2,
                      feed_workers=feed_workers)
    h = loop.train(cfg, tiny, device="cpu").history[0]
    assert h["profiled_steps"] == 3
    for key in ("host_build_ms", "h2d_ms", "feed_wait_ms", "compute_ms"):
        assert h[key] >= 0.0
    plain = loop.train(TrainConfig(**{**TINY, "max_epoch": 1}), tiny, device="cpu").history[0]
    assert all(h[k] == plain[k] for k in METRICS)


def test_cli_flags_reach_the_config():
    from code2vec_tpu_torch.cli import build_parser, config_from_args

    args = build_parser().parse_args(["--prefetch_batches", "3", "--profile_steps", "5",
                                      "--feed_workers", "2", "--stream_chunk_items", "64",
                                      "--corpus_format", "csr", "--no_corpus_cache"])
    config = config_from_args(args)
    assert (config.prefetch_batches, config.profile_steps, config.feed_workers,
            config.stream_chunk_items) == (3, 5, 2, 64)
    assert args.corpus_format == "csr" and args.no_corpus_cache
    config = config_from_args(build_parser().parse_args([]))
    assert (config.prefetch_batches, config.profile_steps, config.feed_workers,
            config.stream_chunk_items) == (0, 0, 0, 0)
