"""The port's parallel host ingest (``data/parallel_feed.py``) on the CPU.

- ``FeedPool`` / ``ParallelFeed`` with real forked workers and the
  shared-memory arena: the delivered stream is bitwise the wrapped
  source's synchronous stream and the JAX package's, the generator left
  in the same state, the pad accounting equal;
- arena slots recycle under backpressure without overwriting a view the
  consumer still holds;
- a worker's exception re-raises with the child's traceback; a killed
  worker fails the stream instead of hanging it; a stream closed midway
  leaves the pool reusable; every wait is bounded;
- ``train()`` with ``feed_workers`` (and ``prefetch_batches``): per-epoch
  losses and F1 bitwise the synchronous run's on every source, and within
  the train differential's tolerance of JAX's ``train`` with the same
  flags; JAX's loud rejects (the variable task, device epochs).
"""

import json
import os
import signal
import threading
import time

import jax
import numpy as np
import pytest

from code2vec_tpu.data import pipeline as jax_pipeline
from code2vec_tpu.data import reader as jax_reader
from code2vec_tpu.train import loop as jax_loop
from code2vec_tpu.train.config import TrainConfig as JaxTrainConfig
from code2vec_tpu.train.step import build_train_step_fn, create_train_state
from code2vec_tpu_torch import interop
from code2vec_tpu_torch.data import pipeline, reader, synth
from code2vec_tpu_torch.data.parallel_feed import (
    FeedPool,
    FeedWorkerError,
    ParallelFeed,
    guard_fork_safety,
)
from code2vec_tpu_torch.tools.corpus_convert import text_to_csr
from code2vec_tpu_torch.train import loop
from code2vec_tpu_torch.train.config import TrainConfig

BAG = 32
METRICS = ("train_loss", "test_loss", "accuracy", "precision", "recall", "f1")


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    out = tmp_path_factory.mktemp("feed")
    paths = synth.generate_corpus_files(out, synth.SPECS["tiny"])
    csr = str(out / "corpus.csr")
    text_to_csr(paths["corpus"], csr)
    vocabs = (paths["path_idx"], paths["terminal_idx"])
    return {
        "paths": paths,
        "text": reader.load_corpus(paths["corpus"], *vocabs, cache=False, native=False),
        "mmap": reader.load_corpus(csr, *vocabs),
        "jax_text": jax_reader.load_corpus(paths["corpus"], *vocabs, cache=False, native=False),
        "jax_mmap": jax_reader.load_corpus(csr, *vocabs),
    }


def ladder_of(data):
    return pipeline.derive_bucket_ladder(np.diff(data.row_splits), BAG)


def make_source(mod, data, kind, ladder):
    idx = np.arange(data.n_items)
    bucketed = dict(ladder=ladder) if kind.endswith("bucketed") else {}
    if kind.startswith("epoch"):
        return mod.EpochSource(data, idx, 8, BAG, **bucketed)
    if kind.startswith("stream"):
        return mod.StreamingSource(data, idx, 8, BAG, 48, **bucketed)
    return mod.MmapCorpusSource(data, idx, 8, BAG, **bucketed)


def owned(stream):
    return [{k: np.array(v) for k, v in batch.items()} for batch in stream]


def same_batches(a, b):
    assert len(a) == len(b) and a
    for k, (x, y) in enumerate(zip(a, b)):
        assert x.keys() == y.keys()
        for key in x:
            assert x[key].dtype == y[key].dtype and np.array_equal(x[key], y[key]), (k, key)


KINDS = ["epoch-fixed", "epoch-bucketed", "stream-fixed", "stream-bucketed", "mmap-fixed",
         "mmap-bucketed"]


@pytest.mark.parametrize("kind", KINDS)
def test_delivered_stream_equals_sync_and_jax(corpora, kind):
    backing = "mmap" if kind.startswith("mmap") else "text"
    data, jax_data = corpora[backing], corpora[f"jax_{backing}"]
    ladder = ladder_of(data)
    source = make_source(pipeline, data, kind, ladder)
    jax_source = make_source(jax_pipeline, jax_data, kind, ladder)
    with FeedPool(data, 2, 8, BAG) as pool:
        feed = ParallelFeed(source, pool)
        assert feed.ladder == source.ladder and feed.last_epoch is None
        for shuffle in (True, False):
            r_sync, r_feed, r_jax = (np.random.default_rng(7) for _ in range(3))
            sync = list(source.batches(r_sync, shuffle))
            got = owned(feed.batches(r_feed, shuffle))
            same_batches(sync, got)
            same_batches(list(jax_source.batches(r_jax, shuffle)), got)
            assert r_sync.bit_generator.state == r_feed.bit_generator.state \
                == r_jax.bit_generator.state
            assert feed.pad_stats() == source.pad_stats() == jax_source.pad_stats()


def test_arena_recycles_under_backpressure_without_overwrite(corpora):
    """Three slots for ~25 batches: every slot recycles many times, and a
    slow consumer lets the workers run ahead into the arena. A view is
    never overwritten before the next pull: every batch's content is
    right while it is held."""
    data = corpora["mmap"]
    source = make_source(pipeline, data, "mmap-bucketed", ladder_of(data))
    sync = list(source.batches(np.random.default_rng(5)))
    with FeedPool(data, 2, 8, BAG, slots=3) as pool:
        assert len(sync) > 3 * pool.slots
        stream = ParallelFeed(source, pool).batches(np.random.default_rng(5))
        for k, batch in enumerate(stream):
            if k % 5 == 0:
                time.sleep(0.02)
            for key in sync[k]:
                assert np.array_equal(sync[k][key], batch[key]), (k, key)


def test_worker_exception_carries_the_child_traceback(corpora):
    data = corpora["mmap"]
    with FeedPool(data, 1, 8, BAG) as pool:
        bad = [pipeline.BatchPlan(width=8, valid=1, items=np.asarray([10**9], np.int64),
                                  uniforms=np.zeros(0, np.float64))]
        with pytest.raises(FeedWorkerError) as err:
            list(pool.run(iter(bad)))
        assert "feed worker traceback" in str(err.value)
        assert "Traceback (most recent call last)" in err.value.remote_traceback
        assert "IndexError" in str(err.value)
        # the pool serves the next stream
        source = make_source(pipeline, data, "mmap-fixed", None)
        same_batches(list(source.batches(np.random.default_rng(1))),
                     owned(ParallelFeed(source, pool).batches(np.random.default_rng(1))))


def test_killed_worker_fails_fast_and_the_pool_tears_down(corpora):
    data = corpora["mmap"]
    pool = FeedPool(data, 2, 8, BAG)
    try:
        feed = ParallelFeed(make_source(pipeline, data, "mmap-fixed", None), pool)
        os.kill(pool._procs[0].pid, signal.SIGKILL)
        pool._procs[0].join(timeout=10)
        t0 = time.monotonic()
        with pytest.raises(FeedWorkerError, match="died"):
            for _ in feed.batches(np.random.default_rng(2)):
                pass
        assert time.monotonic() - t0 < 10
    finally:
        pool.close()
    assert all(not p.is_alive() for p in pool._procs)
    pool.close()  # twice is a no-op
    with pytest.raises(RuntimeError, match="closed"):
        pool.run(iter(()))


def test_stream_closed_midway_leaves_the_pool_reusable(corpora):
    data = corpora["mmap"]
    source = make_source(pipeline, data, "mmap-bucketed", ladder_of(data))
    with FeedPool(data, 2, 8, BAG) as pool:
        feed = ParallelFeed(source, pool)
        stream = feed.batches(np.random.default_rng(3))
        next(stream)
        with pytest.raises(RuntimeError, match="already active"):
            feed.batches(np.random.default_rng(3))
        stream.close()
        same_batches(list(source.batches(np.random.default_rng(4))),
                     owned(feed.batches(np.random.default_rng(4))))


def test_sources_without_a_plan_split_are_refused_when_wrapped(corpora, tmp_path):
    p = corpora["paths"]
    variable = reader.load_corpus(p["corpus"], p["path_idx"], p["terminal_idx"],
                                  infer_variable=True, cache=False, native=False)
    with FeedPool(corpora["text"], 1, 8, BAG) as pool:
        with pytest.raises(ValueError, match="method task only"):
            ParallelFeed(pipeline.EpochSource(variable, np.arange(10), 8, BAG), pool)
        with pytest.raises(ValueError, match="method task only"):
            ParallelFeed(pipeline.StreamingSource(variable, np.arange(10), 8, BAG, 4), pool)
    with pytest.raises(ValueError, match=">= 1"):
        FeedPool(corpora["text"], 0, 8, BAG)


def test_fork_guard_names_live_non_daemon_threads():
    stop = threading.Event()
    worker = threading.Thread(target=stop.wait, name="c2v-test-non-daemon")
    worker.start()
    try:
        assert "c2v-test-non-daemon" in guard_fork_safety("test")
    finally:
        stop.set()
        worker.join(timeout=5)
    assert not worker.is_alive()
    assert "c2v-test-non-daemon" not in guard_fork_safety("test")


# ---------------------------------------------------------------------------
# train() through the pool
# ---------------------------------------------------------------------------

LOOP_KW = dict(terminal_embed_size=8, path_embed_size=6, encode_size=12, batch_size=32,
               max_path_length=BAG, max_epoch=2, dropout_prob=0.25, random_seed=11,
               print_sample_cycle=0)


def same_history(a, b):
    assert len(a.history) == len(b.history)
    for x, y in zip(a.history, b.history):
        for key in METRICS:
            assert x[key] == y[key], (x["epoch"], key)
        assert x.get("pad_efficiency") == y.get("pad_efficiency")


@pytest.mark.parametrize("case", [
    ("text", {}), ("text", dict(bucketed=True)), ("text", dict(stream_chunk_items=48)),
    ("mmap", dict(bucketed=True)), ("mmap", dict(stream_chunk_items=48, bucketed=True)),
], ids=["epoch-fixed", "epoch-bucketed", "stream-fixed", "mmap-bucketed",
        "stream-mmap-bucketed"])
@pytest.mark.parametrize("prefetch", [0, 2])
def test_train_with_workers_equals_sync_bitwise(corpora, case, prefetch):
    backing, flags = case
    cfg = TrainConfig(**LOOP_KW, **flags)
    sync = loop.train(cfg, corpora[backing], device="cpu")
    fed = loop.train(cfg.with_updates(feed_workers=2, prefetch_batches=prefetch),
                     corpora[backing], device="cpu")
    same_history(sync, fed)


def test_cli_feed_workers_and_prefetch_equal_the_sync_run(corpora, tmp_path, capsys):
    """The satellite repair: the post-step reads take the context count
    with the copy, and ``to_device`` owns its CPU tensors, so recycled
    arena slots and a producer running ahead change nothing."""
    from code2vec_tpu_torch import cli

    p = corpora["paths"]
    runs = []
    for extra in ([], ["--feed_workers", "2", "--prefetch_batches", "2"]):
        out = tmp_path / str(len(runs))
        assert cli.main(["--corpus_path", p["corpus"], "--path_idx_path", p["path_idx"],
                         "--terminal_idx_path", p["terminal_idx"], "--model_path", str(out),
                         "--vectors_path", str(out / "code.vec"), "--no_cuda",
                         "--max_epoch", "2", "--batch_size", "16", "--max_path_length", "40",
                         "--terminal_embed_size", "8", "--path_embed_size", "6",
                         "--encode_size", "12", *extra]) == 0
        runs.append([json.loads(x) for x in capsys.readouterr().out.splitlines()
                     if x.startswith("{")])
    assert len(runs[0]) == len(runs[1]) == 2
    for a, b in zip(*runs):
        assert (a["train_loss"], a["test_loss"], a["f1"], a["contexts_per_s"] > 0) == \
            (b["train_loss"], b["test_loss"], b["f1"], True)


def test_train_with_workers_tracks_jax_train(corpora):
    flags = dict(bucketed=True, feed_workers=2, prefetch_batches=2)
    kw = {**LOOP_KW, "dropout_prob": 0.0}
    jcfg = JaxTrainConfig(**kw, **flags)
    jax_data = corpora["jax_mmap"]
    model_cfg = jax_loop.model_config_from(jcfg, jax_data)
    state = create_train_state(jcfg, model_cfg, jax.random.PRNGKey(11), jax_loop.dummy_batch(jcfg))
    params0 = jax.tree.map(np.asarray, state.params)
    step = jax.jit(build_train_step_fn(model_cfg, jax_loop.class_weights_from(jcfg, jax_data)))
    want = jax_loop.train(jcfg, jax_data, sinks=(), initial_state=state, train_step=step)
    cfg = TrainConfig(**kw, **flags)
    sd = interop.state_dict_from_jax_params(params0, loop.model_config_from(cfg, corpora["mmap"]))
    got = loop.train(cfg, corpora["mmap"], device="cpu", initial_state_dict=sd)
    assert len(got.history) == len(want.history) == 2
    for g, w in zip(got.history, want.history):
        np.testing.assert_allclose(g["train_loss"], w["train_loss"], rtol=2e-5)
        np.testing.assert_allclose(g["test_loss"], w["test_loss"], rtol=2e-5)
        assert g["f1"] == w["f1"] and g["pad_efficiency"] == w["pad_efficiency"]


def test_loud_rejects(corpora):
    p = corpora["paths"]
    variable = reader.load_corpus(p["corpus"], p["path_idx"], p["terminal_idx"],
                                  infer_variable=True, cache=False, native=False)
    cfg = TrainConfig(**LOOP_KW, feed_workers=2, infer_variable_name=True)
    with pytest.raises(ValueError, match="method task only"):
        loop.train(cfg, variable, device="cpu")
    with pytest.raises(ValueError, match="device_epoch"):
        TrainConfig(feed_workers=2, device_epoch=True).validate()
    for name in ("feed_workers", "prefetch_batches", "stream_chunk_items", "profile_steps"):
        with pytest.raises(ValueError, match=name):
            TrainConfig(**{name: -1}).validate()
    before = {t.name for t in threading.enumerate()}
    with pytest.raises(ValueError):
        loop.train(cfg, variable, device="cpu")
    assert {t.name for t in threading.enumerate()} <= before  # nothing left running
