"""Elastic training in the port against ``tests/test_elastic.py`` and the
JAX package: the fault plan, the SIGTERM guard, sync and async checkpoint
writers, mid-epoch cursors and their replay.

Each class mirrors its JAX namesake with the port's own counterpart, at
JAX's ``TINY`` size (batch 32, encode 64, embed 32/32, bag 32, 3 epochs,
5 steps an epoch), on the CPU:

- ``TestFaultPlan``: the plan's grammar, counters, env install and the
  ``sigterm`` action;
- ``TestCheckpointCrashWindows``: a slot file that does not load is
  skipped, a ``mid_save`` fault leaves the previous checkpoint restorable,
  a slot's meta is its arrays', a same-step re-save never unpublishes, the
  staging files are swept whatever their pid, a best save prunes the
  ``last`` slot it supersedes;
- ``TestAsyncCheckpoint``: the persist overlaps, its failure re-raises at
  the next save, at most one is in flight, the snapshot owns its memory,
  async training equals sync bitwise (dense, bf16-mu and lazy tables);
- ``TestMidEpochResume``: a kill inside an epoch resumes to the
  uninterrupted history bit for bit (host-fed, prefetched, bucketed,
  streamed, mmap-fed, feed workers, a fault in the producer thread, an
  epoch-boundary resume, device epochs), and a changed batching config
  fails with JAX's guidance;
- ``TestGracefulPreemption``: SIGTERM saves, returns and resumes bitwise;
  a pending cursor survives a second SIGTERM; the producer drains train
  streams only;
- ``TestSkipBatches``: the replay primitive, over every source and the
  feed workers' arena;
- ``TestLossFold``: an epoch's loss is JAX's left fold in float64, bitwise;
- the JAX differentials: the resumed port run tracks the resumed JAX run
  (rtol 1e-4 on the losses, accuracy and F1 equal; plain and pool_only)
  and every fault point's hit count equals JAX's;
- one SIGKILLed CLI in a subprocess, resumed bitwise.
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from code2vec_tpu import faultinject as jax_faultinject
from code2vec_tpu.data import reader as jax_reader
from code2vec_tpu.train import loop as jax_loop
from code2vec_tpu.train.config import TrainConfig as JaxTrainConfig
from code2vec_tpu.train.step import build_train_step_fn, create_train_state
from code2vec_tpu_torch import faultinject, interop
from code2vec_tpu_torch.checkpoint import (
    CheckpointWriter,
    TrainMeta,
    clear_checkpoints,
    restore_checkpoint,
    save_checkpoint,
    slot_path,
    snapshot_state,
)
from code2vec_tpu_torch.data import pipeline, reader, synth
from code2vec_tpu_torch.data.parallel_feed import FeedPool, ParallelFeed
from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig
from code2vec_tpu_torch.tools.corpus_convert import text_to_csr
from code2vec_tpu_torch.train import loop
from code2vec_tpu_torch.train.config import TrainConfig
from code2vec_tpu_torch.train.preempt import (
    install_sigterm_handler,
    preemption_guard,
    restore_sigterm_handler,
)
from code2vec_tpu_torch.train.prefetch import device_batches
from code2vec_tpu_torch.train.step import StepTally, make_optimizer, to_device, train_step

REPO = Path(__file__).resolve().parent.parent
# metrics that must round-trip bitwise through a kill and its resume
METRIC_KEYS = ("train_loss", "test_loss", "accuracy", "precision", "recall", "f1")
TINY = dict(max_epoch=3, batch_size=32, encode_size=64, terminal_embed_size=32,
            path_embed_size=32, max_path_length=32, print_sample_cycle=0, checkpoint_cycle=1)
POINTS = ("train_step", "epoch_start", "pre_save", "mid_save", "post_save")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    out = tmp_path_factory.mktemp("tiny_elastic")
    paths = synth.generate_corpus_files(out, synth.SPECS["tiny"])
    args = (paths["corpus"], paths["path_idx"], paths["terminal_idx"])
    csr = str(out / "corpus.csr")
    text_to_csr(paths["corpus"], csr)
    return {"paths": paths, "data": reader.load_corpus(*args),
            "mmap": reader.load_corpus(csr, paths["path_idx"], paths["terminal_idx"]),
            "jax": jax_reader.load_corpus(*args, cache=False, native=False)}


@pytest.fixture(autouse=True)
def _no_fault_plan():
    faultinject.install_plan(None)
    jax_faultinject.install_plan(None)
    yield
    faultinject.install_plan(None)
    jax_faultinject.install_plan(None)
    preemption_guard().clear()


def run(cfg, data, out_dir=None, **kw):
    return loop.train(TrainConfig(**cfg), data, out_dir, device="cpu", **kw)


@pytest.fixture(scope="module")
def full(tiny, tmp_path_factory):
    """The uninterrupted host-fed run: every host feed (sync, prefetched,
    feed workers) feeds its batches."""
    return run(TINY, tiny["data"], str(tmp_path_factory.mktemp("full")))


def assert_bitwise_history(r1, r2):
    assert len(r1.history) == len(r2.history), (
        [h["epoch"] for h in r1.history], [h["epoch"] for h in r2.history])
    for h1, h2 in zip(r1.history, r2.history):
        for key in METRIC_KEYS:
            assert h1[key] == h2[key], (h1["epoch"], key, h1[key], h2[key])


def assert_same_state(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k].cpu(), b[k].cpu()), k


def kill_and_resume(data, out_dir, kill_cfg, resume_cfg):
    with pytest.raises(faultinject.FaultInjected):
        run(kill_cfg, data, out_dir)
    return run(resume_cfg, data, out_dir)


# ---------------------------------------------------------------------------
# the fault plan
# ---------------------------------------------------------------------------


class TestFaultPlan:
    def test_parse_and_fire(self):
        plan = faultinject.parse_plan("p@2:raise,q:sleep1")
        plan.fire("p")
        with pytest.raises(faultinject.FaultInjected):
            plan.fire("p")
        plan.fire("q")
        assert plan.hits("p") == 2 and plan.hits("q") == 1
        # the JAX package's parse of the same plan
        assert plan.clauses == jax_faultinject.parse_plan("p@2:raise,q:sleep1").clauses

    @pytest.mark.parametrize("bad", ["p", "p:explode", "p@0:raise", "p@1:raise,p:raise",
                                     ":raise", "p:sleep"])
    def test_malformed_plans_rejected(self, bad):
        with pytest.raises(ValueError):
            faultinject.parse_plan(bad)

    def test_install_resets_counters(self):
        faultinject.install_plan("p@1:raise")
        with pytest.raises(faultinject.FaultInjected):
            faultinject.fault_point("p")
        faultinject.install_plan("p@1:raise")
        with pytest.raises(faultinject.FaultInjected):
            faultinject.fault_point("p")
        faultinject.install_plan(None)
        faultinject.fault_point("p")

    def test_env_install(self, monkeypatch):
        monkeypatch.setenv(faultinject.ENV_VAR, "envpoint@1:raise")
        assert faultinject.ENV_VAR == jax_faultinject.ENV_VAR == "C2V_FAULT_PLAN"
        plan = faultinject.install_plan_from_env()
        assert ("envpoint", 1) in plan.clauses

    def test_sigterm_action_sets_guard(self):
        previous = install_sigterm_handler()
        try:
            guard = preemption_guard()
            guard.clear()
            faultinject.install_plan("p@1:sigterm")
            faultinject.fault_point("p")
            signal.pthread_sigmask(signal.SIG_BLOCK, [])  # let it deliver
            assert guard.requested() and guard.reason == "SIGTERM"
        finally:
            restore_sigterm_handler(previous)
        assert signal.getsignal(signal.SIGTERM) is previous


# ---------------------------------------------------------------------------
# the checkpoint layer
# ---------------------------------------------------------------------------


def small_state(seed=0):
    """A small model and its dense Adam, one step taken (the optimizer
    holds moments)."""
    cfg = TrainConfig(batch_size=4, max_path_length=8, terminal_embed_size=8,
                      path_embed_size=8, encode_size=12)
    model = Code2Vec(Code2VecConfig(terminal_count=20, path_count=20, label_count=5,
                                    terminal_embed_size=8, path_embed_size=8, encode_size=12))
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model.seed_dropout(seed)
    opt = make_optimizer(model, cfg)
    step_once(model, opt, seed)
    return model, opt, np.random.default_rng(seed)


def step_once(model, opt, seed=0):
    g = np.random.default_rng(seed + 100)
    batch = {"starts": g.integers(1, 20, (4, 8)), "paths": g.integers(1, 20, (4, 8)),
             "ends": g.integers(1, 20, (4, 8)), "labels": g.integers(0, 5, 4).astype(np.int32),
             "example_mask": np.ones(4, np.float32)}
    train_step(model, opt, to_device(batch, torch.device("cpu")), torch.ones(5))


def restored_weights(out, prefer_best=False):
    model, opt, rng = small_state(seed=9)
    meta = restore_checkpoint(out, model, opt, rng, 1, prefer_best=prefer_best)
    return meta, model.state_dict()


class TestCheckpointCrashWindows:
    def test_truncated_save_is_skipped_by_restore(self, tmp_path, caplog):
        model, opt, rng = small_state()
        out = str(tmp_path)
        save_checkpoint(out, "best", model, opt, TrainMeta(epoch=1), rng)
        want = {k: v.clone() for k, v in model.state_dict().items()}
        step_once(model, opt, 1)
        save_checkpoint(out, "last", model, opt, TrainMeta(epoch=2, step=7), rng)
        with open(slot_path(out, "last"), "r+b") as f:  # a save cut short by other means
            f.truncate(os.path.getsize(slot_path(out, "last")) // 2)
        with caplog.at_level("WARNING", logger="code2vec_tpu_torch.checkpoint"):
            meta, got = restored_weights(out)
        assert meta.epoch == 1
        assert_same_state(got, want)
        assert "unreadable checkpoint" in caplog.text

    def test_mid_save_fault_leaves_previous_checkpoint_restorable(self, tmp_path):
        model, opt, rng = small_state()
        out = str(tmp_path)
        save_checkpoint(out, "last", model, opt, TrainMeta(epoch=1), rng)
        want = {k: v.clone() for k, v in model.state_dict().items()}
        step_once(model, opt, 1)
        faultinject.install_plan("mid_save@1:raise")
        with pytest.raises(faultinject.FaultInjected):
            save_checkpoint(out, "last", model, opt, TrainMeta(epoch=2, step=9), rng)
        faultinject.install_plan(None)
        staged = [n for n in os.listdir(out) if ".tmp" in n]
        assert staged == [f"checkpoint_last.pt.tmp{os.getpid()}"]
        meta, got = restored_weights(out)  # restore never reads the staging file
        assert meta.epoch == 1
        assert_same_state(got, want)
        # the next save of this process writes over its staging file and succeeds
        save_checkpoint(out, "last", model, opt, TrainMeta(epoch=2, step=9), rng)
        assert not any(".tmp" in n for n in os.listdir(out))
        meta, got = restored_weights(out)
        assert meta.epoch == 2 and meta.step == 9
        assert_same_state(got, model.state_dict())

    def test_per_slot_meta_matches_restored_arrays(self, tmp_path):
        model, opt, rng = small_state()
        out = str(tmp_path)
        save_checkpoint(out, "best", model, opt, TrainMeta(epoch=1, best_f1=0.5), rng)
        best = {k: v.clone() for k, v in model.state_dict().items()}
        step_once(model, opt, 1)
        save_checkpoint(out, "last", model, opt, TrainMeta(epoch=3, best_f1=0.5, bad_count=2,
                                                           step=7), rng)
        meta, got = restored_weights(out, prefer_best=True)
        assert meta.epoch == 1 and meta.bad_count == 0
        assert_same_state(got, best)
        meta, got = restored_weights(out)
        assert meta.epoch == 3 and meta.bad_count == 2
        assert_same_state(got, model.state_dict())

    def test_same_step_resave_never_unpublishes(self, tmp_path):
        model, opt, rng = small_state()
        out = str(tmp_path)
        save_checkpoint(out, "last", model, opt, TrainMeta(epoch=1, step=4), rng)
        faultinject.install_plan("mid_save@1:raise")
        with pytest.raises(faultinject.FaultInjected):
            save_checkpoint(out, "last", model, opt, TrainMeta(epoch=2, step=4), rng)
        faultinject.install_plan(None)
        assert restored_weights(out)[0].epoch == 1
        save_checkpoint(out, "last", model, opt, TrainMeta(epoch=2, step=4), rng)
        assert restored_weights(out)[0].epoch == 2

    def test_clear_checkpoints_sweeps_staging_files(self, tmp_path):
        model, opt, rng = small_state()
        out = str(tmp_path)
        save_checkpoint(out, "best", model, opt, TrainMeta(), rng)
        (tmp_path / "checkpoint_last.pt.tmp3").write_bytes(b"partial")
        (tmp_path / "model_meta.json").write_text("{}")
        clear_checkpoints(out)
        assert sorted(os.listdir(out)) == ["model_meta.json"]

    def test_writer_start_sweeps_any_pid_staging_file(self, tmp_path):
        """A ``kill`` at ``mid_save`` leaves another pid's temp file: the
        next writer (the resumed run's) removes it and keeps the slots."""
        model, opt, rng = small_state()
        out = str(tmp_path)
        save_checkpoint(out, "last", model, opt, TrainMeta(epoch=1), rng)
        (tmp_path / "checkpoint_best.pt.tmp999999").write_bytes(b"killed mid-save")
        (tmp_path / "checkpoint_last.pt.tmp1").write_bytes(b"killed mid-save")
        CheckpointWriter(out).close()
        assert sorted(os.listdir(out)) == ["checkpoint_last.pt"]

    def test_best_save_prunes_the_last_slot_it_supersedes(self, tmp_path):
        model, opt, rng = small_state()
        out = str(tmp_path)
        save_checkpoint(out, "last", model, opt, TrainMeta(epoch=1, step=3), rng)
        save_checkpoint(out, "best", model, opt, TrainMeta(epoch=1, step=5), rng)
        assert sorted(os.listdir(out)) == ["checkpoint_best.pt"]
        save_checkpoint(out, "last", model, opt, TrainMeta(epoch=2, step=8), rng)
        save_checkpoint(out, "best", model, opt, TrainMeta(epoch=2, step=7), rng)
        assert sorted(os.listdir(out)) == ["checkpoint_best.pt", "checkpoint_last.pt"]
        assert restored_weights(out)[0].step == 8


# ---------------------------------------------------------------------------
# async checkpointing
# ---------------------------------------------------------------------------


class TestAsyncCheckpoint:
    def test_async_save_overlaps_persist(self, tmp_path):
        model, opt, rng = small_state()
        writer = CheckpointWriter(str(tmp_path), async_save=True)
        faultinject.install_plan("mid_save@1:sleep300")
        path = writer.save("last", model, opt, TrainMeta(epoch=1), rng)
        in_flight = writer._thread is not None and writer._thread.is_alive()
        assert in_flight, "save() blocked until the persist completed"
        assert not os.path.exists(path)
        writer.finish()
        assert os.path.exists(path)
        assert writer.saves[0]["async"] and writer.saves[0]["persist_s"] >= 0.3

    def test_async_persist_failure_raises_at_next_save(self, tmp_path):
        model, opt, rng = small_state()
        writer = CheckpointWriter(str(tmp_path), async_save=True)
        faultinject.install_plan("mid_save@1:raise")
        writer.save("last", model, opt, TrainMeta(epoch=1), rng)
        with pytest.raises(faultinject.FaultInjected):
            writer.save("last", model, opt, TrainMeta(epoch=1), rng)
        writer.close()

    def test_async_persist_failure_raises_at_finish(self, tmp_path):
        model, opt, rng = small_state()
        writer = CheckpointWriter(str(tmp_path), async_save=True)
        faultinject.install_plan("post_save@1:raise")
        writer.save("best", model, opt, TrainMeta(epoch=1), rng)
        with pytest.raises(faultinject.FaultInjected):
            writer.finish()
        writer.close()

    def test_async_at_most_one_in_flight(self, tmp_path):
        model, opt, rng = small_state()
        writer = CheckpointWriter(str(tmp_path), async_save=True)
        faultinject.install_plan("mid_save@1:sleep200")
        writer.save("best", model, opt, TrainMeta(epoch=1), rng)
        first = writer._thread
        second = writer.save("last", model, opt, TrainMeta(epoch=2, step=1), rng)
        # the second save waited out the first persist before it started
        assert not first.is_alive() and os.path.exists(slot_path(str(tmp_path), "best"))
        writer.finish()
        assert os.path.exists(second)

    @pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
    def test_snapshot_owns_its_memory(self, mu_dtype):
        """``state_dict()`` returns the live tensors the next optimizer step
        updates in place: the snapshot must not share them."""
        model, _, rng = small_state()
        opt = make_optimizer(model, TrainConfig(adam_mu_dtype=mu_dtype))
        step_once(model, opt)
        snap = snapshot_state(model, opt, TrainMeta(), rng)
        frozen = snapshot_state(model, opt, TrainMeta(), rng)
        step_once(model, opt, 3)
        assert_same_state(snap["model"], frozen["model"])
        for k, state in snap["optimizer"]["state"].items():
            for name, v in state.items():
                if isinstance(v, torch.Tensor):
                    assert torch.equal(v, frozen["optimizer"]["state"][k][name]), name
        assert not torch.equal(snap["model"]["input_linear.weight"],
                               model.state_dict()["input_linear.weight"])

    def test_async_train_matches_sync_bitwise(self, tiny, tmp_path):
        data = tiny["data"]
        r_sync = run(dict(TINY, checkpoint_every_steps=2), data, str(tmp_path / "sync"))
        r_async = run(dict(TINY, checkpoint_every_steps=2, async_checkpoint=True), data,
                      str(tmp_path / "async"))
        assert_bitwise_history(r_sync, r_async)
        assert_same_state(r_sync.model.state_dict(), r_async.model.state_dict())
        assert [s["slot"] for s in r_sync.checkpoint_saves] == \
            [s["slot"] for s in r_async.checkpoint_saves]
        assert all(s["async"] for s in r_async.checkpoint_saves)
        r_resumed = run(dict(TINY, resume=True), data, str(tmp_path / "async"))
        assert r_resumed.best_f1 == r_async.best_f1 and r_resumed.epochs_run == 0

    @pytest.mark.parametrize("kw", [{"adam_mu_dtype": "bfloat16"}, {"table_update": "lazy"}],
                             ids=lambda kw: next(iter(kw.values())))
    def test_async_snapshot_equals_sync_save(self, tiny, tmp_path, kw):
        """bf16 first moments and the lazy table optimizer: the async
        slot's every tensor equals the sync slot's (a mid-epoch save, the
        optimizer's moments updated in place after it)."""
        cfg = dict(TINY, max_epoch=1, checkpoint_every_steps=2, checkpoint_cycle=0, **kw)
        for name, extra in (("sync", {}), ("async", {"async_checkpoint": True})):
            faultinject.install_plan(None)
            with pytest.raises(faultinject.FaultInjected):
                run(dict(cfg, fault_plan="train_step@3:raise", **extra), tiny["data"],
                    str(tmp_path / name))
        a, b = (torch.load(slot_path(str(tmp_path / name), "last"), weights_only=False)
                for name in ("sync", "async"))
        assert a["meta"]["cursor"]["step"] == b["meta"]["cursor"]["step"] == 2
        assert a["meta"] == b["meta"]
        assert_same_state(a["model"], b["model"])
        flat = []

        def walk(x, y, where):
            if isinstance(x, torch.Tensor):
                assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()), where
                flat.append(x)
            elif isinstance(x, dict):
                assert x.keys() == y.keys(), where
                for k in x:
                    walk(x[k], y[k], f"{where}/{k}")
            elif isinstance(x, (list, tuple)):
                for i, (u, v) in enumerate(zip(x, y, strict=True)):
                    walk(u, v, f"{where}/{i}")
            else:
                assert x == y, where

        walk(a["optimizer"], b["optimizer"], "optimizer")
        if kw.get("adam_mu_dtype") == "bfloat16":
            assert any(t.dtype == torch.bfloat16 for t in flat)
        assert torch.equal(a["dropout_rng_state"], b["dropout_rng_state"])


# ---------------------------------------------------------------------------
# mid-epoch kill -> resume -> bitwise history
# ---------------------------------------------------------------------------


class TestMidEpochResume:
    def test_kill_mid_epoch_resume_bitwise(self, tiny, full, tmp_path):
        out = str(tmp_path / "killed")
        r = kill_and_resume(tiny["data"], out,
                            dict(TINY, checkpoint_every_steps=3, fault_plan="train_step@9:raise"),
                            dict(TINY, resume=True))
        assert_bitwise_history(full, r)
        assert r.history[1]["replayed_batches"] == 3 and r.history[1]["replay_seconds"] >= 0
        assert_same_state(full.model.state_dict(), r.model.state_dict())

    def test_kill_mid_epoch_resume_bitwise_prefetch(self, tiny, full, tmp_path):
        r = kill_and_resume(tiny["data"], str(tmp_path / "killed"),
                            dict(TINY, prefetch_batches=3, checkpoint_every_steps=2,
                                 fault_plan="train_step@8:raise"),
                            dict(TINY, prefetch_batches=3, resume=True))
        assert_bitwise_history(full, r)

    def test_kill_mid_epoch_resume_bitwise_bucketed(self, tiny, tmp_path):
        cfg = dict(TINY, bucketed=True, bucket_ladder="8,16,32")
        r_full = run(cfg, tiny["data"], str(tmp_path / "full"))
        r = kill_and_resume(tiny["data"], str(tmp_path / "killed"),
                            dict(cfg, checkpoint_every_steps=2, fault_plan="train_step@9:raise"),
                            dict(cfg, resume=True))
        assert_bitwise_history(r_full, r)

    def test_kill_with_feed_workers_resumes_bitwise(self, tiny, full, tmp_path):
        """The feed workers' stream replays too (its skipped slots go back
        to the arena); the same batches as the synchronous feed."""
        r = kill_and_resume(tiny["data"], str(tmp_path / "killed"),
                            dict(TINY, feed_workers=2, checkpoint_every_steps=3,
                                 fault_plan="train_step@9:raise"),
                            dict(TINY, feed_workers=2, resume=True))
        assert_bitwise_history(full, r)

    @pytest.mark.parametrize("source", ["mmap", "streamed"])
    def test_kill_over_out_of_core_sources_resumes_bitwise(self, tiny, tmp_path, source):
        data = tiny["mmap"] if source == "mmap" else tiny["data"]
        cfg = dict(TINY, max_epoch=2, **({"stream_chunk_items": 48} if source == "streamed"
                                         else {}))
        r_full = run(cfg, data, str(tmp_path / "full"))
        r = kill_and_resume(data, str(tmp_path / "killed"),
                            dict(cfg, checkpoint_every_steps=2, fault_plan="train_step@9:raise"),
                            dict(cfg, resume=True))
        assert_bitwise_history(r_full, r)

    def test_kill_in_prefetch_producer_resumes(self, tiny, full, tmp_path):
        r = kill_and_resume(tiny["data"], str(tmp_path / "killed"),
                            dict(TINY, prefetch_batches=2, checkpoint_every_steps=2,
                                 fault_plan="prefetch_produce@9:raise"),
                            dict(TINY, resume=True))
        assert_bitwise_history(full, r)

    def test_boundary_resume_is_also_bitwise(self, tiny, full, tmp_path):
        out = str(tmp_path / "killed")
        with pytest.raises(faultinject.FaultInjected):
            # epoch_start@3 fires entering epoch 2, after epoch 1's save
            run(dict(TINY, fault_plan="epoch_start@3:raise"), tiny["data"], out)
        r = run(dict(TINY, resume=True), tiny["data"], out)
        assert r.epochs_run == 1
        assert_bitwise_history(full, r)

    def test_cursor_config_change_fails_with_guidance(self, tiny, tmp_path):
        out = str(tmp_path / "killed")
        with pytest.raises(faultinject.FaultInjected):
            run(dict(TINY, checkpoint_every_steps=2, fault_plan="train_step@8:raise"),
                tiny["data"], out)
        with pytest.raises(ValueError, match="cursor|changed since"):
            run(dict(TINY, batch_size=16, resume=True), tiny["data"], out)
        with pytest.raises(ValueError, match="--device_epoch cannot replay"):
            run(dict(TINY, device_epoch=True, resume=True), tiny["data"], out)
        with pytest.raises(ValueError, match="bucket positions"):
            run(dict(TINY, bucketed=True, bucket_ladder="8,16,32", resume=True),
                tiny["data"], out)

    def test_device_epoch_saves_at_boundaries_and_resumes_bitwise(self, tiny, tmp_path,
                                                                   caplog):
        """``--checkpoint_every_steps`` under ``--device_epoch`` warns and
        saves at epoch ends; SIGTERM is honoured at ``epoch_start`` with a
        boundary save holding the sampler's state, and its resume is the
        uninterrupted device-epoch run bit for bit."""
        cfg = dict(TINY, device_epoch=True, device_chunk_batches=2)
        r_full = run(cfg, tiny["data"], str(tmp_path / "full"))
        out = str(tmp_path / "pre")
        with caplog.at_level("WARNING", logger="code2vec_tpu_torch.train.loop"):
            r_pre = run(dict(cfg, checkpoint_every_steps=2, fault_plan="epoch_start@2:sigterm"),
                        tiny["data"], out)
        assert "save at epoch boundaries only" in caplog.text
        assert r_pre.epochs_run == 1
        assert [s["slot"] for s in r_pre.checkpoint_saves] == ["best", "last"]
        saved = torch.load(slot_path(out, "last"), weights_only=False)
        assert saved["meta"]["cursor"]["step"] == 0 and saved["sampler_rng_state"] is not None
        r = run(dict(cfg, resume=True), tiny["data"], out)
        assert_bitwise_history(r_full, r)


# ---------------------------------------------------------------------------
# graceful preemption (the SIGTERM contract)
# ---------------------------------------------------------------------------


class TestGracefulPreemption:
    def test_sigterm_saves_and_exits_cleanly_then_resumes_bitwise(self, tiny, full, tmp_path):
        out = str(tmp_path / "preempted")
        before = signal.getsignal(signal.SIGTERM)
        r_pre = run(dict(TINY, fault_plan="train_step@8:sigterm"), tiny["data"], out)
        assert signal.getsignal(signal.SIGTERM) is before  # the handler restored
        assert r_pre.epochs_run == 1
        cursor = torch.load(slot_path(out, "last"), weights_only=False)["meta"]["cursor"]
        assert (cursor["epoch"], cursor["step"], cursor["feed_batch"]) == (1, 3, 32)
        r = run(dict(TINY, resume=True), tiny["data"], out)
        assert_bitwise_history(full, r)

    def test_sigterm_during_resume_setup_preserves_pending_cursor(self, tiny, full, tmp_path):
        out = str(tmp_path / "killed")
        with pytest.raises(faultinject.FaultInjected):
            run(dict(TINY, checkpoint_every_steps=3, fault_plan="train_step@9:raise"),
                tiny["data"], out)
        # preempted at the first epoch_start, before the cursor was consumed
        r_pre = run(dict(TINY, resume=True, fault_plan="epoch_start@1:sigterm"), tiny["data"],
                    out)
        assert r_pre.epochs_run == 0
        assert torch.load(slot_path(out, "last"), weights_only=False)["meta"]["cursor"][
            "step"] == 3
        r = run(dict(TINY, resume=True), tiny["data"], out)
        assert_bitwise_history(full, r)

    def test_drain_is_train_stream_only(self):
        def batches(n=6):
            for i in range(n):
                yield {"paths": np.full((2, 4), i, np.int32)}

        guard = preemption_guard()
        guard.request("SIGTERM")
        try:
            with device_batches(batches(), lambda b: b, prefetch=2) as stream:
                assert len(list(stream)) == 6  # eval: runs to its end
            with device_batches(batches(), lambda b: b, prefetch=2,
                                drain_on_preemption=True) as stream:
                assert len(list(stream)) < 6  # train: drains early
        finally:
            guard.clear()

    def test_sigterm_with_prefetch_producer_drains(self, tiny, full, tmp_path):
        out = str(tmp_path / "preempted")
        r_pre = run(dict(TINY, prefetch_batches=3, fault_plan="train_step@8:sigterm"),
                    tiny["data"], out)
        assert r_pre.epochs_run == 1
        r = run(dict(TINY, prefetch_batches=3, resume=True), tiny["data"], out)
        assert_bitwise_history(full, r)

    def test_sigterm_without_a_model_dir_returns(self, tiny):
        r = run(dict(TINY, max_epoch=2, fault_plan="train_step@2:sigterm"), tiny["data"])
        assert r.epochs_run == 0 and r.checkpoint_saves == []


# ---------------------------------------------------------------------------
# skip_batches (the replay)
# ---------------------------------------------------------------------------


class TestSkipBatches:
    def _stream(self, n=5, width=8):
        for i in range(n):
            yield {"paths": np.full((2, width), i, np.int32)}

    def test_skips_exactly_n(self):
        rest = list(pipeline.skip_batches(self._stream(), 2))
        assert [int(b["paths"][0, 0]) for b in rest] == [2, 3, 4]

    def test_past_end_raises_with_guidance(self):
        with pytest.raises(ValueError, match="changed since"):
            pipeline.skip_batches(self._stream(n=3), 5)

    def test_width_mismatch_raises(self):
        with pytest.raises(ValueError, match="bucket"):
            pipeline.skip_batches(self._stream(width=8), 2, expect_widths={"16": 2})

    def test_width_match_accepted(self):
        rest = list(pipeline.skip_batches(self._stream(), 3, expect_widths={8: 3}))
        assert len(rest) == 2

    @pytest.mark.parametrize("source", ["in_ram", "bucketed", "streamed", "mmap", "workers"])
    def test_rest_of_every_source_is_the_stream_tail(self, tiny, source):
        """Over every source (and the feed workers, whose skipped slots go
        back to the arena) the replayed stream's tail is the stream's."""
        data = tiny["mmap"] if source == "mmap" else tiny["data"]
        idx = np.arange(data.n_items)
        kw = {"bucketed": dict(ladder=(8, 16, 32)),
              "streamed": dict(stream_chunk_items=48)}.get(source, {})
        src = pipeline.make_batch_source(data, idx, 16, 32, **kw)
        pool = None
        if source == "workers":
            pool = FeedPool(data, 2, 16, 32, slots=4)
            src = ParallelFeed(src, pool)
        try:
            want = [{k: np.array(v) for k, v in b.items()}
                    for b in src.batches(np.random.default_rng(3))]
            rest = pipeline.skip_batches(src.batches(np.random.default_rng(3)), 4)
            got = [{k: np.array(v) for k, v in b.items()} for b in rest]
            if pool is not None:
                assert len(pool._free) == pool.slots  # every slot back in the arena
        finally:
            if pool is not None:
                pool.close()
        assert len(got) == len(want) - 4
        for g, w in zip(got, want[4:]):
            for k in pipeline_keys(w):
                assert np.array_equal(g[k], w[k]), k


def pipeline_keys(batch):
    return [k for k in ("starts", "paths", "ends", "labels", "example_mask") if k in batch]


# ---------------------------------------------------------------------------
# the epoch loss: JAX's left fold
# ---------------------------------------------------------------------------


class TestLossFold:
    def test_tally_folds_left_as_jax_does(self):
        """Losses where torch's pairwise float64 sum and JAX's fold
        (``loop.py:512-515``: ``sum(map(float, losses), loss_offset)``)
        differ: the tally gives JAX's fold bitwise, read whole, in pieces
        (mid-epoch saves) and resumed from a saved fold state."""
        g = np.random.default_rng(0)
        losses = (g.standard_normal(257) * 10.0 ** g.integers(-6, 7, 257)).astype(np.float32)
        offset = 0.1
        jax_fold = float(sum(map(float, jax.device_get(jax.numpy.asarray(losses))), offset))
        pairwise = float(torch.from_numpy(losses).double().sum()) + offset
        assert pairwise != jax_fold  # the old sum is not the fold

        def tally(values, start, reads=()):
            t = StepTally(torch.device("cpu"), start)
            for i, x in enumerate(values):
                t.add(torch.tensor(x), 1)
                if i in reads:
                    t.partial()
            return t

        assert tally(losses, offset).result()[0] == jax_fold
        assert tally(losses, offset, reads=(3, 100)).result()[0] == jax_fold
        head = tally(losses[:100], offset, reads=(50,))
        assert tally(losses[100:], head.partial()).result()[0] == jax_fold

    def test_train_loss_is_the_fold_of_the_step_losses(self, tiny, monkeypatch):
        seen = []
        original = loop.train_step

        def recording(*a, **kw):
            loss = original(*a, **kw)
            seen.append(float(loss))
            return loss

        monkeypatch.setattr(loop, "train_step", recording)
        r = run(dict(TINY, max_epoch=1), tiny["data"])
        assert r.history[0]["train_loss"] == float(sum(seen, 0.0))


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

DIFF_KW = dict(TINY, dropout_prob=0.0, random_seed=11, checkpoint_every_steps=3)
# a clause that never fires: the points are counted on the resume run too
NEVER = "train_step@100000:raise"


def _jax_runs(tiny, route, out):
    kernel = dict(use_pallas=True, pallas_impl=route) if route != "plain" else {}
    jcfg = JaxTrainConfig(**DIFF_KW, **kernel)
    jdata = tiny["jax"]
    model_cfg = jax_loop.model_config_from(jcfg, jdata)
    if route != "plain":
        model_cfg = model_cfg.__class__(**{**vars(model_cfg), "pallas_backend": "cpu"})
    state = create_train_state(jcfg, model_cfg, jax.random.PRNGKey(11), jax_loop.dummy_batch(jcfg))
    params0 = jax.tree.map(np.asarray, state.params)
    step = jax.jit(build_train_step_fn(model_cfg, jax_loop.class_weights_from(jcfg, jdata)))
    hits = []
    with pytest.raises(jax_faultinject.FaultInjected):
        jax_loop.train(jcfg.__class__(**{**vars(jcfg), "fault_plan": "train_step@9:raise"}),
                       jdata, out_dir=out, sinks=(), initial_state=state, train_step=step)
    hits.append({p: jax_faultinject.active_plan().hits(p) for p in POINTS})
    resumed = jax_loop.train(
        jcfg.__class__(**{**vars(jcfg), "resume": True, "fault_plan": NEVER}), jdata,
        out_dir=out, sinks=(), initial_state=state, train_step=step)
    hits.append({p: jax_faultinject.active_plan().hits(p) for p in POINTS})
    return params0, resumed.history, hits


def _port_runs(tiny, route, out, params0):
    kernel = dict(use_pallas=True, pallas_impl=route) if route != "plain" else {}
    cfg = TrainConfig(**DIFF_KW, **kernel)
    sd = interop.state_dict_from_jax_params(params0, loop.model_config_from(cfg, tiny["data"]))
    hits = []
    with pytest.raises(faultinject.FaultInjected):
        loop.train(cfg.with_updates(fault_plan="train_step@9:raise"), tiny["data"], out,
                   device="cpu", initial_state_dict=sd)
    hits.append({p: faultinject.active_plan().hits(p) for p in POINTS})
    resumed = loop.train(cfg.with_updates(resume=True, fault_plan=NEVER), tiny["data"], out,
                         device="cpu", initial_state_dict=sd)
    hits.append({p: faultinject.active_plan().hits(p) for p in POINTS})
    return resumed.history, hits


@pytest.fixture(scope="module", params=["plain", "pool_only"])
def resumed_pair(request, tiny, tmp_path_factory):
    """The same plan (saves every 3 steps, a raise at step 9, then
    ``--resume``) through the JAX package and the port, from one set of
    weights, dropout 0."""
    route = request.param
    jax_faultinject.install_plan(None)
    params0, jax_history, jax_hits = _jax_runs(
        tiny, route, str(tmp_path_factory.mktemp(f"jax_{route}")))
    port_history, port_hits = _port_runs(
        tiny, route, str(tmp_path_factory.mktemp(f"port_{route}")), params0)
    jax_faultinject.install_plan(None)
    faultinject.install_plan(None)
    return {"jax": (jax_history, jax_hits), "port": (port_history, port_hits)}


def test_resumed_run_tracks_jax_resumed_run(resumed_pair):
    want, got = resumed_pair["jax"][0], resumed_pair["port"][0]
    assert len(got) == len(want) == TINY["max_epoch"]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["train_loss"], w["train_loss"], rtol=1e-4)
        np.testing.assert_allclose(g["test_loss"], w["test_loss"], rtol=1e-4)
        assert g["accuracy"] == w["accuracy"] and g["f1"] == w["f1"]


def test_fault_point_hits_equal_jax(resumed_pair):
    """The saves land at the same steps: each point's hits on the killed
    run and on its resume equal JAX's."""
    want, got = resumed_pair["jax"][1], resumed_pair["port"][1]
    assert got == want
    assert got[0]["train_step"] == 9 and got[0]["mid_save"] >= 3


# ---------------------------------------------------------------------------
# SIGKILL through the CLI, in a subprocess
# ---------------------------------------------------------------------------

_CLI = "import sys\nfrom code2vec_tpu_torch.cli import main\nsys.exit(main(sys.argv[1:]))\n"


def test_sigkill_mid_epoch_then_cli_resume(tiny, tmp_path):
    """``kill`` at the 9th step (epoch 1's 4th, after its step-3 save)
    through the real CLI: nothing runs after SIGKILL; ``--resume`` exits 0
    and the history equals an uninterrupted run of the same flags."""
    from code2vec_tpu_torch import cli

    paths = tiny["paths"]
    out = tmp_path / "model"
    argv = ["--corpus_path", paths["corpus"], "--path_idx_path", paths["path_idx"],
            "--terminal_idx_path", paths["terminal_idx"], "--model_path", str(out),
            "--max_epoch", "2", "--batch_size", "32", "--encode_size", "64",
            "--terminal_embed_size", "32", "--path_embed_size", "32",
            "--max_path_length", "32", "--print_sample_cycle", "0",
            "--checkpoint_every_steps", "3", "--no_cuda"]
    env = {k: v for k, v in os.environ.items() if k != "C2V_FAULT_PLAN"}
    proc = subprocess.run([sys.executable, "-c", _CLI] + argv
                          + ["--fault_plan", "train_step@9:kill"],
                          env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == -signal.SIGKILL, proc.stdout + proc.stderr
    killed = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    cursor = torch.load(slot_path(str(out), "last"), weights_only=False)["meta"]["cursor"]
    assert (cursor["epoch"], cursor["step"]) == (1, 3)
    proc = subprocess.run([sys.executable, "-c", _CLI] + argv + ["--resume"],
                          env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "done: best_f1=" in proc.stderr + proc.stdout
    resumed = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    assert [x["epoch"] for x in killed + resumed] == [0, 1]
    assert resumed[0]["replayed_batches"] == 3
    config = cli.config_from_args(cli.build_parser().parse_args(argv))
    whole = loop.train(config, tiny["data"], device="cpu")
    for got, want in zip(killed + resumed, whole.history):
        for key in METRIC_KEYS:
            assert got[key] == want[key], (got["epoch"], key)
