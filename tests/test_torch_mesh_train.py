"""``train()`` and the CLI on gloo meshes of the CPU.

Each rank is a subprocess of ``tests/test_torch_mesh.py``'s harness
(``spawn``: ``file://`` rendezvous, 60 s group timeout, 120 s a spawn).

- two epochs at ``data=2`` on ``fused`` (its plain version here), dropout
  0.25, within rtol 2e-5 a step of the one-device run (every rank draws
  the global batch's keep mask), the ranks bitwise equal;
- ``--host_shard_corpus`` at ``data=2`` (each feed group its round-robin
  share, lockstep padded) and ``--device_epoch --shard_staged_corpus`` at
  ``data=2`` (each rank stages about half; JAX
  ``tests/test_multiprocess.py:107``): ranks in lockstep, the same metrics;
- the mesh-reshape restore (JAX ``tests/test_elastic.py:625``): a mid-epoch
  save at ``data=2`` (SIGTERM to rank 0), restored onto ``model=2``
  bitwise, the resumed epoch within rtol 2e-5 of the uninterrupted run;
- ``coordinated_stop``: SIGTERM to rank 0 stops every rank at one
  periodic-save step (or, without them, at the stream's end), to rank 1
  only stops none (rank 0's flag is the group's);
- the CLI at ``--data_axis 2`` through a 2-rank launch, and rejected
  without a group.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_torch_mesh as harness
from code2vec_tpu_torch.data import reader, synth

RECIPE = dict(terminal_embed_size=8, path_embed_size=8, encode_size=16, batch_size=32,
              max_path_length=20, max_epoch=2, dropout_prob=0.25, random_seed=11,
              print_sample_cycle=0, vocab_pad_multiple=2)
# what an epoch line carries that is a rank's own: clocks, speeds, its
# staging, its shard's pad and truncation accounting
PER_RANK = ("epoch_seconds", "steps_per_s", "contexts_per_s", "stage_seconds", "staged_bytes",
            "pad_efficiency", "truncated_context_fraction", "replayed_batches",
            "replay_seconds")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    paths = synth.generate_corpus_files(tmp_path_factory.mktemp("mesh"), synth.SPECS["tiny"])
    return {k: str(v) for k, v in paths.items()}


def one_device(corpus, **updates):
    """The world-1 run and its per-step losses."""
    from code2vec_tpu_torch.train import loop
    from code2vec_tpu_torch.train.config import TrainConfig

    data = reader.load_corpus(corpus["corpus"], corpus["path_idx"], corpus["terminal_idx"],
                              cache=False)
    losses, real = [], loop.train_step

    def recording(*a):
        loss = real(*a)
        losses.append(float(loss))
        return loss

    loop.train_step = recording
    try:
        result = loop.train(TrainConfig(**{**RECIPE, **updates}), data, device="cpu", sinks=())
    finally:
        loop.train_step = real
    return result.history, losses


def metrics(history):
    return [{k: v for k, v in h.items() if k not in PER_RANK} for h in history]


def assert_lockstep(results):
    for r in results[1:]:
        assert r["losses"] == results[0]["losses"]
        assert metrics(r["history"]) == metrics(results[0]["history"])


def test_data2_fused_tracks_one_device(tmp_path, corpus):
    want_history, want_losses = one_device(corpus, use_pallas=True, pallas_impl="fused")
    results = harness.spawn(tmp_path, "train", 2, corpus=corpus,
                            config=dict(RECIPE, data_axis=2, use_pallas=True,
                                        pallas_impl="fused"))
    assert_lockstep(results)
    np.testing.assert_allclose(results[0]["losses"], want_losses, rtol=2e-5)
    for got, want in zip(results[0]["history"], want_history):
        np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=2e-5)
        np.testing.assert_allclose(got["test_loss"], want["test_loss"], rtol=2e-5)
    assert results[0]["manifest_mesh"] == {"data": 2, "model": 1, "ctx": 1}


def test_host_sharded_feed_in_lockstep(tmp_path, corpus):
    """Each rank loads its round-robin share (``load_corpus(shard=...)``),
    feeds B/2 rows a step padded to the longest share's steps, and the
    eval's predictions are gathered: every rank reports the same epoch."""
    results = harness.spawn(tmp_path, "train", 2, corpus=corpus, host_shard=True,
                            config=dict(RECIPE, data_axis=2, bucketed=True))
    assert_lockstep(results)
    for rank, r in enumerate(results):
        assert r["shard"] == [rank, 2] and r["n_items"] < r["global_n_items"]
    assert results[0]["n_items"] + results[1]["n_items"] == results[0]["global_n_items"]
    assert all(np.isfinite(results[0]["losses"]))


def test_sharded_device_epochs_in_lockstep(tmp_path, corpus):
    """Each rank stages its data coordinate's share (about half the
    replicated staging) and samples B/2 rows a step from it."""
    results = harness.spawn(tmp_path, "train", 2, corpus=corpus,
                            config=dict(RECIPE, data_axis=2, device_epoch=True,
                                        shard_staged_corpus=True, use_pallas=True,
                                        pallas_impl="pool_only"))
    assert_lockstep(results)
    staged = [r["history"][0]["staged_bytes"] for r in results]
    replicated = one_device(corpus, device_epoch=True, max_epoch=1)[0][0]["staged_bytes"]
    for b in staged:
        assert 0.4 * replicated < b < 0.6 * replicated
    assert all(np.isfinite(results[0]["losses"]))


def test_mesh_reshape_restore(tmp_path, corpus):
    """A mid-epoch save at data=2 (SIGTERM to rank 0 after step 3), restored
    onto model=2: every tensor bitwise the saved one; the resumed epoch's
    losses within rtol 2e-5 of the uninterrupted one-device run."""
    want_history, want_losses = one_device(corpus, use_pallas=True, pallas_impl="fused",
                                           max_epoch=1)
    ckpt = str(tmp_path / "ckpt")
    fused = dict(RECIPE, use_pallas=True, pallas_impl="fused", max_epoch=1)
    saved = harness.spawn(tmp_path, "train", 2, corpus=corpus, out_dir=ckpt,
                          config=dict(fused, data_axis=2, checkpoint_every_steps=3),
                          rank_config={"0": {"fault_plan": "train_step@3:sigterm"}})
    assert [len(r["losses"]) for r in saved] == [3, 3] and saved[0]["history"] == []
    with open(os.path.join(ckpt, "checkpoint_last.shardings.json")) as f:
        import json

        assert json.load(f)["mesh_shape"] == {"data": 2, "model": 1, "ctx": 1}
    resumed = harness.spawn(tmp_path, "train", 2, corpus=corpus, out_dir=ckpt,
                            check_restore=True, config=dict(fused, model_axis=2, resume=True))
    assert_lockstep(resumed)
    for r in resumed:
        assert r["restore"]["bitwise"] and r["restore"]["resharded"]
        assert r["restore"]["saved_mesh_shape"] == {"data": 2, "model": 1, "ctx": 1}
    np.testing.assert_allclose(saved[0]["losses"], want_losses[:3], rtol=2e-5)
    np.testing.assert_allclose(resumed[0]["losses"], want_losses[3:], rtol=2e-5)
    np.testing.assert_allclose(resumed[0]["history"][0]["train_loss"],
                               want_history[0]["train_loss"], rtol=2e-5)


@pytest.mark.parametrize("target,every", [(0, 2), (1, 2), (0, 0)])
def test_coordinated_stop(tmp_path, corpus, target, every):
    """SIGTERM after step 2 to one rank: rank 0's flag, broadcast at the
    periodic-save steps and at the stream's end, is the group's (JAX
    ``_should_stop``). To rank 0 with saves every 2 steps: both ranks save
    at step 2 and return; to rank 1 only: both train on to the end, in
    lockstep; to rank 0 with no periodic saves: both finish the pass, then
    save and return without recording the epoch."""
    ckpt = str(tmp_path / "ckpt")
    results = harness.spawn(tmp_path, "train", 2, corpus=corpus, out_dir=ckpt,
                            config=dict(RECIPE, data_axis=2, max_epoch=1,
                                        checkpoint_every_steps=every),
                            rank_config={str(target): {"fault_plan": "train_step@2:sigterm"}})
    assert_lockstep(results)
    steps = [len(r["losses"]) for r in results]
    if target == 0:
        cursor = torch.load(os.path.join(ckpt, "checkpoint_last.pt"),
                            weights_only=False)["meta"]["cursor"]
        assert steps[0] == steps[1] == cursor["step"] and results[0]["history"] == []
        assert steps[0] == 2 if every else steps[0] > 2
    else:
        assert steps[0] == steps[1] > 2 and len(results[0]["history"]) == 1


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_cli_on_two_ranks(tmp_path, corpus):
    """``--data_axis 2`` through a torchrun-style launch (``RANK`` /
    ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT`` / ``LOCAL_RANK``):
    both ranks print the same epochs; rank 0 writes the model dir and
    ``code.vec``."""
    out = tmp_path / "model"
    common = ["--device", "cpu", "--corpus_path", corpus["corpus"], "--path_idx_path",
              corpus["path_idx"], "--terminal_idx_path", corpus["terminal_idx"],
              "--batch_size", "32", "--terminal_embed_size", "8", "--path_embed_size", "8",
              "--encode_size", "16", "--data_axis", "2", "--model_path", str(out),
              "--no_corpus_cache"]
    logs = launch_cli(common + ["--max_epoch", "2", "--vectors_path", str(out / "code.vec")])
    lines = [[ln for ln in log.splitlines() if ln.startswith('{"epoch"')] for log in logs]
    assert len(lines[0]) == 2
    import json

    assert [metrics([json.loads(x)]) for x in lines[0]] == \
        [metrics([json.loads(x)]) for x in lines[1]]
    assert (out / "code.vec").exists() and (out / "code2vec.model").exists()
    assert (out / "checkpoint_best.shardings.json").exists()
    # --export_only on the mesh: rank 0 writes what one device exports
    launch_cli(common + ["--export_only", "--vectors_path", str(out / "mesh.vec")])
    from code2vec_tpu_torch.export import export_from_checkpoint
    from code2vec_tpu_torch.formats.vectors_io import read_code_vectors
    from code2vec_tpu_torch.train.config import TrainConfig

    data = reader.load_corpus(corpus["corpus"], corpus["path_idx"], corpus["terminal_idx"],
                              cache=False)
    export_from_checkpoint(TrainConfig(batch_size=32, terminal_embed_size=8, path_embed_size=8,
                                       encode_size=16), data, str(out), str(out / "one.vec"),
                           device="cpu")
    got, want = read_code_vectors(out / "mesh.vec"), read_code_vectors(out / "one.vec")
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)


def launch_cli(args: list[str]) -> list[str]:
    """The CLI on two ranks, torchrun's environment by hand; each rank's log."""
    base = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=harness.REPO, WORLD_SIZE="2",
                MASTER_ADDR="localhost", MASTER_PORT=str(free_port()))
    procs = [subprocess.Popen([sys.executable, "-m", "code2vec_tpu_torch", *args],
                              cwd=harness.REPO, env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=harness.SPAWN_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError("the 2-rank CLI did not finish") from None
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return logs


def test_cli_mesh_without_a_group_is_rejected(corpus, tmp_path):
    from code2vec_tpu_torch import cli

    with pytest.raises(ValueError, match="torchrun"):
        cli.main(["--device", "cpu", "--corpus_path", corpus["corpus"], "--path_idx_path",
                  corpus["path_idx"], "--terminal_idx_path", corpus["terminal_idx"],
                  "--data_axis", "2", "--model_path", str(tmp_path / "m"),
                  "--no_corpus_cache"])
