"""Sharded staging where each feed group stages only its own corpus shard
(``shard_staged_multiprocess``, JAX ``train/device_epoch.py:448``), on
gloo ranks of the CPU, against the JAX package in this process.

The ranks are subprocesses of ``tests/test_torch_mesh.py``'s harness
(``scenario_group_staging``). JAX's own function needs a multi-process JAX
runtime, so JAX runs here in one process: each group's shard through JAX
``load_corpus(shard=(g, 2))`` and ``stage_method_corpus`` with the group's
seed, the blocks laid out as JAX's function lays them.

- (a) each rank's placed share is bitwise JAX's host staging of its
  group's shard (contexts, row splits, labels);
- (b) ``shard_counts``, ``n_items`` and ``total_contexts`` are JAX's sums;
  each rank staged fewer items than the corpus holds, the shares sum to it;
- (c) ``ShardedEpochRunner`` chunks on ``pool_only`` (its plain versions
  here) over the same given rows of each share: the two ranks' per-step
  losses bitwise equal, each chunk's sum within rtol 2e-5 of JAX's
  ``ShardedEpochRunner`` chunk over the same blocks, on JAX's plain pool
  (``docs/PARITY.md:16``);
  the corpus's longest row fits the bag, so every row is taken whole and
  the two samplers' different shifts reorder only the pool's sum;
- (d) the replica check on a gathered matrix, agreeing and not, the
  refusal JAX's message;
- (e) on four ranks (``data=2 x model=2``), the variable task, a share past
  int32 on one rank only and one replica staging an item fewer each raise
  on every rank with JAX's message, before any share is placed;
- (f) a world of one rank is ``shard_staged``; so is a feed group of two
  data coordinates (the general ``local_d``, which the port's mesh of one
  rank a coordinate does not lay out: the group and the gather faked).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_mesh as harness
from code2vec_tpu.data import reader as jax_reader
from code2vec_tpu.train import device_epoch as jax_de
from code2vec_tpu_torch import interop
from code2vec_tpu_torch.data import reader, synth
from code2vec_tpu_torch.models.code2vec import Code2VecConfig
from code2vec_tpu_torch.parallel.mesh import Mesh, mesh_grid, single_device_mesh
from code2vec_tpu_torch.train import device_epoch as de

# JAX tests/mp_worker.py's corpus and run (96 methods, bag 16 >= the longest row)
SPEC = synth.SynthSpec(n_methods=96, n_terminals=120, n_paths=100, n_labels=6,
                       mean_contexts=10.0, max_contexts=16, seed=11)
BATCH, BAG, CHUNK, LR = 16, 16, 2, 0.01


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    paths = synth.generate_corpus_files(tmp_path_factory.mktemp("group"), SPEC)
    return {k: str(v) for k, v in paths.items()}


def args_of(corpus):
    return corpus["corpus"], corpus["path_idx"], corpus["terminal_idx"]


def jax_group_stagings(corpus, n_groups=2):
    """JAX's host staging of each group's shard, seeded by group."""
    out = []
    for g in range(n_groups):
        data = jax_reader.load_corpus(*args_of(corpus), cache=False, native=False,
                                      shard=(g, n_groups))
        out.append((data, jax_de.stage_method_corpus(
            data, np.arange(data.n_items), np.random.default_rng(1000 + g), device="host")))
    return out


@pytest.fixture(scope="module")
def two_ranks(corpus, tmp_path_factory):
    """The data=2 run of JAX's worker: the shares, and the chunks over rows
    drawn as JAX ``tests/mp_worker.py:120-131`` draws them; and JAX's
    ``ShardedEpochRunner`` over the same blocks."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from code2vec_tpu.models.code2vec import Code2VecConfig as JaxConfig
    from code2vec_tpu.parallel.mesh import make_mesh
    from code2vec_tpu.parallel.shardings import shard_state
    from code2vec_tpu.train.config import TrainConfig as JaxTrainConfig
    from code2vec_tpu.train.step import create_train_state

    groups = jax_group_stagings(corpus)
    data0 = groups[0][0]
    dims = dict(terminal_count=len(data0.terminal_vocab), path_count=len(data0.path_vocab),
                label_count=len(data0.label_vocab), terminal_embed_size=16,
                path_embed_size=16, encode_size=32)
    # JAX's blocks: each group's shard over its one data coordinate, padded
    # to the global caps (JAX :486-550)
    counts = [np.diff(np.asarray(s.row_splits).astype(np.int64)) for _, s in groups]
    items_cap = max(len(c) for c in counts)
    ctx_cap = max(int(c.sum()) for c in counts)
    blocks = [jax_de._csr_blocks([np.arange(len(c))], c, np.asarray(s.row_splits, np.int64),
                                 np.asarray(s.contexts), np.asarray(s.labels), None,
                                 items_cap, ctx_cap)
              for c, (_, s) in zip(counts, groups)]
    mesh = make_mesh(data=2, model=1, ctx=1)

    def put(i, spec):
        return jax.device_put(np.concatenate([b[i] for b in blocks]), NamedSharding(mesh, spec))

    contexts, row_splits, labels = (put(0, P("data", None, None)), put(1, P("data", None)),
                                    put(2, P("data", None)))
    mc = JaxConfig(**dims, dropout_prob=0.0)
    example = {k: np.zeros((BATCH, BAG), np.int32) for k in ("starts", "paths", "ends")}
    example.update(labels=np.zeros(BATCH, np.int32), example_mask=np.ones(BATCH, np.float32))
    state = create_train_state(JaxTrainConfig(batch_size=BATCH, max_path_length=BAG, lr=LR,
                                              dropout_prob=0.0),
                               mc, jax.random.PRNGKey(0), example)
    params0 = jax.tree.map(np.asarray, state.params)
    state = shard_state(mesh, state)
    runner = jax_de.ShardedEpochRunner(mc, jnp.ones(dims["label_count"], jnp.float32), BATCH,
                                       BAG, CHUNK, mesh=mesh)
    run_chunk = runner._train_chunk(CHUNK)
    span = CHUNK * runner.per_shard
    shard_counts = np.asarray([len(c) for c in counts], np.int64)
    rng, key = np.random.default_rng(7), jax.random.PRNGKey(2)
    all_rows, want = [], []
    for _ in range(3):
        rows = rng.integers(0, np.maximum(shard_counts[:, None], 1),
                            (runner.n_shards, span)).astype(np.int32)
        key, sub = jax.random.split(key)
        state, loss = run_chunk(state, contexts, row_splits, labels, rows,
                                np.ones((runner.n_shards, span), np.float32), sub)
        all_rows.append(rows.tolist())
        want.append(float(loss))
    tmp = tmp_path_factory.mktemp("group_ranks")
    inputs = tmp / "inputs.pt"
    torch.save({"state_dict": interop.state_dict_from_jax_params(params0,
                                                                 Code2VecConfig(**dims))},
               inputs)
    results = harness.spawn(tmp, "group_staging", 2, axes=[2, 1, 1], corpus=corpus,
                            rows=all_rows, inputs=str(inputs), model=dims, lr=LR,
                            batch=BATCH, bag=BAG, chunk=CHUNK)
    return groups, results, want


def test_each_rank_places_jaxs_staging_of_its_groups_shard(two_ranks):
    groups, results, _ = two_ranks
    for rank, r in enumerate(results):
        assert r["group"] == rank
        want = groups[rank][1]
        for key in ("contexts", "row_splits", "labels"):
            np.testing.assert_array_equal(r["local"][key], np.asarray(getattr(want, key)),
                                          err_msg=key)


def test_counts_are_jaxs_sums_and_each_rank_staged_only_its_shard(two_ranks):
    groups, results, _ = two_ranks
    want_counts = np.asarray([s.n_items for _, s in groups], np.int64)
    for r in results:
        np.testing.assert_array_equal(r["shard_counts"], want_counts)
        assert r["n_items"] == SPEC.n_methods == int(want_counts.sum())
        assert r["total_contexts"] == sum(int(s.n_contexts) for _, s in groups)
        assert r["staged_items"] == r["local_items"] < SPEC.n_methods
    assert sum(r["local_items"] for r in results) == SPEC.n_methods


def test_chunk_losses_in_lockstep_and_jaxs(two_ranks):
    _, results, want = two_ranks
    assert results[0]["losses"] == results[1]["losses"]
    got = [float(np.sum(np.asarray(c, np.float32))) for c in results[0]["losses"]]
    assert len(got) == 3 and all(len(c) == CHUNK for c in results[0]["losses"])
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=0)


# ---------------------------------------------------------------------------
# the refusals, with JAX's messages
# ---------------------------------------------------------------------------


def jax_refusal(monkeypatch, staged, gathered=None):
    """JAX's message for ``staged`` (and a gathered matrix), its multi-process
    function run in this process: two processes and the allgather faked."""
    from jax.experimental import multihost_utils

    from code2vec_tpu.parallel import distributed as jax_dist
    from code2vec_tpu.parallel.mesh import make_mesh

    with monkeypatch.context() as m:
        m.setattr(jax, "process_count", lambda: 2)
        m.setattr(jax_dist, "feed_groups", lambda mesh: (0, 2))
        m.setattr(multihost_utils, "process_allgather", lambda x: np.asarray(gathered))
        with pytest.raises(ValueError) as e:
            jax_de.shard_staged_multiprocess(staged, make_mesh(data=2, model=1, ctx=1))
    return str(e.value)


def gathered_matrix(items, ctx, groups):
    """The ``[world, 3 + 2 * data]`` matrix: per rank its caps, group and counts."""
    rows = [[max(max(i), 1), max(max(c), 1), g, *i, *c] for i, c, g in zip(items, ctx, groups)]
    return np.asarray(rows, np.int64)


def test_replica_check_on_a_gathered_matrix(monkeypatch, corpus):
    agree = gathered_matrix([[40, 0], [40, 0], [0, 56], [0, 56]],
                            [[400, 0], [400, 0], [0, 500], [0, 500]], [0, 0, 1, 1])
    counts, total = de.settle_group_counts(agree, 2)
    np.testing.assert_array_equal(counts, [40, 56])
    assert total == 900
    jhost = jax_group_stagings(corpus)[0][1]
    for bad in (gathered_matrix([[40, 0], [39, 0], [0, 56], [0, 56]],
                                [[400, 0], [390, 0], [0, 500], [0, 500]], [0, 0, 1, 1]),
                gathered_matrix([[40, 0], [40, 0], [0, 56], [0, 56]],
                                [[400, 0], [400, 0], [0, 500], [0, 501]], [0, 0, 1, 1])):
        with pytest.raises(ValueError) as e:
            de.settle_group_counts(bad, 2)
        assert str(e.value) == jax_refusal(monkeypatch, jhost, bad)
        assert "seed the staging rng by feed group" in str(e.value)
    over = gathered_matrix([[40, 0], [0, 56]], [[2**31, 0], [0, 500]], [0, 1])
    with pytest.raises(ValueError) as e:
        de.settle_group_counts(over, 2)
    assert str(e.value) == jax_refusal(monkeypatch, jhost, over)


def test_refusals_raise_on_every_rank_before_placement(monkeypatch, corpus, tmp_path):
    results = harness.spawn(tmp_path, "group_staging", 4, axes=[2, 2, 1], corpus=corpus,
                            refusals=True)
    jax_var = jax_reader.load_corpus(*args_of(corpus), cache=False, native=False,
                                     shard=(0, 2), infer_method=False, infer_variable=True)
    jvar = jax_de.stage_variable_corpus(jax_var, np.arange(jax_var.n_items),
                                        np.random.default_rng(0), device="host")
    want_variable = jax_refusal(monkeypatch, jvar)
    for rank, r in enumerate(results):
        for case in ("variable", "over_cap", "replica"):
            message, placed = r[case]
            assert message is not None, (rank, case)
            assert placed == 0, (rank, case)
        assert r["variable"][0] == want_variable
        words = r["over_cap"][0].split()
        assert words[:3] == ["largest", "shard", "holds"] and int(words[3]) >= 2**31
        assert r["over_cap"][0].endswith("increase data_axis beyond 2")
        assert "feed-group 1 replicas disagree on per-shard item counts" in r["replica"][0]
    # every rank read one matrix, so the messages agree everywhere
    assert all(r == results[0] for r in results[1:])


def test_a_world_of_one_is_shard_staged(corpus):
    data = reader.load_corpus(*args_of(corpus), cache=False)
    host = de.stage_method_corpus(data, np.arange(data.n_items), np.random.default_rng(1))
    for mesh in (single_device_mesh(), Mesh(grid=mesh_grid(2, 1, 1, 2), rank=1)):
        assert_same_share(de.shard_staged_multiprocess(host, mesh, "cpu"),
                          de.shard_staged(host, mesh, "cpu"))
    # the one-process wrapper (JAX :436)
    wrapped = de.stage_method_corpus_sharded(data, np.arange(data.n_items),
                                             np.random.default_rng(1), single_device_mesh(),
                                             "cpu")
    assert torch.equal(wrapped.local.contexts, torch.from_numpy(host.contexts))


def assert_same_share(got, want):
    np.testing.assert_array_equal(got.shard_counts, want.shard_counts)
    assert (got.n_items, got.total_contexts) == (want.n_items, want.total_contexts)
    np.testing.assert_array_equal(got.host_labels, want.host_labels)
    for key in ("contexts", "row_splits", "labels"):
        assert torch.equal(getattr(got.local, key), getattr(want.local, key)), key


def test_a_group_of_two_coordinates_deals_its_shard_as_shard_staged(monkeypatch, corpus):
    from code2vec_tpu_torch.parallel import distributed

    data = reader.load_corpus(*args_of(corpus), cache=False)
    host = de.stage_method_corpus(data, np.arange(data.n_items), np.random.default_rng(2))
    monkeypatch.setattr(de.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(de.dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(distributed, "feed_groups", lambda mesh: (0, 1))
    monkeypatch.setattr(distributed, "process_allgather", lambda x: np.stack([x, x]))
    for rank in (0, 1):
        mesh = Mesh(grid=mesh_grid(2, 1, 1, 2), rank=rank)
        assert_same_share(de.shard_staged_multiprocess(host, mesh, "cpu"),
                          de.shard_staged(host, mesh, "cpu"))

