"""The mesh's layout, its sharding rules and the host-sharded feed, held
bitwise against the JAX package in this process (no group needed: each
rank's share is a function of its coordinates).

- the grid and the rejections against JAX ``make_mesh`` on the 8 CPU
  devices ``tests/conftest.py`` forces (``tests/test_parallel.py:57-73``);
- the spec of every ``state_dict`` key against JAX ``_spec_for_param`` of
  its leaf, divisible and not (``:75-103``, ``:245``), and the batch
  layout against ``batch_shardings``;
- the sidecar's specs and mesh shape against JAX ``pytree_spec_doc`` of a
  sharded state; ``validate_runtime_spec`` and ``rebind`` against JAX's;
- ``load_corpus(shard=...)`` (text, native, CSR with ``row_base``),
  ``local_rows_of_global``, ``scheduled_batches``, ``empty_batch`` and
  ``pad_batch_stream`` against JAX's, from the same seed;
- each rank's share of a sharded staging against JAX ``shard_staged``'s
  rows of that shard.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from code2vec_tpu.data import pipeline as jax_pipeline
from code2vec_tpu.data import reader as jax_reader
from code2vec_tpu.parallel import mesh as jax_mesh
from code2vec_tpu.parallel import shardings as jax_shardings
from code2vec_tpu_torch.data import pipeline, reader, synth
from code2vec_tpu_torch.parallel import shardings
from code2vec_tpu_torch.parallel.mesh import AXES, Mesh, mesh_grid, single_device_mesh


def fake_mesh(axes, rank) -> Mesh:
    """Rank ``rank``'s view of a mesh, without process groups (the layout
    and the local slicing only)."""
    return Mesh(grid=mesh_grid(*axes, world_size=int(np.prod(axes))), rank=rank)


@pytest.mark.parametrize("axes", [(2, 2, 2), (8, 1, 1), (1, 4, 2), (4, 2, 1), (2, 1, 4)])
def test_grid_lays_ranks_as_jax_lays_devices(axes):
    want = jax_mesh.make_mesh(data=axes[0], model=axes[1], ctx=axes[2])
    ids = np.vectorize(lambda d: d.id)(want.devices)
    np.testing.assert_array_equal(mesh_grid(*axes, world_size=8), ids - ids.min())
    assert tuple(want.axis_names) == AXES
    mesh = fake_mesh(axes, 5)
    assert mesh.shape == dict(want.shape)
    assert mesh.coords == dict(zip(AXES, (int(i) for i in np.argwhere(ids == 5)[0])))


def test_data_absorbs_the_remaining_ranks():
    assert mesh_grid(None, 2, 1, 8).shape == tuple(jax_mesh.make_mesh(model=2).devices.shape)


def test_a_mesh_larger_than_the_world_is_rejected():
    with pytest.raises(ValueError):
        jax_mesh.make_mesh(data=1000)
    with pytest.raises(ValueError, match="exceeds"):
        mesh_grid(1000, 1, 1, 8)
    with pytest.raises(ValueError, match="torchrun"):
        mesh_grid(2, 1, 1, 8)  # one process drives one card: no idle ranks


def test_single_device_mesh():
    assert single_device_mesh().shape == dict(jax_mesh.single_device_mesh().shape)


def jax_params(dims, margin=False):
    from code2vec_tpu.models.code2vec import Code2Vec, Code2VecConfig

    cfg = Code2VecConfig(**dims, angular_margin_loss=margin)
    ids = np.ones((2, 4), np.int32)
    return jax.tree.map(np.asarray, Code2Vec(cfg).init(jax.random.PRNGKey(0), ids, ids,
                                                       ids)["params"]), cfg


# port key -> (the JAX leaf, whether the layout is transposed)
LEAVES = {
    "terminal_embedding.weight": (("terminal_embedding", "embedding"), False),
    "path_embedding.weight": (("path_embedding", "embedding"), False),
    "input_linear.weight": (("input_dense", "kernel"), True),
    "input_layer_norm.weight": (("input_layer_norm", "scale"), False),
    "input_layer_norm.bias": (("input_layer_norm", "bias"), False),
    "attention_parameter": (("attention",), False),
    "output_linear.weight": (("output_dense", "kernel"), True),
    "output_linear.bias": (("output_dense", "bias"), False),
    "output_linear": (("output_margin_weight",), False),
}
DIMS = dict(terminal_count=64, path_count=48, label_count=16, terminal_embed_size=8,
            path_embed_size=8, encode_size=16)
ODD = dict(DIMS, terminal_count=63, path_count=41, label_count=13)


def jax_specs(dims, axes, margin=False):
    """The JAX rule's spec of each port key, in the port's layout."""
    params, _ = jax_params(dims, margin)
    mesh = jax_mesh.make_mesh(data=axes[0], model=axes[1], ctx=axes[2])
    sh = jax_shardings.param_shardings(mesh, params)
    out = {}
    for key, (leaf, transposed) in LEAVES.items():
        node = sh
        try:
            for part in leaf:
                node = node[part]
        except KeyError:
            continue
        entries = jax_shardings._spec_entries(node.spec)
        if transposed and entries:
            entries = entries[::-1]
        out[key] = entries
    return out


@pytest.mark.parametrize("margin", [False, True], ids=["plain", "margin"])
@pytest.mark.parametrize("dims", [DIMS, ODD], ids=["divisible", "indivisible"])
@pytest.mark.parametrize("axes", [(2, 2, 2), (8, 1, 1)], ids=["model2", "model1"])
def test_every_state_dict_key_takes_the_jax_spec(axes, dims, margin):
    from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig

    want = jax_specs(dims, axes, margin)
    model = Code2Vec(Code2VecConfig(**dims, angular_margin_loss=margin))
    shape = {"data": axes[0], "model": axes[1], "ctx": axes[2]}
    got = {k: shardings.spec_for_param(k, shape, tuple(v.shape))
           for k, v in model.state_dict().items()}
    assert got == want


def test_the_batch_layout_is_jaxs():
    for axes in [(2, 2, 2), (8, 1, 1), (1, 1, 8)]:
        want = jax_shardings.batch_shardings(jax_mesh.make_mesh(*axes))
        mesh = fake_mesh(axes, 0)
        got = shardings.batch_shardings(mesh)
        assert got == {k: jax_shardings._spec_entries(v.spec) for k, v in want.items()}
        batch = {"starts": np.arange(64).reshape(8, 8), "labels": np.arange(8)}
        batch["paths"] = batch["ends"] = batch["starts"]
        local = shardings.shard_batch(mesh, batch)
        rows, cols = 8 // axes[0], 8 // axes[2]
        np.testing.assert_array_equal(local["starts"], batch["starts"][:rows, :cols])
        np.testing.assert_array_equal(local["labels"], batch["labels"][:rows])


def test_the_sidecar_is_jaxs_pytree_spec_doc():
    """The mesh shape and, key by key, the spec JAX's sharded state records
    for the same leaf (the port's doc adds the Adam moments under their
    parameter's spec)."""
    from code2vec_tpu.train.config import TrainConfig as JaxTrainConfig
    from code2vec_tpu.train.step import create_train_state
    from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig
    from code2vec_tpu_torch.train.config import TrainConfig
    from code2vec_tpu_torch.train.step import make_optimizer

    from code2vec_tpu.models.code2vec import Code2VecConfig as JaxModelConfig

    axes = (2, 2, 2)
    jmesh = jax_mesh.make_mesh(*axes)
    batch = {k: np.ones((8, 8), np.int32) for k in ("starts", "paths", "ends")}
    batch["labels"] = np.zeros(8, np.int32)
    state = create_train_state(JaxTrainConfig(), JaxModelConfig(**DIMS), jax.random.PRNGKey(0),
                               batch)
    doc = jax_shardings.pytree_spec_doc(jax_shardings.shard_state(jmesh, state))
    model = Code2Vec(Code2VecConfig(**DIMS))
    mesh = fake_mesh(axes, 0)
    model.shard_entries = shardings.param_shardings(mesh, model)
    opt = make_optimizer(model, TrainConfig())
    for p in model.parameters():  # Adam makes its moments at the first step
        p.grad = torch.zeros_like(p)
    opt.step()
    mine = shardings.pytree_spec_doc(mesh, model, opt)
    assert mine["mesh_shape"] == doc["mesh_shape"]
    want = jax_specs(DIMS, axes)
    for key, (leaf, _) in LEAVES.items():
        if key not in want:
            continue
        path = "".join(f"['{p}']" for p in leaf)
        saved = next(v for k, v in doc["specs"].items() if k.endswith(path) and "params" in k)
        entries = mine["specs"][f"model/{key}"]
        assert entries == want[key]
        assert sorted(str(e) for e in entries) == sorted(str(e) for e in saved)
    names = [n for n, _ in model.named_parameters()]
    table = names.index("terminal_embedding.weight")
    assert mine["specs"][f"optimizer/{table}/exp_avg"] == ["model", None]
    assert shardings.state_shardings(mesh, model, opt) == mine["specs"]


@pytest.mark.parametrize("entries", [["model", None], ["bogus", None], [["data", "data"]],
                                     [None], []])
def test_validate_runtime_spec_is_jaxs(entries):
    from code2vec_tpu.analysis.sharding_check import validate_runtime_spec
    from code2vec_tpu_torch.analysis import sharding_check

    assert sharding_check.validate_runtime_spec(entries, AXES, "k") == \
        validate_runtime_spec(entries, AXES, "k")


def test_rebind_is_jaxs():
    """A saved ``P("model", None)`` on a new mesh: kept where the axis
    divides the dim, replicated where it does not."""
    doc = {"mesh_shape": {"data": 1, "model": 2, "ctx": 1},
           "specs": {"a": ["model", None], "b": ["model", None], "c": None}}
    shapes = {"a": (64, 8), "b": (63, 8), "c": (5,)}
    mesh = jax_mesh.make_mesh(data=2, model=4, ctx=1)
    abstract = {k: jax.ShapeDtypeStruct(s, np.float32) for k, s in shapes.items()}
    jdoc = {"mesh_shape": doc["mesh_shape"],
            "specs": {jax.tree_util.keystr((jax.tree_util.DictKey(k),)): v
                      for k, v in doc["specs"].items()}}
    want = jax_shardings.rebind_abstract_shardings(mesh, abstract, jdoc)
    got = shardings.rebind(fake_mesh((2, 4, 1), 0), doc, shapes)
    for k in ("a", "b"):
        assert isinstance(want[k].sharding, NamedSharding)
        assert got[k] == jax_shardings._spec_entries(want[k].sharding.spec)
    assert got["c"] == []


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("shard")
    paths = synth.generate_corpus_files(root, synth.SPECS["tiny"])
    from code2vec_tpu_torch.tools.corpus_convert import text_to_csr

    text_to_csr(str(paths["corpus"]), str(root / "corpus.csr"))
    return {k: str(v) for k, v in paths.items()} | {"csr": str(root / "corpus.csr")}


FIELDS = ("starts", "paths", "ends", "row_splits", "ids", "labels")


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
@pytest.mark.parametrize("shard", [(0, 2), (1, 2), (2, 3)])
def test_load_corpus_shard_is_jaxs(corpus, shard, native):
    args = (corpus["corpus"], corpus["path_idx"], corpus["terminal_idx"])
    got = reader.load_corpus(*args, cache=False, native=native, shard=shard)
    want = jax_reader.load_corpus(*args, cache=False, native=False, shard=shard)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert got.shard == want.shard and got.global_n_items == want.global_n_items
    assert got.label_vocab.itos == want.label_vocab.itos
    assert got.normalized_labels == want.normalized_labels
    g = np.random.default_rng(0).permutation(want.global_n_items)
    np.testing.assert_array_equal(got.local_rows_of_global(g), want.local_rows_of_global(g))
    np.testing.assert_array_equal(got.global_of_local(np.arange(3)),
                                  want.global_of_local(np.arange(3)))


def test_a_csr_shard_maps_its_rows_with_row_base(corpus):
    args = (corpus["path_idx"], corpus["terminal_idx"])
    got = reader.load_corpus(corpus["csr"], *args, shard=(1, 2))
    want = jax_reader.load_corpus(corpus["csr"], *args, shard=(1, 2))
    assert got.mmap_backed
    for f in ("row_splits", "row_base", "ids", "labels"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    items = np.arange(got.n_items)
    a = pipeline.build_epoch(got, items, 20, np.random.default_rng(4))
    b = jax_pipeline.build_epoch(want, items, 20, np.random.default_rng(4))
    for f in ("starts", "paths", "ends", "labels"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


@pytest.mark.parametrize("source", ["ram", "csr"])
def test_scheduled_batches_are_jaxs(corpus, source):
    """A feed group's shard following an agreed width schedule: the same
    batches as JAX's source, masked empty ones where its rows of a width
    run out."""
    path = corpus["corpus"] if source == "ram" else corpus["csr"]
    args = (path, corpus["path_idx"], corpus["terminal_idx"])
    got = reader.load_corpus(*args, cache=False, shard=(0, 2))
    want = jax_reader.load_corpus(*args, cache=False, native=False, shard=(0, 2))
    ladder = (5, 10, 20)
    items = np.arange(got.n_items)
    counts = np.minimum(np.diff(got.row_splits), 20)
    per_width = pipeline.bucket_batch_counts(counts, ladder, 8) + 1  # one past its rows
    schedule = np.random.default_rng(9).permutation(np.repeat(np.asarray(ladder), per_width))
    for shuffle in (True, False):
        a = list(pipeline.make_batch_source(got, items, 8, 20, ladder=ladder)
                 .scheduled_batches(np.random.default_rng(2), schedule, shuffle=shuffle))
        b = list(jax_pipeline.make_batch_source(want, items, 8, 20, ladder=ladder)
                 .scheduled_batches(np.random.default_rng(2), schedule, shuffle=shuffle))
        assert len(a) == len(b) == len(schedule)
        for x, y in zip(a, b):
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
        assert sum(not x["example_mask"].any() for x in a) >= len(ladder)


def test_padded_streams_are_jaxs():
    for n in (0, 2, 5):
        got = list(pipeline.pad_batch_stream(iter([{"x": i} for i in range(n)]), 4,
                                             pipeline.empty_batch(3, 7)))
        want = list(jax_pipeline.pad_batch_stream(iter([{"x": i} for i in range(n)]), 4,
                                                  jax_pipeline.empty_batch(3, 7)))
        assert len(got) == len(want) == max(n, 4)
        for x, y in zip(got, want):
            for k in y:
                np.testing.assert_array_equal(x[k], y[k])


def test_each_ranks_sharded_staging_is_jaxs_shard(corpus):
    """Every rank holds JAX ``shard_staged``'s rows of its data coordinate:
    contexts, splits and labels (the snake deal over descending counts)."""
    from code2vec_tpu.train import device_epoch as jax_de
    from code2vec_tpu_torch.train import device_epoch

    args = (corpus["corpus"], corpus["path_idx"], corpus["terminal_idx"])
    data = reader.load_corpus(*args, cache=False)
    jdata = jax_reader.load_corpus(*args, cache=False, native=False)
    items = np.random.default_rng(1).permutation(data.n_items)[:150]
    host = device_epoch.stage_method_corpus(data, items, np.random.default_rng(3))
    jhost = jax_de.stage_method_corpus(jdata, items, np.random.default_rng(3), device="host")
    want = jax_de.shard_staged(jhost, jax_mesh.make_mesh(data=2, model=2, ctx=1))
    contexts, splits, labels = (np.asarray(x) for x in (want.contexts, want.row_splits,
                                                         want.labels))
    for rank in range(4):
        mesh = fake_mesh((2, 2, 1), rank)
        got = device_epoch.shard_staged(host, mesh, "cpu")
        s = mesh.coords["data"]
        n = int(want.shard_counts[s])
        np.testing.assert_array_equal(got.shard_counts, want.shard_counts)
        np.testing.assert_array_equal(got.local.row_splits.numpy(), splits[s, :n + 1])
        total = int(splits[s, n])
        np.testing.assert_array_equal(got.local.contexts.numpy(), contexts[s, :total])
        np.testing.assert_array_equal(got.local.labels.numpy(), labels[s, :n])
        assert got.n_items == want.n_items and got.n_contexts == want.n_contexts
    assert torch.equal(device_epoch.shard_staged(host, fake_mesh((2, 2, 1), 0), "cpu")
                       .local.contexts,
                       device_epoch.shard_staged(host, fake_mesh((2, 2, 1), 1), "cpu")
                       .local.contexts)  # the model line holds one share
