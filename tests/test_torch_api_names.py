"""The port's public names against the JAX package's, on the CPU.

- For every JAX module and its counterpart in the port (the same path
  under ``code2vec_tpu_torch/``, or the renamed pair in ``RENAMED``): each
  public top-level function and class of the JAX module is in the port
  module, and each public method or property of a class both define is on
  the port's class (inherited ones count). The only names let off are the
  JAX idioms in ``EXEMPT``; where the port does the same work under
  another name or in another module, the entry names it and the test
  checks that it is there. An entry the port no longer needs fails too.
- The names that closed the last gaps, each against its JAX counterpart:
  ``predict.nearest_neighbors``, ``formats.corpus_io.read_corpus`` (and
  the ``formats`` package's exports), ``ops.quant.maybe_quantize`` with
  ``QuantTable.shape`` / ``nbytes``, ``ServingEngine.from_predictor``,
  ``CorpusData.context_counts``, ``FeedPool.worker_failed`` and the
  bucketed stagings' ``contexts``.
"""

from __future__ import annotations

import ast
import importlib
import os
import types

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG, PORT_PKG = "code2vec_tpu", "code2vec_tpu_torch"
# JAX modules whose counterpart has another file name
RENAMED = {
    "analysis/jaxlint.py": "analysis/torchlint.py",  # the static analyzer
    "ops/pallas_attention.py": "ops/pool_kernel.py",  # K1 / K1b
}
# JAX idioms the port has no name for, as "module:Name" or
# "module:Class.method" -> the port's counterpart ("module:name"), or None
# where torch needs nothing in its place
EXEMPT = {
    # pytree hooks (jax.tree_util): the port's dataclasses hold tensors
    "ann/index.py:IvfPqIndex.tree_flatten": None,
    "ann/index.py:IvfPqIndex.tree_unflatten": None,
    "ops/quant.py:QuantTable.tree_flatten": None,
    "ops/quant.py:QuantTable.tree_unflatten": None,
    # one function lowered three ways by JAX (Pallas TPU, Pallas GPU, XLA):
    # the port has K5 and its plain version
    "ann/lut_kernel.py:pallas_lut_score_cells": "ann/lut_kernel.py:lut_score_cells",
    "ann/lut_kernel.py:gpu_lut_score_cells": "ann/lut_kernel.py:lut_score_cells",
    "ann/lut_kernel.py:xla_lut_score_cells": "ann/lut_kernel.py:lut_score_cells_reference",
    "ops/fused_encode_pool.py:xla_encode_contexts": "ops/fused_encode_pool.py:encode_contexts",
    "ops/fused_encode_pool.py:xla_reference_forward":
        "ops/fused_encode_pool.py:reference_forward",
    "ops/pallas_attention.py:pallas_attention_pool": "ops/pool_kernel.py:attention_pool_kernel",
    # jit statics and lowering strategies: the port picks a kernel by the
    # tensor's device
    "ops/fused_encode_pool.py:FusedStatic": None,
    "ops/pallas_attention.py:compat_def_partition": None,
    "ops/backend.py:BackendStrategy": "ops/backend.py:resolve",
    "ops/backend.py:device_backend": "ops/backend.py:resolve_device",
    "cli.py:pin_platform": "ops/backend.py:resolve_device",
    # flax's train state and the jitted step builders: the port steps a
    # torch module and its optimizer
    "train/step.py:TrainState": None,
    "train/step.py:create_train_state": "train/step.py:make_optimizer",
    "train/step.py:build_train_step_fn": "train/step.py:train_step",
    "train/step.py:make_train_step": "train/step.py:train_step",
    "train/step.py:build_eval_step_fn": "train/step.py:eval_step",
    "train/step.py:make_eval_step": "train/step.py:eval_step",
    "train/step.py:torch_style_adam": "train/step.py:TorchStyleAdam",
    "parallel/step.py:make_parallel_train_step": "parallel/step.py:sync_gradients",
    "parallel/step.py:make_parallel_eval_step": "train/step.py:eval_step",
    "train/loop.py:dummy_batch": None,  # flax init's example batch
    # optax's lazy-table states and transforms: one torch optimizer
    "train/table_opt.py:LazyAdamState": "train/table_opt.py:LazyTableAdam",
    "train/table_opt.py:MixedTableOptState": "train/table_opt.py:LazyTableAdam",
    "train/table_opt.py:SparseRowUpdate": "train/table_opt.py:lazy_rows",
    "train/table_opt.py:SparseTableGrad": "train/step.py:slot_grads",
    "train/table_opt.py:apply_updates_sparse": "train/table_opt.py:lazy_rows",
    "train/table_opt.py:has_sparse_grads": None,
    "train/table_opt.py:mixed_table_adam": "train/table_opt.py:LazyTableAdam",
    # XLA's compiled cost analysis: the port's costs are analytic
    "obs/costs.py:executable_cost": "obs/costs.py:analytic_forward_cost",
    "obs/costs.py:extract_cost": None,
    # NamedSharding caches and orbax's abstract restore targets
    "parallel/shardings.py:cached_batch_shardings": "parallel/shardings.py:batch_shardings",
    "parallel/shardings.py:rebind_abstract_shardings": "parallel/shardings.py:rebind",
    # orbax's checkpoint layout: the port writes one file a slot
    "checkpoint.py:RestoredCheckpoint": "checkpoint.py:restore_checkpoint",
    "checkpoint.py:sweep_staging_dirs": "checkpoint.py:sweep_staging_files",
    # JAX's device_put may alias the arena; the port's to_device copies
    "data/parallel_feed.py:FeedPool.deliver_mode": None,
    # the native corpus parser lives with the port's data layer
    "extractor.py:parse_corpus_native": "data/corpus_parser.py:parse_corpus_native",
    # the flax parameter tree of the reference bridge: the port's
    # state_dict is its own parameter layout
    "interop.py:to_param_tree": "interop.py:jax_params_from_state_dict",
    "interop.py:from_param_tree": "interop.py:state_dict_from_jax_params",
}


def _files(pkg: str) -> list[str]:
    root = os.path.join(REPO, pkg)
    out = []
    for d, dirs, files in os.walk(root):
        dirs[:] = sorted(x for x in dirs if x != "__pycache__")
        out += [os.path.relpath(os.path.join(d, f), root) for f in files if f.endswith(".py")]
    return sorted(out)


def _public(path: str) -> tuple[list[str], dict[str, list[str]]]:
    """A module's public top-level functions and classes, and each public
    class's public methods and properties, read from its source."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    names, methods = [], {}

    def walk(body):
        for node in body:
            if isinstance(node, (ast.If, ast.Try)):
                walk(node.body + node.orelse + getattr(node, "finalbody", []))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                if node.name.startswith("_"):
                    continue
                names.append(node.name)
                if isinstance(node, ast.ClassDef):
                    methods[node.name] = [m.name for m in node.body
                                          if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                                          and not m.name.startswith("_")]

    walk(tree.body)
    return names, methods


def _module(pkg: str, rel: str) -> types.ModuleType:
    parts = rel[:-3].split(os.sep)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return importlib.import_module(".".join([pkg, *parts]))


def _port_has(ref: str) -> bool:
    rel, dotted = ref.split(":")
    obj = _module(PORT_PKG, rel)
    for part in dotted.split("."):
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


JAX_FILES = _files(JAX_PKG)
PORT_FILES = set(_files(PORT_PKG))
PAIRS = {rel: RENAMED.get(rel, rel) for rel in JAX_FILES}


def test_every_jax_module_has_a_counterpart():
    assert [rel for rel, port in PAIRS.items() if port not in PORT_FILES] == []


@pytest.mark.parametrize("rel", JAX_FILES)
def test_public_names_have_counterparts(rel):
    names, methods = _public(os.path.join(REPO, JAX_PKG, rel))
    port = _module(PORT_PKG, PAIRS[rel])
    wanted = [(n, port, n) for n in names]
    wanted += [(f"{cls}.{m}", getattr(port, cls), m) for cls, ms in methods.items()
               if hasattr(port, cls) for m in ms]
    missing, needless = [], []
    for key, owner, attr in wanted:
        exempt = f"{rel}:{key}"
        if exempt in EXEMPT:
            if hasattr(owner, attr):
                needless.append(exempt)
            elif EXEMPT[exempt] is not None and not _port_has(EXEMPT[exempt]):
                missing.append(f"{key} (its counterpart {EXEMPT[exempt]})")
        elif not hasattr(owner, attr):
            missing.append(key)
    assert missing == [], f"{PORT_PKG}/{PAIRS[rel]} lacks {missing}"
    assert needless == [], f"the port has these now; drop them from EXEMPT: {needless}"


def test_every_exemption_names_a_jax_name():
    """No entry outlives the JAX name it lets off."""
    for key in EXEMPT:
        rel, dotted = key.split(":")
        names, methods = _public(os.path.join(REPO, JAX_PKG, rel))
        cls, _, meth = dotted.partition(".")
        assert (meth in methods.get(cls, ())) if meth else (cls in names), key


# ---------------------------------------------------------------------------
# the names that closed the gaps, against JAX
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from code2vec_tpu_torch.data import synth

    spec = synth.SynthSpec(n_methods=40, n_terminals=60, n_paths=50, n_labels=5,
                           mean_contexts=8.0, max_contexts=12, seed=4)
    return synth.generate_corpus_files(tmp_path_factory.mktemp("names"), spec)


def test_nearest_neighbors_is_jaxs(tmp_path):
    from code2vec_tpu.predict import nearest_neighbors as jax_nearest
    from code2vec_tpu_torch.formats.vectors_io import (append_code_vectors,
                                                       write_code_vectors_header)
    from code2vec_tpu_torch.predict import nearest_neighbors

    rows = np.random.default_rng(0).standard_normal((30, 8)).astype(np.float32)
    path = tmp_path / "code.vec"
    write_code_vectors_header(path, len(rows), rows.shape[1])
    append_code_vectors(path, [f"m{i}" for i in range(len(rows))], rows)
    for seed in range(3):
        q = np.random.default_rng(seed + 10).standard_normal(8).astype(np.float32)
        assert nearest_neighbors(str(path), q, 7) == jax_nearest(str(path), q, 7)


def test_read_corpus_and_the_formats_exports_are_jaxs(corpus):
    import code2vec_tpu.formats as jax_formats
    import code2vec_tpu_torch.formats as formats

    got, want = (m.read_corpus(corpus["corpus"]) for m in (formats, jax_formats))
    assert len(got) == len(want) == 40
    assert [vars(r) for r in got] == [vars(r) for r in want]

    def exports(pkg):
        return {n for n, v in vars(pkg).items()
                if not n.startswith("_") and not isinstance(v, types.ModuleType)}

    assert exports(formats) == exports(jax_formats)


@pytest.mark.parametrize("table_dtype", ["f32", "bf16", "int8"])
def test_maybe_quantize_is_jaxs(table_dtype):
    import jax.numpy as jnp

    from code2vec_tpu.ops.quant import maybe_quantize as jax_maybe
    from code2vec_tpu_torch.ops.quant import QuantTable, maybe_quantize

    table = np.random.default_rng(1).standard_normal((17, 6)).astype(np.float32)
    table[3] = 0.0
    t = torch.from_numpy(table)
    got, want = maybe_quantize(t, table_dtype), jax_maybe(jnp.asarray(table), table_dtype)
    if table_dtype == "f32":
        assert got is t
        return
    assert isinstance(got, QuantTable) and got.table_dtype == want.table_dtype
    assert got.shape == tuple(want.shape) and got.nbytes() == want.nbytes()
    np.testing.assert_array_equal(got.values.float().numpy(),
                                  np.asarray(want.values.astype(jnp.float32)))
    if want.scale is not None:
        np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


def test_from_predictor_takes_what_jaxs_takes(tmp_path):
    from code2vec_tpu.serve.engine import ServingEngine as JaxEngine
    from code2vec_tpu_torch.predict import Predictor
    from code2vec_tpu_torch.serve.engine import ServingEngine
    from test_torch_serve import make_model_dir

    path = make_model_dir(tmp_path)[0]
    predictor = Predictor(str(path), str(path / "terminal_idxs.txt"),
                          str(path / "path_idxs.txt"), device="cpu")
    for recorded in (True, False):
        predictor.ladder_recorded = recorded
        # JAX's engine of a Predictor with the same meta and ladder
        stand_in = types.SimpleNamespace(
            state=None, meta=predictor.meta, ladder=predictor.ladder,
            ladder_recorded=recorded, _quant_tables=None, table_dtype=predictor.table_dtype,
            bag=predictor.bag, base_bag=predictor.base_bag)
        for kw in ({}, {"batch_sizes": (1, 4)}):
            got = ServingEngine.from_predictor(predictor, **kw)
            want = JaxEngine.from_predictor(stand_in, **kw)
            for attr in ("ladder", "max_width", "base_width", "batch_sizes", "table_dtype"):
                assert getattr(got, attr) == getattr(want, attr), (recorded, kw, attr)
            assert got._dims[:3] == want._model_dims
    assert ServingEngine.from_predictor(predictor, ladder=(8, 16)).ladder == (8, 16)


def test_context_counts_are_jaxs(corpus):
    from code2vec_tpu.data import reader as jax_reader
    from code2vec_tpu_torch.data import reader

    args = (corpus["corpus"], corpus["path_idx"], corpus["terminal_idx"])
    for shard in (None, (1, 2)):
        got = reader.load_corpus(*args, cache=False, shard=shard).context_counts()
        want = jax_reader.load_corpus(*args, cache=False, native=False,
                                      shard=shard).context_counts()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_worker_failed_is_jaxs():
    from code2vec_tpu.data.parallel_feed import FeedPool as JaxPool
    from code2vec_tpu_torch.data.parallel_feed import FeedPool, FeedWorkerError

    jax_pool = object.__new__(JaxPool)
    jax_pool._events = None
    for tb in ("Traceback (most recent call last):\n  boom\n", ""):
        got = object.__new__(FeedPool).worker_failed("worker 2: ValueError", tb)
        want = jax_pool.worker_failed("worker 2: ValueError", tb)
        assert isinstance(got, FeedWorkerError)
        assert (str(got), got.remote_traceback) == (str(want), want.remote_traceback)


def test_bucketed_contexts_are_the_first_buckets(corpus):
    from code2vec_tpu.data import reader as jax_reader
    from code2vec_tpu.train import device_epoch as jax_de
    from code2vec_tpu_torch.data import reader
    from code2vec_tpu_torch.parallel.mesh import single_device_mesh
    from code2vec_tpu_torch.train import device_epoch as de

    args = (corpus["corpus"], corpus["path_idx"], corpus["terminal_idx"])
    data = reader.load_corpus(*args, cache=False)
    items = np.arange(data.n_items)
    host = de.stage_method_corpus(data, items, np.random.default_rng(5))
    jhost = jax_de.stage_method_corpus(
        jax_reader.load_corpus(*args, cache=False, native=False), items,
        np.random.default_rng(5), device="host")
    ladder = (4, 8, 12)
    want = np.asarray(jax_de.bucket_staged(jhost, ladder).contexts)
    np.testing.assert_array_equal(de.bucket_staged(host, ladder, "cpu").contexts.numpy(), want)
    sharded = de.bucket_shard_staged(host, ladder, single_device_mesh(), "cpu")
    np.testing.assert_array_equal(sharded.contexts.numpy(), want)
