"""The port's mesh steps on gloo process groups of the CPU, against the
JAX package's sharded step.

Rank workers are subprocesses running this file as a script
(``python tests/test_torch_mesh.py <spec.json> <rank>``): they import only
torch, numpy and the port, form a gloo group by ``file://`` rendezvous in
``tmp_path`` (no ports, so no races between test processes) with a 60 s
timeout, run one scenario and save their result. Every spawn waits at
most 120 s, so a missed collective fails one test. :func:`spawn` is the
harness the other ``test_torch_mesh_*.py`` files use too.

- one and three train steps, dropout 0, at ``data=2``, ``model=2``,
  ``ctx=2`` and ``data=2 x model=2`` (4 ranks) against JAX
  ``make_parallel_train_step`` on the same mesh from the same weights:
  losses rtol 2e-5, parameters atol 3e-5 / rtol 1e-4 (``docs/PARITY.md:16``),
  the ranks bitwise equal; the kernel routes and lazy tables on the mesh
  (plain versions on the CPU) against JAX's plain sharded step;
- lazy tables at ``model=2`` with a shard no slot touches, and the
  per-slot gradients the same on both model ranks (no collective needed);
- a vocab the model axis does not divide (replicated, JAX's rule);
- ranks whose weight sums differ: the loss's global normalizer;
- the table gradients at ``model=2`` against one device's (the identity
  backward of the row-sharded gather);
- the ctx pool's forward and gradient against JAX
  ``context_parallel_attention_pool`` (``tests/test_parallel.py:181-234``);
- the shard and unshard round trip of parameters and Adam moments, exact.
"""

from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys
import uuid

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT_S = 120
GROUP_TIMEOUT_S = 60


def spawn(tmp_path, scenario: str, world: int, env: dict | None = None, **params) -> list:
    """Run ``scenario`` on ``world`` gloo ranks; return each rank's result.
    ``env``: ``{rank: {name: value}}`` set in that rank's process."""
    import torch

    out = tmp_path / f"{scenario}-{uuid.uuid4().hex[:8]}"
    out.mkdir()
    spec = dict(scenario=scenario, world=world, init=str(out / "rendezvous"), out=str(out),
                **params)
    (out / "spec.json").write_text(json.dumps(spec))
    base = {k: v for k, v in os.environ.items() if not k.startswith(("RANK", "WORLD_SIZE",
                                                                     "MASTER_", "LOCAL_RANK"))}
    base.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = []
    for rank in range(world):
        proc_env = dict(base, **{k: str(v) for k, v in (env or {}).get(rank, {}).items()})
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(out / "spec.json"), str(rank)],
            cwd=REPO, env=proc_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=SPAWN_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for proc in procs:
            proc.kill()
        raise AssertionError(f"{scenario}: a rank did not finish in {SPAWN_TIMEOUT_S} s "
                             "(a missed collective?)") from None
    for rank, (proc, log) in enumerate(zip(procs, logs)):
        assert proc.returncode == 0, f"{scenario} rank {rank} exited {proc.returncode}:\n{log}"
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


# ---------------------------------------------------------------------------
# the rank workers' scenarios (torch and the port only)
# ---------------------------------------------------------------------------


def _mesh(axes):
    from code2vec_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(*axes, timeout_s=GROUP_TIMEOUT_S)


def _torch_batch(batch: dict) -> dict:
    import torch

    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items() if k != "ids"}


def scenario_steps(spec, rank):
    """Train steps of each variant on the mesh: losses and global params."""
    import torch

    from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig
    from code2vec_tpu_torch.parallel.distributed import global_batch
    from code2vec_tpu_torch.parallel.shardings import shard_model, unshard_state
    from code2vec_tpu_torch.train.config import TrainConfig
    from code2vec_tpu_torch.train.step import make_optimizer, train_step

    inputs = torch.load(spec["inputs"], weights_only=False)
    mesh = _mesh(spec["axes"])
    weights = torch.from_numpy(inputs["class_weights"])
    out = {}
    for name, variant in spec["variants"].items():
        kernel = variant.get("route", "plain") != "plain"
        cfg = Code2VecConfig(**spec["model"], dropout_prob=0.0, use_pallas=kernel,
                             pallas_impl=variant["route"] if kernel else "pool_only")
        model = Code2Vec(cfg)
        model.load_state_dict(inputs["state_dict"], strict=True)
        shard_model(model, mesh)
        opt = make_optimizer(model, TrainConfig(lr=spec["lr"],
                                                table_update=variant.get("table_update",
                                                                         "dense")))
        losses = [float(train_step(model, opt, _torch_batch(global_batch(mesh, b)), weights))
                  for b in inputs["batches"]]
        out[name] = {"losses": losses, "params": unshard_state(mesh, model, None)[0]}
    return out


def scenario_grads(spec, rank):
    """One backward on the mesh, the gradients synced and gathered whole."""
    import torch

    from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig
    from code2vec_tpu_torch.parallel.distributed import global_batch
    from code2vec_tpu_torch.parallel.shardings import shard_model, unshard_tensor
    from code2vec_tpu_torch.parallel.step import sync_gradients
    from code2vec_tpu_torch.train.step import forward_backward

    inputs = torch.load(spec["inputs"], weights_only=False)
    mesh = _mesh(spec["axes"])
    model = Code2Vec(Code2VecConfig(**spec["model"], dropout_prob=0.0))
    model.load_state_dict(inputs["state_dict"], strict=True)
    shard_model(model, mesh)
    loss = forward_backward(model, _torch_batch(global_batch(mesh, inputs["batches"][0])),
                            torch.from_numpy(inputs["class_weights"]))
    sync_gradients(model, mesh)
    return {"loss": float(loss),
            "grads": {n: unshard_tensor(p.grad, model.shard_entries[n], mesh)
                      for n, p in model.named_parameters()}}


def scenario_slots(spec, rank):
    """The lazy step's per-slot table gradients on this rank, before any
    collective over the plane."""
    import torch

    from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig
    from code2vec_tpu_torch.parallel.distributed import global_batch
    from code2vec_tpu_torch.parallel.shardings import shard_model
    from code2vec_tpu_torch.train.step import lazy_forward_backward

    inputs = torch.load(spec["inputs"], weights_only=False)
    mesh = _mesh(spec["axes"])
    model = Code2Vec(Code2VecConfig(**spec["model"], dropout_prob=0.0))
    model.load_state_dict(inputs["state_dict"], strict=True)
    shard_model(model, mesh)
    loss, table_grads = lazy_forward_backward(
        model, _torch_batch(global_batch(mesh, inputs["batches"][0])),
        torch.from_numpy(inputs["class_weights"]))
    return {"loss": float(loss), "table_grads": table_grads}


def scenario_ctx_pool(spec, rank):
    """The ctx pool on this rank's bag shard: outputs and gradients."""
    import torch

    from code2vec_tpu_torch.parallel.context import context_parallel_attention_pool
    from code2vec_tpu_torch.parallel.distributed import all_reduce_sum

    inputs = torch.load(spec["inputs"], weights_only=False)
    mesh = _mesh((1, 1, spec["world"]))
    c, n = mesh.coords["ctx"], spec["world"]
    width = inputs["ctx"].shape[1] // n
    ctx = torch.from_numpy(inputs["ctx"][:, c * width:(c + 1) * width].copy()).requires_grad_()
    mask = torch.from_numpy(inputs["mask"][:, c * width:(c + 1) * width].copy())
    attn = torch.from_numpy(inputs["attn"]).requires_grad_()
    cv, w = context_parallel_attention_pool(mesh, ctx, mask, attn)
    (cv * torch.from_numpy(inputs["cot"])).sum().backward()
    return {"cv": cv.detach(), "w": w.detach(), "d_ctx": ctx.grad,
            "d_attn": all_reduce_sum(attn.grad, mesh.group("ctx"))}


def scenario_roundtrip(spec, rank):
    """Shard and unshard: parameters, then Adam's moments after a step."""
    import torch

    from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig
    from code2vec_tpu_torch.parallel.distributed import global_batch
    from code2vec_tpu_torch.parallel.shardings import shard_model, shard_state, unshard_state
    from code2vec_tpu_torch.train.config import TrainConfig
    from code2vec_tpu_torch.train.step import make_optimizer, train_step

    inputs = torch.load(spec["inputs"], weights_only=False)
    mesh = _mesh(spec["axes"])
    model = Code2Vec(Code2VecConfig(**spec["model"], dropout_prob=0.0))
    model.load_state_dict(inputs["state_dict"], strict=True)
    whole = {k: v.clone() for k, v in model.state_dict().items()}
    shard_model(model, mesh)
    local = {k: v.clone() for k, v in model.state_dict().items()}
    back = {k: v.clone() for k, v in unshard_state(mesh, model, None)[0].items()}
    opt = make_optimizer(model, TrainConfig(lr=0.01))
    train_step(model, opt, _torch_batch(global_batch(mesh, inputs["batches"][0])),
               torch.from_numpy(inputs["class_weights"]))
    msd, osd = unshard_state(mesh, model, opt)
    re_msd, re_osd = shard_state(mesh, model, msd, opt, osd)
    live = opt.state_dict()
    # interop's JAX tree -> this rank's shards -> JAX tree, padding included
    from code2vec_tpu_torch import interop

    cfg = model.config
    tree = interop.jax_params_from_state_dict(whole, cfg)
    shards = interop.rank_state_dict_from_jax_params(tree, cfg, mesh)
    back_tree = interop.jax_params_from_rank_state_dict(shards, cfg, mesh)
    flat = lambda t: {f"{a}/{b}": v for a, d in t.items()  # noqa: E731
                      for b, v in (d.items() if isinstance(d, dict) else [("", d)])}
    return {
        "interop_exact": all(np.array_equal(flat(back_tree)[k], v) for k, v in flat(tree).items()),
        "interop_shapes": {k: tuple(v.shape) for k, v in shards.items()},
        "whole": whole, "back": back, "local_shapes": {k: tuple(v.shape) for k, v in local.items()},
        "model_exact": all(torch.equal(re_msd[k], v) for k, v in model.state_dict().items()),
        "moments_exact": all(torch.equal(re_osd["state"][i][k], v)
                             for i, st in live["state"].items() for k, v in st.items()
                             if isinstance(v, torch.Tensor) and v.dim()),
        "global_moment_shapes": {name: tuple(osd["state"][i]["exp_avg"].shape)
                                 for i, (name, _) in enumerate(model.named_parameters())},
    }


def scenario_train(spec, rank):
    """``train()`` on the mesh of ``spec["config"]`` (a rank's own fault plan
    from ``rank_config``): history, per-step losses, the corpus shard, the
    manifest's mesh shape and, with ``check_restore``, whether a restore of
    the checkpoint onto this mesh equals the saved tensors bitwise."""
    import torch

    from code2vec_tpu_torch.data import reader
    from code2vec_tpu_torch.obs.events import EventLog
    from code2vec_tpu_torch.train import loop
    from code2vec_tpu_torch.train.config import TrainConfig

    corpus = spec["corpus"]
    args = (corpus["corpus"], corpus["path_idx"], corpus["terminal_idx"])
    config = TrainConfig(**spec["config"], **(spec.get("rank_config") or {}).get(str(rank), {}))
    shard = None
    if spec.get("host_shard"):
        from code2vec_tpu_torch.parallel.mesh import mesh_grid

        grid = mesh_grid(config.data_axis, config.model_axis, config.context_axis,
                         spec["world"])
        shard = (int(np.argwhere(grid == rank)[0][0]), config.data_axis)
    data = reader.load_corpus(*args, cache=False, shard=shard)
    out = {"shard": list(data.shard) if data.shard else None, "n_items": data.n_items,
           "global_n_items": data.global_n_items}
    if spec.get("check_restore"):
        out["restore"] = _check_restore(spec, config, data)
    losses, real = [], loop.train_step

    def recording(*a):
        loss = real(*a)
        losses.append(float(loss))
        return loss

    loop.train_step = recording
    events, manifests = EventLog(), []
    events.subscribe(lambda e: manifests.append(e) if e["event"] == "manifest" else None)
    result = loop.train(config, data, spec.get("out_dir"), device="cpu", sinks=(), events=events)
    out.update(history=result.history, losses=losses,
               manifest_mesh=manifests[0]["mesh_shape"] if manifests else None)
    return out


def _check_restore(spec, config, data):
    """Restore the checkpoint onto this run's mesh and compare every tensor,
    gathered, with the file's."""
    import torch

    from code2vec_tpu_torch.checkpoint import restore_checkpoint, slot_path
    from code2vec_tpu_torch.models.code2vec import Code2Vec
    from code2vec_tpu_torch.parallel.shardings import shard_model, unshard_state
    from code2vec_tpu_torch.train.loop import build_mesh, model_config_from
    from code2vec_tpu_torch.train.step import make_optimizer

    mesh = build_mesh(config)
    model = Code2Vec(model_config_from(config, data))
    shard_model(model, mesh)
    opt = make_optimizer(model, config)
    info = {}
    restore_checkpoint(spec["out_dir"], model, opt, np.random.default_rng(0),
                       config.vocab_pad_multiple, mesh=mesh, info=info)
    msd, osd = unshard_state(mesh, model, opt)
    saved = torch.load(slot_path(spec["out_dir"], info["slot"]), weights_only=False)
    same = all(torch.equal(msd[k], v) for k, v in saved["model"].items())
    for i, st in saved["optimizer"]["state"].items():
        for k, v in st.items():
            same &= bool(torch.equal(osd["state"][i][k], v) if isinstance(v, torch.Tensor)
                         else osd["state"][i][k] == v)
    return {"bitwise": bool(same), "resharded": info["resharded"],
            "saved_mesh_shape": info["saved_mesh_shape"]}


def scenario_autotune(spec, rank):
    """``pallas_impl="auto"`` on the mesh: each rank forwards its rows of
    the batch twice; the schedule is looked up once, keyed on the global
    batch (tests/test_torch_autotune.py)."""
    import torch

    from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig
    from code2vec_tpu_torch.ops import autotune
    from code2vec_tpu_torch.parallel.distributed import global_batch
    from code2vec_tpu_torch.parallel.shardings import shard_model

    inputs = torch.load(spec["inputs"], weights_only=False)
    mesh = _mesh(spec["axes"])
    autotune.get_cache(spec["cache"])
    model = Code2Vec(Code2VecConfig(**spec["model"], dropout_prob=0.0, use_pallas=True,
                                    pallas_impl="auto"))
    model.load_state_dict(inputs["state_dict"], strict=True)
    shard_model(model, mesh)
    model.eval()
    batch = _torch_batch(global_batch(mesh, inputs["batches"][0]))
    before = autotune.counters_snapshot()
    with torch.no_grad():
        cvs = [model(batch["starts"], batch["paths"], batch["ends"])[1] for _ in range(2)]
    after = autotune.counters_snapshot()
    return {"local_rows": int(batch["starts"].shape[0]), "code_vectors": cvs,
            "resolved": sorted((k[1:3], v) for k, v in model._schedules[1].items()),
            "counters": {k: after[k] - before[k] for k in after}}


def scenario_serve(spec, rank):
    """Retrieval on the mesh, every rank with the same queries: the exact
    index's top-k at each ``(Q, k)``, the IVF-PQ searcher's shortlists and
    ``load_retrieval_index`` of both backends from files."""
    import torch

    from code2vec_tpu_torch.ann.index import AnnSearcher, IvfPqIndex
    from code2vec_tpu_torch.serve.retrieval import RetrievalIndex, load_retrieval_index

    inputs = torch.load(spec["inputs"], weights_only=False)
    mesh = _mesh(spec["axes"])
    exact = RetrievalIndex(inputs["labels"], inputs["rows"], mesh=mesh, device="cpu")
    out = {"exact": {(q, k): exact.top_k_batch(inputs["queries"][:q], k)
                     for q in spec["queries"] for k in spec["ks"]},
           "exact_rows": exact.host_rows(), "exact_describe": exact.describe()}
    searcher = AnnSearcher(IvfPqIndex(**inputs["index"]), mesh=mesh, device="cpu",
                           **spec["searcher"])
    out["search"] = searcher.search(inputs["ann_queries"])
    out["probed_fraction"] = searcher.probed_fraction(inputs["ann_queries"])
    out["search_describe"] = searcher.describe()
    for backend in ("exact", "ann"):
        index = load_retrieval_index(backend, code_vec_path=inputs["code_vec"],
                                     ann_index_path=inputs["ann_index"], mesh=mesh, device="cpu")
        out[f"load_{backend}"] = index.top_k_batch(inputs["ann_queries"], 10)
        out[f"load_{backend}_rows"] = index.host_rows()
        index.close()
    return out


def scenario_build(spec, rank):
    """k-means, ``assign_cells`` and ``build_index`` with the assignments
    over the mesh's ``data`` line."""
    import torch

    from code2vec_tpu_torch.ann.index import build_index
    from code2vec_tpu_torch.ann.kmeans import assign_cells, kmeans_fit

    inputs = torch.load(spec["inputs"], weights_only=False)
    mesh = _mesh(spec["axes"])
    x, kw = inputs["x"], spec["kmeans"]
    cents = kmeans_fit(x, kw["k"], seed=kw["seed"], iters=kw["iters"],
                       batch_size=kw["batch_size"], mesh=mesh, device="cpu")
    index, unit = build_index(inputs["rows"], mesh=mesh, device="cpu", **spec["build"])
    return {"centroids": cents,
            "assign": assign_cells(x, cents, batch_size=kw["batch_size"], mesh=mesh,
                                   device="cpu"),
            "index": index, "unit": unit}


def scenario_group_staging(spec, rank):
    """Each feed group loads and stages only its corpus shard (the rng
    seeded by group), ``shard_staged_multiprocess`` assembles the shares;
    with ``spec["rows"]``, ``ShardedEpochRunner`` chunks on ``pool_only``
    over the given rows of each share. With ``spec["refusals"]``, the
    refused cases instead, each ``(message, shares placed)``."""
    import torch

    from code2vec_tpu_torch.data import reader
    from code2vec_tpu_torch.parallel import distributed
    from code2vec_tpu_torch.train import device_epoch as de

    mesh = _mesh(spec["axes"])
    group, n_groups = distributed.feed_groups(mesh)
    corpus = spec["corpus"]
    args = (corpus["corpus"], corpus["path_idx"], corpus["terminal_idx"])
    data = reader.load_corpus(*args, cache=False, shard=(group, n_groups))
    host = de.stage_method_corpus(data, np.arange(data.n_items),
                                  np.random.default_rng(1000 + group))
    if spec.get("refusals"):
        return _group_staging_refusals(mesh, rank, data, host, args, group, n_groups)
    staged = de.shard_staged_multiprocess(host, mesh, "cpu")
    out = {"group": group, "local_items": data.n_items, "staged_items": host.n_items,
           "shard_counts": staged.shard_counts, "n_items": staged.n_items,
           "total_contexts": staged.total_contexts,
           "local": {k: getattr(staged.local, k).numpy() for k in
                     ("contexts", "row_splits", "labels")}}
    if "rows" in spec:
        out["losses"] = _group_staging_chunks(spec, mesh, staged)
    return out


def _group_staging_chunks(spec, mesh, staged):
    """The chunks' per-step losses over the given rows of this rank's share."""
    import torch

    from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig
    from code2vec_tpu_torch.parallel.shardings import shard_model
    from code2vec_tpu_torch.train import device_epoch as de
    from code2vec_tpu_torch.train.config import TrainConfig
    from code2vec_tpu_torch.train.step import StepTally, make_optimizer

    inputs = torch.load(spec["inputs"], weights_only=False)
    model = Code2Vec(Code2VecConfig(**spec["model"], dropout_prob=0.0, use_pallas=True,
                                    pallas_impl="pool_only"))
    model.load_state_dict(inputs["state_dict"], strict=True)
    shard_model(model, mesh)
    opt = make_optimizer(model, TrainConfig(lr=spec["lr"]))
    chunk = spec["chunk"]
    runner = de.ShardedEpochRunner(torch.ones(spec["model"]["label_count"]), spec["batch"],
                                   spec["bag"], chunk, mesh=mesh)
    generator = de.sampler_generator(3, "cpu")
    losses = []
    for rows in spec["rows"]:  # [data, span] per chunk: the given rows of each share
        order = np.asarray(rows[runner.shard], np.int64)
        tally = StepTally(torch.device("cpu"))
        runner.train_chunk(model, opt, staged.local, order, 0, chunk, len(order), generator,
                           tally)
        losses.append([float(x) for x in tally.losses])
    return losses


def _group_staging_refusals(mesh, rank, data, host, args, group, n_groups):
    """Every refused case on every rank, one after another: the variable
    task, a share past int32 on the last rank only, and the last rank
    staging one item fewer than its group's other replica."""
    from code2vec_tpu_torch.data import reader
    from code2vec_tpu_torch.parallel import distributed
    from code2vec_tpu_torch.train import device_epoch as de

    placed, real_place, real_gather = [], de.place_staged, distributed.process_allgather
    de.place_staged = lambda *a: placed.append(1) or real_place(*a)
    last = rank == mesh.size - 1

    def inflated(x):
        x = np.asarray(x, np.int64).copy()
        if last:
            x[1] += 2**31
        return real_gather(x)

    var_data = reader.load_corpus(*args, cache=False, shard=(group, n_groups),
                                  infer_method=False, infer_variable=True)
    cases = {
        "variable": lambda: de.stage_variable_corpus(var_data, np.arange(var_data.n_items),
                                                     np.random.default_rng(1000 + group)),
        "over_cap": lambda: host,
        "replica": lambda: (de.stage_method_corpus(data, np.arange(data.n_items - 1),
                                                   np.random.default_rng(1000 + group))
                            if last else host),
    }
    out = {}
    for name, staging in cases.items():
        placed.clear()
        distributed.process_allgather = inflated if name == "over_cap" else real_gather
        try:
            de.shard_staged_multiprocess(staging(), mesh, "cpu")
            out[name] = (None, len(placed))
        except ValueError as e:
            out[name] = (str(e), len(placed))
    distributed.process_allgather = real_gather
    return out


def _worker_main(spec_path: str, rank: int) -> None:
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    dist.init_process_group("gloo", init_method="file://" + spec["init"], rank=rank,
                            world_size=spec["world"],
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        result = globals()["scenario_" + spec["scenario"]](spec, rank)
        torch.save(result, os.path.join(spec["out"], f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _worker_main(sys.argv[1], int(sys.argv[2]))
    sys.exit(0)


# ---------------------------------------------------------------------------
# the tests (the JAX oracle runs here, in the pytest process)
# ---------------------------------------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from code2vec_tpu_torch import interop  # noqa: E402
from code2vec_tpu_torch.models.code2vec import Code2VecConfig  # noqa: E402

DIMS = dict(terminal_count=64, path_count=48, label_count=16, terminal_embed_size=8,
            path_embed_size=8, encode_size=16)
ODD = dict(DIMS, terminal_count=63, path_count=41, label_count=13)
B, L = 8, 8


def make_batches(dims, n=3, seed=0, masks=None):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        starts = rng.integers(1, dims["terminal_count"], (B, L)).astype(np.int32)
        starts[:, L // 2 + i % 2:] = 0
        out.append({
            "ids": np.arange(B, dtype=np.int64),
            "starts": starts,
            "paths": rng.integers(1, dims["path_count"], (B, L)).astype(np.int32),
            "ends": rng.integers(1, dims["terminal_count"], (B, L)).astype(np.int32),
            "labels": rng.integers(0, dims["label_count"], B).astype(np.int32),
            "example_mask": (np.ones(B, np.float32) if masks is None
                             else np.asarray(masks[i], np.float32)),
        })
    return out


def jax_sharded_steps(axes, dims, batches, weights, lr=0.01, table_update="dense"):
    """JAX's sharded step on the same mesh: (initial params, losses, final params)."""
    from code2vec_tpu.models.code2vec import Code2VecConfig as JaxModelConfig
    from code2vec_tpu.parallel.mesh import make_mesh
    from code2vec_tpu.parallel.shardings import shard_state
    from code2vec_tpu.parallel.step import make_parallel_train_step
    from code2vec_tpu.train.config import TrainConfig as JaxTrainConfig
    from code2vec_tpu.train.step import create_train_state

    jcfg = JaxModelConfig(**dims, dropout_prob=0.0)
    tcfg = JaxTrainConfig(lr=lr, dropout_prob=0.0, batch_size=B, max_path_length=L,
                          table_update=table_update)
    state = create_train_state(tcfg, jcfg, jax.random.PRNGKey(7), batches[0])
    params0 = jax.tree.map(np.asarray, state.params)
    mesh = make_mesh(data=axes[0], model=axes[1], ctx=axes[2])
    state = shard_state(mesh, state)
    step = make_parallel_train_step(jcfg, jnp.asarray(weights), mesh, state,
                                    table_update=table_update)
    losses = []
    for b in batches:
        state, loss = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(loss))
    return params0, losses, jax.tree.map(np.asarray, state.params)


def write_inputs(tmp_path, dims, params0, batches, weights):
    sd = interop.state_dict_from_jax_params(params0, Code2VecConfig(**dims))
    path = tmp_path / f"inputs-{uuid.uuid4().hex[:8]}.pt"
    torch.save({"state_dict": sd, "batches": batches, "class_weights": weights}, path)
    return str(path)


def assert_matches_jax(result, want_losses, want_params, dims, steps=3):
    np.testing.assert_allclose(result["losses"][:steps], want_losses[:steps], rtol=2e-5, atol=0)
    want = interop.state_dict_from_jax_params(want_params, Code2VecConfig(**dims))
    for k, v in result["params"].items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4, atol=3e-5, err_msg=k)


def assert_ranks_bitwise(results, key=None):
    first = results[0] if key is None else results[0][key]
    for other in results[1:]:
        got = other if key is None else other[key]
        assert got["losses"] == first["losses"]
        for k, v in first["params"].items():
            assert torch.equal(got["params"][k], v), k


AXES = {"data2": (2, 1, 1), "model2": (1, 2, 1), "ctx2": (1, 1, 2), "data2_model2": (2, 2, 1)}
# each mesh runs the plain route; data and model also every kernel route (their
# plain versions on the CPU) and lazy tables where the config takes them
VARIANTS = {
    "data2": ["plain", "pool_only", "gather_split", "fused", "lazy"],
    "model2": ["plain", "pool_only", "gather_split", "fused", "lazy", "lazy_gather_split",
               "lazy_fused"],
    "ctx2": ["plain", "lazy"],
    "data2_model2": ["plain", "fused", "lazy"],
}


def _variant(name):
    """``lazy[_<route>]``: lazy tables on that route (plain by default)."""
    if name.startswith("lazy"):
        return {"route": name[len("lazy_"):] or "plain", "table_update": "lazy"}
    return {"route": name}


@pytest.mark.parametrize("mesh_name", list(AXES))
def test_steps_match_the_jax_sharded_step(tmp_path, mesh_name):
    """One step (its loss) and three steps (losses and parameters) of every
    variant against JAX's sharded step on the same mesh; the ranks bitwise
    equal to each other."""
    axes = AXES[mesh_name]
    batches = make_batches(DIMS)
    weights = np.ones(DIMS["label_count"], np.float32)
    params0, want_losses, want_params = jax_sharded_steps(axes, DIMS, batches, weights)
    variants = {v: _variant(v) for v in VARIANTS[mesh_name]}
    results = spawn(tmp_path, "steps", int(np.prod(axes)), axes=list(axes), model=DIMS,
                    lr=0.01, variants=variants,
                    inputs=write_inputs(tmp_path, DIMS, params0, batches, weights))
    lazy_want = None
    for name in variants:
        assert_ranks_bitwise(results, name)
        if name.startswith("lazy"):
            if lazy_want is None:
                _, *lazy_want = jax_sharded_steps(axes, DIMS, batches, weights,
                                                  table_update="lazy")
            assert_matches_jax(results[0][name], *lazy_want, DIMS)
            continue
        assert_matches_jax(results[0][name], want_losses, want_params, DIMS, steps=1)
        assert_matches_jax(results[0][name], want_losses, want_params, DIMS)


def test_lazy_steps_with_an_untouched_shard(tmp_path):
    """Lazy tables at ``model=2`` on batches whose ids all lie in rank 0's
    rows (PAD too): rank 1's table shards are touched by no slot. It steps
    without error, its rows and moments stay as they were, and the steps
    match JAX's sharded lazy step."""
    axes = (1, 2, 1)
    half = dict(DIMS, terminal_count=DIMS["terminal_count"] // 2,
                path_count=DIMS["path_count"] // 2)
    batches = make_batches(half, seed=4)
    weights = np.ones(DIMS["label_count"], np.float32)
    params0, want_losses, want_params = jax_sharded_steps(axes, DIMS, batches, weights,
                                                          table_update="lazy")
    variants = {v: _variant(v) for v in ("lazy", "lazy_fused")}
    results = spawn(tmp_path, "steps", 2, axes=list(axes), model=DIMS, lr=0.01,
                    variants=variants,
                    inputs=write_inputs(tmp_path, DIMS, params0, batches, weights))
    start = interop.state_dict_from_jax_params(params0, Code2VecConfig(**DIMS))
    for name in variants:
        assert_ranks_bitwise(results, name)
        assert_matches_jax(results[0][name], want_losses, want_params, DIMS)
        for key, rows in (("terminal_embedding.weight", half["terminal_count"]),
                          ("path_embedding.weight", half["path_count"])):
            assert torch.equal(results[0][name]["params"][key][rows:], start[key][rows:]), key
            assert not torch.equal(results[0][name]["params"][key][:rows], start[key][:rows])


def test_an_indivisible_vocab_replicates(tmp_path):
    """63 terminals, 41 paths and 13 labels over a model axis of 2: no dim
    divides, every parameter replicates (JAX ``_spec_for_param``), and the
    steps still match JAX's."""
    axes = (1, 2, 1)
    batches = make_batches(ODD)
    weights = np.ones(ODD["label_count"], np.float32)
    params0, want_losses, want_params = jax_sharded_steps(axes, ODD, batches, weights)
    results = spawn(tmp_path, "steps", 2, axes=list(axes), model=ODD, lr=0.01,
                    variants={"plain": {"route": "plain"}},
                    inputs=write_inputs(tmp_path, ODD, params0, batches, weights))
    assert_ranks_bitwise(results, "plain")
    assert_matches_jax(results[0]["plain"], want_losses, want_params, ODD)


def test_the_loss_normalizer_is_the_global_batchs(tmp_path):
    """Rank 0's rows are mostly masked and the class weights differ, so the
    ranks' weight sums differ: a mean of per-rank means would miss JAX's
    loss; the global ``sum(w nll) / sum(w)`` matches it."""
    axes = (2, 1, 1)
    masks = [[1, 0, 0, 0, 1, 1, 1, 1], [0, 0, 1, 0, 1, 1, 1, 0], [1, 0, 0, 0, 1, 1, 1, 1]]
    batches = make_batches(DIMS, masks=masks)
    weights = np.linspace(0.2, 3.0, DIMS["label_count"]).astype(np.float32)
    params0, want_losses, want_params = jax_sharded_steps(axes, DIMS, batches, weights)
    results = spawn(tmp_path, "steps", 2, axes=list(axes), model=DIMS, lr=0.01,
                    variants={"plain": {"route": "plain"}},
                    inputs=write_inputs(tmp_path, DIMS, params0, batches, weights))
    assert_ranks_bitwise(results, "plain")
    assert_matches_jax(results[0]["plain"], want_losses, want_params, DIMS)


def test_table_gradients_at_model2_are_one_devices(tmp_path):
    """The row-sharded gather's backward is the identity: each table row's
    gradient at ``model=2`` equals one device's (an all-reduce there would
    double it), and so does every other gradient."""
    from code2vec_tpu_torch.models.code2vec import Code2Vec
    from code2vec_tpu_torch.train.step import forward_backward

    batches = make_batches(DIMS, n=1)
    weights = np.ones(DIMS["label_count"], np.float32)
    model = Code2Vec(Code2VecConfig(**DIMS, dropout_prob=0.0))
    model.reset_parameters(torch.Generator().manual_seed(3))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    loss = forward_backward(model, {k: torch.from_numpy(v) for k, v in batches[0].items()
                                    if k != "ids"}, torch.from_numpy(weights))
    path = tmp_path / "grads.pt"
    torch.save({"state_dict": sd, "batches": batches, "class_weights": weights}, path)
    results = spawn(tmp_path, "grads", 2, axes=[1, 2, 1], model=DIMS, inputs=str(path))
    for r in results:
        np.testing.assert_allclose(r["loss"], float(loss), rtol=1e-6)
        for n, p in model.named_parameters():
            np.testing.assert_allclose(r["grads"][n].numpy(), p.grad.numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=n)
    touched = torch.unique(torch.from_numpy(np.concatenate([batches[0]["starts"].ravel(),
                                                            batches[0]["ends"].ravel()])))
    assert results[0]["grads"]["terminal_embedding.weight"][touched].abs().sum() > 0


def test_lazy_slots_are_the_same_on_the_model_line(tmp_path):
    """``gather_slot_grads`` adds no collective over ``model``: the
    row-sharded gather's identity backward and the head's all-reduced
    code-vector gradient give both model ranks the same per-slot
    gradients, bitwise, which are one device's."""
    from code2vec_tpu_torch.models.code2vec import Code2Vec
    from code2vec_tpu_torch.train.step import lazy_forward_backward

    batches = make_batches(DIMS, n=1)
    weights = np.ones(DIMS["label_count"], np.float32)
    model = Code2Vec(Code2VecConfig(**DIMS, dropout_prob=0.0))
    model.reset_parameters(torch.Generator().manual_seed(3))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    _, want = lazy_forward_backward(model, {k: torch.from_numpy(v) for k, v in
                                            batches[0].items() if k != "ids"},
                                    torch.from_numpy(weights))
    path = tmp_path / "slots.pt"
    torch.save({"state_dict": sd, "batches": batches, "class_weights": weights}, path)
    results = spawn(tmp_path, "slots", 2, axes=[1, 2, 1], model=DIMS, inputs=str(path))
    for (ids0, slots0), (ids1, slots1), (ids, slots) in zip(
            results[0]["table_grads"], results[1]["table_grads"], want):
        assert torch.equal(ids0, ids1) and torch.equal(slots0, slots1)
        assert torch.equal(ids0, ids)
        np.testing.assert_allclose(slots0.numpy(), slots.numpy(), rtol=1e-5, atol=1e-7)


def test_ctx_pool_matches_jax(tmp_path):
    """Forward and gradient against JAX ``context_parallel_attention_pool``
    on a ctx axis of 2 (``tests/test_parallel.py:181-234``)."""
    from code2vec_tpu.parallel.context import context_parallel_attention_pool as jax_pool
    from code2vec_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(1)
    b, length, e = 4, 32, 16
    ctx = rng.normal(size=(b, length, e)).astype(np.float32)
    mask = (rng.random((b, length)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    mask[-1] = 0.0  # an all-masked row: uniform weights
    attn = rng.normal(size=e).astype(np.float32)
    cot = rng.normal(size=(b, e)).astype(np.float32)
    mesh = make_mesh(data=1, model=1, ctx=2)

    def loss(c, a):
        cv, _ = jax_pool(mesh, c, jnp.asarray(mask), a)
        return jnp.sum(cv * jnp.asarray(cot))

    with jax.set_mesh(mesh) if hasattr(jax, "set_mesh") else mesh:
        cv_j, w_j = jax_pool(mesh, jnp.asarray(ctx), jnp.asarray(mask), jnp.asarray(attn))
        g_ctx, g_attn = jax.grad(loss, argnums=(0, 1))(jnp.asarray(ctx), jnp.asarray(attn))
    path = tmp_path / "pool.pt"
    torch.save({"ctx": ctx, "mask": mask, "attn": attn, "cot": cot}, path)
    results = spawn(tmp_path, "ctx_pool", 2, inputs=str(path))
    for r in results:
        np.testing.assert_allclose(r["cv"].numpy(), np.asarray(cv_j), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["d_attn"].numpy(), np.asarray(g_attn), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(torch.cat([r["w"] for r in results], 1).numpy(),
                               np.asarray(w_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(torch.cat([r["d_ctx"] for r in results], 1).numpy(),
                               np.asarray(g_ctx), rtol=1e-5, atol=1e-6)


def test_use_pallas_with_a_ctx_axis_is_rejected():
    """JAX ``build_mesh``'s rejection and message (``train/loop.py:331-343``)."""
    from code2vec_tpu.train import loop as jax_loop
    from code2vec_tpu.train.config import TrainConfig as JaxTrainConfig

    from code2vec_tpu_torch.train import loop
    from code2vec_tpu_torch.train.config import TrainConfig

    kw = dict(context_axis=2, use_pallas=True, pallas_impl="fused")
    with pytest.raises(ValueError) as port:
        loop.build_mesh(TrainConfig(**kw))
    with pytest.raises(ValueError) as ref:
        jax_loop.build_mesh(JaxTrainConfig(**kw))
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("axes", [(1, 2, 1), (2, 2, 1)], ids=["model2", "data2_model2"])
def test_shard_and_unshard_round_trip_exactly(tmp_path, axes):
    """The shards of every parameter gathered back equal the whole tensors
    bitwise; the tables and the head are halved on the model axis; Adam's
    moments after a step go global and back to the live shards exactly."""
    batches = make_batches(DIMS, n=1)
    weights = np.ones(DIMS["label_count"], np.float32)
    from code2vec_tpu_torch.models.code2vec import Code2Vec

    model = Code2Vec(Code2VecConfig(**DIMS))
    model.reset_parameters(torch.Generator().manual_seed(5))
    path = tmp_path / "rt.pt"
    torch.save({"state_dict": model.state_dict(), "batches": batches,
                "class_weights": weights}, path)
    results = spawn(tmp_path, "roundtrip", int(np.prod(axes)), axes=list(axes), model=DIMS,
                    inputs=str(path))
    for r in results:
        for k, v in r["whole"].items():
            assert torch.equal(r["back"][k], v), k
        assert r["model_exact"] and r["moments_exact"] and r["interop_exact"]
        assert r["interop_shapes"] == r["local_shapes"]
        assert r["local_shapes"]["terminal_embedding.weight"] == (32, 8)
        assert r["local_shapes"]["path_embedding.weight"] == (24, 8)
        assert r["local_shapes"]["output_linear.weight"] == (8, 16)
        assert r["local_shapes"]["output_linear.bias"] == (8,)
        assert r["local_shapes"]["input_linear.weight"] == (16, 24)
        assert r["global_moment_shapes"]["terminal_embedding.weight"] == (64, 8)
        assert r["global_moment_shapes"]["output_linear.weight"] == (16, 16)
