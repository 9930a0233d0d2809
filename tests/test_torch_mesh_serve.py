"""Retrieval, ``neighbors`` and ANN builds on gloo meshes of the CPU,
against one device and the JAX package's meshed classes.

Each rank is a subprocess of ``tests/test_torch_mesh.py``'s harness
(``spawn``: ``file://`` rendezvous, 60 s group timeout, 120 s a spawn);
every rank gets the same inputs and returns the whole answer.

- the exact index (``RetrievalIndex(mesh=)``) at ``model=2`` and
  ``model=4`` over 1,203 rows (no axis divides them), k in {1, 5, more
  than a shard's rows, n}, Q in {1, 5}: ids equal and scores within 1e-6
  of the port's one device and of JAX's ``RetrievalIndex(mesh=)``
  (``tests/test_serve.py:419``), the ranks bitwise equal; ``host_rows``
  gives the whole matrix;
- the IVF-PQ searcher on JAX's ``test_searcher_mesh_parity`` setup (1,200
  rows, dim 16, ``n_list`` 10 over ``model=4``, so cells pad, and over
  ``model=2``): ids equal and scores within atol 1e-5 of one device and of
  JAX's meshed searcher, pad slots ``-1``, the probed fraction one
  device's;
- ``kmeans_fit`` / ``assign_cells`` / ``build_index`` at ``data=2`` with
  batch 300 (the last assignment batch short, so padded): bitwise one
  device's and JAX's meshed fit (``tests/test_ann.py:75``);
- ``load_retrieval_index(mesh=)`` for both backends from files.

Where two candidates score within the tolerance of each other, their
order may differ between two computations that agree to the tolerance
(JAX's product, or the CPU's one-query product, against a shard's), so
ids are compared as sets inside such runs of near-equal scores and
exactly everywhere else.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import test_torch_mesh as harness
from code2vec_tpu.ann.index import AnnSearcher as JaxSearcher
from code2vec_tpu.ann.index import build_index as jax_build_index
from code2vec_tpu.ann.kmeans import assign_cells as jax_assign_cells
from code2vec_tpu.ann.kmeans import kmeans_fit as jax_kmeans_fit
from code2vec_tpu.parallel.mesh import make_mesh as jax_make_mesh
from code2vec_tpu.serve.retrieval import RetrievalIndex as JaxRetrievalIndex
from code2vec_tpu_torch.ann.index import AnnSearcher, IvfPqIndex, build_index, save_index
from code2vec_tpu_torch.ann.kmeans import assign_cells, kmeans_fit
from code2vec_tpu_torch.formats import vectors_io
from code2vec_tpu_torch.serve.retrieval import RetrievalIndex

FIELDS = ("centroids", "codebooks", "codes", "scales", "ids", "cell_counts")
N_EXACT, DIM = 1203, 16
QUERIES = (1, 5)
SEARCHER = {"n_probe": 4, "shortlist": 48}


def clustered_rows(n=3000, dim=16, k0=48, noise=0.15, seed=0):
    """The JAX suite's synthetic clustered corpus (tests/test_ann.py)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k0, dim)).astype(np.float32)
    member = rng.integers(0, k0, n)
    return (centers[member] + noise * rng.normal(size=(n, dim))).astype(np.float32)


def same_ranking(ids_a, scores_a, ids_b, scores_b, tol):
    """Scores within ``tol``; ids equal, as sets inside runs of scores
    within ``tol`` of their neighbour."""
    ids_a, ids_b = np.asarray(ids_a), np.asarray(ids_b)
    scores_a, scores_b = np.asarray(scores_a, np.float64), np.asarray(scores_b, np.float64)
    assert ids_a.shape == ids_b.shape
    np.testing.assert_allclose(scores_a, scores_b, rtol=0, atol=tol)
    finite = np.isfinite(scores_a)
    assert np.array_equal(finite, np.isfinite(scores_b))
    assert np.array_equal(ids_a[~finite], ids_b[~finite])  # the -inf tail: pad ids
    cut = np.flatnonzero(np.abs(np.diff(scores_a[finite])) > tol) + 1
    for run_a, run_b in zip(np.split(ids_a[finite], cut), np.split(ids_b[finite], cut)):
        assert sorted(run_a.tolist()) == sorted(run_b.tolist())


def as_pairs(result):
    """``top_k_batch``'s ``[[(label, score)]]`` -> (ids, scores) per query."""
    return [([int(lab[1:]) for lab, _ in row], [s for _, s in row]) for row in result]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_serve")
    rng = np.random.default_rng(13)
    labels = [f"m{i}" for i in range(N_EXACT)]
    rows = rng.normal(size=(N_EXACT, DIM)).astype(np.float32)
    queries = rng.normal(size=(max(QUERIES), DIM)).astype(np.float32)
    ann_rows = clustered_rows(n=1200, dim=16, k0=24)
    index, unit = jax_build_index(ann_rows, n_list=10, m=4, seed=0, kmeans_iters=6, pq_iters=4)
    ann_queries = np.random.default_rng(1).normal(size=(5, 16)).astype(np.float32)
    code_vec, ann_index = root / "code.vec", root / "ann.index"
    vectors_io.write_code_vectors_header(str(code_vec), N_EXACT, DIM)
    vectors_io.append_code_vectors(str(code_vec), labels, rows)
    ann_labels = [f"m{i}" for i in range(len(ann_rows))]
    port_index = IvfPqIndex(*(np.asarray(getattr(index, f)) for f in FIELDS),
                            meta=dict(index.meta))
    save_index(str(ann_index), port_index, unit, ann_labels,
               defaults={"n_probe": SEARCHER["n_probe"], "shortlist": SEARCHER["shortlist"]})
    data = {"labels": labels, "rows": rows, "queries": queries, "ann_rows": ann_rows,
            "ann_unit": unit, "ann_labels": ann_labels, "ann_queries": ann_queries,
            "index": {f: np.asarray(getattr(index, f)) for f in FIELDS} | {
                "meta": dict(index.meta)},
            "jax_index": index, "code_vec": str(code_vec), "ann_index": str(ann_index)}
    path = root / "inputs.pt"
    torch.save({k: v for k, v in data.items() if k != "jax_index"}, path)
    data["path"] = str(path)
    return data


def ks(model: int) -> list[int]:
    """1, 5, more than a shard's rows, and n."""
    return [1, 5, -(-N_EXACT // model) + 7, N_EXACT]


@pytest.fixture(scope="module", params=[2, 4], ids=["model2", "model4"])
def served(request, tmp_path_factory, inputs):
    model = request.param
    results = harness.spawn(tmp_path_factory.mktemp(f"serve{model}"), "serve", model,
                            axes=[1, model, 1], inputs=inputs["path"], queries=list(QUERIES),
                            ks=ks(model), searcher=SEARCHER)
    return model, results


def jax_mesh(model):
    return jax_make_mesh(data=1, model=model, ctx=1, devices=jax.devices()[:model])


def test_exact_index_on_the_mesh(served, inputs):
    model, results = served
    one = RetrievalIndex(inputs["labels"], inputs["rows"], device="cpu")
    ref = JaxRetrievalIndex(inputs["labels"], inputs["rows"], mesh=jax_mesh(model))
    for r in results[1:]:
        assert r["exact"] == results[0]["exact"]  # the ranks bitwise equal
    got = results[0]["exact"]
    for q in QUERIES:
        for k in ks(model):
            mesh_rows = as_pairs(got[(q, k)])
            assert len(mesh_rows) == q and all(len(ids) == k for ids, _ in mesh_rows)
            for want in (one.top_k_batch(inputs["queries"][:q], k),
                         ref.top_k_batch(inputs["queries"][:q], k)):
                for (ids, scores), (w_ids, w_scores) in zip(mesh_rows, as_pairs(want)):
                    same_ranking(ids, scores, w_ids, w_scores, 1e-6)
    # every real row surfaces at k = n, no pad row does
    assert sorted(as_pairs(got[(1, N_EXACT)])[0][0]) == list(range(N_EXACT))
    np.testing.assert_array_equal(results[0]["exact_rows"], one.host_rows())
    assert results[0]["exact_describe"]["model_shards"] == model


def test_searcher_on_the_mesh(served, inputs):
    """JAX's ``test_searcher_mesh_parity``: ``n_list`` 10 over the model
    axis (padded at 4), the shortlists of one device and of JAX's meshed
    searcher."""
    model, results = served
    index = IvfPqIndex(**inputs["index"])
    one = AnnSearcher(index, device="cpu", **SEARCHER)
    s1, i1 = one.search(inputs["ann_queries"])
    js, ji = JaxSearcher(inputs["jax_index"], mesh=jax_mesh(model),
                         **SEARCHER).search(inputs["ann_queries"])
    for r in results[1:]:
        for a, b in zip(r["search"], results[0]["search"]):
            np.testing.assert_array_equal(a, b)
    s, i = results[0]["search"]
    assert s.dtype == np.float32 and i.dtype == np.int32 and s.shape == (5, 48)
    for row in range(5):
        same_ranking(i[row], s[row], i1[row], s1[row], 1e-5)
        same_ranking(i[row], s[row], ji[row], js[row], 1e-5)
    # K5's plain version scores a shard's slot as it scores the whole index's
    np.testing.assert_array_equal(s, s1)
    assert results[0]["probed_fraction"] == one.probed_fraction(inputs["ann_queries"])
    desc = results[0]["search_describe"]
    assert desc["model_shards"] == model and desc["cells_per_shard"] == -(-10 // model)


def test_a_shard_short_of_the_shortlist(tmp_path, inputs):
    """n_probe 1 and a shortlist of every probed slot: each query's one
    probed cell lives on one rank, so the other ranks have no finite slot
    at all and the merged tail is ``-inf`` with id ``-1``, as on one
    device."""
    index = IvfPqIndex(**inputs["index"])
    cfg = {"n_probe": 1, "shortlist": index.meta["capacity"]}
    results = harness.spawn(tmp_path, "serve", 2, axes=[1, 2, 1], inputs=inputs["path"],
                            queries=[1], ks=[1], searcher=cfg)
    s1, i1 = AnnSearcher(index, device="cpu", **cfg).search(inputs["ann_queries"])
    s, i = results[0]["search"]
    assert np.isneginf(s).any() and (i[np.isneginf(s)] == -1).all()
    for row in range(5):
        same_ranking(i[row], s[row], i1[row], s1[row], 1e-5)


def test_load_retrieval_index_on_the_mesh(served, inputs):
    from code2vec_tpu_torch.serve.retrieval import load_retrieval_index

    _, results = served
    for backend in ("exact", "ann"):
        one = load_retrieval_index(backend, code_vec_path=inputs["code_vec"],
                                   ann_index_path=inputs["ann_index"], device="cpu")
        want = as_pairs(one.top_k_batch(inputs["ann_queries"], 10))
        for (ids, scores), (w_ids, w_scores) in zip(as_pairs(results[0][f"load_{backend}"]),
                                                    want):
            same_ranking(ids, scores, w_ids, w_scores, 1e-6)
        np.testing.assert_array_equal(results[0][f"load_{backend}_rows"], one.host_rows())


def test_build_at_data2_is_one_devices(tmp_path):
    """JAX's ``test_kmeans_mesh_parity_bitwise`` at ``data=2``: batch 300
    over 1,600 rows (so the last assignment batch is short and padded),
    and a whole ``build_index``: bitwise one device's and JAX's meshed
    fit."""
    x = clustered_rows(n=1600, dim=8, k0=12)
    rows = clustered_rows(n=1200, dim=16, k0=24)
    kw = {"k": 12, "seed": 3, "iters": 8, "batch_size": 300}
    build = {"n_list": 10, "m": 4, "seed": 0, "kmeans_iters": 6, "pq_iters": 4,
             "batch_size": 300}
    path = tmp_path / "build.pt"
    torch.save({"x": x, "rows": rows}, path)
    results = harness.spawn(tmp_path, "build", 2, axes=[2, 1, 1], inputs=str(path),
                            kmeans=kw, build=build)
    single = kmeans_fit(x, 12, seed=3, iters=8, batch_size=300, device="cpu")
    jmesh = jax_make_mesh(data=2, model=1, ctx=1, devices=jax.devices()[:2])
    jax_fit = jax_kmeans_fit(x, 12, seed=3, iters=8, batch_size=300, mesh=jmesh)
    one_index, one_unit = build_index(rows, device="cpu", **build)
    jax_index, _ = jax_build_index(rows, mesh=jmesh, **build)
    for r in results:
        np.testing.assert_array_equal(r["centroids"], single)
        np.testing.assert_array_equal(r["centroids"], jax_fit)
        np.testing.assert_array_equal(r["assign"],
                                      assign_cells(x, single, batch_size=300, device="cpu"))
        np.testing.assert_array_equal(r["assign"],
                                      jax_assign_cells(x, single, batch_size=300, mesh=jmesh))
        np.testing.assert_array_equal(r["unit"], one_unit)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(r["index"], f), getattr(one_index, f))
            np.testing.assert_array_equal(getattr(r["index"], f),
                                          np.asarray(getattr(jax_index, f)))
        assert r["index"].meta == one_index.meta
