"""The port's retrieval path against the JAX package's, on the CPU.

- K5's plain version (``lut_score_cells_reference``, what the port's
  wrapper runs for CPU tensors) against ``xla_lut_score_cells`` and the TPU
  kernel ``pallas_lut_score_cells(interpret=True)``: atol 1e-5 with
  identical ``-inf`` masks (the JAX suite's bar, tests/test_ann.py:134-155);
- the index container and ``code.vec`` written by one package and read by
  the other, both ways;
- k-means: the seeding, the fit and ``assign_cells`` against the JAX
  package's (on the CPU the port's float64 D² updates and f32 argmin come
  out bitwise equal; on the card argmin near-ties may flip, so building
  is also held by its properties: every row in one cell, recall@10 >= 0.95
  at a pinned n_probe on the JAX suite's corpus);
- the port's ``AnnSearcher`` on a JAX-built index against the JAX
  searcher: equal shortlists as id sets (``torch.topk`` and ``lax.top_k``
  may order equal values differently, so ids tied at the cut are compared
  by count);
- the exact backend against numpy normalize -> matmul -> argsort;
- the ``neighbors`` op: the same requests through the JAX and the port
  ``CodeServer`` (both over the same stub engine) give the same responses,
  on both backends, in the ``vector`` and ``contexts`` forms.
"""

import json
from concurrent.futures import Future
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from code2vec_tpu.ann import pq as jax_pq
from code2vec_tpu.ann.index import AnnSearcher as JaxSearcher
from code2vec_tpu.ann.index import build_index as jax_build_index
from code2vec_tpu.ann.index import load_index as jax_load_index
from code2vec_tpu.ann.index import save_index as jax_save_index
from code2vec_tpu.ann.kmeans import assign_cells as jax_assign_cells
from code2vec_tpu.ann.kmeans import kmeans_fit as jax_kmeans_fit
from code2vec_tpu.ann.kmeans import kmeans_pp_init as jax_kmeans_pp_init
from code2vec_tpu.ann.lut_kernel import pallas_lut_score_cells, xla_lut_score_cells
from code2vec_tpu.formats import vectors_io as jax_vectors_io
from code2vec_tpu.serve import retrieval as jax_retrieval
from code2vec_tpu.serve.protocol import CodeServer as JaxCodeServer
from code2vec_tpu_torch.ann import pq
from code2vec_tpu_torch.ann.index import (
    AnnSearcher,
    IvfPqIndex,
    build_index,
    load_index,
    normalize_rows,
    save_index,
)
from code2vec_tpu_torch.ann.kmeans import assign_cells, kmeans_fit, kmeans_pp_init
from code2vec_tpu_torch.ann.lut_kernel import lut_score_cells, lut_score_cells_reference
from code2vec_tpu_torch.formats import vectors_io
from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts
from code2vec_tpu_torch.serve import retrieval
from code2vec_tpu_torch.serve.protocol import CodeServer

CPU = "cpu"


def clustered_rows(n=3000, dim=16, k0=48, noise=0.15, seed=0):
    """The JAX suite's synthetic clustered corpus (tests/test_ann.py)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k0, dim)).astype(np.float32)
    member = rng.integers(0, k0, n)
    return (centers[member] + noise * rng.normal(size=(n, dim))).astype(np.float32)


@pytest.fixture(scope="module")
def jax_index():
    rows = clustered_rows(n=1200, dim=16, k0=24)
    index, unit = jax_build_index(rows, n_list=10, m=4, seed=0, kmeans_iters=6, pq_iters=4)
    return rows, index, unit


# ---------------------------------------------------------------------------
# K5's plain version
# ---------------------------------------------------------------------------


def lut_inputs(q, m, n_list, cap, n_probe, seed=0):
    rng = np.random.default_rng(seed)
    lut = rng.normal(size=(q, m, 256)).astype(np.float32)
    probed = rng.integers(0, n_list, (q, n_probe)).astype(np.int32)
    codes = rng.integers(0, 256, (n_list, cap, m)).astype(np.uint8)
    scales = rng.random((n_list, cap)).astype(np.float32)
    bias = np.zeros((n_list, cap), np.float32)
    bias[:, cap - cap // 4:] = -np.inf  # pad slots
    scales[:, cap - cap // 4:] = 0.0
    return lut, probed, codes, scales, bias


def same_scores(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.array_equal(np.isneginf(got), np.isneginf(ref))
    finite = np.isfinite(ref)
    np.testing.assert_allclose(got[finite], ref[finite], atol=1e-5, rtol=0)


@pytest.mark.parametrize("q,m,n_list,cap,n_probe", [
    (1, 8, 6, 128, 1), (3, 4, 10, 256, 5), (4, 20, 7, 128, 3), (2, 6, 5, 384, 4),
])
def test_lut_plain_version_matches_jax(q, m, n_list, cap, n_probe):
    inp = lut_inputs(q, m, n_list, cap, n_probe, seed=q * m)
    ref_xla = xla_lut_score_cells(*inp)
    ref_tpu = pallas_lut_score_cells(*inp, interpret=True)
    reset_launch_counts()
    got = lut_score_cells(*(torch.from_numpy(x) for x in inp))
    assert launch_counts() == {}  # CPU tensors: the plain version, no kernel
    assert torch.equal(got, lut_score_cells_reference(*(torch.from_numpy(x) for x in inp)))
    same_scores(got, ref_xla)
    same_scores(got, ref_tpu)


def test_lut_pinned_cuda_on_cpu_tensors_raises():
    inp = [torch.from_numpy(x) for x in lut_inputs(1, 4, 3, 128, 2)]
    with pytest.raises(ValueError, match="pinned"):
        lut_score_cells(*inp, backend="cuda")


# ---------------------------------------------------------------------------
# files: the index container and code.vec, both ways
# ---------------------------------------------------------------------------


FIELDS = ("centroids", "codebooks", "codes", "scales", "ids", "cell_counts")


def assert_same_container(a, b):
    (ia, ra, la), (ib, rb, lb) = a, b
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(ia, f)), np.asarray(getattr(ib, f)))
    np.testing.assert_array_equal(np.asarray(ra), np.asarray(rb))
    assert la == lb and ia.meta == ib.meta


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_container_interchanges(jax_index, tmp_path, writer):
    _, index, unit = jax_index
    labels = [f"m{i}_é" for i in range(unit.shape[0])]
    defaults = {"n_probe": 4, "shortlist": 64}
    jax_path, port_path = tmp_path / "jax.index", tmp_path / "port.index"
    jax_save_index(str(jax_path), index, unit, labels, defaults=defaults)
    save_index(str(port_path), IvfPqIndex(*(getattr(index, f) for f in FIELDS),
                                          meta=dict(index.meta)), unit, labels, defaults=defaults)
    assert jax_path.read_bytes() == port_path.read_bytes()
    path = jax_path if writer == "jax" else port_path
    assert_same_container(load_index(str(path)), jax_load_index(str(path)))
    assert load_index(str(path))[0].meta["defaults"] == defaults


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_code_vec_interchanges(tmp_path, writer):
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(7, 5)).astype(np.float32)
    names = [f"name{i}" for i in range(7)]
    paths = {}
    for who, mod in (("jax", jax_vectors_io), ("port", vectors_io)):
        paths[who] = tmp_path / f"{who}.vec"
        mod.write_code_vectors_header(str(paths[who]), 7, 5)
        mod.append_code_vectors(str(paths[who]), names, vecs)
    assert paths["jax"].read_bytes() == paths["port"].read_bytes()
    labels_p, rows_p = vectors_io.read_code_vectors(str(paths[writer]))
    labels_j, rows_j = jax_vectors_io.read_code_vectors(str(paths[writer]))
    assert labels_p == labels_j == names
    np.testing.assert_array_equal(rows_p, rows_j)
    np.testing.assert_array_equal(rows_p, vecs)


# ---------------------------------------------------------------------------
# building: k-means, PQ, the index
# ---------------------------------------------------------------------------


class TestBuild:
    def test_kmeans_pp_init_equals_jax(self):
        x = clustered_rows(n=1500, dim=8, k0=16)
        np.testing.assert_array_equal(
            kmeans_pp_init(x, 16, np.random.default_rng(3), CPU),
            jax_kmeans_pp_init(x, 16, np.random.default_rng(3)),
        )

    def test_kmeans_fit_equals_jax_and_is_seeded(self):
        x = clustered_rows(n=1500, dim=8, k0=16)
        a = kmeans_fit(x, 16, seed=7, iters=10, batch_size=512, device=CPU)
        np.testing.assert_array_equal(a, jax_kmeans_fit(x, 16, seed=7, iters=10, batch_size=512))
        np.testing.assert_array_equal(a, kmeans_fit(x, 16, seed=7, iters=10, batch_size=512,
                                                    device=CPU))
        assert not np.array_equal(a, kmeans_fit(x, 16, seed=8, iters=10, batch_size=512,
                                                device=CPU))

    def test_assign_cells_equals_jax(self, jax_index):
        rows, index, unit = jax_index
        np.testing.assert_array_equal(assign_cells(unit, index.centroids, device=CPU),
                                      jax_assign_cells(unit, index.centroids))
        np.testing.assert_array_equal(
            assign_cells(unit, index.centroids, batch_size=100, device=CPU),
            jax_assign_cells(unit, index.centroids))

    def test_pq_matches_jax_and_round_trips(self):
        rng = np.random.default_rng(1)
        residuals = rng.normal(size=(600, 8)).astype(np.float32) * 0.2
        residuals[::7] = 0.0
        cb, sc = pq.train_codebooks(residuals, 4, seed=0, iters=5, device=CPU)
        cb_j, sc_j = jax_pq.train_codebooks(residuals, 4, seed=0, iters=5)
        np.testing.assert_array_equal(sc, sc_j)
        np.testing.assert_array_equal(cb, cb_j)
        codes = pq.encode(residuals, cb, sc, device=CPU)
        np.testing.assert_array_equal(codes, jax_pq.encode(residuals, cb_j, sc_j))
        decoded = pq.decode(codes, cb, sc)
        np.testing.assert_array_equal(decoded, jax_pq.decode(codes, cb, sc))
        assert np.all(decoded[::7] == 0.0) and np.all(sc[::7] == 0.0)
        assert np.all(np.abs(decoded) <= sc[:, None] + 1e-6)

    def test_every_row_lands_in_exactly_one_cell(self):
        index, _ = build_index(clustered_rows(n=500, dim=8, k0=10), n_list=6, m=4,
                               kmeans_iters=5, pq_iters=4, device=CPU)
        real = index.ids[index.ids >= 0]
        assert sorted(real.tolist()) == list(range(500))
        assert int(index.cell_counts.sum()) == 500
        assert index.codes.shape[1] % 128 == 0

    def test_recall_at_pinned_n_probe(self):
        """The JAX suite's bar on its corpus: recall@10 >= 0.95."""
        rows = clustered_rows(n=4000, dim=16, k0=64)
        index, unit = build_index(rows, n_list=32, m=4, seed=0, kmeans_iters=10, pq_iters=8,
                                  device=CPU)
        searcher = AnnSearcher(index, n_probe=8, shortlist=100, device=CPU)
        rng = np.random.default_rng(5)
        queries = rows[rng.integers(0, 4000, 25)] + 0.05 * rng.normal(size=(25, 16)).astype(
            np.float32)
        qn = normalize_rows(queries)
        truth = np.argsort(-(qn @ unit.T), axis=1)[:, :10]
        _, ids = searcher.search(queries)
        recall = 0.0
        for i in range(25):
            valid = ids[i][ids[i] >= 0]
            top10 = valid[np.argsort(-(unit[valid] @ qn[i]))][:10]
            recall += len(set(top10.tolist()) & set(truth[i].tolist())) / 10
        assert recall / 25 >= 0.95


# ---------------------------------------------------------------------------
# searching
# ---------------------------------------------------------------------------


def same_shortlist(scores_a, ids_a, scores_b, ids_b):
    """Equal as id sets: every id scoring above the cut is in both; ids
    tied at the cut may differ but not in number."""
    for sa, ia, sb, ib in zip(scores_a, ids_a, scores_b, ids_b):
        fa, fb = np.isfinite(sa), np.isfinite(sb)
        assert fa.sum() == fb.sum()
        if not fa.any():
            continue
        cut = sa[fa].min()
        above_a = set(ia[fa & (sa > cut + 1e-5)].tolist())
        above_b = set(ib[fb & (sb > cut + 1e-5)].tolist())
        assert above_a == above_b
        np.testing.assert_allclose(np.sort(sa[fa]), np.sort(sb[fb]), atol=1e-5, rtol=0)


class TestSearch:
    @pytest.mark.parametrize("n_probe,shortlist", [(1, 16), (4, 48), (10, 200)])
    def test_shortlist_equals_jax_searcher(self, jax_index, n_probe, shortlist):
        rows, index, _ = jax_index
        q = np.concatenate([rows[:3] + 0.01, np.random.default_rng(1).normal(
            size=(4, 16)).astype(np.float32)])
        ours = AnnSearcher(index, n_probe=n_probe, shortlist=shortlist, device=CPU)
        theirs = JaxSearcher(index, n_probe=n_probe, shortlist=shortlist)
        assert (ours.n_probe, ours.shortlist) == (theirs.n_probe, theirs.shortlist)
        same_shortlist(*ours.search(q), *theirs.search(q))
        assert ours.probed_fraction(q) == pytest.approx(theirs.probed_fraction(q), abs=1e-12)

    def test_query_buckets_are_powers_of_two(self, jax_index):
        _, index, _ = jax_index
        searcher = AnnSearcher(index, n_probe=4, shortlist=32, device=CPU)
        rng = np.random.default_rng(0)
        for q in (1, 3, 5, 2, 8, 1, 7):
            searcher.search(rng.normal(size=(q, 16)).astype(np.float32))
        assert searcher._cache_size() == 4  # buckets {1, 2, 4, 8}

    def test_empty_cells_are_never_probed(self):
        dim, cap = 8, 128
        centroids = np.zeros((2, dim), np.float32)
        centroids[0, 0] = 1.0  # empty cell, dead-on the query direction
        centroids[1, 1] = 1.0
        ids = np.full((2, cap), -1, np.int32)
        ids[1, :3] = np.arange(3)
        scales = np.zeros((2, cap), np.float32)
        scales[1, :3] = 1.0
        index = IvfPqIndex(
            centroids=centroids, codebooks=np.zeros((2, 256, 4), np.float32),
            codes=np.zeros((2, cap, 2), np.uint8), scales=scales, ids=ids,
            cell_counts=np.array([0, 3], np.int32),
            meta={"version": 1, "n": 3, "dim": dim, "n_list": 2, "m": 2, "dsub": 4,
                  "capacity": cap, "seed": 0},
        )
        searcher = AnnSearcher(index, n_probe=2, shortlist=3, device=CPU)
        assert searcher.n_probe == 1  # clamped to the non-empty cells
        q = np.zeros((1, dim), np.float32)
        q[0, 0] = 1.0
        assert searcher.probed_fraction(q) == 1.0
        _, got = searcher.search(q)
        assert sorted(got[0].tolist()) == [0, 1, 2]

    def test_exact_ranking_equals_numpy(self):
        rng = np.random.default_rng(2)
        rows = rng.normal(size=(300, 12)).astype(np.float32)
        labels = [f"r{i}" for i in range(300)]
        index = retrieval.RetrievalIndex(labels, rows, device=CPU)
        q = rng.normal(size=(5, 12)).astype(np.float32)
        unit = rows / np.linalg.norm(rows, axis=1, keepdims=True)
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        order = np.argsort(-(qn @ unit.T), axis=1)[:, :7]
        got = index.top_k_batch(q, 7)
        jax_got = jax_retrieval.RetrievalIndex(labels, rows).top_k_batch(q, 7)
        for r in range(5):
            assert [n for n, _ in got[r]] == [labels[i] for i in order[r]]
            assert [n for n, _ in got[r]] == [n for n, _ in jax_got[r]]
            np.testing.assert_allclose([s for _, s in got[r]], [s for _, s in jax_got[r]],
                                       atol=1e-6)
        assert index.top_k(q[0], 500)[0][0] == got[0][0][0]  # k capped at N
        assert index.describe()["query_executables"] == 2

    def test_load_retrieval_index_dispatch(self, jax_index, tmp_path):
        _, index, unit = jax_index
        with pytest.raises(ValueError, match="ann_index_path"):
            retrieval.load_retrieval_index("ann", device=CPU)
        with pytest.raises(ValueError, match="code_vec_path"):
            retrieval.load_retrieval_index("exact", device=CPU)
        with pytest.raises(ValueError, match="retrieval_backend"):
            retrieval.load_retrieval_index("fuzzy", device=CPU)
        path = tmp_path / "ann.index"
        jax_save_index(str(path), index, unit, [f"m{i}" for i in range(len(unit))],
                       defaults={"n_probe": 6, "shortlist": 64})
        ann = retrieval.load_retrieval_index("ann", ann_index_path=str(path), n_probe=3,
                                             device=CPU)
        assert (ann.searcher.n_probe, ann.searcher.shortlist) == (3, 64)
        desc = ann.describe()
        assert desc["backend"] == "ann" and desc["index_path"] == str(path)


# ---------------------------------------------------------------------------
# the neighbors op, JAX server and port server over the same stubs
# ---------------------------------------------------------------------------


class StubBatcher:
    """Embeds a bag as a fixed function of its ids (the code vector is the
    same for both servers, so their neighbors must be too)."""

    def __init__(self, dim):
        self.dim = dim

    def submit(self, arr):
        arr = np.asarray(arr, np.int64)
        vec = np.cos(np.arange(self.dim) * 0.37 + arr.sum() * 0.01).astype(np.float32)
        fut = Future()
        fut.set_result(SimpleNamespace(
            logits=np.zeros(3, np.float32), code_vector=vec, queue_wait_ms=0.0,
            device_ms=0.0, coalesced=1, batch=1, width=8,
        ))
        return fut

    def close(self):
        pass


def servers(jax_backend, port_backend, dim):
    meta = {"terminal_count": 50, "path_count": 40}
    stub = dict(predictor=SimpleNamespace(meta=meta, label_vocab=None),
                engine=SimpleNamespace(max_width=16), batcher=StubBatcher(dim))
    return (JaxCodeServer(retrieval=jax_backend, **stub),
            CodeServer(retrieval=port_backend, **stub))


def strip_timing(resp):
    resp = json.loads(json.dumps(resp))
    for entry in resp.get("methods", []):
        entry.pop("timing")
    return resp


def schema(obj):
    if isinstance(obj, dict):
        return {k: schema(v) for k, v in sorted(obj.items())}
    if isinstance(obj, list):
        return [schema(v) for v in obj]
    return type(obj).__name__


@pytest.fixture(scope="module")
def backends(jax_index, tmp_path_factory):
    rows, index, unit = jax_index
    labels = [f"m{i}" for i in range(len(unit))]
    path = tmp_path_factory.mktemp("ann") / "ann.index"
    jax_save_index(str(path), index, unit, labels, defaults={"n_probe": 10, "shortlist": 64})
    return {
        "exact": (jax_retrieval.RetrievalIndex(labels, rows),
                  retrieval.RetrievalIndex(labels, rows, device=CPU)),
        # every cell probed: the ann shortlist covers the whole index, so
        # both re-ranks return the exact answer
        "ann": (jax_retrieval.AnnRetrievalIndex.from_container(str(path)),
                retrieval.AnnRetrievalIndex.from_container(str(path), device=CPU)),
    }


class TestNeighborsOp:
    @pytest.mark.parametrize("form", ["vector", "contexts"])
    @pytest.mark.parametrize("backend", ["exact", "ann"])
    def test_response_equals_jax(self, jax_index, backends, backend, form):
        rows = jax_index[0]
        jax_srv, port_srv = servers(*backends[backend], dim=16)
        for include_vector in (False, True):
            req = {"id": 3, "op": "neighbors", "top_k": 5, "include_vector": include_vector}
            if form == "vector":
                req["vector"] = rows[17].tolist()
            else:
                req["contexts"] = [[1, 2, 3], [4, 5, 6]]
            a, b = strip_timing(jax_srv.handle(req)), strip_timing(port_srv.handle(req))
            assert a["ok"] and b["ok"]
            assert schema(a) == schema(b)
            assert [n["name"] for n in _neighbors(a)] == [n["name"] for n in _neighbors(b)]
            np.testing.assert_allclose([n["similarity"] for n in _neighbors(a)],
                                       [n["similarity"] for n in _neighbors(b)], atol=1e-5)
        if form == "vector":
            assert _neighbors(b)[0]["name"] == "m17"

    def test_topk_beyond_the_shortlist_is_rejected(self, backends):
        port_ann = backends["ann"][1]
        with pytest.raises(ValueError, match="shortlist"):
            port_ann.top_k(np.ones(16, np.float32), 100)
        _, srv = servers(*backends["ann"], dim=16)
        resp = srv.handle({"op": "neighbors", "vector": [1.0] * 16, "top_k": 100})
        assert resp["error_kind"] == "bad_request" and "shortlist" in resp["error"]

    @pytest.mark.parametrize("req,kind", [
        ({"vector": [1.0] * 3}, "bad_request"),
        ({"vector": [1.0] * 16, "granularity": "class"}, "bad_request"),
        ({"contexts": [[1, 2, 3]], "granularity": "file"}, "not_implemented"),
        ({"source": "class A { void f() {} }"}, "not_implemented"),
    ])
    def test_bad_and_unported_forms(self, backends, req, kind):
        _, srv = servers(*backends["exact"], dim=16)
        assert srv.handle({"op": "neighbors", **req})["error_kind"] == kind


def _neighbors(resp):
    return resp["neighbors"] if "neighbors" in resp else resp["methods"][0]["neighbors"]


def test_server_cli_loads_both_backends(tmp_path, jax_index):
    """``--code_vec_path`` (exact) and ``--retrieval_backend ann`` through
    the port's own ``build_server``; health carries the retrieval block."""
    from tests.test_torch_serve import make_model_dir, server_for

    model_dir, _, _ = make_model_dir(tmp_path)
    _, index, unit = jax_index
    labels = [f"m{i}" for i in range(len(unit))]
    vectors_io.write_code_vectors_header(str(model_dir / "code.vec"), len(unit), 16)
    vectors_io.append_code_vectors(str(model_dir / "code.vec"), labels, unit)
    save_index(str(model_dir / "ann.index"), index, unit, labels,
               defaults={"n_probe": 4, "shortlist": 32})
    for extra, backend in (((), "exact"), (("--retrieval_backend", "ann", "--ann_n_probe", "2"),
                                           "ann")):
        srv = server_for(model_dir, *extra)
        try:
            health = srv.handle({"op": "health"})
            assert health["retrieval"]["backend"] == backend
            assert health["retrieval"]["size"] == len(unit)
            resp = srv.handle({"op": "neighbors", "vector": unit[5].tolist(), "top_k": 3})
            assert resp["neighbors"][0]["name"] == "m5"
        finally:
            srv.close()
    assert health["retrieval"]["n_probe"] == 2
