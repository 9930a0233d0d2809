"""The port's serving slice end to end, on the CPU, against the JAX model.

A tiny model dir is written from a JAX ``Code2Vec`` initialised from a seed
(weights through the port's ``interop`` into a reference ``code2vec.model``,
plus ``model_meta.json`` and the vocab files). The port's server is built
through its own ``build_server`` (``device="cpu"``: the kernel routes run
their plain versions) and driven through ``CodeServer.handle``. Its code
vectors and top-k probabilities are held against JAX ``Code2Vec.apply``
padded to the same ladder width, followed by
``code2vec_tpu.predict.softmax_top_k``; tolerance rtol 2e-4 / atol 2e-5.
"""

import io
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from code2vec_tpu.models.code2vec import Code2Vec as JaxCode2Vec
from code2vec_tpu.models.code2vec import Code2VecConfig as JaxConfig
from code2vec_tpu.predict import softmax_top_k as jax_softmax_top_k
from code2vec_tpu_torch import interop
from code2vec_tpu_torch.formats.vocab_io import write_vocab
from code2vec_tpu_torch.models.code2vec import Code2VecConfig
from code2vec_tpu_torch.serve.__main__ import build_parser, build_server
from code2vec_tpu_torch.serve.batcher import MicroBatcher, ServeOverloaded
from code2vec_tpu_torch.serve.protocol import serve_stdio

DIMS = dict(terminal_count=50, path_count=40, label_count=9,
            terminal_embed_size=8, path_embed_size=6, encode_size=12)
BAG, LADDER = 16, (8, 16)


def make_model_dir(path, margin=False, pad=1):
    """A model dir from a seeded JAX init; returns (dir, jax model, params)."""
    jcfg = JaxConfig(**DIMS, dropout_prob=0.0, angular_margin_loss=margin,
                     vocab_pad_multiple=pad)
    jm = JaxCode2Vec(jcfg)
    ids = jnp.ones((1, BAG), jnp.int32)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(7), ids, ids, ids)["params"])
    cfg = Code2VecConfig(**DIMS, angular_margin_loss=margin, vocab_pad_multiple=pad)
    interop.save_state_dict(interop.state_dict_from_jax_params(params, cfg), str(path), cfg)
    meta = dict(DIMS, angular_margin_loss=margin, angular_margin=0.5, inverse_temp=30.0,
                vocab_pad_multiple=pad, max_path_length=BAG, infer_method_name=True,
                infer_variable_name=False, table_dtype="f32", bucket_ladder=list(LADDER))
    (path / "model_meta.json").write_text(json.dumps(meta))
    write_vocab(path / "label_vocab.txt", [(i, f"label{i}") for i in range(DIMS["label_count"])])
    # the terminal file holds count-1 names: "@question" takes index 1
    write_vocab(path / "terminal_idxs.txt",
                [(0, "<PAD/>")] + [(i, f"t{i}") for i in range(1, DIMS["terminal_count"] - 1)])
    write_vocab(path / "path_idxs.txt",
                [(0, "<PAD/>")] + [(i, f"p{i}") for i in range(1, DIMS["path_count"])])
    return path, jm, params


def server_for(path, *extra):
    args = build_parser().parse_args([
        "--model_path", str(path), "--terminal_idx_path", str(path / "terminal_idxs.txt"),
        "--path_idx_path", str(path / "path_idxs.txt"), "--device", "cpu",
        "--batch_sizes", "1,8", *extra,
    ])
    return build_server(args)


@pytest.fixture(scope="module", params=[(False, 1), (True, 4)], ids=["plain", "margin_pad4"])
def model_dir(request, tmp_path_factory):
    margin, pad = request.param
    return make_model_dir(tmp_path_factory.mktemp("model"), margin=margin, pad=pad)


@pytest.fixture
def server(model_dir):
    srv = server_for(model_dir[0])
    yield srv
    srv.close()


def bag(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([
        rng.integers(1, DIMS["terminal_count"], n),
        rng.integers(1, DIMS["path_count"], n),
        rng.integers(0, DIMS["terminal_count"], n),
    ], axis=1).astype(np.int32)


def jax_reference(jm, params, contexts):
    """JAX forward of one bag: subsampled past BAG (seeded rule of
    protocol.py:521-527), padded to its nearest ladder width."""
    if len(contexts) > BAG:
        keep = np.random.default_rng(0).choice(len(contexts), BAG, replace=False)
        contexts = contexts[np.sort(keep)]
    width = next(w for w in LADDER if len(contexts) <= w)
    ids = np.zeros((3, 1, width), np.int32)
    ids[:, 0, : len(contexts)] = contexts.T
    logits, cv, _ = jm.apply({"params": params}, *(jnp.asarray(x) for x in ids))
    return np.asarray(logits)[0], np.asarray(cv)[0], len(contexts)


class TestServeMatchesJax:
    @pytest.mark.parametrize("n", [1, 5, 8, 9, 16, 23, 40])
    def test_predict_matches_jax(self, model_dir, server, n):
        _, jm, params = model_dir
        contexts = bag(n, seed=n)
        resp = server.handle({"id": n, "op": "predict", "contexts": contexts.tolist(),
                              "top_k": 3, "include_vector": True})
        assert resp["ok"] and resp["id"] == n
        (entry,) = resp["methods"]
        logits, cv, kept = jax_reference(jm, params, contexts)
        assert entry["n_contexts"] == kept == min(n, BAG)
        np.testing.assert_allclose(entry["code_vector"], cv, rtol=2e-4, atol=2e-5)
        expect = jax_softmax_top_k(logits, DIMS["label_count"], 3)
        assert [p["name"] for p in entry["predictions"]] == [f"label{i}" for i, _ in expect]
        np.testing.assert_allclose([p["prob"] for p in entry["predictions"]],
                                   [p for _, p in expect], rtol=2e-4, atol=2e-5)

    def test_embed_returns_the_code_vector(self, model_dir, server):
        _, jm, params = model_dir
        contexts = bag(11, seed=3)
        resp = server.handle({"op": "embed", "contexts": contexts.tolist()})
        (entry,) = resp["methods"]
        assert "predictions" not in entry
        np.testing.assert_allclose(entry["code_vector"], jax_reference(jm, params, contexts)[1],
                                   rtol=2e-4, atol=2e-5)


    def test_predictor_predict_contexts_matches_the_server(self, server):
        contexts = bag(23, seed=5)
        served = server.handle({"op": "predict", "contexts": contexts.tolist(), "top_k": 3,
                                "include_vector": True})["methods"][0]
        pred = server.predictor.predict_contexts(contexts.tolist(), top_k=3)
        assert pred.n_contexts == served["n_contexts"] == BAG
        np.testing.assert_allclose(pred.code_vector, served["code_vector"], rtol=1e-6, atol=1e-7)
        assert [p.name for p in pred.predictions] == [p["name"] for p in served["predictions"]]
        weights = [row[3] for row in pred.attention]
        assert weights == sorted(weights, reverse=True)
        np.testing.assert_allclose(sum(weights), 1.0, rtol=1e-5)


class TestServeBehaviour:
    def test_coalesced_equals_one_at_a_time(self, model_dir):
        """The hot-swap gate's invariant (JAX serve/swap.py:211-245): a
        request's code vector from a micro-batch of 8 or 64 is bitwise its
        batch-1 vector, over the ladder (bags of 1-16 contexts, padded to
        the group's widest) and over the long-bag rung (17-32 contexts, K4's
        plain version). On the CPU the two rungs' plain versions are
        different formulas, so a group holds one kind; on the card K3 and
        K4 online are one kernel and chip_smoke.py mixes them."""
        srv = server_for(model_dir[0], "--deadline_ms", "40", "--batch_sizes", "1,8,64",
                         "--longbag_widths", "32")
        try:
            rng = np.random.default_rng(5)
            for lo, hi in ((1, 16), (17, 32)):
                lengths = [lo, hi] + list(rng.integers(lo, hi + 1, 62))
                bags = [bag(int(n), seed=100 + i) for i, n in enumerate(lengths)]
                singles = [srv.handle({"op": "embed", "contexts": b.tolist()})["methods"][0]
                           for b in bags]
                assert {e["timing"]["batch"] for e in singles} == {1}
                for size in (8, 64):
                    resolvers = [srv.handle_async({"op": "embed", "contexts": b.tolist()})
                                 for b in bags[:size]]
                    coalesced = [r()["methods"][0] for r in resolvers]
                    assert max(e["timing"]["batch"] for e in coalesced) == size
                    for single, entry in zip(singles, coalesced):
                        assert np.array_equal(np.asarray(entry["code_vector"], np.float32),
                                              np.asarray(single["code_vector"], np.float32))
        finally:
            srv.close()

    @pytest.mark.parametrize("row", [[50, 1, 1], [1, 40, 1], [1, 1, -1], [1, 2]])
    def test_out_of_vocab_triple_is_bad_request(self, server, row):
        resp = server.handle({"op": "predict", "contexts": [[1, 1, 1], row]})
        assert resp["error_kind"] == "bad_request"

    def test_source_request_is_an_error_response(self, server):
        # Java and Python sources are served (tests/test_torch_extract.py,
        # tests/test_torch_file_vectors.py); against this model's made-up vocab
        # every context of a Python method is OOV: an entry with an error and
        # no device work, as JAX answers it; a source that does not parse is
        # an error response of JAX's kind ("internal": a SyntaxError)
        resp = server.handle({"op": "predict", "source": "def f(a):\n    return a\n",
                              "language": "python"})
        (entry,) = resp["methods"]
        assert resp["ok"] and entry["method_name"] == "f" and entry["n_contexts"] == 0
        assert entry["n_oov"] > 0 and "OOV" in entry["error"] and "timing" not in entry
        resp = server.handle({"op": "embed", "source": "def f(:\n", "language": "python"})
        assert resp["error_kind"] == "internal" and resp["error"].startswith("SyntaxError")
        resp = server.handle({"op": "embed", "source": "def f(a):\n    return a\n",
                              "language": "cobol"})
        assert resp["error_kind"] == "bad_request" and "unknown language" in resp["error"]

    @pytest.mark.parametrize("op", ["neighbors", "reload", "rollback", "bogus"])
    def test_other_ops_are_errors(self, server, op, tmp_path):
        # neighbors is served, but this server loaded no retrieval index; a
        # reload of a dir that is not there fails its build (swap_failed)
        # and leaves the active generation serving; there is nothing to
        # roll back to before a swap
        version = server.version
        request = {"op": op}
        if op == "reload":
            request.update(model_path=str(tmp_path / "missing"), wait=True)
        resp = server.handle(request)
        assert resp["error_kind"] == ("swap_failed" if op == "reload" else "bad_request")
        assert server.version == version
        if op == "reload":
            assert resp["swap"]["last_swap"]["outcome"] == "failed"
            assert resp["swap"]["active_version"] == version

    def test_health_after_traffic(self, server):
        for n in (1, 9, 16, 30):
            assert server.handle({"op": "embed", "contexts": bag(n, n).tolist()})["ok"]
        health = server.handle({"op": "health"})
        assert health["post_warmup_compiles"] == 0
        assert health["executables"] == len(LADDER) * 2
        assert health["ladder"] == list(LADDER) and health["device"] == "cpu"
        assert health["kernel_route"] == "fused"

    def test_stdio_transport_keeps_order(self, model_dir):
        srv = server_for(model_dir[0])
        lines = [json.dumps({"id": i, "op": "embed", "contexts": bag(i + 1, i).tolist()})
                 for i in range(5)]
        lines += ["not json", json.dumps({"id": 9, "op": "health"}),
                  json.dumps({"id": 10, "op": "shutdown"})]
        out = io.StringIO()
        serve_stdio(srv, io.StringIO("\n".join(lines) + "\n"), out)
        responses = [json.loads(x) for x in out.getvalue().splitlines()]
        assert [r.get("id") for r in responses] == [0, 1, 2, 3, 4, None, 9, 10]
        assert responses[5]["error_kind"] == "bad_request"
        assert responses[6]["post_warmup_compiles"] == 0

    def test_full_queue_sheds(self):
        release = threading.Event()

        class SlowEngine:
            batch_sizes, max_width = (1,), 4

            def pad_requests(self, contexts):
                release.wait(10)
                z = np.zeros((1, 4), np.int32)
                return z, z, z, 1, 4

            def run(self, s, p, e):
                return np.zeros((1, 3)), np.zeros((1, 2)), np.zeros((1, 4))

        batcher = MicroBatcher(SlowEngine(), deadline_ms=0, max_pending=1)
        try:
            first = batcher.submit([[1, 1, 1]])
            with pytest.raises(ServeOverloaded):
                for _ in range(4):
                    batcher.submit([[1, 1, 1]])
        finally:
            release.set()
            batcher.close()
        assert first.result(timeout=5).coalesced == 1
