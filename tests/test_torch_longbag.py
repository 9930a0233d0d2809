"""The port's long-bag path against the JAX package's, on the CPU.

K4's plain version (``streamed_reference_forward``, what the port's wrapper
runs for CPU tensors in a chunked softmax mode) is held against the JAX
fused op in ``online`` / ``two_pass`` mode with ``interpret=True``, so the
TPU kernel's own streamed recurrence runs (off-TPU the JAX wrapper would
otherwise rewrite a chunked mode to ``materialize``). Then the layers
above it: the model's long-bag dispatch against the JAX model's
``_resolve_kernel`` and forward, ``derive_longbag_ladder``, and a server
with long-bag rungs answering a 700-context request through a 1024 rung.

Tolerance rtol = atol = 2e-5, the JAX long-bag suite's bar
(tests/test_longbag.py:48-60). The JAX fused op runs under the GSPMD
partitioner (Shardy rejects its ``custom_partitioning``; ROADMAP §C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu.data.pipeline import derive_longbag_ladder as jax_longbag_ladder
from code2vec_tpu.models.code2vec import Code2Vec as JaxCode2Vec
from code2vec_tpu.models.code2vec import Code2VecConfig as JaxConfig
from code2vec_tpu.ops.fused_encode_pool import fused_encode_attend_pool as jax_fused
from code2vec_tpu_torch import interop
from code2vec_tpu_torch.data.pipeline import derive_longbag_ladder
from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig
from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts
from code2vec_tpu_torch.ops.fused_encode_pool import (
    fused_encode_attend_pool,
    kernel_name,
    reference_forward,
    stream_ctas,
    streamed_reference_forward,
)
from tests.test_torch_ops import gspmd, jax_args, op_inputs, port_args
from tests.test_torch_serve import DIMS as SERVE_DIMS
from tests.test_torch_serve import bag, make_model_dir, server_for

TOL = 2e-5


def close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=TOL, atol=TOL)


def jax_streamed(inp, table_dtype, mode, chunk_l):
    with gspmd():
        return jax_fused(*jax_args(inp, table_dtype), impl="fused", softmax_mode=mode,
                         chunk_l=chunk_l, block_b=4, interpret=True)


class TestStreamedPlainVersion:
    @pytest.mark.parametrize("L", [1, 37, 300, 700])
    @pytest.mark.parametrize("chunk_l", [64, 128])
    @pytest.mark.parametrize("mode", ["online", "two_pass"])
    def test_matches_jax_kernel(self, mode, chunk_l, L):
        # op_inputs: PAD tails, and the last row all-PAD
        inp = op_inputs(B=3, L=L, seed=L + chunk_l)
        cv_j, w_j = jax_streamed(inp, "f32", mode, chunk_l)
        cv, w = streamed_reference_forward(*port_args(inp, "f32"), softmax_mode=mode,
                                           chunk_l=chunk_l)
        close(cv, cv_j)
        close(w, w_j)

    @pytest.mark.parametrize("mode", ["online", "two_pass"])
    def test_all_masked_row_is_uniform(self, mode):
        inp = op_inputs(B=4, L=150, seed=5)
        inp["mask"][1] = 0.0  # masked by the caller although its ids are real
        cv_j, w_j = jax_streamed(inp, "f32", mode, 64)
        cv, w = streamed_reference_forward(*port_args(inp, "f32"), softmax_mode=mode,
                                           chunk_l=64)
        close(cv, cv_j)
        close(w, w_j)
        for row in (1, 3):
            np.testing.assert_allclose(w[row].numpy(), np.full(150, 1 / 150), rtol=1e-6)

    @pytest.mark.parametrize("table_dtype", ["bf16", "int8"])
    @pytest.mark.parametrize("mode", ["online", "two_pass"])
    def test_quantized_tables(self, mode, table_dtype):
        inp = op_inputs(B=3, L=300, seed=11)
        cv_j, w_j = jax_streamed(inp, table_dtype, mode, 128)
        cv, w = streamed_reference_forward(*port_args(inp, table_dtype), softmax_mode=mode,
                                           chunk_l=128)
        close(cv, cv_j)
        close(w, w_j)

    @pytest.mark.parametrize("mode", ["online", "two_pass"])
    def test_cpu_wrapper_runs_the_streamed_plain_version(self, mode):
        args = port_args(op_inputs(B=3, L=300, seed=2), "f32")
        reset_launch_counts()
        cv, w = fused_encode_attend_pool(*args, softmax_mode=mode, chunk_l=64)
        cv_s, w_s = streamed_reference_forward(*args, softmax_mode=mode, chunk_l=64)
        assert torch.equal(cv, cv_s) and torch.equal(w, w_s)
        assert launch_counts() == {}
        cv_m, w_m = reference_forward(*args)
        close(cv, cv_m)
        close(w, w_m)

    def test_chunked_mode_needs_the_fused_impl(self):
        args = port_args(op_inputs(), "f32")
        with pytest.raises(ValueError, match="impl='fused'"):
            fused_encode_attend_pool(*args, impl="gather_split", softmax_mode="online")

    @pytest.mark.parametrize("kw", [{"softmax_mode": "flash"}, {"chunk_l": 0}])
    def test_bad_mode_or_chunk_fails_loudly(self, kw):
        with pytest.raises(ValueError):
            fused_encode_attend_pool(*port_args(op_inputs(), "f32"), **kw)

    def test_kernel_names_and_cta_rule(self):
        assert kernel_name("fused", "int8", "two_pass") == "two_pass_int8"
        assert kernel_name("fused", "bf16") == "fused_bf16"
        assert kernel_name("gather_split", "f32", "online") == "gather_split"
        # CTAs per row: from B and the SM count, capped by the bag's chunks
        assert stream_ctas(64, 2048, 132) == stream_ctas(64, 4096, 132) == 5
        assert stream_ctas(1, 33, 132) == 2
        assert stream_ctas(1, 10**6, 132) == 264


# ---------------------------------------------------------------------------
# the model's long-bag dispatch
# ---------------------------------------------------------------------------

DIMS = dict(terminal_count=50, path_count=40, label_count=9,
            terminal_embed_size=8, path_embed_size=6, encode_size=12)


def ids(B, L, seed):
    rng = np.random.default_rng(seed)
    out = [rng.integers(1, DIMS["terminal_count"], (B, L)).astype(np.int32),
           rng.integers(1, DIMS["path_count"], (B, L)).astype(np.int32),
           rng.integers(0, DIMS["terminal_count"], (B, L)).astype(np.int32)]
    for i, n in enumerate(rng.integers(1, L + 1, B)):
        for x in out:
            x[i, n:] = 0
    for x in out:
        x[-1] = 0
    return out


class TestModelDispatch:
    @pytest.mark.parametrize("width", [64, 200, 201, 512])
    @pytest.mark.parametrize("softmax", ["auto", "materialize", "online", "two_pass"])
    @pytest.mark.parametrize("impl", ["pool_only", "gather_split", "fused"])
    def test_resolve_kernel_matches_jax(self, impl, softmax, width):
        kw = dict(DIMS, use_pallas=True, pallas_impl=impl, pallas_softmax=softmax,
                  longbag_width=200)
        _, sched = JaxCode2Vec(JaxConfig(**kw))._resolve_kernel(2, width)
        assert Code2Vec(Code2VecConfig(**kw)).resolve_kernel(width) == (sched.impl,
                                                                        sched.softmax)

    @pytest.mark.parametrize("softmax", ["auto", "two_pass"])
    def test_longbag_forward_matches_jax(self, softmax):
        """Width 512 above longbag_width 200: both models stream the
        softmax (JAX: the TPU kernel under the interpreter; port: K4's
        plain version), on weights carried across by interop."""
        kw = dict(DIMS, dropout_prob=0.0, use_pallas=True, pallas_impl="fused",
                  pallas_softmax=softmax, longbag_width=200)
        jm = JaxCode2Vec(JaxConfig(**kw, pallas_backend="interpret"))
        s, p, e = ids(3, 512, seed=1)
        with gspmd():
            params = jm.init(jax.random.PRNGKey(5), *(jnp.asarray(x) for x in (s, p, e)))
            out_j = jm.apply(params, *(jnp.asarray(x) for x in (s, p, e)))
        cfg = Code2VecConfig(**kw)
        model = Code2Vec(cfg)
        params = jax.tree.map(np.asarray, params["params"])
        model.load_state_dict(interop.state_dict_from_jax_params(params, cfg), strict=True)
        assert model.resolve_kernel(512) == ("fused", "online" if softmax == "auto" else softmax)
        with torch.no_grad():
            out_t = model.eval()(*(torch.from_numpy(x) for x in (s, p, e)))
        for a, b in zip(out_t, out_j):
            close(a.numpy(), b)


@pytest.mark.parametrize("seed", range(6))
def test_derive_longbag_ladder_matches_jax(seed):
    rng = np.random.default_rng(seed)
    lengths = np.unique(rng.integers(1, rng.choice([150, 900, 5000]), 40))
    weights = rng.integers(0, 4, lengths.shape[0])
    base = int(rng.choice([100, 200]))
    for chunk_l, max_rungs in ((128, 4), (64, 2), (100, 3)):
        assert derive_longbag_ladder(lengths, weights, base, chunk_l, max_rungs) == \
            jax_longbag_ladder(lengths, weights, base, chunk_l, max_rungs)


# ---------------------------------------------------------------------------
# serving long bags
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return make_model_dir(tmp_path_factory.mktemp("longbag_model"))


def jax_longbag_forward(params, contexts, width, base):
    """The JAX model at a long-bag width: fused kernel, streamed softmax,
    TPU formulation under the interpreter."""
    cfg = JaxConfig(**SERVE_DIMS, dropout_prob=0.0, use_pallas=True, pallas_impl="fused",
                    pallas_backend="interpret", longbag_width=base)
    x = np.zeros((3, 1, width), np.int32)
    x[:, 0, : len(contexts)] = contexts.T
    with gspmd():
        logits, cv, _ = JaxCode2Vec(cfg).apply({"params": params}, *(jnp.asarray(a) for a in x))
    return np.asarray(logits)[0], np.asarray(cv)[0]


class TestServeLongBags:
    def test_700_contexts_through_the_1024_rung(self, model_dir):
        path, _, params = model_dir
        srv = server_for(path, "--longbag_widths", "64,1024")
        try:
            assert srv.engine.ladder == (8, 16, 64, 1024)
            assert (srv.engine.base_width, srv.engine.max_width) == (16, 1024)
            assert srv.predictor.config.longbag_width == 16
            contexts = bag(700, seed=4)
            resp = srv.handle({"op": "predict", "contexts": contexts.tolist(), "top_k": 3,
                               "include_vector": True})
            (entry,) = resp["methods"]
            assert entry["n_contexts"] == 700 and entry["timing"]["width"] == 1024
            logits, cv = jax_longbag_forward(params, contexts, 1024, 16)
            close(entry["code_vector"], cv)
            from code2vec_tpu.predict import softmax_top_k as jax_top_k

            expect = jax_top_k(logits, SERVE_DIMS["label_count"], 3)
            assert [p["name"] for p in entry["predictions"]] == [f"label{i}" for i, _ in expect]
            health = srv.handle({"op": "health"})
            assert health["post_warmup_compiles"] == 0
            assert health["max_width"] == 1024 and health["base_width"] == 16
        finally:
            srv.close()

    def test_beyond_the_top_rung_is_rejected_loudly(self, model_dir):
        srv = server_for(model_dir[0], "--longbag_widths", "64")
        try:
            with pytest.raises(ValueError, match="subsample"):
                srv.batcher.submit(bag(65, seed=1))
            # the protocol applies the seeded subsample rule first, as the
            # JAX server does: a longer bag serves at the top rung
            entry = srv.handle({"op": "embed", "contexts": bag(90, 2).tolist()})["methods"][0]
            assert entry["n_contexts"] == 64 and entry["timing"]["width"] == 64
        finally:
            srv.close()

    def test_longbag_widths_must_exceed_the_ladder(self, model_dir):
        with pytest.raises(ValueError, match="exceed the ladder top"):
            server_for(model_dir[0], "--longbag_widths", "12,64")

    def test_recorded_longbag_ladder_raises_the_bag(self, model_dir, tmp_path):
        import json
        import shutil

        path = tmp_path / "m"
        shutil.copytree(model_dir[0], path)
        meta = json.loads((path / "model_meta.json").read_text())
        meta["bucket_ladder"] = [8, 16, 128]
        (path / "model_meta.json").write_text(json.dumps(meta))
        srv = server_for(path)
        try:
            pred = srv.predictor
            assert (pred.base_bag, pred.bag, pred.ladder_recorded) == (16, 128, True)
            assert pred.model.resolve_kernel(128) == ("fused", "online")
            assert pred.model.resolve_kernel(16) == ("fused", "materialize")
            out = pred.predict_contexts(bag(100, seed=9).tolist(), top_k=2)
            assert out.n_contexts == 100 and np.isfinite(out.code_vector).all()
        finally:
            srv.close()
