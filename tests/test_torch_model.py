"""The port's ``Code2Vec`` against the JAX ``Code2Vec``, on the CPU.

The JAX model is initialised from a seed; its param tree goes through the
port's ``interop`` into the port's model (``strict=True``); both run the
same numpy batch. The JAX side runs each kernel route it has
(``use_pallas`` with ``pallas_impl`` pool_only / gather_split / fused, its
kernels on ``pallas_backend="cpu"``, eagerly) and the port the same route,
which on the CPU is its plain version. Tolerance rtol 2e-4 / atol 2e-5,
the JAX model-dispatch suite's own (tests/test_fused.py).

jax 0.9 partitions with Shardy by default, which rejects the JAX fused
op's ``custom_partitioning`` (no ``sharding_rule``; ROADMAP §C): the JAX
forward runs under the GSPMD partitioner, restored afterwards.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu import interop as jax_interop
from code2vec_tpu.models.code2vec import Code2Vec as JaxCode2Vec
from code2vec_tpu.models.code2vec import Code2VecConfig as JaxConfig
from code2vec_tpu_torch import interop
from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig, encode_matmul

DIMS = dict(terminal_count=50, path_count=40, label_count=9,
            terminal_embed_size=8, path_embed_size=6, encode_size=12)


@contextlib.contextmanager
def gspmd():
    previous = jax.config.jax_use_shardy_partitioner
    jax.config.update("jax_use_shardy_partitioner", False)
    try:
        yield
    finally:
        jax.config.update("jax_use_shardy_partitioner", previous)


def batch(B=5, L=14, seed=0):
    """Ids with PAD tails and one all-PAD row (what the engine's spare
    batch rows look like)."""
    rng = np.random.default_rng(seed)
    s = rng.integers(1, DIMS["terminal_count"], (B, L)).astype(np.int32)
    p = rng.integers(1, DIMS["path_count"], (B, L)).astype(np.int32)
    e = rng.integers(0, DIMS["terminal_count"], (B, L)).astype(np.int32)
    for i, n in enumerate(rng.integers(1, L + 1, B)):
        s[i, n:] = p[i, n:] = e[i, n:] = 0
    s[-1] = p[-1] = e[-1] = 0
    return s, p, e


def jax_setup(margin=False, pad=1, route="xla", table_dtype="f32", **extra):
    kw = dict(DIMS, dropout_prob=0.0, angular_margin_loss=margin, vocab_pad_multiple=pad,
              table_dtype=table_dtype, **extra)
    if route != "xla":
        kw.update(use_pallas=True, pallas_impl=route, pallas_backend="cpu")
    cfg = JaxConfig(**kw)
    model = JaxCode2Vec(cfg)
    s, p, e = batch()
    with gspmd():
        params = model.init(jax.random.PRNGKey(3), jnp.asarray(s), jnp.asarray(p), jnp.asarray(e))
    params = jax.tree.map(np.asarray, params["params"])
    return model, params


def port_model(params, margin=False, pad=1, route="xla", table_dtype="f32", **extra):
    kw = dict(DIMS, dropout_prob=0.0, angular_margin_loss=margin, vocab_pad_multiple=pad,
              table_dtype=table_dtype, **extra)
    if route != "xla":
        kw.update(use_pallas=True, pallas_impl=route)
    cfg = Code2VecConfig(**kw)
    model = Code2Vec(cfg)
    model.load_state_dict(interop.state_dict_from_jax_params(params, cfg), strict=True)
    return model.eval()


def compare(jax_model, params, model, labels=None, seed=0):
    s, p, e = batch(seed=seed)
    with gspmd():
        out_j = jax_model.apply(
            {"params": params}, jnp.asarray(s), jnp.asarray(p), jnp.asarray(e),
            labels=None if labels is None else jnp.asarray(labels),
        )
    with torch.no_grad():
        out_t = model(*(torch.from_numpy(x) for x in (s, p, e)),
                      labels=None if labels is None else torch.from_numpy(labels))
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-5)


class TestForwardParity:
    @pytest.mark.parametrize("table_dtype", ["f32", "bf16", "int8"])
    @pytest.mark.parametrize("route", ["xla", "pool_only", "gather_split", "fused"])
    def test_routes_and_table_dtypes(self, route, table_dtype):
        jm, params = jax_setup(route=route, table_dtype=table_dtype)
        compare(jm, params, port_model(params, route=route, table_dtype=table_dtype))

    @pytest.mark.parametrize("pad", [1, 4])
    @pytest.mark.parametrize("margin", [False, True])
    @pytest.mark.parametrize("route", ["xla", "fused"])
    def test_heads_and_vocab_padding(self, route, margin, pad):
        jm, params = jax_setup(margin=margin, pad=pad, route=route)
        compare(jm, params, port_model(params, margin=margin, pad=pad, route=route), seed=pad)

    def test_margin_head_with_labels(self):
        jm, params = jax_setup(margin=True, pad=4)
        labels = np.array([0, 3, 8, 2, 5], np.int32)
        compare(jm, params, port_model(params, margin=True, pad=4), labels=labels)

    @pytest.mark.parametrize("extra", [{"encoder_impl": "split"}, {"attn_impl": "streaming"}])
    def test_plain_formulations(self, extra):
        jm, params = jax_setup(**extra)
        compare(jm, params, port_model(params, **extra))

    def test_all_pad_row_is_finite_uniform(self):
        _, params = jax_setup(route="fused")
        model = port_model(params, route="fused")
        s, p, e = batch()
        with torch.no_grad():
            logits, cv, attn = model(*(torch.from_numpy(x) for x in (s, p, e)))
        assert torch.isfinite(logits).all() and torch.isfinite(cv).all()
        np.testing.assert_allclose(attn[-1].numpy(), np.full(14, 1 / 14), rtol=1e-6)

    def test_unknown_route_rejected(self):
        with pytest.raises(ValueError, match="pallas_impl"):
            Code2Vec(Code2VecConfig(**DIMS, use_pallas=True, pallas_impl="typo"))


class TestInterop:
    @pytest.mark.parametrize("pad", [1, 4])
    @pytest.mark.parametrize("margin", [False, True])
    def test_round_trip_is_exact(self, margin, pad):
        _, params = jax_setup(margin=margin, pad=pad)
        cfg = Code2VecConfig(**DIMS, angular_margin_loss=margin, vocab_pad_multiple=pad)
        back = interop.jax_params_from_state_dict(
            interop.state_dict_from_jax_params(params, cfg), cfg
        )
        assert jax.tree.structure(back) == jax.tree.structure(params)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
            np.testing.assert_array_equal(a, b)

    def test_key_sets_match_the_jax_package(self):
        assert interop.PLAIN_KEYS == jax_interop.PLAIN_KEYS
        assert interop.MARGIN_KEYS == jax_interop.MARGIN_KEYS
        for margin, keys in ((False, interop.PLAIN_KEYS), (True, interop.MARGIN_KEYS)):
            model = Code2Vec(Code2VecConfig(**DIMS, angular_margin_loss=margin))
            assert set(model.state_dict()) == keys

    @pytest.mark.parametrize("margin", [False, True])
    def test_unpadded_mapping_equals_the_jax_package(self, margin):
        _, params = jax_setup(margin=margin)
        cfg = Code2VecConfig(**DIMS, angular_margin_loss=margin)
        ours = interop.state_dict_from_jax_params(params, cfg)
        theirs = jax_interop.from_param_tree(params, JaxConfig(**DIMS, angular_margin_loss=margin))
        assert set(ours) == set(theirs)
        for k in ours:
            np.testing.assert_array_equal(ours[k].numpy(), theirs[k])

    def test_reference_file_round_trip_with_padding(self, tmp_path):
        jm, params = jax_setup(pad=4)
        cfg = Code2VecConfig(**DIMS, vocab_pad_multiple=4)
        path = interop.save_state_dict(
            interop.state_dict_from_jax_params(params, cfg), str(tmp_path), cfg
        )
        sd = interop.load_state_dict(path)
        assert sd["terminal_embedding.weight"].shape[0] == DIMS["terminal_count"]
        interop.check_dims(sd, cfg)
        model = Code2Vec(cfg)
        model.load_state_dict(interop.pad_state_dict(sd, cfg), strict=True)
        # pad rows are zero now, not the JAX init values: never gathered,
        # sliced off the logits — the forward is unchanged
        compare(jm, params, model.eval())

    def test_wrong_dims_rejected(self):
        _, params = jax_setup()
        cfg = Code2VecConfig(**DIMS)
        sd = interop.state_dict_from_jax_params(params, cfg)
        with pytest.raises(ValueError, match="input_linear.weight"):
            interop.check_dims(sd, cfg.with_updates(encode_size=16))


@pytest.mark.parametrize("grad", [False, True])
def test_encode_matmul_is_one_product_on_the_cpu(grad):
    """The fixed encode slabs are for cuBLAS, which picks its kernel by the
    row count: on the CPU (and with gradients on anywhere) the plain encode
    is one product, bit for bit, and keeps its gradient."""
    g = np.random.default_rng(3)
    x = torch.from_numpy(g.standard_normal((5, 37, 30)).astype(np.float32))
    w = torch.from_numpy(g.standard_normal((30, 16)).astype(np.float32)).requires_grad_(grad)
    with torch.set_grad_enabled(grad):
        out = encode_matmul(x, w)
    assert out.shape == (5, 37, 16)
    assert torch.equal(out, x @ w)
    assert out.requires_grad == grad
