"""The port's ops against the JAX package's, on the CPU.

Every kernel wrapper of ``code2vec_tpu_torch`` runs its plain PyTorch
version for CPU tensors; these tests hold those plain versions against the
JAX functions the TPU kernels compute (K1: ``pallas_attention_pool``; K2/K3:
``fused_encode_attend_pool``), called eagerly with ``backend="cpu"``, and
against the unfused XLA formulations. The CUDA kernels themselves are
held against the same plain versions on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``). Inputs come from numpy seeds and go to both
frameworks as numpy arrays.

Tolerances: rtol/atol 1e-5 for f32 tables, 1e-4 for quantized ones (the
JAX kernel suite's own, tests/test_fused.py): both sides compute in f32
with different reduction orders.

jax 0.9 partitions with Shardy by default, which rejects the JAX fused
op's ``custom_partitioning`` (it registers no ``sharding_rule``; ROADMAP
§C); the ``gspmd`` fixture runs those calls under the GSPMD partitioner
and restores the setting afterwards.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu.ops.attention import attention_pool as jax_attention_pool
from code2vec_tpu.ops.attention import streaming_attention_pool as jax_streaming_pool
from code2vec_tpu.ops.fused_encode_pool import fused_encode_attend_pool as jax_fused
from code2vec_tpu.ops.fused_encode_pool import xla_reference_forward
from code2vec_tpu.ops.pallas_attention import pallas_attention_pool
from code2vec_tpu.ops.quant import quantize_table as jax_quantize
from code2vec_tpu_torch.ops import attention as port_attention
from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts, resolve
from code2vec_tpu_torch.ops.fused_encode_pool import (
    encode_pool_reference,
    fused_encode_attend_pool,
    gather_rows,
    reference_forward,
)
from code2vec_tpu_torch.ops.pool_kernel import attention_pool_kernel
from code2vec_tpu_torch.ops.quant import dequantize_table, quantize_table

TOL = {"f32": 1e-5, "bf16": 1e-4, "int8": 1e-4}


def pool_inputs(B=3, L=13, H=16, seed=0):
    """B rows with PAD tails; the last row is all-masked."""
    rng = np.random.default_rng(seed)
    ctx = np.tanh(rng.normal(size=(B, L, H))).astype(np.float32)
    mask = np.zeros((B, L), np.float32)
    for i, n in enumerate(rng.integers(1, L + 1, B)):
        mask[i, :n] = 1.0
    mask[-1] = 0.0
    attn = rng.normal(size=H).astype(np.float32)
    return ctx, mask, attn


def op_inputs(B=3, L=13, Et=6, Ep=5, H=12, seed=0):
    """Table ids with PAD tails (mask = starts > 0) and an all-PAD row."""
    rng = np.random.default_rng(seed)
    Vt, Vp = 37, 29
    starts = rng.integers(1, Vt, (B, L)).astype(np.int32)
    paths = rng.integers(1, Vp, (B, L)).astype(np.int32)
    ends = rng.integers(1, Vt, (B, L)).astype(np.int32)
    for i, n in enumerate(rng.integers(1, L + 1, B)):
        starts[i, n:] = paths[i, n:] = ends[i, n:] = 0
    starts[-1] = paths[-1] = ends[-1] = 0
    t_table = rng.normal(size=(Vt, Et)).astype(np.float32)
    t_table[0] = 0.0  # a zero row: its int8 scale stays 0
    return dict(
        t_table=t_table,
        p_table=rng.normal(size=(Vp, Ep)).astype(np.float32),
        starts=starts, paths=paths, ends=ends,
        mask=(starts > 0).astype(np.float32),
        dense_kernel=(rng.normal(size=(2 * Et + Ep, H)) * 0.3).astype(np.float32),
        ln_scale=(1.0 + 0.1 * rng.normal(size=H)).astype(np.float32),
        ln_bias=(0.1 * rng.normal(size=H)).astype(np.float32),
        attn_param=rng.normal(size=H).astype(np.float32),
    )


ORDER = ("t_table", "p_table", "starts", "paths", "ends", "mask", "dense_kernel",
         "ln_scale", "ln_bias", "attn_param")


def jax_args(inp, table_dtype):
    args = [jnp.asarray(inp[k]) for k in ORDER]
    if table_dtype != "f32":
        args[0] = jax_quantize(args[0], table_dtype)
        args[1] = jax_quantize(args[1], table_dtype)
    return args


def port_args(inp, table_dtype):
    args = [torch.from_numpy(inp[k]) for k in ORDER]
    if table_dtype != "f32":
        args[0] = quantize_table(args[0], table_dtype)
        args[1] = quantize_table(args[1], table_dtype)
    return args


@contextlib.contextmanager
def gspmd():
    """Run JAX's fused op under the GSPMD partitioner (see module doc)."""
    previous = jax.config.jax_use_shardy_partitioner
    jax.config.update("jax_use_shardy_partitioner", False)
    try:
        yield
    finally:
        jax.config.update("jax_use_shardy_partitioner", previous)


def close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


class TestPool:
    """K1's plain version against the JAX pool kernel and the XLA pool."""

    @pytest.mark.parametrize("L", [1, 13, 37])
    def test_pool_matches_jax_kernel_and_xla(self, L):
        ctx, mask, attn = pool_inputs(L=L, seed=L)
        cv_k, w_k = pallas_attention_pool(
            jnp.asarray(ctx), jnp.asarray(mask), jnp.asarray(attn), backend="cpu"
        )
        cv_x, w_x = jax_attention_pool(jnp.asarray(ctx), jnp.asarray(mask), jnp.asarray(attn))
        t = [torch.from_numpy(x) for x in (ctx, mask, attn)]
        cv, w = attention_pool_kernel(*t)
        for ref_cv, ref_w in ((cv_k, w_k), (cv_x, w_x)):
            close(cv, ref_cv, 1e-5)
            close(w, ref_w, 1e-5)

    def test_all_masked_row_is_uniform_mean(self):
        ctx, mask, attn = pool_inputs(L=13)
        cv, w = attention_pool_kernel(*(torch.from_numpy(x) for x in (ctx, mask, attn)))
        np.testing.assert_allclose(w[-1].numpy(), np.full(13, 1 / 13), rtol=1e-6)
        np.testing.assert_allclose(cv[-1].numpy(), ctx[-1].mean(0), rtol=1e-5, atol=1e-6)
        assert torch.isfinite(cv).all() and torch.isfinite(w).all()

    @pytest.mark.parametrize("form", ["xla", "streaming"])
    def test_plain_pools_match_jax(self, form):
        ctx, mask, attn = pool_inputs(L=21, seed=3)
        jax_fn = jax_attention_pool if form == "xla" else jax_streaming_pool
        port_fn = (port_attention.attention_pool if form == "xla"
                   else port_attention.streaming_attention_pool)
        cv_j, w_j = jax_fn(jnp.asarray(ctx), jnp.asarray(mask), jnp.asarray(attn))
        cv, w = port_fn(*(torch.from_numpy(x) for x in (ctx, mask, attn)))
        close(cv, cv_j, 1e-5)
        close(w, w_j, 1e-5)


class TestEncodePool:
    """K2/K3's plain version against the JAX fused op and its reference."""

    @pytest.mark.parametrize("table_dtype", ["f32", "bf16", "int8"])
    @pytest.mark.parametrize("impl", ["gather_split", "fused"])
    def test_matches_jax(self, impl, table_dtype):
        inp = op_inputs(seed=7)
        tol = TOL[table_dtype]
        with gspmd():
            cv_k, w_k = jax_fused(*jax_args(inp, table_dtype), impl=impl, backend="cpu")
        cv_x, w_x = xla_reference_forward(*jax_args(inp, table_dtype))
        cv, w = fused_encode_attend_pool(*port_args(inp, table_dtype), impl=impl)
        for ref_cv, ref_w in ((cv_k, w_k), (cv_x, w_x)):
            close(cv, ref_cv, tol)
            close(w, ref_w, tol)

    @pytest.mark.parametrize("B,L", [(1, 1), (4, 37), (8, 50)])
    def test_shapes_match_jax(self, B, L):
        inp = op_inputs(B=B, L=L, seed=B * 100 + L)
        cv_x, w_x = xla_reference_forward(*jax_args(inp, "f32"))
        cv, w = reference_forward(*port_args(inp, "f32"))
        close(cv, cv_x, 1e-5)
        close(w, w_x, 1e-5)

    def test_gather_split_twin_equals_reference(self):
        args = port_args(op_inputs(seed=2), "int8")
        t, p, s, pa, e = args[:5]
        cv1, w1 = encode_pool_reference(
            gather_rows(t, s), gather_rows(p, pa), gather_rows(t, e), *args[5:]
        )
        cv2, w2 = reference_forward(*args)
        assert torch.equal(cv1, cv2) and torch.equal(w1, w2)

    def test_mismatched_table_dtypes_rejected(self):
        args = port_args(op_inputs(), "f32")
        args[1] = quantize_table(args[1], "int8")
        with pytest.raises(ValueError, match="share a storage dtype"):
            fused_encode_attend_pool(*args)

    def test_unknown_impl_rejected(self):
        with pytest.raises(ValueError, match="impl must be one of"):
            fused_encode_attend_pool(*port_args(op_inputs(), "f32"), impl="pool_only")


class TestQuant:
    def table(self):
        rng = np.random.default_rng(11)
        t = rng.normal(size=(9, 7)).astype(np.float32)
        t[2] = 0.0  # zero row
        # exact .5 ties of x/scale (scale 1 here): round half to even
        t[4] = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5], np.float32)
        return t

    def test_int8_bitwise_equal_to_jax(self):
        t = self.table()
        qj = jax_quantize(jnp.asarray(t), "int8")
        qt = quantize_table(torch.from_numpy(t), "int8")
        np.testing.assert_array_equal(qt.values.numpy(), np.asarray(qj.values))
        np.testing.assert_array_equal(qt.scale.numpy(), np.asarray(qj.scale))

    def test_zero_rows_stay_zero(self):
        qt = quantize_table(torch.from_numpy(self.table()), "int8")
        assert qt.scale[2, 0].item() == 0.0
        assert torch.count_nonzero(qt.values[2]) == 0
        assert torch.count_nonzero(dequantize_table(qt)[2]) == 0

    def test_bf16_matches_jax(self):
        t = self.table()
        qj = jax_quantize(jnp.asarray(t), "bf16")
        qt = quantize_table(torch.from_numpy(t), "bf16")
        np.testing.assert_array_equal(
            qt.values.float().numpy(), np.asarray(qj.values.astype(jnp.float32))
        )


class TestRouting:
    def test_cpu_tensors_take_the_plain_version_and_count_nothing(self):
        reset_launch_counts()
        ctx, mask, attn = pool_inputs()
        attention_pool_kernel(*(torch.from_numpy(x) for x in (ctx, mask, attn)))
        fused_encode_attend_pool(*port_args(op_inputs(), "f32"))
        assert launch_counts() == {}

    def test_pinned_cuda_route_on_cpu_tensor_raises(self):
        ctx, mask, attn = (torch.from_numpy(x) for x in pool_inputs())
        with pytest.raises(ValueError, match="pinned"):
            attention_pool_kernel(ctx, mask, attn, backend="cuda")
        with pytest.raises(ValueError, match="pinned"):
            fused_encode_attend_pool(*port_args(op_inputs(), "f32"), backend="cuda")

    def test_resolve_rejects_unknown_backend(self):
        with pytest.raises(ValueError, match="backend must be one of"):
            resolve(torch.zeros(1), "tpu")
