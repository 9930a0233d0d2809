"""K1b's one-pass formulation against the JAX package, on the CPU.

K1b (``csrc/pool.cu``) takes the row's softmax term from the forward's
code vector instead of a pass over the contexts:

    T = sum_l w_l dldw_l = <g_cv, cv> + <w, g_w>      (cv = sum_l w_l ctx_l)

so each context is read once. The kernel runs only on the card; here the
same arithmetic, written in plain torch from the ``cv, w`` of the pool's
forward, is held against ``jax.vjp`` of ``pallas_attention_pool`` on the
compiled CPU strategy (whose backward computes T from dldw, as
``pool_backward_reference`` does), at the tolerance the card's tests hold
the kernel to: d_ctx atol 1e-5 (rtol 0), d_attn rtol 1e-4 / atol 1e-5.
Inputs come from numpy with a seed: every bag length from 1 to L, a bag of
one context, the last row all-masked, with and without a weights
cotangent. Also: ``_AttentionPool`` saves ``cv`` for its backward and
still returns autograd's gradients through the plain pool, and K1b's
wrapper refuses arguments of the wrong dtype or shape before it reaches
the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu.ops.pallas_attention import pallas_attention_pool
from code2vec_tpu_torch.ops.attention import attention_pool, pool_backward_reference
from code2vec_tpu_torch.ops.pool_kernel import (
    MAX_H,
    attention_pool_kernel,
    pool_backward_kernel,
)

ATOL_CTX = 1e-5  # d_ctx, rtol 0 (tests/test_torch_cuda.py, chip_smoke.py)
RTOL_ATTN, ATOL_ATTN = 1e-4, 1e-5  # d_attn
SHAPES = [(3, 1, 7), (10, 9, 7), (34, 33, 13), (64, 37, 300)]


def inputs(B, L, H, seed):
    """Row i has a bag of 1 + i % L contexts (every length 1..L once B > L),
    the last row none."""
    rng = np.random.default_rng(seed)
    ctx = np.tanh(rng.normal(size=(B, L, H))).astype(np.float32)
    lens = 1 + np.arange(B) % L
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.float32)
    mask[-1] = 0.0
    attn = (rng.normal(size=H) / np.sqrt(H)).astype(np.float32)
    g_cv = rng.normal(size=(B, H)).astype(np.float32)
    g_w = rng.normal(size=(B, L)).astype(np.float32)
    return ctx, mask, attn, g_cv, g_w


def one_pass(ctx, mask, attn, w, cv, g_cv, g_w=None):
    """K1b's arithmetic in plain torch: T from the code vector, then each
    context's d_ctx and its term of d_attn from that context alone."""
    x = ctx.float()
    t = (g_cv * cv).sum(dim=-1, keepdim=True)
    dldw = torch.einsum("be,ble->bl", g_cv, x)
    if g_w is not None:
        t = t + (w * g_w).sum(dim=-1, keepdim=True)
        dldw = dldw + g_w
    ds = w * (dldw - t) * mask
    d_ctx = w[..., None] * g_cv[:, None, :] + ds[..., None] * attn.float()
    return d_ctx.to(ctx.dtype), torch.einsum("bl,ble->e", ds, x)


@pytest.mark.parametrize("with_gw", [False, True])
@pytest.mark.parametrize("B,L,H", SHAPES)
def test_one_pass_matches_jax_vjp(B, L, H, with_gw):
    ctx, mask, attn, g_cv, g_w = inputs(B, L, H, B * L + H)
    (cv, w), vjp = jax.vjp(
        lambda c, a: pallas_attention_pool(c, jnp.asarray(mask), a, backend="cpu"),
        jnp.asarray(ctx), jnp.asarray(attn))
    j_ctx, j_attn = vjp((jnp.asarray(g_cv), jnp.asarray(g_w if with_gw else np.zeros_like(g_w))))
    t = [torch.from_numpy(np.array(x)) for x in (ctx, mask, attn, w, cv, g_cv, g_w)]
    d_ctx, d_attn = one_pass(*t[:6], t[6] if with_gw else None)
    np.testing.assert_allclose(d_ctx.numpy(), np.asarray(j_ctx), rtol=0, atol=ATOL_CTX)
    np.testing.assert_allclose(d_attn.numpy(), np.asarray(j_attn), rtol=RTOL_ATTN,
                               atol=ATOL_ATTN)
    # the all-masked row gets w * g_cv only
    np.testing.assert_allclose(d_ctx[-1].numpy(), np.asarray(w)[-1][:, None] * g_cv[-1],
                               rtol=0, atol=ATOL_CTX)


@pytest.mark.parametrize("with_gw", [False, True])
@pytest.mark.parametrize("B,L,H", SHAPES)
def test_one_pass_over_bf16_contexts_matches_the_plain_version(B, L, H, with_gw):
    """Over bf16 contexts, with ``cv, w`` of the pool over those contexts
    widened (as K1 gives them): d_ctx within 1e-5 plus one bf16 ulp of the
    plain version's value (each side rounds its f32 value once), d_attn at
    the f32 tolerance."""
    ctx, mask, attn, g_cv, g_w = (torch.from_numpy(x) for x in inputs(B, L, H, B + L + H))
    ctx, attn = ctx.to(torch.bfloat16), attn.to(torch.bfloat16)
    cv, w = attention_pool(ctx.float(), mask, attn.float())
    gw = g_w if with_gw else None
    d_ctx, d_attn = one_pass(ctx, mask, attn, w, cv, g_cv, gw)
    r_ctx, r_attn = pool_backward_reference(ctx, mask, attn, w, g_cv, gw)
    assert d_ctx.dtype == r_ctx.dtype == torch.bfloat16
    mag = r_ctx.abs().double().clamp_min(2.0**-126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    assert ((d_ctx.double() - r_ctx.double()).abs() <= ATOL_CTX + ulp).all()
    torch.testing.assert_close(d_attn, r_attn, rtol=RTOL_ATTN, atol=ATOL_ATTN)


@pytest.mark.parametrize("with_gw", [False, True])
def test_pool_function_saves_cv_and_matches_autograd(with_gw):
    ctx, mask, attn, g_cv, g_w = (torch.from_numpy(x) for x in inputs(6, 5, 7, 3))
    c1, a1 = ctx.clone().requires_grad_(), attn.clone().requires_grad_()
    c2, a2 = ctx.clone().requires_grad_(), attn.clone().requires_grad_()
    cv, w = attention_pool_kernel(c1, mask, a1)
    saved = cv.grad_fn.saved_tensors
    assert len(saved) == 5
    assert torch.equal(saved[3], cv) and saved[3].data_ptr() == cv.data_ptr()
    torch.testing.assert_close(saved[4], w, rtol=0, atol=0)
    out2 = attention_pool(c2, mask, a2)
    outs1, outs2 = ((cv, w), out2) if with_gw else ((cv,), (out2[0],))
    grads = (g_cv, g_w) if with_gw else (g_cv,)
    for x, y in zip(torch.autograd.grad(outs1, (c1, a1), grads),
                    torch.autograd.grad(outs2, (c2, a2), grads)):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-6)


def _bwd_args(B=4, L=6, H=8, **over):
    f32 = torch.float32
    args = dict(contexts=torch.zeros(B, L, H), mask=torch.ones(B, L),
                attn_param=torch.zeros(H), weights=torch.zeros(B, L), cv=torch.zeros(B, H),
                g_cv=torch.zeros(B, H), g_w=torch.zeros(B, L, dtype=f32))
    args.update(over)
    return args


@pytest.mark.parametrize("over,match", [
    (dict(cv=torch.zeros(4, 7)), "cv must be torch.float32 \\(4, 8\\)"),
    (dict(cv=torch.zeros(4, 8, dtype=torch.bfloat16)), "cv must be torch.float32"),
    (dict(cv=torch.zeros(8)), "cv must be"),
    (dict(g_cv=torch.zeros(4, 6)), "g_cv must be"),
    (dict(weights=torch.zeros(4, 5)), "weights must be"),
    (dict(g_w=torch.zeros(4, 6, 8)), "g_w must be"),
    (dict(attn_param=torch.zeros(8, dtype=torch.bfloat16)), "attn_param must be torch.float32"),
    (dict(contexts=torch.zeros(4, 6, 8, dtype=torch.float64)), "contexts must be"),
    (_bwd_args(L=0), "empty batch or bag"),
    (_bwd_args(H=MAX_H + 1), "encode width"),
])
def test_pool_backward_kernel_checks_its_arguments(over, match):
    """Every argument, ``cv`` included, is checked for dtype and shape
    against the contexts before a launch (here, on CPU tensors, before any
    CUDA call)."""
    with pytest.raises(ValueError, match=match):
        pool_backward_kernel(**_bwd_args(**over))
