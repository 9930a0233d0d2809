"""Masked global-attention pooling over a bag of context vectors (plain).

Counterpart of ``code2vec_tpu/ops/attention.py``: one learned vector
``a`` scores every context, PAD positions get the finite ``NINF``
sentinel, softmax over the bag axis, and the weighted sum is the code
vector. These are the plain PyTorch versions (and the pool's closed-form
backward); the hand kernels of the same pool are ``ops/pool_kernel.py``.
The pools keep the contexts' dtype as the JAX ones do: over bf16 contexts
(and a bf16 ``attn_param``) the scores and the code vector are bf16
einsums, the softmax is f32 and its weights are cast to bf16 for the sum.

On the CPU, where a wrapper runs these plain versions in place of its
kernel, a row's bits must not depend on the batch it rides in (the
serving invariant the hot-swap gate holds, ``serve/swap.py``). There
:func:`attention_pool` writes its two contractions as exact products
summed in f32 over one axis (a library batched product may take another
path at B = 1 than at B = 64), and the softmax's exponentials are
evaluated in float64 and rounded back (:func:`elementwise`): PyTorch's
CPU loops run vector code on most elements of a tensor and scalar code on
the tail, whose exp differs in the last bit, so a row's weights would
depend on where the row lies in the tensor and how wide it is padded.

On the card the plain pool keeps its einsums while gradients are on (a
training step needs no invariance). With gradients off (serving, eval)
it runs :func:`batch_free_attention_pool`: exact products, and every sum
a pairwise tree of elementwise adds over one axis, whose order depends on
that axis alone. A library reduction (cuBLAS, ``torch.sum``) may split a
row's work otherwise at B = 1 than at B = 64, so the bits of a row would
move with its micro-batch; a tree of elementwise adds cannot, and zero
padding of the bag leaves its sums unchanged.
"""

from __future__ import annotations

import torch

# Same sentinel the reference uses for masked scores (model/model.py:12).
NINF = -3.4e38


def elementwise(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` for an elementwise exp: on the CPU evaluated in
    float64 and rounded to ``x``'s dtype, so that an element's bits do not
    depend on its position in the tensor (the vector and scalar code paths
    agree once rounded); elsewhere in ``x``'s dtype."""
    if x.device.type != "cpu":
        return fn(x)
    return fn(x.double()).to(x.dtype)


def masked_attention_weights(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax over the bag axis with PAD positions masked out.

    The mask arithmetic is ``s*m + (1-m)*NINF`` (model/model.py:93), not a
    ``where``: with every position masked the row degenerates to uniform
    weights instead of NaN. Computed in f32; on the CPU the exponentials
    and their sum in float64, rounded once (a row padded wider then gives
    the same weights, :func:`elementwise`).
    """
    scores = scores.float()
    mask = mask.float()
    z = scores * mask + (1.0 - mask) * NINF
    if z.device.type != "cpu":
        return torch.softmax(z, dim=-1)
    z = z.double()
    e = torch.exp(z - z.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).float()


def tree_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum of ``x`` over ``dim`` as a pairwise tree of elementwise
    adds: elements ``2i`` and ``2i + 1`` of each level are added, an odd
    level gains a zero at its end. Each element's order of additions is a
    function of the axis's length alone, and trailing zeros leave the sum
    as it is (a bag padded wider sums to the same bits)."""
    x = x.movedim(dim, 0)
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, x.new_zeros((1, *x.shape[1:]))])
        x = x[0::2] + x[1::2]
    return x[0]


def batch_free_attention_pool(
    contexts: torch.Tensor,  # [B, L, E]
    mask: torch.Tensor,  # [B, L]
    attn_param: torch.Tensor,  # [E]
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`attention_pool` with no reduction whose order depends on the
    batch: the scores, the softmax's denominator and the weighted sum are
    :func:`tree_sum` s of exact f32 products, the max is exact in any
    order and the exponentials are elementwise. Widened to f32 and rounded
    back to the contexts' dtype, as the CPU form. The card's plain pool
    with gradients off; it runs on the CPU too."""
    dtype = contexts.dtype
    ctx = contexts.float()
    scores = tree_sum(ctx * attn_param.float(), -1).to(dtype).float()
    m = mask.float()
    z = scores * m + (1.0 - m) * NINF
    e = torch.exp(z - z.amax(dim=-1, keepdim=True))
    attention = e / tree_sum(e, -1)[:, None]
    code_vector = tree_sum(attention.to(dtype).float()[..., None] * ctx, 1).to(dtype)
    return code_vector, attention


def attention_pool(
    contexts: torch.Tensor,  # [B, L, E]
    mask: torch.Tensor,  # [B, L] (1 = real, 0 = PAD)
    attn_param: torch.Tensor,  # [E]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Return ``(code_vector [B, E], attention [B, L])``."""
    if contexts.device.type != "cpu":
        if not torch.is_grad_enabled():
            return batch_free_attention_pool(contexts, mask, attn_param)
        scores = torch.einsum("ble,e->bl", contexts, attn_param)
        attention = masked_attention_weights(scores, mask)
        code_vector = torch.einsum("bl,ble->be", attention.to(contexts.dtype), contexts)
        return code_vector, attention
    dtype = contexts.dtype
    ctx = contexts.float()
    scores = (ctx * attn_param.float()).sum(-1).to(dtype)
    attention = masked_attention_weights(scores, mask)
    code_vector = (attention.to(dtype).float()[..., None] * ctx).sum(1).to(dtype)
    return code_vector, attention


def pool_backward_reference(
    contexts: torch.Tensor,  # [B, L, E]
    mask: torch.Tensor,  # [B, L]
    attn_param: torch.Tensor,  # [E]
    weights: torch.Tensor,  # [B, L], the forward's attention
    g_cv: torch.Tensor,  # [B, E]
    g_w: torch.Tensor | None = None,  # [B, L]
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(d_contexts [B, L, E], d_attn [E])`` of :func:`attention_pool`
    from the saved weights: the closed-form softmax VJP of the JAX pool
    kernel's backward (``code2vec_tpu/ops/pallas_attention.py:224-250``),
    computed in f32 on the widened contexts; ``d_contexts`` is rounded to
    the contexts' dtype (bf16 contexts get bf16, as ``:247`` casts) and
    ``d_attn`` stays f32.

    - ``dldw = g_cv . ctx_l + g_w``;
    - ``ds = w (dldw - sum_k w_k dldw_k) mask``;
    - ``d_ctx = w g_cv + ds a``;  ``d_attn = sum_{b,l} ds ctx``.

    The mask gets no gradient. This is the plain version of K1b, for f32
    and bf16 contexts."""
    ctx = contexts.float()
    g_cv = g_cv.float()
    dldw = torch.einsum("be,ble->bl", g_cv, ctx)
    if g_w is not None:
        dldw = dldw + g_w.float()
    ds = weights * (dldw - (weights * dldw).sum(dim=-1, keepdim=True)) * mask.float()
    d_ctx = weights[..., None] * g_cv[:, None, :] + ds[..., None] * attn_param.float()
    d_attn = torch.einsum("bl,ble->e", ds, ctx)
    return d_ctx.to(contexts.dtype), d_attn


def streaming_attention_pool(
    contexts: torch.Tensor,  # [B, L, E]
    mask: torch.Tensor,  # [B, L]
    attn_param: torch.Tensor,  # [E]
) -> tuple[torch.Tensor, torch.Tensor]:
    """The explicit exp/sum decomposition of :func:`attention_pool`
    (max-shift, exp, sum, divide) — the same function, the other
    formulation the JAX package offers (``attn_impl="streaming"``). The
    ``1e-38`` clamp is inert: the max position contributes exp(0) = 1."""
    scores = torch.einsum("ble,e->bl", contexts, attn_param).float()
    mask = mask.float()
    masked = scores * mask + (1.0 - mask) * NINF
    e = torch.exp(masked - masked.max(dim=-1, keepdim=True).values)
    weights = e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-38)
    code_vector = torch.einsum("bl,ble->be", weights.to(contexts.dtype), contexts)
    return code_vector, weights
