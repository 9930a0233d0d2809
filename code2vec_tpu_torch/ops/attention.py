"""Masked global-attention pooling over a bag of context vectors (plain).

Counterpart of ``code2vec_tpu/ops/attention.py``: one learned vector
``a`` scores every context, PAD positions get the finite ``NINF``
sentinel, softmax over the bag axis, and the weighted sum is the code
vector. These are the plain PyTorch versions; the hand kernel of the same
pool is ``ops/pool_kernel.py``.
"""

from __future__ import annotations

import torch

# Same sentinel the reference uses for masked scores (model/model.py:12).
NINF = -3.4e38


def masked_attention_weights(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax over the bag axis with PAD positions masked out.

    The mask arithmetic is ``s*m + (1-m)*NINF`` (model/model.py:93), not a
    ``where``: with every position masked the row degenerates to uniform
    weights instead of NaN. Computed in f32.
    """
    scores = scores.float()
    mask = mask.float()
    return torch.softmax(scores * mask + (1.0 - mask) * NINF, dim=-1)


def attention_pool(
    contexts: torch.Tensor,  # [B, L, E]
    mask: torch.Tensor,  # [B, L] (1 = real, 0 = PAD)
    attn_param: torch.Tensor,  # [E]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Return ``(code_vector [B, E], attention [B, L])``."""
    scores = torch.einsum("ble,e->bl", contexts, attn_param)
    attention = masked_attention_weights(scores, mask)
    code_vector = torch.einsum(
        "bl,ble->be", attention.to(contexts.dtype), contexts
    )
    return code_vector, attention


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
