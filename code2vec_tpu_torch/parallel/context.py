"""Context (bag) parallelism for the attention pool.

Counterpart of ``code2vec_tpu/parallel/context.py``: the bag axis ``L``
is sharded over the ``ctx`` line and the masked softmax and weighted sum
use the streaming decomposition of ``ops/attention.streaming_attention_pool``
with the line's collectives:

    m   = all_reduce_max(max(local scores))     one scalar a row
    e   = exp(local scores - m)
    s   = all_reduce_sum(sum(e))
    out = all_reduce_sum((e / s) @ local contexts)

The max shift carries no gradient (its terms cancel in the normalization).
The code vector's all-reduce has the identity backward (every rank of
the line then uses it alike); the weights ``e / s`` are per rank, so the
gradient reaching ``s`` is summed over the line before it goes back to
each rank's partial sum (JAX's psum transpose). This is the plain route
only: JAX rejects ``use_pallas`` with ``context_axis > 1`` and so does the
port (``train/loop.build_mesh``).
"""

from __future__ import annotations

import torch

from code2vec_tpu_torch.ops.attention import NINF
from code2vec_tpu_torch.parallel.distributed import (
    all_reduce_max,
    copy_to_group,
    reduce_from_group,
)
from code2vec_tpu_torch.parallel.mesh import AXIS_CTX, Mesh


def context_parallel_attention_pool(
    mesh: Mesh,
    contexts: torch.Tensor,  # [B, l, E], this rank's shard of the bag
    mask: torch.Tensor,  # [B, l]
    attn_param: torch.Tensor,  # [E] replicated
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(code_vector [B, E]`` the same on every rank of the ctx line,
    ``attention [B, l]`` this rank's shard)."""
    group = mesh.group(AXIS_CTX)
    scores = torch.einsum("ble,e->bl", contexts, attn_param).float()
    mask = mask.float()
    masked = scores * mask + (1.0 - mask) * NINF
    gmax = all_reduce_max(masked.detach().amax(dim=-1), group)
    e = torch.exp(masked - gmax[:, None])
    # the weights are per rank: the gradient reaching the all-reduced
    # denominator sums over the line (copy_to_group's backward)
    s = copy_to_group(reduce_from_group(e.sum(dim=-1), group), group)
    weights = e / torch.clamp(s[:, None], min=1e-38)
    local_cv = torch.einsum("bl,ble->be", weights.to(contexts.dtype), contexts)
    return reduce_from_group(local_cv, group), weights
