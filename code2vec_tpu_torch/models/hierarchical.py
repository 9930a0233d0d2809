"""Hierarchical two-level pooling: method vectors -> one vector a file.

Counterpart of ``code2vec_tpu/models/hierarchical.py``. The model embeds
one method a forward (a bag of path contexts -> attention pool -> ``[H]``
code vector). Whole-file code search needs one vector a file, and the
second level is the same pool one tier up: the file's method vectors form
the bag, a salience direction scores them, the masked softmax weights
them, and the weighted sum is the file vector.

- :func:`pool_vectors_by_group` pools method vectors grouped by any key
  (source file, class) on the host, in float64 numpy as JAX does, so the
  file vector matches JAX's at f32 resolution whatever the group size.
  ``export.export_file_vectors``, ``Predictor.embed_file`` and the
  server's ``embed_file`` run it with the checkpoint's method-level
  ``attention_parameter`` as the direction (method vectors live in the
  space of the encoded contexts that parameter scores); ``attn_param=None``
  is the mean.
- :class:`HierarchicalAttentionPool` is the module form over batched
  groups ``[G, M, H]`` with a mask, with its own ``file_attention``
  parameter for runs that train the file level. It pools through
  ``ops.attention.attention_pool``, the function the JAX module calls, so
  an all-masked group is uniform over M.

File vectors are ``[H]`` f32 rows: ``formats/vectors_io`` writes them
(``file.vec``), ``serve/retrieval`` and the ``ann`` index search them.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from code2vec_tpu_torch.ops.attention import attention_pool

__all__ = ["HierarchicalAttentionPool", "pool_vectors", "pool_vectors_by_group"]


def pool_vectors(vectors: np.ndarray, attn_param: np.ndarray | None) -> np.ndarray:
    """Attention-pool one group of method vectors ``[M, H]`` into one
    ``[H]`` f32 vector: scores, shifted softmax, weighted sum, in float64
    (``attn_param=None``: the mean)."""
    vectors = np.asarray(vectors, np.float64)
    if vectors.ndim != 2 or not len(vectors):
        raise ValueError(f"need a non-empty [M, H] vector matrix, got {vectors.shape}")
    if attn_param is None:
        pooled = vectors.mean(axis=0)
    else:
        scores = vectors @ np.asarray(attn_param, np.float64)
        z = np.exp(scores - scores.max())
        pooled = (z / z.sum()) @ vectors
    return pooled.astype(np.float32)


def pool_vectors_by_group(vectors: np.ndarray, group_ids,
                          attn_param: np.ndarray | None = None) -> tuple[list, np.ndarray]:
    """``(group keys, [G, H] f32)``: the method vectors ``[N, H]`` grouped
    by ``group_ids`` (one hashable key a vector) and each group pooled;
    groups in order of first appearance. No vectors give ``[0, H]``."""
    vectors = np.asarray(vectors, np.float32)
    if len(vectors) != len(group_ids):
        raise ValueError(f"{len(vectors)} vectors but {len(group_ids)} group ids")
    members: dict = {}
    for row, gid in enumerate(group_ids):
        members.setdefault(gid, []).append(row)
    keys = list(members)
    if not keys:
        return keys, np.zeros((0, vectors.shape[-1] if vectors.ndim == 2 else 0), np.float32)
    return keys, np.stack([pool_vectors(vectors[members[gid]], attn_param) for gid in keys])


class HierarchicalAttentionPool(nn.Module):
    """``forward(method_vectors [G, M, H], mask [G, M])`` ->
    ``(file_vector [G, H] f32, attention [G, M] f32)``; ``mask`` is 1 on
    real methods and 0 on padding rows. ``file_attention`` ``[H]`` starts
    normal with std sqrt(2 / (H + 1)) (xavier-normal over the reference's
    ``[H, 1]``, as the method-level vector), drawn from ``generator``."""

    def __init__(self, encode_size: int, generator: torch.Generator | None = None) -> None:
        super().__init__()
        self.encode_size = encode_size
        self.file_attention = nn.Parameter(torch.empty(encode_size))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        self.file_attention.normal_(std=math.sqrt(2.0 / (self.encode_size + 1)),
                                    generator=generator)

    def forward(self, method_vectors: torch.Tensor, mask: torch.Tensor):
        return attention_pool(method_vectors.float(), mask.float(), self.file_attention)
