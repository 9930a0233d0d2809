"""Embedding lookup.

Counterpart of ``code2vec_tpu/ops/embed.py``. The forward is a row
gather cast to f32; its backward is a dense scatter-add into the table's
gradient (the JAX ``embed_grad="dense"``), through ``F.embedding``: its
CUDA backward sums the rows of each repeated id in parallel segments,
where the backward of ``table[ids]`` adds a repeated id's rows one after
another (every PAD slot of a batch repeats id 0). The selectable
``segment`` / ``segment_sorted`` formulations are not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Gather rows of ``table`` ``[V, E]`` at integer ``ids`` ``[...]``."""
    if ids.dtype.is_floating_point:
        raise TypeError(f"ids must be an integer tensor, got {ids.dtype}")
    if table.dtype == torch.float32:
        return F.embedding(ids, table)
    return table[ids].float()
