"""Embedding lookup, forward only.

Counterpart of ``code2vec_tpu/ops/embed.py``. The forward is a row
gather cast to f32; the selectable backward formulations (``segment``,
``segment_sorted``) come with the training slice.
"""

from __future__ import annotations

import torch


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Gather rows of ``table`` ``[V, E]`` at integer ``ids`` ``[...]``."""
    if ids.dtype.is_floating_point:
        raise TypeError(f"ids must be an integer tensor, got {ids.dtype}")
    return table[ids].float()
