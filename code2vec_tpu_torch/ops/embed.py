"""Embedding lookup; the ``embed_grad`` modes of the JAX package.

Counterpart of ``code2vec_tpu/ops/embed.py``. The forward is a row gather
of the f32 table. JAX picks the backward, the ``[vocab, dim]`` gradient of
the table from the ``[..., dim]`` gradients of the rows, with ``grad_mode``:

- ``dense``: XLA's scatter-add (the reference's ``nn.Embedding``,
  model/model.py:21-22);
- ``segment``: a segment sum over the flattened ids;
- ``segment_sorted``: the same sum over argsorted ids, which XLA takes as
  its ``indices_are_sorted`` hint.

PyTorch has no such hint, and ``F.embedding``'s backward already is a
segment sum (on CUDA it sorts the ids and sums each id's rows in f32), so
every mode runs ``F.embedding``: the three compute the same function, and
the mode is accepted and checked so that a JAX configuration that sets it
trains here unchanged.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from code2vec_tpu_torch.analysis.contracts import shape_contract, spec

GRAD_MODES = ("dense", "segment", "segment_sorted")


# ids may be any rank ([B, L] contexts, [N] flat) but must be an integer
# tensor; a Python int (torch.tensor of it is int64) is rejected (TX001)
@shape_contract(table=spec("V,E", "float"), ids=spec(None, "int"))
def embedding_lookup(table: torch.Tensor, ids: torch.Tensor,
                     grad_mode: str = "dense") -> torch.Tensor:
    """Gather rows of ``table`` ``[V, E]`` at integer ``ids`` ``[...]``;
    ``grad_mode`` is one of :data:`GRAD_MODES`, all with ``F.embedding``'s
    backward."""
    if ids.dtype.is_floating_point:
        raise TypeError(f"ids must be an integer tensor, got {ids.dtype}")
    if grad_mode not in GRAD_MODES:
        raise ValueError(f"grad_mode must be one of {GRAD_MODES}, got {grad_mode!r}")
    if table.dtype != torch.float32:
        return table[ids].float()
    return F.embedding(ids, table)
