"""Sharded train and eval steps: the single-device step over a mesh.

Counterpart of ``code2vec_tpu/parallel/step.py``. JAX compiles its one
step function with mesh shardings and XLA inserts the collectives; the
port's step (``train/step.train_step`` / ``eval_step``) is the same code,
and on a mesh (a model given ``parallel/shardings.shard_model``) it adds
them itself:

- the forward gathers the sharded tables' rows and the head's logits over
  ``model`` and pools over ``ctx`` (``models/code2vec.py``);
- the loss's denominator is the global batch's (``train/step.weighted_nll``);
- after the backward, :func:`sync_gradients` all-reduces every gradient:
  the bag-side parameters' (tables, encoder, LayerNorm, attention vector)
  over the data x ctx plane, each rank of it holding a partial sum, the
  head's over the data line only (the ctx line computes the same head
  gradient on every rank), JAX's psum over ``data``;
- with lazy tables the per-slot gradients of the plane are all-gathered
  (:func:`gather_slot_grads`), so every rank steps the same rows (on a
  ``model`` axis, those of its row shard).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from code2vec_tpu_torch.parallel.distributed import _all_gather
from code2vec_tpu_torch.parallel.mesh import AXIS_DATA, Mesh
from code2vec_tpu_torch.parallel.shardings import HEAD_KEYS


def gradient_groups(model, mesh: Mesh) -> list[tuple[list[torch.Tensor], object]]:
    """``[(parameters, group)]``: the bag side over ``dc``, the head over
    ``data`` (groups of one rank dropped)."""
    head, bag = [], []
    for name, p in model.named_parameters():
        (head if name in HEAD_KEYS else bag).append(p)
    pairs = [(bag, mesh.group("dc")), (head, mesh.group(AXIS_DATA))]
    return [(ps, g) for ps, g in pairs if g is not None]


def sync_gradients(model, mesh: Mesh) -> int:
    """All-reduce (SUM) the gradients in place, one flat buffer a group;
    returns the bytes all-reduced."""
    moved = 0
    for params, group in gradient_groups(model, mesh):
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            continue
        flat = _flatten_dense_tensors(grads)
        dist.all_reduce(flat, group=group)
        for g, synced in zip(grads, _unflatten_dense_tensors(flat, grads)):
            g.copy_(synced)
        moved += flat.numel() * flat.element_size()
    return moved


def gather_slot_grads(table_grads: list, mesh: Mesh) -> list:
    """The lazy step's ``[(ids, slots)]`` of the whole data x ctx plane (in
    its rank order), the same on every rank of it. The model line needs no
    collective: the row-sharded gather's identity backward and the head's
    all-reduced code-vector gradient give every rank of it the same slots,
    of which each keeps its own rows' (``train/table_opt.lazy_rows``)."""
    group = mesh.group("dc")
    if group is None:
        return table_grads
    return [(_all_gather(ids, group, 0), _all_gather(slots, group, 0))
            for ids, slots in table_grads]

