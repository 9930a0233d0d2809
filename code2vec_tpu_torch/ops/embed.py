"""Embedding lookup; the ``embed_grad`` modes of the JAX package; K6, the
dense tables' gradient on the card.

Counterpart of ``code2vec_tpu/ops/embed.py``. The forward is a row gather
of the f32 table. JAX picks the backward, the ``[vocab, dim]`` gradient of
the table from the ``[..., dim]`` gradients of the rows, with ``grad_mode``:

- ``dense``: XLA's scatter-add (the reference's ``nn.Embedding``,
  model/model.py:21-22);
- ``segment``: a segment sum over the flattened ids;
- ``segment_sorted``: the same sum over argsorted ids, which XLA takes as
  its ``indices_are_sorted`` hint.

The three compute one function, so here they share one backward; the mode
is accepted and checked so that a JAX configuration that sets it trains
here unchanged. On the CPU that backward is ``F.embedding``'s. On the card
it is K6 (``csrc/table_grad.cu``): one call sorts the ids stably, sums each
id's rows in chunks and finishes the runs that cross a chunk's edge in a few
more levels, so the PAD run, a third of a bag's slots, is no longer one
thread's serial loop as in ``F.embedding``'s CUDA backward. Its plain
version is :func:`table_grad_reference`.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from code2vec_tpu_torch.analysis.contracts import shape_contract, spec
from code2vec_tpu_torch.ops import _build
from code2vec_tpu_torch.ops.backend import count_launch

GRAD_MODES = ("dense", "segment", "segment_sorted")
KERNEL = "table_grad"

# the 0-d int64 counter K6 adds its split rows into while collect_split_rows
# runs (the autograd engine launches K6 from its own thread)
_split_rows: torch.Tensor | None = None


def _lib():
    lib = _build.load("table_grad")
    if lib.c2v_table_grad.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.c2v_table_grad_workspace.argtypes = [ll, i, i]
        lib.c2v_table_grad_workspace.restype = ll
        lib.c2v_table_grad.argtypes = [p, i, p, ll, i, i, p, p, ll, p, i, p]
        lib.c2v_table_grad.restype = i
    return lib


@contextlib.contextmanager
def collect_split_rows(device: torch.device):
    """Yield a 0-d int64 tensor on ``device`` to which every K6 launch on
    that device adds, with no sync, the rows in runs of equal ids longer
    than one chunk: the rows whose sums its later levels finish."""
    global _split_rows
    counter = torch.zeros((), dtype=torch.int64, device=device)
    outer, _split_rows = _split_rows, counter
    try:
        yield counter
    finally:
        _split_rows = outer


def table_grad_reference(ids: torch.Tensor, rows: torch.Tensor, num_rows: int) -> torch.Tensor:
    """The plain version of K6: ``[num_rows, E]`` in ``rows``' dtype, row
    ``v`` the sum of ``rows[..., :]`` at the slots where ``ids == v``
    (``index_add_``), zero for a row no slot names."""
    e = rows.shape[-1]
    out = torch.zeros((num_rows, e), dtype=rows.dtype, device=rows.device)
    return out.index_add_(0, ids.reshape(-1).long(), rows.reshape(-1, e))


def table_grad_kernel(ids: torch.Tensor, rows: torch.Tensor, num_rows: int) -> torch.Tensor:
    """K6: :func:`table_grad_reference` on the card for int32 or int64
    ``ids [...]`` and f32 ``rows [..., E]``; returns f32 ``[num_rows, E]``.
    One call of the library sorts the ids and sums the rows; each call
    gives the same bits for the same inputs."""
    dev = rows.device
    e = rows.shape[-1] if rows.dim() else 0
    if (ids.device != dev or ids.dtype not in (torch.int32, torch.int64)
            or rows.dtype != torch.float32 or tuple(rows.shape) != (*ids.shape, e) or e < 1):
        raise ValueError(f"table grad kernel: ids must be int32 or int64 [...] and rows f32 "
                         f"[..., E] on one device, got {ids.dtype} {tuple(ids.shape)} on "
                         f"{ids.device} and {rows.dtype} {tuple(rows.shape)} on {dev}")
    n = ids.numel()
    if not 0 <= num_rows < 2**31 or n >= 2**31:
        raise ValueError(f"table grad kernel: {num_rows} table rows, {n} slots; the kernel "
                         "indexes both in int32")
    flat, vals = ids.reshape(-1).contiguous(), rows.reshape(n, e).contiguous()
    lib = _lib()
    nbytes = lib.c2v_table_grad_workspace(n, e, num_rows)
    if nbytes < 0:
        raise ValueError(f"table grad kernel: no workspace for {n} slots into {num_rows} rows")
    workspace = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    grad = torch.empty((num_rows, e), dtype=torch.float32, device=dev)
    split = _split_rows if _split_rows is not None and _split_rows.device == dev else None
    code = lib.c2v_table_grad(flat.data_ptr(), flat.dtype == torch.int64, vals.data_ptr(), n, e,
                              num_rows, grad.data_ptr(), workspace.data_ptr(), nbytes,
                              None if split is None else split.data_ptr(), dev.index,
                              torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, "table grad kernel launch")
    count_launch(KERNEL)
    return grad


class _TableLookup(torch.autograd.Function):
    """``F.embedding``'s gather forward, K6 backward (CUDA tables)."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.num_rows = table.shape[0]
        return F.embedding(ids, table)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        return table_grad_kernel(ids, grad.float(), ctx.num_rows), None


# ids may be any rank ([B, L] contexts, [N] flat) but must be an integer
# tensor; a Python int (torch.tensor of it is int64) is rejected (TX001)
@shape_contract(table=spec("V,E", "float"), ids=spec(None, "int"))
def embedding_lookup(table: torch.Tensor, ids: torch.Tensor,
                     grad_mode: str = "dense") -> torch.Tensor:
    """Gather rows of ``table`` ``[V, E]`` at integer ``ids`` ``[...]``;
    ``grad_mode`` is one of :data:`GRAD_MODES`, all with one backward: K6
    for an f32 table on the card that takes a gradient, ``F.embedding``'s
    on the CPU."""
    if ids.dtype.is_floating_point:
        raise TypeError(f"ids must be an integer tensor, got {ids.dtype}")
    if grad_mode not in GRAD_MODES:
        raise ValueError(f"grad_mode must be one of {GRAD_MODES}, got {grad_mode!r}")
    if table.dtype != torch.float32:
        return table[ids].float()
    if table.is_cuda and table.requires_grad and torch.is_grad_enabled():
        return _TableLookup.apply(table, ids)
    return F.embedding(ids, table)
