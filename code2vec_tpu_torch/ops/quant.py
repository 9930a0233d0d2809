"""Quantized embedding-table storage for serving.

Counterpart of ``code2vec_tpu/ops/quant.py``. Storage modes
(``table_dtype``):

- ``f32``  — no quantization (the master table);
- ``bf16`` — values stored bfloat16, no scale;
- ``int8`` — values stored int8 with one f32 scale per ROW
  (``absmax/127`` symmetric), dequantized on load: ``row = q * scale``.

``quantize_table`` gives int8 values bitwise equal to the JAX package's:
both divide in f32 and round half to even.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

TABLE_DTYPES = ("f32", "bf16", "int8")


@dataclass
class QuantTable:
    """A quantized ``[vocab, dim]`` embedding table.

    ``values``: int8 or bf16 ``[V, E]``; ``scale``: f32 ``[V, 1]`` per-row
    dequant scale for int8, ``None`` for bf16.
    """

    values: torch.Tensor
    scale: torch.Tensor | None
    table_dtype: str  # "bf16" | "int8"

    @property
    def shape(self) -> tuple:
        return tuple(self.values.shape)

    def nbytes(self) -> int:
        n = self.values.numel() * self.values.element_size()
        if self.scale is not None:
            n += self.scale.numel() * self.scale.element_size()
        return n


def row_absmax(x: torch.Tensor) -> torch.Tensor:
    """Per-row absmax ``[V, 1]`` of a ``[V, E]`` matrix; an all-zero row
    yields 0."""
    return x.float().abs().amax(dim=1, keepdim=True)


def quantize_table(table: torch.Tensor, table_dtype: str) -> QuantTable:
    """f32 ``[V, E]`` master table -> quantized storage.

    int8 is symmetric per-row absmax: ``scale = absmax/127``,
    ``q = clip(round(x/scale), -127, 127)``. A zero row keeps scale 0 and
    dequantizes to exact zeros.
    """
    if table_dtype == "bf16":
        return QuantTable(values=table.to(torch.bfloat16), scale=None,
                          table_dtype="bf16")
    if table_dtype == "int8":
        scale = row_absmax(table) / 127.0
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        q = torch.round(table.float() / safe)
        values = torch.clamp(q, -127, 127).to(torch.int8)
        return QuantTable(values=values, scale=scale, table_dtype="int8")
    raise ValueError(
        f"table_dtype must be one of {TABLE_DTYPES[1:]} to quantize, "
        f"got {table_dtype!r}"
    )


def dequantize_rows(qt: QuantTable, ids: torch.Tensor) -> torch.Tensor:
    """Gather rows at ``ids`` and dequantize to f32 (the plain lookup)."""
    rows = qt.values[ids]
    if qt.scale is not None:
        return rows.float() * qt.scale[ids]
    return rows.float()


def dequantize_table(qt: QuantTable) -> torch.Tensor:
    """The full dequantized f32 table (tests / error analysis)."""
    if qt.scale is not None:
        return qt.values.float() * qt.scale
    return qt.values.float()


def maybe_quantize(table: torch.Tensor, table_dtype: str):
    """``"f32"`` passes the master table through untouched; any other
    ``table_dtype`` returns its :class:`QuantTable`."""
    if table_dtype == "f32":
        return table
    return quantize_table(table, table_dtype)
