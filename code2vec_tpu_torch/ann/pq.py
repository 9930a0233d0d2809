"""Product quantization of the coarse residuals.

Counterpart of ``code2vec_tpu/ann/pq.py``. Each residual row (vector minus
its cell centroid) is split into ``M`` subspaces of ``dsub = E / M`` dims;
each subspace gets a 256-entry codebook trained by the k-means core
(``kmeans.py``), and a row stores one uint8 codebook id per subspace.

Rows are divided by their per-row absmax (``ops/quant.row_absmax``, the
int8 tables' scale primitive) before encoding and the scale is stored per
row, so the codebooks learn residual shape on a unit-magnitude cloud. An
all-zero residual keeps scale 0 and reconstructs to exact zeros.

Asymmetric scoring (``index.py``): for a unit query ``q``,
``q·x ≈ q·c_cell + s * sum_m <q_m, cb[m, code_m]>``; the per-query
``[M, 256]`` table of ``<q_m, cb[m, j]>`` is the LUT that K5 reads.
"""

from __future__ import annotations

import numpy as np
import torch

from code2vec_tpu_torch.ann.kmeans import assign_cells, kmeans_fit
from code2vec_tpu_torch.ops.quant import row_absmax

__all__ = ["PQ_ENTRIES", "train_codebooks", "encode", "decode"]

PQ_ENTRIES = 256  # one uint8 per subspace


def _row_scales(residuals: np.ndarray) -> np.ndarray:
    """Per-row absmax scale ``[N]`` (on the host)."""
    return row_absmax(torch.from_numpy(np.ascontiguousarray(residuals, np.float32))).numpy().reshape(-1)


def _unit_rows(residuals: np.ndarray, scales: np.ndarray) -> np.ndarray:
    safe = np.where(scales > 0, scales, 1.0).astype(np.float32)
    return (residuals.astype(np.float32) / safe[:, None]).astype(np.float32)


def _split(m: int, dim: int) -> int:
    if m < 1 or dim % m:
        raise ValueError(f"m must divide dim; got m={m}, dim={dim}")
    return dim // m


def train_codebooks(residuals: np.ndarray, m: int, *, seed: int = 0, iters: int = 15,
                    batch_size: int | None = None,
                    device: str | torch.device | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Per-subspace codebooks on absmax-normalized residuals: ``(codebooks
    f32 [M, 256, dsub], scales f32 [N])``. With fewer than 256 samples the
    trailing entries duplicate entry 0, which the first-index argmin never
    emits."""
    n, dim = residuals.shape
    dsub = _split(m, dim)
    scales = _row_scales(residuals)
    unit = _unit_rows(residuals, scales)
    k_eff = min(PQ_ENTRIES, n)
    codebooks = np.zeros((m, PQ_ENTRIES, dsub), np.float32)
    for sub in range(m):
        block = unit[:, sub * dsub:(sub + 1) * dsub]
        cb = kmeans_fit(block, k_eff, seed=seed + sub, iters=iters, batch_size=batch_size,
                        device=device)
        codebooks[sub, :k_eff] = cb
        if k_eff < PQ_ENTRIES:
            codebooks[sub, k_eff:] = cb[0]
    return codebooks, scales


def encode(residuals: np.ndarray, codebooks: np.ndarray, scales: np.ndarray, *,
           batch_size: int | None = None,
           device: str | torch.device | None = None) -> np.ndarray:
    """uint8 codes ``[N, M]``: the nearest codebook entry per subspace of
    each absmax-normalized residual row."""
    m, _, dsub = codebooks.shape
    unit = _unit_rows(residuals, scales)
    codes = np.empty((unit.shape[0], m), np.uint8)
    for sub in range(m):
        block = unit[:, sub * dsub:(sub + 1) * dsub]
        codes[:, sub] = assign_cells(block, codebooks[sub], batch_size=batch_size,
                                     device=device).astype(np.uint8)
    return codes


def decode(codes: np.ndarray, codebooks: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """Approximate residuals ``[N, E]`` (tests and error analysis; the query
    path never builds them)."""
    m, _, dsub = codebooks.shape
    unit = np.concatenate(
        [codebooks[sub][codes[:, sub].astype(np.int64)] for sub in range(m)], axis=1
    )
    return unit * scales.astype(np.float32)[:, None]
