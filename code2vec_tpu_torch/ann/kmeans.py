"""Mini-batch Lloyd's k-means: the coarse quantizer and PQ codebook core.

Counterpart of ``code2vec_tpu/ann/kmeans.py``, with the same split of
labour, chosen for determinism:

- the distance work — k-means++'s D² updates and the nearest-centroid
  assignment, the only terms that grow with corpus and cluster count —
  runs on the card;
- every random draw comes from one host ``np.random.default_rng(seed)``,
  consumed exactly as the JAX package consumes it (``rng.choice(n, p=...)``
  is one ``rng.random()`` searched in the normalised cumulative D² mass);
- the centroid update folds on the host in float64 in fixed row order (the
  running-average form: each centroid is the exact mean of every sample
  ever assigned to it).

The JAX package's k-means++ seeding is O(k·N·E) float64 numpy work on the
host; here the D² vector lives on the card and only the drawn index comes
back each step. Argmin near-ties may resolve differently from the JAX
package's CPU run, so a built index is held by its properties and search
parity on a shared index, not bitwise.

On a mesh (``parallel/mesh.Mesh``; every rank calls with the same inputs)
each rank of the ``data`` line assigns a contiguous slice of every batch,
padded to the compiled batch (:func:`_compiled_batch`), and the slices are
all-gathered to the host; the fold stays there in its fixed order and the
draw size depends on ``(n, batch_size)`` alone, so the rng is consumed the
same on any mesh and the fit equals one device's bitwise.
"""

from __future__ import annotations

import numpy as np
import torch

from code2vec_tpu_torch.ops.backend import resolve_device
from code2vec_tpu_torch.parallel.mesh import AXIS_DATA

__all__ = ["kmeans_pp_init", "kmeans_fit", "assign_cells"]

ASSIGN_BATCH = 65536  # rows per assignment launch of a full pass
# rows per cuBLAS product of an assignment on the card: cuBLAS picks its
# kernel by the row count, and a row's products moved with it (1,200 rows
# against 600 at 10 x 16, H100), so every product runs on slabs of this
# many rows and a row's distances do not depend on the batch or the mesh
ASSIGN_SLAB_ROWS = 8192


def _sq_dist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``||x_i - c||²`` per row of ``x`` (float64)."""
    d = x - c[None, :]
    return (d * d).sum(dim=1)


def kmeans_pp_init(x: np.ndarray, k: int, rng: np.random.Generator,
                   device: str | torch.device | None = None) -> np.ndarray:
    """k-means++ seeding: the first center uniform, each next one drawn with
    probability proportional to the squared distance to the nearest center
    so far. With fewer distinct points than ``k`` the D² mass reaches zero
    and the remaining centers draw uniformly."""
    n = x.shape[0]
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    dev = resolve_device(device)
    xd = torch.as_tensor(np.ascontiguousarray(x), device=dev).to(torch.float64)
    picks = [int(rng.integers(n))]
    d2 = _sq_dist(xd, xd[picks[0]])
    for _ in range(1, k):
        total = float(d2.sum())
        if total > 0.0:
            cdf = torch.cumsum(d2 / total, dim=0)
            cdf = cdf / cdf[-1]
            u = torch.tensor([rng.random()], dtype=torch.float64, device=dev)
            idx = int(torch.searchsorted(cdf, u, right=True))
        else:
            idx = int(rng.integers(n))
        picks.append(idx)
        d2 = torch.minimum(d2, _sq_dist(xd, xd[idx]))
    return np.asarray(x, np.float32)[picks]


def _nearest(xb: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """Nearest centroid per row, ``argmin ||c||² - 2 x·c`` in f32 (the
    first index wins a tie); on the card in slabs of ``ASSIGN_SLAB_ROWS``."""
    c2 = (cents * cents).sum(dim=1)
    if not xb.is_cuda:
        return torch.argmin(c2[None, :] - 2.0 * (xb @ cents.T), dim=1)
    n = xb.shape[0]
    padded = xb.new_zeros((-(-n // ASSIGN_SLAB_ROWS) * ASSIGN_SLAB_ROWS, xb.shape[1]))
    padded[:n] = xb
    return torch.cat([torch.argmin(c2[None, :] - 2.0 * (slab @ cents.T), dim=1)
                      for slab in padded.split(ASSIGN_SLAB_ROWS)])[:n]


def _draw_size(n: int, batch_size: int | None) -> int:
    """Rows sampled per mini-batch: a function of (n, batch_size) only."""
    batch = int(batch_size) if batch_size else min(n, 16384)
    return max(min(batch, n), 1)


def _compiled_batch(draw: int, mesh=None) -> int:
    """The rows of one assignment: ``draw`` rounded up so the ``data`` axis
    divides it (JAX ``_compiled_batch``). The pad rows are zeros, sliced off
    before any fold: the mesh changes the shape only, never the samples."""
    axis = mesh.shape[AXIS_DATA] if mesh is not None else 1
    return -(-draw // axis) * axis


def _assign(xb: np.ndarray, cents: torch.Tensor, batch: int, mesh=None) -> np.ndarray:
    """Nearest centroid of each row of ``xb`` (at most ``batch`` rows),
    padded to ``batch``; on a ``data`` line of ``n`` ranks this rank
    assigns rows ``[d·batch/n, (d+1)·batch/n)`` and every rank gets all."""
    n = xb.shape[0]
    if n < batch:
        xb = np.concatenate([xb, np.zeros((batch - n, xb.shape[1]), xb.dtype)])
    if mesh is None or mesh.group(AXIS_DATA) is None:
        return _nearest(torch.from_numpy(xb).to(cents.device), cents).cpu().numpy()[:n]
    from code2vec_tpu_torch.parallel.distributed import allgather_to_host

    per = batch // mesh.shape[AXIS_DATA]
    lo = mesh.coords[AXIS_DATA] * per
    mine = _nearest(torch.from_numpy(xb[lo:lo + per]).to(cents.device), cents)
    return allgather_to_host(mine, mesh, AXIS_DATA)[:n]


def kmeans_fit(x: np.ndarray, k: int, *, seed: int = 0, iters: int = 25,
               batch_size: int | None = None, mesh=None,
               device: str | torch.device | None = None) -> np.ndarray:
    """Fit ``k`` centroids over ``x [N, E]``; returns f32 ``[k, E]``.
    Per iteration a seeded sample is assigned on the card (over the
    ``data`` line of ``mesh``) and folded into the running per-cluster
    means on the host (float64, fixed order). Clusters that never receive a
    sample keep their k-means++ seed point."""
    x = np.ascontiguousarray(x, np.float32)
    n = x.shape[0]
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    centers = kmeans_pp_init(x, k, rng, dev).astype(np.float64)
    counts = np.zeros(k, np.int64)
    draw = _draw_size(n, batch_size)
    batch = _compiled_batch(draw, mesh)
    for _ in range(max(int(iters), 0)):
        idx = rng.choice(n, size=draw, replace=False) if draw < n else np.arange(n)
        xb = x[idx]
        a = _assign(xb, torch.from_numpy(centers.astype(np.float32)).to(dev), batch, mesh)
        sums = np.zeros_like(centers)
        np.add.at(sums, a, xb.astype(np.float64))
        bc = np.bincount(a, minlength=k).astype(np.int64)
        touched = bc > 0
        total = counts[touched] + bc[touched]
        centers[touched] = (centers[touched] * counts[touched, None] + sums[touched]) / total[:, None]
        counts[touched] = total
    return centers.astype(np.float32)


def assign_cells(x: np.ndarray, centroids: np.ndarray, *, batch_size: int | None = None,
                 mesh=None, device: str | torch.device | None = None) -> np.ndarray:
    """Nearest-centroid id per row: int32 ``[N]``, on the card in batches
    (over the ``data`` line of ``mesh``), the last one zero-padded to the
    batch as the JAX assigner pads it."""
    x = np.ascontiguousarray(x, np.float32)
    dev = resolve_device(device)
    cents = torch.from_numpy(np.ascontiguousarray(centroids, np.float32)).to(dev)
    step = _draw_size(x.shape[0], batch_size or ASSIGN_BATCH)
    batch = _compiled_batch(step, mesh)
    out = np.empty(x.shape[0], np.int32)
    for lo in range(0, x.shape[0], step):
        out[lo:lo + step] = _assign(x[lo:lo + step], cents, batch, mesh)
    return out
