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
"""

from __future__ import annotations

import numpy as np
import torch

from code2vec_tpu_torch.ops.backend import resolve_device

__all__ = ["kmeans_pp_init", "kmeans_fit", "assign_cells"]

ASSIGN_BATCH = 65536  # rows per assignment launch of a full pass


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
    first index wins a tie)."""
    c2 = (cents * cents).sum(dim=1)
    return torch.argmin(c2[None, :] - 2.0 * (xb @ cents.T), dim=1)


def _draw_size(n: int, batch_size: int | None) -> int:
    """Rows sampled per mini-batch: a function of (n, batch_size) only."""
    batch = int(batch_size) if batch_size else min(n, 16384)
    return max(min(batch, n), 1)


def kmeans_fit(x: np.ndarray, k: int, *, seed: int = 0, iters: int = 25,
               batch_size: int | None = None,
               device: str | torch.device | None = None) -> np.ndarray:
    """Fit ``k`` centroids over ``x [N, E]``; returns f32 ``[k, E]``.
    Per iteration a seeded sample is assigned on the card and folded into
    the running per-cluster means on the host (float64, fixed order).
    Clusters that never receive a sample keep their k-means++ seed point."""
    x = np.ascontiguousarray(x, np.float32)
    n = x.shape[0]
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    centers = kmeans_pp_init(x, k, rng, dev).astype(np.float64)
    counts = np.zeros(k, np.int64)
    draw = _draw_size(n, batch_size)
    for _ in range(max(int(iters), 0)):
        idx = rng.choice(n, size=draw, replace=False) if draw < n else np.arange(n)
        xb = x[idx]
        cents = torch.from_numpy(centers.astype(np.float32)).to(dev)
        a = _nearest(torch.from_numpy(xb).to(dev), cents).cpu().numpy()
        sums = np.zeros_like(centers)
        np.add.at(sums, a, xb.astype(np.float64))
        bc = np.bincount(a, minlength=k).astype(np.int64)
        touched = bc > 0
        total = counts[touched] + bc[touched]
        centers[touched] = (centers[touched] * counts[touched, None] + sums[touched]) / total[:, None]
        counts[touched] = total
    return centers.astype(np.float32)


def assign_cells(x: np.ndarray, centroids: np.ndarray, *, batch_size: int | None = None,
                 device: str | torch.device | None = None) -> np.ndarray:
    """Nearest-centroid id per row: int32 ``[N]``, on the card in batches."""
    x = np.ascontiguousarray(x, np.float32)
    dev = resolve_device(device)
    cents = torch.from_numpy(np.ascontiguousarray(centroids, np.float32)).to(dev)
    step = int(batch_size) if batch_size else ASSIGN_BATCH
    out = np.empty(x.shape[0], np.int32)
    for lo in range(0, x.shape[0], step):
        xb = torch.from_numpy(x[lo:lo + step]).to(dev)
        out[lo:lo + step] = _nearest(xb, cents).cpu().numpy()
    return out
