"""The IVF-PQ index: build, (de)serialize, and the query path on the card.

Counterpart of ``code2vec_tpu/ann/index.py``. Build (:func:`build_index`):
L2-normalize the vectors, k-means the unit rows into ``n_list`` cells (the
coarse quantizer), PQ-encode each row's residual (``pq.py``), then lay the
corpus out cell-major: every cell's rows packed into a fixed ``capacity``
slab (the largest cell rounded up to a multiple of 128), so the search is
static-shaped — codes ``[n_list, C, M]`` uint8, per-row scales
``[n_list, C]`` f32, original row ids ``[n_list, C]`` int32 (``-1`` on pad
slots). The index serializes through the ``formats/ann_io.py`` container
together with the unit rows (the exact re-rank matrix) and the labels, in
the JAX package's layout, so either package reads the other's files.

Per query, :class:`AnnSearcher` scores the cells against the centroids,
probes the top ``n_probe``, builds the ``[M, 256]`` LUT, scores the probed
slabs with K5 (``lut_kernel.py``), adds the coarse term and returns a
``shortlist`` of candidate row ids for exact re-ranking: O(n_probe * C * M
+ shortlist * E) per query instead of O(N * E). Query batches pad to a
power of two, as the JAX searcher's compiled entry points do; the products
run in full f32 (TF32 off), so the probe agrees with the JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from code2vec_tpu_torch.ops.backend import resolve_device

__all__ = ["IvfPqIndex", "build_index", "save_index", "load_index", "AnnSearcher",
           "normalize_rows", "pow2_bucket", "require_full_f32"]

_LANE = 128


def normalize_rows(rows: np.ndarray) -> np.ndarray:
    """L2-normalize ``[N, E]`` rows: cosine becomes a plain dot product."""
    rows = np.ascontiguousarray(rows, np.float32)
    norms = np.linalg.norm(rows, axis=1, keepdims=True)
    return rows / np.maximum(norms, 1e-12)


def pow2_bucket(n: int, cap: int | None = None) -> int:
    """Round up to a power of two, optionally capped: the query-batch and
    k bucketing rule of both retrieval backends."""
    bucket = 1
    while bucket < n:
        bucket *= 2
    return min(bucket, cap) if cap is not None else bucket


def require_full_f32(dev: torch.device) -> None:
    """Retrieval ranks by f32 products; TF32 would move rankings off the
    reference's, so it must be off on the card."""
    if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "retrieval needs full-f32 matmuls: set "
            "torch.backends.cuda.matmul.allow_tf32 = False"
        )


@dataclasses.dataclass
class IvfPqIndex:
    centroids: np.ndarray  # f32 [n_list, E]
    codebooks: np.ndarray  # f32 [M, 256, dsub]
    codes: np.ndarray  # uint8 [n_list, C, M]
    scales: np.ndarray  # f32 [n_list, C] (0 on pad slots)
    ids: np.ndarray  # int32 [n_list, C] (-1 on pad slots)
    cell_counts: np.ndarray  # int32 [n_list] real rows per cell
    meta: dict


def build_index(rows: np.ndarray, *, n_list: int, m: int, seed: int = 0,
                kmeans_iters: int = 25, pq_iters: int = 15, batch_size: int | None = None,
                capacity: int | None = None,
                device: str | torch.device | None = None) -> tuple[IvfPqIndex, np.ndarray]:
    """Train an index over ``rows [N, E]``: ``(index, unit_rows)``. Seeded
    end to end (one seed lineage, host-side draws and folds); rows keep
    their relative order inside each cell."""
    from code2vec_tpu_torch.ann import pq
    from code2vec_tpu_torch.ann.kmeans import assign_cells, kmeans_fit

    dev = resolve_device(device)
    unit = normalize_rows(rows)
    n, dim = unit.shape
    n_list = max(min(int(n_list), n), 1)
    if dim % m:
        raise ValueError(f"m={m} must divide dim={dim}")
    centroids = kmeans_fit(unit, n_list, seed=seed, iters=kmeans_iters,
                           batch_size=batch_size, device=dev)
    assign = assign_cells(unit, centroids, device=dev)
    residuals = unit - centroids[assign]
    codebooks, row_scales = pq.train_codebooks(residuals, m, seed=seed + 1, iters=pq_iters,
                                               batch_size=batch_size, device=dev)
    row_codes = pq.encode(residuals, codebooks, row_scales, device=dev)

    counts = np.bincount(assign, minlength=n_list).astype(np.int32)
    cap = int(capacity) if capacity else int(counts.max())
    cap = max(-(-cap // _LANE) * _LANE, _LANE)
    if counts.max() > cap:
        raise ValueError(
            f"capacity {cap} < largest cell ({int(counts.max())} rows); raise capacity or n_list"
        )
    codes = np.zeros((n_list, cap, m), np.uint8)
    scales = np.zeros((n_list, cap), np.float32)
    ids = np.full((n_list, cap), -1, np.int32)
    order = np.argsort(assign, kind="stable")
    starts = np.searchsorted(assign[order], np.arange(n_list))
    for cell in range(n_list):
        lo, cnt = int(starts[cell]), int(counts[cell])
        sel = order[lo:lo + cnt]
        codes[cell, :cnt] = row_codes[sel]
        scales[cell, :cnt] = row_scales[sel]
        ids[cell, :cnt] = sel.astype(np.int32)
    meta = {"version": 1, "n": int(n), "dim": int(dim), "n_list": int(n_list), "m": int(m),
            "dsub": int(dim // m), "capacity": int(cap), "seed": int(seed)}
    index = IvfPqIndex(centroids=centroids, codebooks=codebooks, codes=codes, scales=scales,
                       ids=ids, cell_counts=counts, meta=meta)
    return index, unit


def save_index(path: str, index: IvfPqIndex, unit_rows: np.ndarray, labels: list[str],
               defaults: dict | None = None) -> None:
    """Index + re-rank rows + labels as one container; ``defaults`` (e.g.
    ``{"n_probe": 8, "shortlist": 128}``) ride in the header meta."""
    from code2vec_tpu_torch.formats.ann_io import write_ann_container

    n = index.meta["n"]
    if len(labels) != n or unit_rows.shape[0] != n:
        raise ValueError(
            f"labels ({len(labels)}) and rows ({unit_rows.shape[0]}) must match the index "
            f"size ({n})"
        )
    encoded = [label.encode("utf-8") for label in labels]
    offsets = np.zeros(n + 1, np.int64)
    offsets[1:] = np.cumsum([len(b) for b in encoded])
    blob = b"".join(encoded)
    arrays = {
        "centroids": index.centroids,
        "codebooks": index.codebooks,
        "codes": index.codes,
        "scales": index.scales,
        "ids": index.ids,
        "cell_counts": index.cell_counts,
        "label_offsets": offsets,
        "label_blob": np.frombuffer(blob, np.uint8) if blob else np.zeros(0, np.uint8),
        "rows": np.ascontiguousarray(unit_rows, np.float32),
    }
    meta = dict(index.meta)
    meta["defaults"] = dict(defaults or {})
    write_ann_container(path, arrays, meta)


def load_index(path: str) -> tuple[IvfPqIndex, np.ndarray, list[str]]:
    """``(index, unit_rows, labels)`` from a container; ``rows`` and
    ``codes`` stay memory-mapped until touched."""
    from code2vec_tpu_torch.formats.ann_io import read_ann_container

    arrays, meta = read_ann_container(path)
    offsets = arrays["label_offsets"]
    blob = bytes(arrays["label_blob"])
    labels = [blob[int(offsets[i]):int(offsets[i + 1])].decode("utf-8")
              for i in range(len(offsets) - 1)]
    index = IvfPqIndex(
        centroids=arrays["centroids"], codebooks=arrays["codebooks"], codes=arrays["codes"],
        scales=arrays["scales"], ids=arrays["ids"],
        cell_counts=np.asarray(arrays["cell_counts"], np.int32),
        meta={k: v for k, v in meta.items() if k != "defaults"},
    )
    index.meta["defaults"] = dict(meta.get("defaults", {}))
    return index, arrays["rows"], labels


class AnnSearcher:
    """IVF-PQ search with the index resident on the card.

    ``n_probe`` is clamped to the non-empty cells and ``shortlist`` to the
    probed slots; empty cells get a ``-inf`` coarse bias (never probed) and
    pad slots a ``-inf`` row bias (never short-listed)."""

    def __init__(self, index: IvfPqIndex, *, n_probe: int = 8, shortlist: int = 128,
                 device: str | torch.device | None = None) -> None:
        self.device = resolve_device(device)
        meta = index.meta
        self.meta = meta
        self.capacity = int(meta["capacity"])
        self.dim = int(meta["dim"])
        self.m = int(meta["m"])
        self.n_list = int(meta["n_list"])
        counts = np.asarray(index.cell_counts, np.int64)
        self.n_probe = max(min(int(n_probe), int((counts > 0).sum())), 1)
        self.shortlist = max(min(int(shortlist), self.n_probe * self.capacity), 1)
        self._counts = counts
        self._centroids_host = np.ascontiguousarray(index.centroids, np.float32)
        ids = np.ascontiguousarray(index.ids, np.int32)
        dev = self.device

        def put(x, dtype=None):  # a copy: container sections are read-only maps
            return torch.from_numpy(np.array(x, dtype)).to(dev)

        self._centroids = put(self._centroids_host)
        self._codebooks = put(index.codebooks, np.float32)
        self._codes = put(index.codes, np.uint8)
        self._scales = put(index.scales, np.float32)
        self._bias = put(np.where(ids < 0, -np.inf, 0.0), np.float32)
        self._ids = put(ids)
        self._cell_bias = put(np.where(counts == 0, -np.inf, 0.0), np.float32)
        self._buckets: set[int] = set()

    def _cache_size(self) -> int:
        """Distinct query-batch buckets served so far (bounded by
        log2 of the largest batch)."""
        return len(self._buckets)

    def probed_fraction(self, queries: np.ndarray) -> float:
        """Mean fraction of the index's real rows inside the probed cells,
        ranking cells as the query path does (empty cells never probed)."""
        q = normalize_rows(np.asarray(queries, np.float32).reshape(-1, self.dim))
        sims = q @ self._centroids_host.T
        sims[:, self._counts == 0] = -np.inf
        order = np.argsort(-sims, axis=1)[:, : self.n_probe]
        probed = self._counts[order].sum(axis=1)
        return float(probed.mean() / max(self._counts.sum(), 1))

    def describe(self) -> dict:
        return {
            "n_list": self.n_list,
            "n_probe": self.n_probe,
            "shortlist": self.shortlist,
            "m": self.m,
            "capacity": self.capacity,
            "kernel_route": self.device.type,
            "search_executables": self._cache_size(),
        }

    def search(self, queries: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Shortlist for ``queries [Q, E]`` (normalized here): ``(adc_scores
        [Q, S] f32, row_ids [Q, S] int32, -1 = pad slot)``. The scores are
        the approximate (ADC) values; callers re-rank the ids exactly. The
        cells are scored by K5's wrapper (``lut_score_cells``): the kernel
        on the card, its plain version on the CPU."""
        from code2vec_tpu_torch.ann.lut_kernel import lut_score_cells

        require_full_f32(self.device)
        q = normalize_rows(np.asarray(queries, np.float32).reshape(-1, self.dim))
        n = q.shape[0]
        qb = pow2_bucket(max(n, 1))
        if n < qb:
            q = np.concatenate([q, np.zeros((qb - n, self.dim), np.float32)])
        self._buckets.add(qb)
        cap, m = self.capacity, self.m
        with torch.inference_mode():
            qd = torch.from_numpy(q).to(self.device)
            cell_scores = qd @ self._centroids.T + self._cell_bias[None, :]
            coarse, probed = torch.topk(cell_scores, self.n_probe, dim=1)
            lut = torch.einsum("qmd,mjd->qmj", qd.reshape(qb, m, self.dim // m), self._codebooks)
            adc = lut_score_cells(lut.contiguous(), probed.to(torch.int32), self._codes,
                                  self._scales, self._bias)
            flat = (adc + coarse[:, :, None]).reshape(qb, self.n_probe * cap)
            top, flat_idx = torch.topk(flat, self.shortlist, dim=1)
            p_idx = torch.div(flat_idx, cap, rounding_mode="floor")
            cells = torch.gather(probed, 1, p_idx)
            rows = self._ids[cells, flat_idx - p_idx * cap]
            return top[:n].cpu().numpy(), rows[:n].cpu().numpy()
