"""Top-k nearest-method retrieval: the exact and the IVF-PQ backends.

Counterpart of ``code2vec_tpu/serve/retrieval.py``. Two backends behind
one interface (``labels``/``n``/``dim``/``top_k``/``top_k_batch``/
``describe``), both resident on the card:

- :class:`RetrievalIndex` (``exact``): the ``[N, E]`` matrix L2-normalized
  once at load, so cosine similarity is one ``q @ rows.T`` (full f32, TF32
  off) followed by ``torch.topk``. The JAX package computes this product
  outside any kernel too.
- :class:`AnnRetrievalIndex` (``ann``): an IVF-PQ index (``ann/``) probes
  ``n_probe`` of ``n_list`` cells, scores their codes with K5 and re-ranks a
  ``shortlist`` exactly on the host against the container's unit rows, so
  every returned similarity is an exact cosine.

On a mesh (``parallel/mesh.Mesh``, one rank a card; every rank of the
model line calls with the same queries and gets the whole answer): the
exact backend pads its rows to a multiple of the ``model`` axis (pad rows
get a ``-inf`` bias, JAX ``:76-90``) and each rank holds its row shard
(``parallel/shardings.retrieval_shardings``), takes its local top-k and
the ranks' candidates are all-gathered and merged by value, then index
(``lax.top_k``'s order on ties); the ann backend's searcher shards its
cells (``ann/index.AnnSearcher``).

Query batches and k round up to powers of two (k capped at N), as the JAX
backends key their compiled entry points; ``describe`` counts the buckets.
``host_rows`` gives the unit rows as host numpy (the hot-swap gate's
recall check, ``serve/swap.py``); ``close`` retires an index with the
generation that owned it.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from code2vec_tpu_torch.ann.index import normalize_rows, pow2_bucket, require_full_f32
from code2vec_tpu_torch.obs import handles
from code2vec_tpu_torch.ops.backend import resolve_device
from code2vec_tpu_torch.parallel.mesh import AXIS_MODEL

logger = logging.getLogger(__name__)

__all__ = ["RetrievalIndex", "AnnRetrievalIndex", "load_retrieval_index"]


class RetrievalIndex:
    """Cosine top-k over ``[n_methods, E]`` vectors on the card (its row
    shard on a mesh's ``model`` line)."""

    def __init__(self, labels: list[str], rows: np.ndarray, mesh=None,
                 device: str | torch.device | None = None) -> None:
        from code2vec_tpu_torch.parallel.shardings import (
            retrieval_shardings,
            shard_start,
            shard_tensor,
        )

        if rows.ndim != 2 or len(labels) != rows.shape[0]:
            raise ValueError(
                f"rows must be [len(labels), E]; got {rows.shape} for {len(labels)} labels"
            )
        self.device = resolve_device(device)
        self.labels = list(labels)
        self.n = len(labels)
        self.dim = int(rows.shape[1])
        self.mesh = mesh
        self.shards = mesh.shape[AXIS_MODEL] if mesh is not None else 1
        unit = torch.from_numpy(normalize_rows(rows))
        self._lo, self._bias = 0, None
        if self.shards > 1:
            n_pad = -(-self.n // self.shards) * self.shards
            unit = torch.cat([unit, unit.new_zeros(n_pad - self.n, self.dim)])
            bias = torch.zeros(n_pad)
            bias[self.n:] = -torch.inf  # pad rows never surface
            entries = retrieval_shardings(mesh, n_pad)["rows"]
            unit, bias = shard_tensor(unit, entries, mesh), shard_tensor(bias, entries[:1], mesh)
            self._lo = shard_start(unit.shape[0], entries, mesh)
            self._bias = bias.to(self.device)
        self._rows = unit.to(self.device)
        self._buckets: set[tuple[int, int]] = set()
        handles.track(self, "retrieval_exact", name=f"{self.n}x{self.dim}")

    @classmethod
    def from_code_vec(cls, path: str, mesh=None,
                      device: str | torch.device | None = None) -> "RetrievalIndex":
        """Load an exported ``code.vec``."""
        from code2vec_tpu_torch.formats.vectors_io import read_code_vectors

        labels, rows = read_code_vectors(path)
        logger.info("retrieval index: %d vectors of dim %d from %s", len(labels),
                    rows.shape[1] if rows.ndim == 2 else -1, path)
        return cls(labels, rows, mesh=mesh, device=device)

    def _cache_size(self) -> int:
        return len(self._buckets)

    def host_rows(self) -> np.ndarray:
        """The unit rows ``[N, E]`` f32, copied off the card (on a mesh
        all-gathered over the model line: every rank of it calls this)."""
        if self.shards == 1:
            return self._rows.cpu().numpy()
        from code2vec_tpu_torch.parallel.distributed import allgather_to_host

        return allgather_to_host(self._rows, self.mesh, AXIS_MODEL)[:self.n]

    def close(self) -> None:
        """Leave the handle ledger (idempotent); the rows go back to the
        allocator with the generation that owns the index."""
        handles.untrack(self)

    def describe(self) -> dict:
        """The health op's retrieval block."""
        return {"backend": "exact", "size": self.n, "dim": self.dim,
                "model_shards": self.shards, "query_executables": self._cache_size()}

    def top_k_batch(self, vectors: np.ndarray, k: int = 5) -> list[list[tuple[str, float]]]:
        """Cosine top-k per query row of ``vectors [Q, E]``."""
        k = min(int(k), self.n)
        if k < 1:
            return [[] for _ in range(len(vectors))]
        require_full_f32(self.device)
        q = normalize_rows(np.asarray(vectors, np.float32).reshape(-1, self.dim))
        n_q = q.shape[0]
        qb, kb = pow2_bucket(max(n_q, 1)), pow2_bucket(k, self.n)
        if n_q < qb:
            q = np.concatenate([q, np.zeros((qb - n_q, self.dim), np.float32)])
        self._buckets.add((kb, qb))
        with torch.inference_mode():
            sims = torch.from_numpy(q).to(self.device) @ self._rows.T
            if self.shards == 1:
                values, indices = torch.topk(sims, kb, dim=1)
                values = values[:n_q, :k].cpu().numpy()
                indices = indices[:n_q, :k].cpu().numpy()
            else:
                values, indices = self._merged_top(sims[:n_q] + self._bias[None, :], kb)
                values, indices = values[:, :k], indices[:, :k]
        return [[(self.labels[int(i)], float(v)) for i, v in zip(indices[r], values[r])]
                for r in range(n_q)]

    def _merged_top(self, sims: torch.Tensor, kb: int) -> tuple[np.ndarray, np.ndarray]:
        """This shard's top ``min(kb, rows)`` of ``sims [Q, rows]`` at global
        indices, all-gathered over the model line as one f64 tensor (exact
        for f32 values and int indices) and merged to the top
        ``kb`` by value descending, then index ascending."""
        from code2vec_tpu_torch.parallel.distributed import allgather_to_host

        values, indices = torch.topk(sims, min(kb, sims.shape[1]), dim=1)
        packed = torch.stack([values.double(), (indices + self._lo).double()])
        every = allgather_to_host(packed[None], self.mesh, AXIS_MODEL)  # [n, 2, Q, k]
        vals, idx = (every[:, j].transpose(1, 0, 2).reshape(sims.shape[0], -1) for j in (0, 1))
        order = np.lexsort((idx, -vals), axis=-1)[:, :kb]
        return (np.take_along_axis(vals, order, 1).astype(np.float32),
                np.take_along_axis(idx, order, 1).astype(np.int64))

    def top_k(self, vector: np.ndarray, k: int = 5) -> list[tuple[str, float]]:
        return self.top_k_batch(np.asarray(vector)[None, :], k)[0]


class AnnRetrievalIndex:
    """The ``ann`` backend: IVF-PQ shortlist on the card, exact f32 re-rank
    on the host. The response schema is the exact backend's; only the
    candidate set is approximate."""

    def __init__(self, labels: list[str], unit_rows: np.ndarray, index, *, n_probe: int = 8,
                 shortlist: int = 128, mesh=None, source: str | None = None,
                 device: str | torch.device | None = None) -> None:
        from code2vec_tpu_torch.ann.index import AnnSearcher

        if unit_rows.ndim != 2 or len(labels) != unit_rows.shape[0]:
            raise ValueError(
                f"rows must be [len(labels), E]; got {unit_rows.shape} for {len(labels)} labels"
            )
        self.labels = list(labels)
        self.n = len(labels)
        self.dim = int(unit_rows.shape[1])
        self._rows = unit_rows  # unit-normalized; may be a memory-mapped view
        self._source = source
        self.searcher = AnnSearcher(index, n_probe=n_probe, shortlist=shortlist, mesh=mesh,
                                    device=device)
        handles.track(self, "mmap_ann", name=source or f"{self.n}x{self.dim}")

    @classmethod
    def from_container(cls, path: str, *, n_probe: int | None = None,
                       shortlist: int | None = None, mesh=None,
                       device: str | torch.device | None = None) -> "AnnRetrievalIndex":
        """Load an index container; ``n_probe``/``shortlist`` default to
        the values in its header."""
        from code2vec_tpu_torch.ann.index import load_index

        index, rows, labels = load_index(path)
        defaults = index.meta.get("defaults", {})
        probe = int(n_probe if n_probe is not None else defaults.get("n_probe", 8))
        short = int(shortlist if shortlist is not None else defaults.get("shortlist", 128))
        logger.info("ann retrieval index: %d vectors of dim %d from %s (n_list=%d m=%d "
                    "n_probe=%d shortlist=%d)", index.meta["n"], index.meta["dim"], path,
                    index.meta["n_list"], index.meta["m"], probe, short)
        return cls(labels, rows, index, n_probe=probe, shortlist=short, mesh=mesh, source=path,
                   device=device)

    def host_rows(self) -> np.ndarray:
        """The container's unit rows ``[N, E]`` f32 (the re-rank rows)."""
        return np.asarray(self._rows, np.float32)

    def close(self) -> None:
        """Leave the handle ledger (idempotent); the searcher's arrays on
        the card and the row view go with the generation that owns it."""
        handles.untrack(self)

    def describe(self) -> dict:
        out = {"backend": "ann", "size": self.n, "dim": self.dim, **self.searcher.describe()}
        if self._source:
            out["index_path"] = self._source
        return out

    def top_k_batch(self, vectors: np.ndarray, k: int = 5) -> list[list[tuple[str, float]]]:
        """ANN cosine top-k per query row. ``k`` beyond the shortlist is
        rejected: the re-rank pool could not fill the response the exact
        backend would give."""
        k = min(int(k), self.n)
        if k < 1:
            return [[] for _ in range(len(vectors))]
        if k > self.searcher.shortlist:
            raise ValueError(
                f"top_k={k} exceeds the ANN shortlist ({self.searcher.shortlist}); raise "
                "--ann_shortlist (or lower top_k)"
            )
        q = normalize_rows(np.asarray(vectors, np.float32).reshape(-1, self.dim))
        _, id_rows = self.searcher.search(q)
        out = []
        for row in range(q.shape[0]):
            ids = id_rows[row]
            ids = ids[ids >= 0]
            sims = np.asarray(self._rows[ids], np.float32) @ q[row]
            order = np.argsort(-sims, kind="stable")[:k]
            out.append([(self.labels[int(ids[i])], float(sims[i])) for i in order])
        return out

    def top_k(self, vector: np.ndarray, k: int = 5) -> list[tuple[str, float]]:
        return self.top_k_batch(np.asarray(vector)[None, :], k)[0]

    def probed_fraction(self, vectors: np.ndarray) -> float:
        return self.searcher.probed_fraction(vectors)


def load_retrieval_index(backend: str, *, code_vec_path: str | None = None,
                         ann_index_path: str | None = None, n_probe: int | None = None,
                         shortlist: int | None = None, mesh=None,
                         device: str | torch.device | None = None):
    """Backend dispatch for the serve CLI (``--retrieval_backend``);
    ``mesh`` shards either backend over its ``model`` line."""
    if backend == "exact":
        if not code_vec_path:
            raise ValueError("retrieval_backend 'exact' needs --code_vec_path")
        return RetrievalIndex.from_code_vec(code_vec_path, mesh=mesh, device=device)
    if backend == "ann":
        if not ann_index_path:
            raise ValueError("retrieval_backend 'ann' needs --ann_index_path")
        return AnnRetrievalIndex.from_container(ann_index_path, n_probe=n_probe,
                                                shortlist=shortlist, mesh=mesh, device=device)
    raise ValueError(f"retrieval_backend must be 'exact' or 'ann', got {backend!r}")
