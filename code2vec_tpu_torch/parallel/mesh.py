"""The ``(data, model, ctx)`` mesh over the ranks of a process group.

Counterpart of ``code2vec_tpu/parallel/mesh.py``. JAX runs one controller
over many devices; PyTorch runs one process a card, so a mesh of
``data x model x ctx`` needs a ``torch.distributed`` group of exactly that
world size. The ranks lie on the grid in the order JAX's
``np.asarray(devices).reshape(data, model, ctx)`` lays devices
(:func:`mesh_grid`), and each axis line gets a process group of its own:

- ``data``: data parallelism; each rank takes ``B / data`` rows of the
  global batch and the gradients are all-reduced over the line;
- ``model``: the embedding tables row-sharded over the vocab, the label
  head column-sharded (``parallel/shardings.py``);
- ``ctx``: the bag axis ``L`` sharded; the pool's max and sums are
  all-reduced over the line (``parallel/context.py``).

``dc`` is the line of ranks that share a model coordinate (the data x ctx
plane): the gradients of the bag-side parameters sum over it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

AXIS_DATA = "data"
AXIS_MODEL = "model"
AXIS_CTX = "ctx"
AXES = (AXIS_DATA, AXIS_MODEL, AXIS_CTX)
# a group that is not an axis: the data x ctx plane through a rank
GROUP_DC = "dc"


def mesh_grid(data: int | None, model: int, ctx: int, world_size: int) -> np.ndarray:
    """The ranks on the ``[data, model, ctx]`` grid. ``data=None`` absorbs
    the ranks the other axes leave (JAX ``make_mesh``). The mesh must
    cover the world exactly: one process drives one card."""
    if model < 1 or ctx < 1 or (data is not None and data < 1):
        raise ValueError(f"mesh axes must be >= 1, got data={data} model={model} ctx={ctx}")
    if data is None:
        data = max(world_size // (model * ctx), 1)
    n = data * model * ctx
    if n > world_size:
        raise ValueError(f"mesh ({data}x{model}x{ctx}={n}) exceeds {world_size} ranks")
    if n != world_size:
        raise ValueError(
            f"mesh ({data}x{model}x{ctx}={n}) must cover the process group's {world_size} "
            f"ranks: one process drives one card; launch with torchrun --nproc_per_node {n}")
    return np.arange(n).reshape(data, model, ctx)


@dataclass
class Mesh:
    """This rank's view of the mesh: the grid, its coordinates and the
    process group of each axis line through it (None for a line of one
    rank, whose collectives are the identity)."""

    grid: np.ndarray  # int [data, model, ctx] of ranks
    rank: int
    groups: dict = field(default_factory=dict, repr=False)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(AXES, (int(n) for n in self.grid.shape)))

    @property
    def axis_names(self) -> tuple[str, ...]:
        return AXES

    @property
    def size(self) -> int:
        return int(self.grid.size)

    @property
    def coords(self) -> dict[str, int]:
        pos = np.argwhere(self.grid == self.rank)[0]
        return dict(zip(AXES, (int(p) for p in pos)))

    def group(self, axis: str):
        """The process group of ``axis``'s line through this rank (``"dc"``:
        the data x ctx plane), or None when the line is this rank alone."""
        return self.groups.get(axis)


def _lines(grid: np.ndarray) -> dict[str, list[list[int]]]:
    """Every line of each axis (and the data x ctx planes), in a fixed
    order all ranks share: ``new_group`` is collective over the world."""
    d, m, c = grid.shape
    return {
        AXIS_DATA: [grid[:, j, k].tolist() for j in range(m) for k in range(c)],
        AXIS_MODEL: [grid[i, :, k].tolist() for i in range(d) for k in range(c)],
        AXIS_CTX: [grid[i, j, :].tolist() for i in range(d) for j in range(m)],
        GROUP_DC: [grid[:, j, :].reshape(-1).tolist() for j in range(m)],
    }


def make_mesh(data: int | None = None, model: int = 1, ctx: int = 1, timeout_s: float = 0) -> Mesh:
    """The mesh over the current process group (one rank and no group:
    a ``1x1x1`` mesh). Every rank must call this with the same axes: each
    axis line's group is made by all ranks together."""
    import torch.distributed as dist

    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    rank = dist.get_rank() if up else 0
    want = None if data is None else data * model * ctx
    if not up and (want is None or want > 1):
        if want is None and model * ctx == 1:
            return single_device_mesh()
        raise ValueError(
            f"mesh axes data={data} model={model} ctx={ctx} need a torch.distributed process "
            "group of that many ranks: launch with torchrun --nproc_per_node N (or call "
            "parallel.distributed.initialize_from_env first)")
    grid = mesh_grid(data, model, ctx, world)
    mesh = Mesh(grid=grid, rank=rank)
    kw = {}
    if timeout_s:
        import datetime

        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    for axis, lines in _lines(grid).items():
        for ranks in lines:
            group = dist.new_group(ranks, **kw) if len(ranks) > 1 else None
            if rank in ranks:
                mesh.groups[axis] = group
    return mesh


def single_device_mesh() -> Mesh:
    """The degenerate ``1x1x1`` mesh of one process."""
    return Mesh(grid=np.zeros((1, 1, 1), np.int64), rank=0)
