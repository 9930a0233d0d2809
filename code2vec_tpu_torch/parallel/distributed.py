"""Process groups, host-side feeding and the collectives of the mesh.

Counterpart of ``code2vec_tpu/parallel/distributed.py``. JAX forms its
process group with ``jax.distributed`` and lets XLA insert the
collectives; here :func:`initialize_from_env` forms a ``torch.distributed``
group (NCCL on the card, gloo on the CPU) and the collectives are
``torch.autograd.Function`` s of the port's own, Megatron's conjugate
pairs (``torch.distributed.nn.functional``'s all-reduce sums again in its
backward, which is wrong for the uses below):

- :func:`reduce_from_group`: all-reduce SUM forward, identity backward.
  For a value every rank of the line then uses identically: the
  row-sharded gather's rows (an all-reduce there in the backward would
  multiply each table gradient by the line's size) and the ctx pool's
  numerator and denominator;
- :func:`copy_to_group`: identity forward, all-reduce SUM backward: the
  code vector entering the column-sharded head, each rank's head
  contributing a partial gradient;
- :func:`gather_from_group`: all-gather along a dim forward, this rank's
  slice backward: the head's logits along the label axis, and the tables
  before K3 under ``model > 1``;
- :func:`all_reduce_max` (no gradient): the ctx pool's max shift.

Feeding (JAX ``:84-186``): with a replicated corpus every rank builds the
same global batch and :func:`global_batch` keeps this rank's rows (its
data coordinate) and bag columns (its ctx coordinate); with a
host-sharded corpus each feed group (the ranks of one data coordinate,
:func:`feed_groups`) builds its own ``B / data`` rows and
:func:`local_to_global_batch` keeps the bag columns. Rows lie in the
global batch by data coordinate, as JAX's global arrays lay them.
"""

from __future__ import annotations

import datetime
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from code2vec_tpu_torch.parallel.mesh import AXIS_CTX, AXIS_DATA, Mesh

logger = logging.getLogger(__name__)

BAG_KEYS = ("starts", "paths", "ends")
# the default timeout of a group this module forms (a missed collective
# fails a rank instead of hanging it for the library's 30 minutes)
DEFAULT_TIMEOUT_S = 600.0


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def initialize_from_env(device: str | torch.device | None = None,
                        timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Form the process group from torchrun's ``RANK`` / ``WORLD_SIZE`` /
    ``MASTER_ADDR`` / ``MASTER_PORT``, or JAX's ``COORDINATOR_ADDRESS`` /
    ``NUM_PROCESSES`` / ``PROCESS_ID``; the backend follows ``device``
    (NCCL for the card, gloo for ``"cpu"``). A no-op returning False when a
    group already exists (a caller formed its own) or the environment names
    none (one process)."""
    if not dist.is_available() or dist.is_initialized():
        return False
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env and "MASTER_ADDR" in env:
        init = f"tcp://{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    elif env.get("COORDINATOR_ADDRESS") and env.get("NUM_PROCESSES") and env.get("PROCESS_ID"):
        init = f"tcp://{env['COORDINATOR_ADDRESS']}"
        rank, world = int(env["PROCESS_ID"]), int(env["NUM_PROCESSES"])
    else:
        return False
    on_card = torch.device(device).type == "cuda" if device is not None else (
        torch.cuda.is_available())
    backend = "nccl" if on_card else "gloo"
    if on_card:
        torch.cuda.set_device(local_rank())
    dist.init_process_group(backend, init_method=init, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    logger.info("torch.distributed up: rank %d/%d (%s) via %s", rank, world, backend, init)
    return True


def rank_device(device: str | torch.device | None) -> torch.device:
    """The card a rank drives: ``cuda:LOCAL_RANK`` for ``"cuda"`` or None
    (when a card is present), else ``device`` itself."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank())
    return dev


def process_info(device: torch.device | None = None) -> dict:
    """This process's identity block for the run manifest (JAX
    ``process_info``)."""
    up = dist.is_available() and dist.is_initialized()
    dev = torch.device(device if device is not None else "cpu")
    return {
        "process_index": dist.get_rank() if up else 0,
        "process_count": dist.get_world_size() if up else 1,
        "backend": dist.get_backend() if up else dev.type,
        "device_kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
        "local_device_count": 1,
        "global_device_count": dist.get_world_size() if up else 1,
    }


def _slice_bag(batch: dict, mesh: Mesh) -> dict:
    """This rank's bag columns (numpy or torch). A width the ctx axis does
    not divide (a bucket's) is padded with PAD columns first, which the
    pool masks out, as GSPMD pads an uneven shard."""
    c, n = mesh.coords[AXIS_CTX], mesh.shape[AXIS_CTX]
    if n == 1:
        return batch
    out = dict(batch)
    for key in BAG_KEYS:
        x = batch[key]
        pad = -x.shape[1] % n
        if pad:
            x = (np.pad(x, ((0, 0), (0, pad))) if isinstance(x, np.ndarray)
                 else torch.nn.functional.pad(x, (0, pad)))
        w = x.shape[1] // n
        out[key] = x[:, c * w:(c + 1) * w]
    return out


def global_batch(mesh: Mesh, full_batch: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """This rank's part of a global batch every rank holds whole: rows
    ``[d * B/D, (d + 1) * B/D)`` by its data coordinate, bag columns by its
    ctx coordinate (JAX ``global_batch``'s layout)."""
    d, n = mesh.coords[AXIS_DATA], mesh.shape[AXIS_DATA]
    out = dict(full_batch)
    if n > 1:
        b = len(full_batch["labels"])
        if b % n:
            raise ValueError(f"batch of {b} rows does not divide over data_axis {n}")
        rows = b // n
        out = {k: v[d * rows:(d + 1) * rows] for k, v in full_batch.items()}
    return _slice_bag(out, mesh)


def local_to_global_batch(mesh: Mesh, local_batch: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """This rank's part of its feed group's sub-batch (a host-sharded
    corpus: the rows are the group's already): its bag columns."""
    return _slice_bag(local_batch, mesh)


def feed_groups(mesh: Mesh) -> tuple[int, int]:
    """``(my_group, n_groups)`` of host-sharded feeding (JAX
    ``feed_groups``): a group is the ranks of one data coordinate, which
    load the same corpus shard (``load_corpus(shard=feed_groups(mesh))``)
    and build the same ``B / data`` rows; groups are ordered by their
    coordinate, so group ``g`` owns global rows ``[g * B/D, (g + 1) * B/D)``."""
    if mesh.rank not in mesh.grid:
        raise ValueError(f"rank {mesh.rank} is not in the mesh {mesh.grid.tolist()}")
    return mesh.coords[AXIS_DATA], mesh.shape[AXIS_DATA]


def comm_device(group=None) -> torch.device:
    """Where a group's host-side values travel: the card for NCCL, the CPU
    for gloo."""
    backend = dist.get_backend(group)
    return torch.device("cuda", torch.cuda.current_device()) if backend == "nccl" \
        else torch.device("cpu")


# ---------------------------------------------------------------------------
# collectives: every helper is the identity on a group of None (one rank)
# ---------------------------------------------------------------------------


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        me = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, me * ctx.size, ctx.size).contiguous(), None, None


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce SUM over ``group``; the backward is the identity."""
    return x if group is None else _ReduceFromGroup.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """The identity; the backward all-reduces the gradient over ``group``."""
    return x if group is None else _CopyToGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """All-gather along ``dim`` in group-rank order; the backward keeps this
    rank's slice."""
    if group is None:
        return x
    return _GatherFromGroup.apply(x, group, dim % x.dim())


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce MAX over ``group`` (no gradient)."""
    return x if group is None else _all_reduce(x.detach(), group, dist.ReduceOp.MAX)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce SUM over ``group`` (no gradient)."""
    return x if group is None else _all_reduce(x.detach(), group)


def allgather_to_host(x, mesh: Mesh, axis: str = AXIS_DATA) -> np.ndarray:
    """Every rank's ``x`` (a tensor or array, of any length along dim 0)
    concatenated in the ``axis`` line's order, as host numpy on every rank
    (JAX ``allgather_to_host``; ``-1``-style padding to the longest)."""
    group = mesh.group(axis)
    arr = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if group is None:
        return arr
    dev = comm_device(group)
    n = torch.tensor([arr.shape[0]], dtype=torch.int64, device=dev)
    counts = _all_gather(n, group, 0).tolist()
    pad = max(counts)
    t = torch.zeros((pad, *arr.shape[1:]), dtype=torch.from_numpy(arr[:0].copy()).dtype,
                    device=dev)
    if arr.shape[0]:
        t[:arr.shape[0]] = torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
    parts = _all_gather(t, group, 0).reshape(len(counts), pad, *arr.shape[1:]).cpu().numpy()
    return np.concatenate([parts[i, :c] for i, c in enumerate(counts)])


def process_allgather(x) -> np.ndarray:
    """Every rank's host vector ``x`` (int64, the same length on every
    rank) stacked in world-rank order: ``[world, len(x)]`` on every rank
    (JAX ``multihost_utils.process_allgather``); ``x[None]`` alone."""
    arr = np.ascontiguousarray(np.asarray(x, np.int64))
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return arr[None]
    t = torch.from_numpy(arr).to(comm_device())
    return _all_gather(t[None], None, 0).cpu().numpy()


def broadcast_flag(value: bool) -> bool:
    """Rank 0's ``value`` on every rank of the world (one tiny broadcast)."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return bool(value)
    t = torch.tensor([1 if value else 0], dtype=torch.int32, device=comm_device())
    dist.broadcast(t, 0)
    return bool(t.item())


def barrier() -> None:
    """Wait for every rank of the world (a no-op alone)."""
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
