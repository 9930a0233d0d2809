"""Touched-rows ("lazy") Adam for the embedding tables.

Counterpart of ``code2vec_tpu/train/table_opt.py``. The dense step forms a
``[vocab, dim]`` gradient for each table and runs Adam's read-modify-write
over every row of parameter, ``mu`` and ``nu``, whatever the batch touched.
This module updates only the touched rows, with the semantics of
``torch.optim.SparseAdam`` (JAX ``table_opt.py:13-23``):

- the slots of a repeated id are summed first (``grad.coalesce()``);
- touched rows get Adam with the global step's bias correction,
  ``step_size = lr * sqrt(1 - b2^t) / (1 - b1^t)`` and ``denom = sqrt(nu)
  + eps`` (torch's eps placement);
- untouched rows keep their parameters and both moments bit for bit.

One step count ``t`` is shared by both tables; ``mu`` is stored in
``mu_dtype`` (its update uses the unrounded f32 ``b1``, as JAX's
``_lazy_rows`` does), ``nu`` in f32. The tables take no weight decay
(``torch.optim.SparseAdam`` has none); the other parameters step with the
port's dense Adam, weight decay included (JAX ``mixed_table_adam``).

The per-slot gradients come from the model's zero offsets
(``Code2Vec.forward(embed_offsets=...)``, ``train/step.py``): ``ids[i]`` is
the row the ``i``-th gathered slot read, ``slots[i]`` the loss's gradient
with respect to that gather.

Static shapes, so a step never waits for the device: the ``N`` ids are
sorted, run starts give each slot its segment, the slots are summed into an
``[N, dim]`` buffer (the distinct ids at the front, a ``vocab`` sentinel
behind them: :func:`dedupe_sorted`). Sentinel row ``p`` is then pointed at
distinct row ``p mod K`` with its summed gradient, so every row written
twice is written with the same value: PyTorch has no ``mode="drop"``
scatter, and the sentinel must not reach a real row (row 0 is PAD, which
every PAD slot touches). Spreading them keeps the copies of one row few,
as the zero slots' own sum rows keep the atomic adds off one row: on the
card many writes to one row queue behind each other.

Over a ``model`` axis (``parallel/shardings``: the tables row-sharded) each
rank holds global rows ``[lo, lo + rows)`` of a table and of its moments.
Every rank of the model line computes the same slots, so each keeps the
slots of its own ids, mapped to local rows; the others become the
sentinel with zero gradients before :func:`dedupe_sorted` (else they
would count as touched). A rank whose shard the batch does not touch (PAD
row 0 lives on rank 0 only) writes each row it reads back unchanged,
decided on the device: no step waits for a count.
"""

from __future__ import annotations

import numpy as np
import torch

# the two tables' parameter names (models/code2vec.py), in table_grads order
TABLE_PARAMS = ("terminal_embedding.weight", "path_embedding.weight")


def dedupe_sorted(ids: torch.Tensor, slots: torch.Tensor, vocab: int):
    """Coalesce duplicate ids (JAX ``_dedupe_sorted``): ``(uids, gsum)`` of
    capacity ``N``, the first rows the distinct ids (ascending) with their
    summed slots, the rest the ``vocab`` sentinel with zero rows."""
    n = ids.shape[0]
    sid, order = torch.sort(ids.long(), stable=True)
    is_start = torch.ones(n, dtype=torch.bool, device=ids.device)
    is_start[1:] = sid[1:] != sid[:-1]
    seg = torch.cumsum(is_start, 0) - 1
    # each slot's segment in the slots' own order: the sum reads them once
    slot_seg = torch.empty_like(seg).scatter_(0, order, seg)
    # a slot of zeros adds nothing: it goes to a sum row of its own, so the
    # zero slots of one id (every PAD slot reads row 0) do not queue their
    # atomic adds on that id's row
    slot_seg = torch.where(slots.ne(0).any(dim=1), slot_seg,
                           torch.arange(n, device=slots.device))
    gsum = torch.zeros((n, slots.shape[1]), dtype=slots.dtype, device=slots.device)
    gsum.index_add_(0, slot_seg, slots)
    uids = torch.full((n,), vocab, dtype=torch.long, device=ids.device).scatter_(0, seg, sid)
    return uids, gsum


@torch.no_grad()
def lazy_rows(param: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor, ids: torch.Tensor,
              slots: torch.Tensor, step_size: float, b1: float, b2: float, eps: float,
              row_lo: int | None = None) -> torch.Tensor:
    """One SparseAdam step of ``param``'s touched rows, in place (JAX
    ``_lazy_rows`` + ``apply_updates_sparse``). ``row_lo``: ``param`` is
    the row shard ``[row_lo, row_lo + rows)`` of a table the global
    ``ids`` index; the ids outside it are dropped. Returns the rows it
    touched, a 0-d tensor on the device (of the ``N`` rows it reads and
    writes, one a slot, whatever that count)."""
    vocab = param.shape[0]
    ids, slots = ids.reshape(-1), slots.reshape(-1, param.shape[1]).float()
    if row_lo is not None:
        local = ids.long() - row_lo
        inside = (local >= 0) & (local < vocab)
        ids, slots = torch.where(inside, local, vocab), torch.where(inside[:, None], slots, 0.0)
    uids, gsum = dedupe_sorted(ids, slots, vocab)
    # sentinel row p -> distinct row p mod K and its sum: a row written twice
    # is written the same value, and no row more than ~N/K times
    pos = torch.arange(uids.shape[0], device=uids.device)
    valid = uids < vocab
    touched = valid.sum()
    src = torch.where(valid, pos, pos % touched.clamp_min(1))
    uids, gsum = uids[src], gsum[src]
    if row_lo is not None:  # an untouched shard: row 0 read and written back as it was
        uids = uids.clamp_max(vocab - 1)
        before = (param[uids], mu[uids], nu[uids])
    mu_new = mu[uids].float().mul_(b1).add_(gsum, alpha=1.0 - b1)
    nu_new = nu[uids].mul_(b2).addcmul_(gsum, gsum, value=1.0 - b2)
    rows = param[uids].addcdiv_(mu_new, nu_new.sqrt().add_(eps), value=-step_size)
    after = (rows, mu_new.to(mu.dtype), nu_new)
    if row_lo is not None:
        after = tuple(torch.where(touched > 0, a, b) for a, b in zip(after, before))
    for table, new in zip((param, mu, nu), after):
        table.index_copy_(0, uids, new)
    return touched


def bias_corrected_step(lr: float, b1: float, b2: float, t: int) -> float:
    """``lr * sqrt(1 - b2^t) / (1 - b1^t)`` in f32, as the JAX step computes
    it from its f32 count."""
    f32, one = np.float32, np.float32(1.0)
    return float(f32(lr) * np.sqrt(one - f32(b2) ** f32(t)) / (one - f32(b1) ** f32(t)))


class LazyTableAdam(torch.optim.Optimizer):
    """SparseAdam rows on the two tables plus ``dense``, the port's dense
    Adam (``torch.optim.Adam``, or ``TorchStyleAdam`` for a bf16 ``mu``)
    over every other parameter: JAX ``mixed_table_adam``.

    :meth:`step` takes the tables' per-slot gradients; the tables' ``.grad``
    is never read. The moments are made at construction, on the tables'
    device (a row-sharded table's: its shard's). ``row_offsets``: per table,
    the global id of its first row when it is a ``model`` axis's row shard
    (the ids of the slots are global), else None. ``state_dict`` holds the
    tables' state and, under ``"dense"``, the dense optimizer's;
    ``load_state_dict`` keeps ``mu`` in the run's ``mu_dtype``."""

    def __init__(self, tables, dense: torch.optim.Optimizer, lr: float,
                 betas=(0.9, 0.999), eps: float = 1e-8, mu_dtype: torch.dtype = torch.float32,
                 row_offsets=None):
        super().__init__(list(tables), dict(lr=lr, betas=tuple(betas), eps=eps,
                                            mu_dtype=mu_dtype, step=0))
        self.dense = dense
        # a property of this run's mesh, not of the state: kept out of state_dict
        self.row_offsets = list(row_offsets or [None] * len(self.param_groups[0]["params"]))
        self.rows = []  # the last step's (rows read and written, rows touched) a table
        for p in self.param_groups[0]["params"]:
            self.state[p] = {"exp_avg": torch.zeros_like(p, dtype=mu_dtype),
                             "exp_avg_sq": torch.zeros_like(p)}

    def zero_grad(self, set_to_none: bool = True) -> None:
        super().zero_grad(set_to_none)
        self.dense.zero_grad(set_to_none)

    @torch.no_grad()
    def step(self, table_grads=None, closure=None):
        """One step: ``table_grads`` is ``[(ids, slots), ...]`` in the order
        of the tables (terminal, path), then the dense step."""
        if table_grads is None:
            raise ValueError("the lazy table optimizer steps with the tables' per-slot "
                             "gradients: step([(ids, slots), (ids, slots)])")
        (group,) = self.param_groups
        if len(table_grads) != len(group["params"]):
            raise ValueError(f"{len(group['params'])} tables, {len(table_grads)} gradients")
        group["step"] += 1
        b1, b2 = group["betas"]
        step_size = bias_corrected_step(group["lr"], b1, b2, group["step"])
        self.rows = []
        for p, (ids, slots), lo in zip(group["params"], table_grads, self.row_offsets):
            state = self.state[p]
            touched = lazy_rows(p, state["exp_avg"], state["exp_avg_sq"], ids, slots, step_size,
                                b1, b2, group["eps"], lo)
            self.rows.append((ids.numel(), touched))
        return self.dense.step(closure)

    def rows_read(self) -> dict:
        """The last step's rows by table (``terminal``, ``path``):
        ``<table>_rows_processed``, the rows its update read and wrote (one
        a slot, a host int), and ``<table>_rows_touched``, the distinct ids
        among them (a 0-d tensor on the tables' device, read with no
        sync)."""
        out = {}
        for name, (processed, touched) in zip(TABLE_PARAMS, self.rows):
            table = name.split("_", 1)[0]
            out[f"{table}_rows_processed"] = processed
            out[f"{table}_rows_touched"] = touched
        return out

    def state_dict(self):
        out = super().state_dict()
        out["dense"] = self.dense.state_dict()
        return out

    def load_state_dict(self, state_dict) -> None:
        state_dict = dict(state_dict)
        self.dense.load_state_dict(state_dict.pop("dense"))
        super().load_state_dict(state_dict)
        for p in self.param_groups[0]["params"]:
            self.state[p]["exp_avg"] = self.state[p]["exp_avg"].to(self.defaults["mu_dtype"])
