"""The plain reference: code2vec in plain PyTorch, f32, with no kernel.

It imports neither ``jax`` nor ``code2vec_tpu`` nor anything of
``code2vec_tpu_torch`` (``guard.py`` checks this file's imports), and takes
nothing the program made: the weights come from ``weights.py`` and the
corpus from ``corpus.py``, as the program's do, and what the program
derives from them (its sampled batches, its dropout masks, its optimizer
state) is worked out again here from the seed. Where that needs one of the
program's rules, this file holds a frozen copy of it:

- the device sampler's rotation window (``train/device_epoch.py``
  ``sample_batch_from_shift`` for the method task, shifts uniform in
  ``[0, 2^30)`` from one ``torch.Generator``, ``(B, 1)`` a batch);
- the dropout keep mask (``models/code2vec.py`` ``Code2Vec._keep_mask``:
  one ``bernoulli_`` draw of f32 ``[B, L, H]`` a training forward from the
  module's own generator, divided by the keep probability);
- torch Adam with coupled L2 (``torch.optim.Adam``) for the dense step,
  and SparseAdam's touched-row rule for the lazy tables
  (``train/table_opt.py``: the rows a batch reads, the global step's bias
  correction computed in f32, ``sqrt(nu) + eps``).

The model is the reference code2vec's (model/model.py:15-105) as the port
states it: ``[start; path; end] @ W`` with no bias, LayerNorm (eps 1e-6),
tanh, the keep mask, attention pooling with PAD scored ``s m + (1 - m)
NINF``, a linear head, and the class-weighted NLL over the example mask.
Matrix products run in full f32 unless a caller asks for TF32 (the control).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from c2vbench.seeds import sub_seed, torch_generator
from c2vbench.weights import PARAMS, TABLES

NINF = -3.4e38
LN_EPS = 1e-6
SHIFT_HIGH = 1 << 30


@contextlib.contextmanager
def precision(tf32: bool):
    """Matrix products in TF32 (the control) or in full f32 inside."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(tf32)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def sample_batch(corpus, rows: torch.Tensor, bag: int, generator: torch.Generator) -> dict:
    """One sampled ``[B, bag]`` batch of ``rows`` (the frozen sampler rule)."""
    contexts, row_splits = corpus.contexts, corpus.row_splits
    dev = contexts.device
    rows = rows.long()
    shift = torch.randint(0, SHIFT_HIGH, (rows.shape[0], 1), generator=generator, device=dev)
    off = row_splits[rows]
    n = row_splits[rows + 1] - off
    n_safe = n.clamp(min=1)[:, None]
    j = torch.arange(bag, dtype=torch.int32, device=dev)[None, :]
    idx = (j + shift % n_safe) % n_safe
    valid = j < n.clamp(max=bag)[:, None]
    trip = contexts[torch.where(valid, off[:, None] + idx, 0)]
    pad = torch.zeros((), dtype=trip.dtype, device=dev)
    return {"starts": torch.where(valid, trip[..., 0], pad),
            "paths": torch.where(valid, trip[..., 1], pad),
            "ends": torch.where(valid, trip[..., 2], pad),
            "labels": corpus.labels[rows]}


def lazy_step_size(lr: float, b1: float, b2: float, t: int) -> float:
    """The lazy tables' ``lr * sqrt(1 - b2^t) / (1 - b1^t)``, in f32 as the
    port states it (``train/table_opt.bias_corrected_step``): at ``t = 1``
    the f32 ``b2 = 0.999`` leaves ``1 - b2`` 1.3e-5 below 1e-3."""
    f32, one = np.float32, np.float32(1.0)
    return float(f32(lr) * np.sqrt(one - f32(b2) ** f32(t)) / (one - f32(b1) ** f32(t)))


def keep_mask(shape, keep: float, generator: torch.Generator, device) -> torch.Tensor:
    m = torch.empty(shape, dtype=torch.float32, device=device)
    return m.bernoulli_(keep, generator=generator) / keep


def encode_pool(p: dict, starts, paths, ends, keep=None):
    """``(code_vector [B, H], attention [B, L])`` of the id bags."""
    t, q = p["terminal_embedding.weight"], p["path_embedding.weight"]
    x = torch.cat([t[starts.long()], q[paths.long()], t[ends.long()]], dim=-1)
    enc = x @ p["input_linear.weight"].t()
    mu = enc.mean(dim=-1, keepdim=True)
    var = ((enc - mu) ** 2).mean(dim=-1, keepdim=True)
    ctx = torch.tanh((enc - mu) / torch.sqrt(var + LN_EPS) * p["input_layer_norm.weight"]
                     + p["input_layer_norm.bias"])
    if keep is not None:
        ctx = ctx * keep
    m = (starts > 0).float()
    s = (ctx * p["attention_parameter"]).sum(dim=-1)
    w = torch.softmax(s * m + (1.0 - m) * NINF, dim=1)
    return (w[..., None] * ctx).sum(dim=1), w


def weighted_nll(logits, labels, class_weights, example_mask) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    w = class_weights[labels.long()] * example_mask
    return (nll * w).sum() / torch.clamp(w.sum(), min=1e-12)


def follow_train(config: dict, traffic: dict, weights: dict, corpus, rows: list, seed: int,
                 tf32: bool = False, fault: str | None = None) -> dict:
    """The program's first ``len(rows)`` steps from the same weights, rows
    and seed: ``{"losses": [...], "grad": {leaf: norm of the first
    gradient}, "delta": {leaf: norm of the change after the steps}}``.
    ``fault`` plants one of the faults the comparison must catch:
    ``"frozen"`` (a step that leaves the state unchanged) or ``"half"``
    (half of each batch left out, the mean taken over the rest)."""
    dev = corpus.contexts.device
    b, bag = config["batch_size"], config["max_path_length"]
    lr, b1, b2 = config["lr"], config["beta_min"], config["beta_max"]
    wd, eps = config["weight_decay"], 1e-8
    lazy = traffic["table_update"] == "lazy"
    keep = 1.0 - config["dropout_prob"]
    sampler = torch_generator(seed, "sampler", dev)
    dropout = torch.Generator(device=dev)
    dropout.manual_seed(sub_seed(seed, "dropout"))
    class_weights = torch.ones(config["label_count"], dtype=torch.float32, device=dev)
    params = {k: weights[k].detach().clone().requires_grad_(True) for k in PARAMS}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    example_mask = torch.ones(b, dtype=torch.float32, device=dev)
    if fault == "half":
        example_mask[b // 2:] = 0.0
    out = {"losses": [], "grad": {}, "delta": {}}
    with precision(tf32):
        for t, step_rows in enumerate(rows, start=1):
            batch = sample_batch(corpus, torch.as_tensor(step_rows, device=dev), bag, sampler)
            drop = keep_mask((b, bag, config["encode_size"]), keep, dropout, dev) \
                if 0.0 < config["dropout_prob"] < 1.0 else None
            cv, _ = encode_pool(params, batch["starts"], batch["paths"], batch["ends"], drop)
            logits = cv @ params["output_linear.weight"].t() + params["output_linear.bias"]
            loss = weighted_nll(logits, batch["labels"], class_weights, example_mask)
            grads = dict(zip(PARAMS, torch.autograd.grad(loss, [params[k] for k in PARAMS])))
            out["losses"].append(float(loss.detach()))
            with torch.no_grad():
                for k in PARAMS:
                    table = lazy and k in TABLES
                    g = grads[k] if table or not wd else grads[k] + wd * params[k]
                    if t == 1:  # as the optimizer's state holds it after one step
                        out["grad"][k] = 0.0 if fault == "frozen" else float(g.norm())
                    if fault == "frozen":
                        continue
                    bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
                    if table:
                        ids = (torch.cat([batch["starts"], batch["ends"]], dim=1)
                               if k == TABLES[0] else batch["paths"])
                        r = torch.unique(ids.long())
                        gr = g[r]
                        mu[k][r] = b1 * mu[k][r] + (1.0 - b1) * gr
                        nu[k][r] = b2 * nu[k][r] + (1.0 - b2) * gr * gr
                        step = lazy_step_size(lr, b1, b2, t)
                        params[k][r] -= step * mu[k][r] / (nu[k][r].sqrt() + eps)
                    else:
                        mu[k].mul_(b1).add_(g, alpha=1.0 - b1)
                        nu[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                        denom = nu[k].sqrt() / bc2 ** 0.5 + eps
                        params[k] -= (lr / bc1) * mu[k] / denom
            del grads, logits, cv, batch, drop, loss
    with torch.no_grad():
        out["delta"] = {k: float((params[k] - weights[k]).norm()) for k in PARAMS}
    return out


@torch.no_grad()
def code_vectors(weights: dict, bags: list, device, tf32: bool = False,
                 block: int = 128) -> list:
    """Each id bag's code vector (``[n, 3]`` int arrays), computed in blocks
    of bags of like length, each block padded to its longest bag."""
    order = sorted(range(len(bags)), key=lambda i: len(bags[i]))
    out = [None] * len(bags)
    with precision(tf32):
        for lo in range(0, len(order), block):
            idx = order[lo:lo + block]
            width = max(len(bags[i]) for i in idx)
            ids = torch.zeros((3, len(idx), width), dtype=torch.int64)
            for row, i in enumerate(idx):
                bag = torch.as_tensor(bags[i], dtype=torch.int64).reshape(-1, 3)
                ids[:, row, :bag.shape[0]] = bag.t()
            ids = ids.to(device)
            cv, _ = encode_pool(weights, ids[0], ids[1], ids[2])
            cv = cv.cpu()
            for row, i in enumerate(idx):
                out[i] = cv[row]
    return out
