"""A plain PyTorch code2seq, f32, for the port's tests to hold
``code2vec_tpu_torch/models/code2seq.py`` against.

It imports neither JAX nor anything of the port: it takes the port's
parameters as a ``{name: tensor}`` dict (the ``state_dict`` names) and its
expansion tables as plain tensors. Every LSTM is written as its gate
equations, in torch's gate order (input, forget, cell, output), stepped in
a Python loop, with no ``nn.LSTM``:

- the forward direction steps ``k = 0..P-1`` and keeps the state only
  where ``k < n``, so its state is the one after node ``n``;
- the backward direction steps ``k = P-1..0`` under the same rule, so it
  reads nodes ``n..1`` and ends on node 1;

so a slip in how the port maps lengths, reversal or gate order onto cuDNN
shows as a gap here. The attention scores ``o . W_a z_i`` are taken in the
paper's order (``W_a z_i`` first). Matrix products run with TF32 off.
"""

from __future__ import annotations

import contextlib

import torch

NINF = -3.4e38
PAD, SOS = 0, 2


@contextlib.contextmanager
def full_f32():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def cell(x, h, c, w_ih, w_hh, b_ih, b_hh):
    """One LSTM step: ``(h', c')``."""
    gates = x @ w_ih.t() + b_ih + h @ w_hh.t() + b_hh
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def path_states(x, n, prefix: str, params: dict, backward: bool):
    """The final state of each path (``x [N, P, E]``, ``n [N]``) of one
    direction; zeros for ``n = 0``."""
    w = [params[f"{prefix}.{k}_l0"] for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
    hidden = w[1].shape[1]
    h = x.new_zeros(x.shape[0], hidden)
    c = x.new_zeros(x.shape[0], hidden)
    steps = range(x.shape[1] - 1, -1, -1) if backward else range(x.shape[1])
    for k in steps:
        h2, c2 = cell(x[:, k], h, c, *w)
        live = (k < n).unsqueeze(-1)
        h, c = torch.where(live, h2, h), torch.where(live, c2, c)
    return h


def contexts(params: dict, tables: dict, starts, paths, ends, keep=None):
    """``(z [B, L, D], real [B, L])``."""
    sub_table = tables["term_subtokens"].long()
    emb = params["subtoken_embedding.weight"]
    terms = []
    for ids in (starts, ends):
        sub = sub_table[ids.long()]
        terms.append((emb[sub] * (sub > 0).float().unsqueeze(-1)).sum(dim=2))
    b, l = paths.shape
    nodes = tables["path_nodes"].long()[paths.long()]
    n = tables["path_lengths"].long()[paths.long()].reshape(-1)
    x = params["node_embedding.weight"][nodes].reshape(b * l, nodes.shape[-1], -1)
    p = torch.cat([path_states(x, n, "path_fw", params, False),
                   path_states(x, n, "path_bw", params, True)], dim=-1).reshape(b, l, -1)
    ctx = torch.cat([terms[0], p, terms[1]], dim=-1)
    if keep is not None:
        ctx = ctx * keep
    real = starts > 0
    z = torch.tanh(ctx @ params["context_linear.weight"].t()) * real.float().unsqueeze(-1)
    return z, real


def _decoder_weights(params):
    return [params[f"decoder_cell.{k}"] for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]


def _start(z, real):
    zbar = z.sum(dim=1) / real.float().sum(dim=1, keepdim=True).clamp(min=1)
    return zbar, zbar, torch.zeros_like(zbar)


def _attend(params, o, z, wz, real):
    s = (wz * o.unsqueeze(1)).sum(dim=-1)
    w = torch.softmax(torch.where(real, s, torch.full_like(s, NINF)), dim=-1)
    ctx = (w.unsqueeze(-1) * z).sum(dim=1)
    return torch.cat([o, ctx], dim=-1) @ params["attention_output.weight"].t()


def teacher_logits(params: dict, z, real, y_in, keep=None):
    """``[B, T, V]``: the decoder fed ``y_in [B, T]``."""
    wz = z @ params["attention_linear.weight"].t()
    h, c, a = _start(z, real)
    outs = []
    for k in range(y_in.shape[1]):
        x = torch.cat([params["target_embedding.weight"][y_in[:, k].long()], a], dim=-1)
        h, c = cell(x, h, c, *_decoder_weights(params))
        a = _attend(params, h if keep is None else h * keep[k], z, wz, real)
        outs.append(a @ params["output_linear.weight"].t())
    return torch.stack(outs, dim=1)


def loss(params: dict, tables: dict, batch: dict, keeps=(None, None)) -> torch.Tensor:
    """The summed cross-entropy of each kept row's ``len + 1`` steps over
    the kept rows' count; ``keeps``: the embeddings' and the decoder's keep
    masks, pre-scaled, or None."""
    z, real = contexts(params, tables, batch["starts"], batch["paths"], batch["ends"], keeps[0])
    labels = batch["labels"].long()
    tgt = tables["label_targets"].long()[labels]
    length = tables["label_lengths"].long()[labels]
    b, dev = tgt.shape[0], tgt.device
    y_in = torch.cat([torch.full((b, 1), SOS, dtype=torch.long, device=dev), tgt], dim=1)
    y_out = torch.cat([tgt, torch.full((b, 1), PAD, dtype=torch.long, device=dev)], dim=1)
    logp = torch.log_softmax(teacher_logits(params, z, real, y_in, keeps[1]), dim=-1)
    total = torch.zeros((), device=dev)
    mask = batch["example_mask"].float()
    for row in range(b):
        for k in range(int(length[row]) + 1):
            total = total - logp[row, k, y_out[row, k]] * mask[row]
    return total / mask.sum().clamp(min=1e-12)


def greedy(params: dict, tables: dict, batch: dict, steps: int) -> torch.Tensor:
    """``[B, steps]`` greedy ids, 0 from the first end of name on."""
    z, real = contexts(params, tables, batch["starts"], batch["paths"], batch["ends"])
    wz = z @ params["attention_linear.weight"].t()
    h, c, a = _start(z, real)
    y = torch.full((z.shape[0],), SOS, dtype=torch.long, device=z.device)
    out = []
    for _ in range(steps):
        x = torch.cat([params["target_embedding.weight"][y], a], dim=-1)
        h, c = cell(x, h, c, *_decoder_weights(params))
        a = _attend(params, h, z, wz, real)
        y = (a @ params["output_linear.weight"].t()).argmax(dim=-1)
        out.append(y)
    preds = torch.stack(out, dim=1)
    for row in preds:
        ends = (row == PAD).nonzero()
        if len(ends):
            row[int(ends[0]):] = PAD
    return preds


def nesterov_step(params: dict, grads: dict, bufs: dict, lr: float, momentum: float) -> None:
    """SGD with Nesterov momentum, in place: ``buf = g`` on the first step,
    else ``momentum * buf + g``; ``p -= lr * (g + momentum * buf)``."""
    with torch.no_grad():
        for k, g in grads.items():
            bufs[k] = g.clone() if k not in bufs else momentum * bufs[k] + g
            params[k] -= lr * (g + momentum * bufs[k])
