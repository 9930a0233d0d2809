"""The plain reference of the code2seq cells: code2seq in plain PyTorch,
f32, with every LSTM written as its gate equations.

It imports neither ``jax`` nor ``code2vec_tpu`` nor anything of
``code2vec_tpu_torch``, and takes nothing the program made: the corpus
comes from ``corpus.py``, the expansion tables and the weights from
``code2seq_inputs.py``, as the program's do, and what the program derives
from them is worked out again here from the seed. Where that needs one of
the program's rules, this file holds a frozen copy of it:

- the device sampler's rotation window (``reference.sample_batch``);
- the dropout keep masks (``models/code2seq.py``): two ``bernoulli_`` draws
  a training step from the model's generator (the seed's ``dropout``
  stream), f32 ``[B, L, 2E + 2H]`` then f32 ``[T + 1, B, D]``, each divided
  by its keep probability;
- torch's gate order (input, forget, cell, output) and ``state_dict``
  names; the reserved target ids (0 the end of a name, 2 its start);
- torch SGD with Nesterov momentum: ``buf = g`` on the first step, then
  ``momentum * buf + g``; ``p -= lr * (g + momentum * buf)``.

The model is the paper's (Alon et al., ICLR 2019) as the configuration
states it: each terminal the sum of its subtokens' rows; each path's final
states of a forward LSTM over nodes ``1..n`` and a backward one over ``n..1``
(stepped over every position, the state kept only at the path's own
steps; zeros for ``n = 0``); ``z = tanh(W_in drop([t_s; p; t_e]))``, 0 at a PAD
slot; a decoder LSTM cell from the mean of ``z`` over the real contexts, fed
``[E_tgt(y_{k-1}); a_{k-1}]``, its output dropped, scored against ``W_a z``
(the paper's order), the softmax over the real contexts,
``a_k = W_att [o_k; ctx_k]``, ``logits_k = W_out a_k``; the loss summed over
each row's ``len + 1`` steps and the kept rows, over their count. Matrix
products run in full f32 unless a caller asks for TF32 (the control).
"""

from __future__ import annotations

import torch

from c2vbench.code2seq_inputs import PAD, SOS, params_of
from c2vbench.reference import NINF, precision, sample_batch
from c2vbench.seeds import sub_seed, torch_generator


def keep_mask(shape, keep: float, generator, device) -> torch.Tensor:
    m = torch.empty(shape, dtype=torch.float32, device=device)
    return m.bernoulli_(keep, generator=generator) / keep


def lstm_step(x, h, c, w):
    """One LSTM step over ``w = (w_ih, w_hh, b_ih, b_hh)``: ``(h', c')``."""
    gates = x @ w[0].t() + w[2] + h @ w[1].t() + w[3]
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def path_final(x, n, w, reverse: bool):
    """The state after a direction's last step of each path (``x [N, P,
    E]``, ``n [N]``): forward over positions ``0..n-1``, ``reverse`` over
    ``n-1..0``; a position past ``n`` leaves the state as it is."""
    hidden = w[1].shape[1]
    h = x.new_zeros(x.shape[0], hidden)
    c = x.new_zeros(x.shape[0], hidden)
    for k in (range(x.shape[1] - 1, -1, -1) if reverse else range(x.shape[1])):
        h2, c2 = lstm_step(x[:, k], h, c, w)
        live = (k < n).unsqueeze(-1)
        h, c = torch.where(live, h2, h), torch.where(live, c2, c)
    return h


def _lstm(p: dict, prefix: str, suffix: str = "_l0"):
    return tuple(p[f"{prefix}.{k}{suffix}"] for k in ("weight_ih", "weight_hh", "bias_ih",
                                                      "bias_hh"))


def contexts(p: dict, tables: dict, starts, paths, ends, keep=None):
    """``(z [B, L, D], real [B, L])`` of a batch of id bags."""
    terms = []
    for ids in (starts, ends):
        sub = tables["term_subtokens"][ids.long()].long()
        rows = p["subtoken_embedding.weight"][sub] * (sub > 0).unsqueeze(-1).float()
        terms.append(rows.sum(dim=2))
    b, l = paths.shape
    nodes = tables["path_nodes"][paths.long()].long()
    n = tables["path_lengths"][paths.long()].long().reshape(-1)
    x = p["node_embedding.weight"][nodes].reshape(b * l, nodes.shape[-1], -1)
    pv = torch.cat([path_final(x, n, _lstm(p, "path_fw"), False),
                    path_final(x, n, _lstm(p, "path_bw"), True)], dim=-1).reshape(b, l, -1)
    ctx = torch.cat([terms[0], pv, terms[1]], dim=-1)
    if keep is not None:
        ctx = ctx * keep
    real = starts > 0
    z = torch.tanh(ctx @ p["context_linear.weight"].t()) * real.unsqueeze(-1).float()
    return z, real


def decoder_logits(p: dict, z, real, y_in, keep=None):
    """``[B, T, V]`` of the decoder fed ``y_in [B, T]`` (teacher forcing)."""
    m = real.float()
    zbar = z.sum(dim=1) / m.sum(dim=1, keepdim=True).clamp(min=1)
    h, c, a = zbar, zbar, torch.zeros_like(zbar)
    wz = z @ p["attention_linear.weight"].t()
    w = _lstm(p, "decoder_cell", "")
    outs = []
    for k in range(y_in.shape[1]):
        h, c = lstm_step(torch.cat([p["target_embedding.weight"][y_in[:, k]], a], dim=-1), h,
                         c, w)
        o = h if keep is None else h * keep[k]
        s = (wz * o.unsqueeze(1)).sum(dim=-1)
        alpha = torch.softmax(s * m + (1.0 - m) * NINF, dim=-1)
        ctx = (alpha.unsqueeze(-1) * z).sum(dim=1)
        a = torch.cat([o, ctx], dim=-1) @ p["attention_output.weight"].t()
        outs.append(a)
    return torch.stack(outs, dim=1) @ p["output_linear.weight"].t()


def sequence_loss(p: dict, tables: dict, batch: dict, example_mask, keeps=(None, None)):
    z, real = contexts(p, tables, batch["starts"], batch["paths"], batch["ends"], keeps[0])
    labels = batch["labels"].long()
    tgt = tables["label_targets"][labels].long()
    length = tables["label_lengths"][labels].long()
    b, dev = tgt.shape[0], tgt.device
    y_in = torch.cat([torch.full((b, 1), SOS, dtype=torch.long, device=dev), tgt], dim=1)
    y_out = torch.cat([tgt, torch.full((b, 1), PAD, dtype=torch.long, device=dev)], dim=1)
    logp = torch.log_softmax(decoder_logits(p, z, real, y_in, keeps[1]), dim=-1)
    nll = -logp.gather(-1, y_out.unsqueeze(-1)).squeeze(-1)
    steps = (torch.arange(y_in.shape[1], device=dev) <= length.unsqueeze(-1)).float()
    return (nll * steps * example_mask.unsqueeze(-1)).sum() / example_mask.sum().clamp(min=1e-12)


def follow_train(config: dict, traffic: dict, weights: dict, tables: dict, corpus, rows: list,
                 seed: int, tf32: bool = False, fault: str | None = None) -> dict:
    """The program's first ``len(rows)`` steps from the same weights, tables,
    rows and seed: ``{"losses": [...], "grad": {leaf: norm of the first
    gradient}, "delta": {leaf: norm of the change after the steps}}``.
    ``fault``: ``"frozen"`` (a step that leaves the state unchanged) or
    ``"half"`` (half of each batch left out, the mean over the rest)."""
    dev = corpus.contexts.device
    b, bag = config["batch_size"], config["max_path_length"]
    lr, momentum = config["lr"], config["momentum"]
    e, h, d = config["embed_size"], config["rnn_size"] // 2, config["decoder_size"]
    steps = config["max_target_parts"] + 1
    sampler = torch_generator(seed, "sampler", dev)
    dropout = torch.Generator(device=dev)
    dropout.manual_seed(sub_seed(seed, "dropout"))
    names = params_of(config)
    params = {k: weights[k].detach().clone().requires_grad_(True) for k in names}
    bufs: dict = {}
    example_mask = torch.ones(b, dtype=torch.float32, device=dev)
    if fault == "half":
        example_mask[b // 2:] = 0.0
    out = {"losses": [], "grad": {}, "delta": {}}
    with precision(tf32):
        for t, step_rows in enumerate(rows, start=1):
            batch = sample_batch(corpus, torch.as_tensor(step_rows, device=dev), bag, sampler)
            keeps = (keep_mask((b, bag, 2 * e + 2 * h), 1.0 - config["embed_dropout_prob"],
                               dropout, dev),
                     keep_mask((steps, b, d), 1.0 - config["rnn_dropout_prob"], dropout, dev))
            loss = sequence_loss(params, tables, batch, example_mask, keeps)
            grads = dict(zip(names, torch.autograd.grad(loss, [params[k] for k in names])))
            out["losses"].append(float(loss.detach()))
            del loss, keeps, batch
            with torch.no_grad():
                for k in names:
                    g = grads[k]
                    if t == 1:  # the momentum buffer after one step
                        out["grad"][k] = 0.0 if fault == "frozen" else float(g.norm())
                    if fault == "frozen":
                        continue
                    bufs[k] = g.clone() if k not in bufs else momentum * bufs[k] + g
                    params[k] -= lr * (g + momentum * bufs[k])
            del grads
    with torch.no_grad():
        out["delta"] = {k: float((params[k] - weights[k]).norm()) for k in names}
    return out
