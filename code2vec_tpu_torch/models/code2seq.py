"""code2seq as a PyTorch ``nn.Module``, over the port's code2vec corpus.

code2seq (Alon, Brody, Levy and Yahav, ICLR 2019, arXiv:1808.01400; the
published TensorFlow model, tech-srl/code2seq) reads a method's bag of
path-contexts and generates its name subtoken by subtoken. It takes the
batches of the device sampler (``train/device_epoch.py``) as code2vec does,
``(starts, paths, ends)`` ids ``[B, L]``, and expands them on the device
through the tables of ``data/expansion.py``: each terminal to its subtokens
``[.., S]``, each path to its nodes ``[.., P]`` with their count ``n``, each
label to its target subtokens ``[.., T]`` with their count.

- Terminal: the sum of its subtokens' rows, ``[B, L, E]`` for each end.
- Path: two LSTMs (their own weights, hidden ``H = rnn_size / 2``), the
  forward one over ``v_1..v_n``, the backward one over ``v_n..v_1``: each
  path's node ids reversed within its own length, so that no length reaches
  the host (``pack_padded_sequence`` needs them there, which would break a
  device-epoch chunk's no-sync run). Each direction's state after its
  ``n``-th step is gathered, ``p = [h_fw ; h_bw]``; steps past ``n`` are
  computed and never read; a PAD context (``n = 0``) gives zeros, the zero
  state TF's ``dynamic_rnn`` returns. TF's ``forget_bias`` 1.0 is folded into
  the bias at initialisation.
- Context: ``z = tanh(W_in drop([t_start; p; t_end]))``, no bias, keep
  probability ``1 - embed_dropout_prob``; a PAD slot's ``z`` is 0.
- Decoder: an LSTM cell over ``[E_tgt(y_{k-1}); a_{k-1}]`` (input feeding,
  ``y_0`` SOS, ``a_0 = 0``; teacher forcing in training) from ``h = c =`` the
  mean of ``z`` over the real contexts; ``o_k = drop(h_k)`` at keep
  ``1 - rnn_dropout_prob``; Luong's unscaled score ``o_k . W_a z_i``, taken as
  the query ``q = W_a^T o_k`` against ``z`` (one ``[B, L, D]`` pass fewer),
  softmax over the real contexts; ``a_k = W_att [o_k; ctx_k]`` (TF's
  ``AttentionWrapper``: no bias, no activation); ``logits_k = W_out a_k``,
  for ``k = 1..T+1``. PAD contexts are masked out of the softmax, as the
  paper's equations and code2vec's pool have it (the published code lets
  its zero vectors share the softmax).
- Loss: cross-entropy summed over each row's steps ``k <= len + 1`` (its
  subtokens, then the end of the name, id 0) and over the rows the example
  mask keeps, over the kept rows' count (code2seq's sum over the batch
  size, at a full batch).

Every entry point (``loss``, ``logits``, ``decode``, ``evaluate``) runs under
:func:`full_f32`, and the train step runs the backward under the model's
``step_scope``, the same (``train/step.forward_backward``): f32 with TF32
off whatever the process's global settings, the LSTMs ATen's.

The model answers what the train step and the loop ask of it: its own
loss (``owns_loss``); SGD with Nesterov momentum 0.95 and the rate ×0.95
an epoch (``USE_MOMENTUM``); greedy-decoded names scored by subtoken
(:meth:`Code2Seq.score`); a ``model_meta.json`` of its widths
(:meth:`Code2Seq.meta`) and none of code2vec's code-vector outputs.

Dropout draws two keep masks a training forward from the module's
generator, in this order: f32 ``[B, L, 2E + 2H]``, then f32 ``[T + 1, B,
D]``, each ``bernoulli_`` over the keep probability and divided by it.

The dense tables' gradients go through ``ops/embed.embedding_lookup`` (K6
on the card). Under a tracer ``forward`` holds the edged spans
``path_encoder`` (args ``path_steps_real``, the real contexts' nodes over
both directions, a 0-d device tensor; ``path_steps_run``, the steps the
LSTMs ran) and ``decoder`` (``decode_steps``; ``target_tokens``, the kept
rows' ``len + 1`` summed, a 0-d device tensor).

Not ported for code2seq (ROADMAP F): the kernel routes K2-K4, lazy tables,
bf16, the host feed, meshes, export, predict and serving.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from code2vec_tpu_torch.data.expansion import PAD, SOS
from code2vec_tpu_torch.metrics import sequence_subtoken_match
from code2vec_tpu_torch.models.code2vec import Code2Vec
from code2vec_tpu_torch.obs.trace import get_tracer
from code2vec_tpu_torch.ops.attention import NINF
from code2vec_tpu_torch.ops.embed import embedding_lookup

EXPANSIONS = ("term_subtokens", "path_nodes", "path_lengths", "label_targets", "label_lengths")


@contextlib.contextmanager
def full_f32():
    """The model's setting inside, the process's restored after: every
    product in f32 with TF32 off (the configuration states f32), and ATen's
    LSTM, not cuDNN's (cuDNN off). At batch 102,400 cuDNN's persistent LSTM
    kernels ran at a few percent of the card's f32 peak; ATen's steps each
    run as two library products and one fused cell kernel."""
    saved = (torch.backends.cudnn.enabled, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.enabled = False
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.enabled, torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


@dataclass(frozen=True)
class Code2SeqConfig:
    subtoken_count: int  # table rows, the reserved ids included
    node_count: int
    target_count: int
    embed_size: int = 128  # EMBEDDINGS_SIZE
    rnn_size: int = 256  # RNN_SIZE: both directions
    decoder_size: int = 320  # DECODER_SIZE
    max_name_parts: int = 5  # MAX_NAME_PARTS
    max_path_nodes: int = 9  # MAX_PATH_LENGTH
    max_target_parts: int = 6  # MAX_TARGET_PARTS
    embed_dropout_prob: float = 0.25  # 1 - EMBEDDINGS_DROPOUT_KEEP_PROB
    rnn_dropout_prob: float = 0.5  # 1 - RNN_DROPOUT_KEEP_PROB

    @property
    def decode_steps(self) -> int:
        return self.max_target_parts + 1


class Code2Seq(nn.Module):
    """``loss(batch)`` trains (:func:`~code2vec_tpu_torch.train.step.
    forward_backward` takes it in place of code2vec's head and NLL);
    ``evaluate(batch)`` decodes greedily."""

    # the train and eval steps call the model's own loss, the backward under
    # its precision too (models/code2vec.Code2Vec lists the questions)
    owns_loss = True
    step_scope = staticmethod(full_f32)
    nesterov_momentum = 0.95  # USE_MOMENTUM
    epoch_lr_decay = 0.95
    code_vectors = False
    seed_dropout = Code2Vec.seed_dropout
    dropout_generator = Code2Vec.dropout_generator

    def __init__(self, config: Code2SeqConfig, expansions: dict,
                 target_names: list | None = None) -> None:
        """``expansions``: the tables of ``EXPANSIONS``; ``target_names``
        each target id's subtoken (``data/expansion.Expansions``), which
        :meth:`score` reads."""
        super().__init__()
        c = config
        if c.rnn_size % 2:
            raise ValueError(f"rnn_size {c.rnn_size} is two directions' states: make it even")
        self.config = c
        self.target_names = target_names
        e, h, d = c.embed_size, c.rnn_size // 2, c.decoder_size
        self.subtoken_embedding = nn.Embedding(c.subtoken_count, e)
        self.node_embedding = nn.Embedding(c.node_count, e)
        self.target_embedding = nn.Embedding(c.target_count, e)
        self.path_fw = nn.LSTM(e, h, batch_first=True)
        self.path_bw = nn.LSTM(e, h, batch_first=True)
        self.context_linear = nn.Linear(2 * e + c.rnn_size, d, bias=False)
        self.decoder_cell = nn.LSTMCell(e + d, d)
        self.attention_linear = nn.Linear(d, d, bias=False)
        self.attention_output = nn.Linear(2 * d, d, bias=False)
        self.output_linear = nn.Linear(d, c.target_count, bias=False)
        widths = {"term_subtokens": c.max_name_parts, "path_nodes": c.max_path_nodes,
                  "label_targets": c.max_target_parts}
        for name in EXPANSIONS:
            table = torch.as_tensor(expansions[name], dtype=torch.int32)
            if name in widths and table.shape[-1] != widths[name]:
                raise ValueError(f"{name} has {table.shape[-1]} columns, the config "
                                 f"{widths[name]}")
            self.register_buffer(name, table, persistent=False)
        self.mesh = None
        self.dropout_seed = 0
        self._dropout_gen: torch.Generator | None = None
        self.reset_parameters()

    def meta(self) -> dict:
        """A model dir's ``model_meta.json``: the model's name and widths
        (the serving path reads the name to refuse it)."""
        return {"model": "code2seq", **dataclasses.asdict(self.config)}

    def score(self, expected: np.ndarray, preds: np.ndarray,
              label_vocab) -> tuple[float, float, float, float]:
        """``(accuracy, precision, recall, f1)`` of greedy-decoded names
        ``preds [N, T + 1]`` against the label ids ``expected``, by subtoken
        (``metrics.sequence_subtoken_match``)."""
        want = [label_vocab.itosubtokens.get(int(i), ()) for i in expected]
        return sequence_subtoken_match(want, preds, self.target_names)

    # the step contract's tables (train/step.STEP_STATE_CONTRACT): those a
    # terminal and a path are read through
    @property
    def terminal_embedding(self) -> nn.Embedding:
        return self.subtoken_embedding

    @property
    def path_embedding(self) -> nn.Embedding:
        return self.node_embedding

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """The published model's init families: the tables uniform with
        variance scaling over their width (``FAN_OUT``), every kernel
        Glorot-uniform over TF's shape (an LSTM's ``[in + H, 4H]``), zero
        biases but the LSTMs' forget gates at 1.0 (``forget_bias``)."""
        g = generator

        def uniform(t, limit):
            t.uniform_(-limit, limit, generator=g)

        for table in (self.subtoken_embedding, self.node_embedding, self.target_embedding):
            uniform(table.weight, math.sqrt(3.0 / table.weight.shape[1]))
        for lstm, (w_ih, w_hh, b_ih, b_hh) in self._lstm_weights():
            hidden = w_hh.shape[1]
            limit = math.sqrt(6.0 / (w_ih.shape[1] + hidden + 4 * hidden))
            uniform(w_ih, limit)
            uniform(w_hh, limit)
            b_ih.zero_()
            b_hh.zero_()
            b_ih[hidden:2 * hidden] = 1.0  # torch's gate order: i, f, g, o
        for lin in (self.context_linear, self.attention_linear, self.attention_output,
                    self.output_linear):
            out_f, in_f = lin.weight.shape
            uniform(lin.weight, math.sqrt(6.0 / (in_f + out_f)))

    def _lstm_weights(self):
        for lstm in (self.path_fw, self.path_bw):
            yield lstm, (lstm.weight_ih_l0, lstm.weight_hh_l0, lstm.bias_ih_l0, lstm.bias_hh_l0)
        cell = self.decoder_cell
        yield cell, (cell.weight_ih, cell.weight_hh, cell.bias_ih, cell.bias_hh)

    def _keep_mask(self, shape, prob: float, device) -> torch.Tensor | None:
        if not (self.training and 0.0 < prob < 1.0):
            return None
        keep = 1.0 - prob
        m = torch.empty(shape, dtype=torch.float32, device=device)
        return m.bernoulli_(keep, generator=self.dropout_generator(device)) / keep

    def _paths(self, paths: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(p [B, L, 2H], n [B, L])``: the bi-LSTM's final states of each
        path and its node count."""
        b, l = paths.shape
        c = self.config
        ids = paths.long()
        nodes = self.path_nodes[ids]
        n = self.path_lengths[ids].long()
        k = torch.arange(c.max_path_nodes, device=paths.device)
        last = n.unsqueeze(-1)
        reverse = torch.where(k < last, last - 1 - k, k)
        both = torch.stack([nodes, nodes.gather(-1, reverse)])
        x = embedding_lookup(self.node_embedding.weight, both)
        x = x.reshape(2, b * l, c.max_path_nodes, c.embed_size)
        out_fw, _ = self.path_fw(x[0])
        out_bw, _ = self.path_bw(x[1])
        h = c.rnn_size // 2
        at = (n - 1).clamp(min=0).reshape(b * l, 1, 1).expand(b * l, 1, h)
        p = torch.cat([out_fw.gather(1, at), out_bw.gather(1, at)], dim=-1)
        return p.reshape(b, l, 2 * h) * (n > 0).unsqueeze(-1), n

    def _contexts(self, starts, paths, ends) -> tuple[torch.Tensor, torch.Tensor]:
        """``(z [B, L, D], real [B, L] bool)``."""
        tracer, dev = get_tracer(), starts.device
        real = starts > 0
        sub = self.term_subtokens[torch.stack([starts, ends], dim=-1).long()]
        rows = embedding_lookup(self.subtoken_embedding.weight, sub)
        t = (rows * (sub > 0).unsqueeze(-1)).sum(dim=-2)
        with tracer.span("path_encoder", "train", dev) as span:
            p, n = self._paths(paths)
            if tracer.enabled:
                span.args.update(path_steps_real=2 * (n * real).sum(),
                                 path_steps_run=2 * n.numel() * self.config.max_path_nodes)
        x = torch.cat([t[:, :, 0], p, t[:, :, 1]], dim=-1)
        keep = self._keep_mask(x.shape, self.config.embed_dropout_prob, dev)
        if keep is not None:
            x = x * keep
        z = torch.tanh(self.context_linear(x)) * real.unsqueeze(-1)
        return z, real

    def _attend(self, o: torch.Tensor, z: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
        q = o @ self.attention_linear.weight
        s = torch.bmm(z, q.unsqueeze(-1)).squeeze(-1)
        w = torch.softmax(torch.where(real, s, NINF), dim=-1)
        ctx = torch.bmm(w.unsqueeze(1), z).squeeze(1)
        return self.attention_output(torch.cat([o, ctx], dim=-1))

    def _start(self, z: torch.Tensor, real: torch.Tensor):
        zbar = z.sum(dim=1) / real.sum(dim=1, keepdim=True).clamp(min=1)
        return zbar, zbar, torch.zeros_like(zbar)

    def _targets(self, labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        ids = labels.long()
        return self.label_targets[ids].long(), self.label_lengths[ids].long()

    def loss(self, batch: dict) -> torch.Tensor:
        """The training loss of a sampled batch (teacher forcing; dropout in
        training mode), on the device."""
        with full_f32():
            z, real = self._contexts(batch["starts"], batch["paths"], batch["ends"])
            return self._teacher_loss(z, real, batch)

    def _teacher_loss(self, z: torch.Tensor, real: torch.Tensor, batch: dict) -> torch.Tensor:
        tracer, dev = get_tracer(), z.device
        c = self.config
        b, steps = z.shape[0], c.decode_steps
        with tracer.span("decoder", "train", dev) as span:
            tgt, length = self._targets(batch["labels"])
            y_in = torch.cat([torch.full((b, 1), SOS, dtype=tgt.dtype, device=dev), tgt], dim=1)
            y_out = F.pad(tgt, (0, 1), value=PAD)
            keep = self._keep_mask((steps, b, c.decoder_size), c.rnn_dropout_prob, dev)
            logp = F.log_softmax(self._teacher_logits(z, real, y_in, keep), dim=-1)
            nll = -logp.gather(-1, y_out.unsqueeze(-1)).squeeze(-1)
            counted = torch.arange(steps, device=dev) <= length.unsqueeze(-1)
            mask = batch["example_mask"]
            loss = (nll * counted * mask.unsqueeze(-1)).sum() / mask.sum().clamp(min=1e-12)
            if tracer.enabled:
                span.args.update(decode_steps=steps, target_tokens=((length + 1) * mask).sum())
        return loss

    def _teacher_logits(self, z, real, y_in, keep) -> torch.Tensor:
        """``[B, T + 1, V]``: the decoder fed ``y_in`` (teacher forcing)."""
        emb = embedding_lookup(self.target_embedding.weight, y_in)
        h, cell, a = self._start(z, real)
        outs = []
        for k in range(y_in.shape[1]):
            h, cell = self.decoder_cell(torch.cat([emb[:, k], a], dim=-1), (h, cell))
            a = self._attend(h if keep is None else h * keep[k], z, real)
            outs.append(a)
        return self.output_linear(torch.stack(outs, dim=1))

    @torch.no_grad()
    def logits(self, batch: dict) -> torch.Tensor:
        """Eval mode: the teacher-forced logits ``[B, T + 1, V]`` of a batch."""
        self.eval()
        with full_f32():
            z, real = self._contexts(batch["starts"], batch["paths"], batch["ends"])
            tgt, _ = self._targets(batch["labels"])
            sos = torch.full((tgt.shape[0], 1), SOS, dtype=tgt.dtype, device=tgt.device)
            return self._teacher_logits(z, real, torch.cat([sos, tgt], dim=1), None)

    def _greedy(self, z: torch.Tensor, real: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        b, dev = z.shape[0], z.device
        h, cell, a = self._start(z, real)
        y = torch.full((b,), SOS, dtype=torch.long, device=dev)
        preds, scores = [], []
        for _ in range(self.config.decode_steps):
            e = embedding_lookup(self.target_embedding.weight, y)
            h, cell = self.decoder_cell(torch.cat([e, a], dim=-1), (h, cell))
            a = self._attend(h, z, real)
            best, y = F.log_softmax(self.output_linear(a), dim=-1).max(dim=-1)
            preds.append(y)
            scores.append(best)
        preds = torch.stack(preds, dim=1)
        is_end = preds == PAD
        ended = torch.cumsum(is_end, dim=1)
        counted = (ended - is_end.long()) == 0  # up to and with the first end
        logp = (torch.stack(scores, dim=1) * counted).sum(dim=1)
        return torch.where(ended > 0, PAD, preds), logp

    @torch.no_grad()
    def decode(self, starts, paths, ends) -> tuple[torch.Tensor, torch.Tensor]:
        """Eval mode: greedy decoding, at most ``T + 1`` steps: ``(preds [B,
        T + 1]``, 0 from the first end of name on; ``logp [B]``, the
        prediction's log probability up to its end)."""
        self.eval()
        with full_f32():
            return self._greedy(*self._contexts(starts, paths, ends))

    @torch.no_grad()
    def evaluate(self, batch: dict) -> dict:
        """Eval mode: the teacher-forced loss, the greedy predictions
        (``preds [B, T + 1]``) and their log probabilities (``max_logit``)."""
        self.eval()
        with full_f32():
            z, real = self._contexts(batch["starts"], batch["paths"], batch["ends"])
            preds, logp = self._greedy(z, real)
            return {"loss": self._teacher_loss(z, real, batch), "preds": preds,
                    "max_logit": logp}
