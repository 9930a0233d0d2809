"""Train and eval steps.

Counterpart of ``code2vec_tpu/train/step.py``:

- the loss is log-softmax + class-weighted NLL with the example mask,
  ``sum(w nll mask) / max(sum(w mask), 1e-12)`` (``:178-187``; torch
  NLLLoss's weighted mean, reference main.py:129-130);
- the optimizer is ``torch.optim.Adam(lr, (beta_min, beta_max), eps=1e-8,
  weight_decay)``, whose coupled L2 (added to the gradient before the
  moments) is what the JAX ``torch_style_adam`` reproduces (``:94-123``);
  with ``adam_mu_dtype="bfloat16"`` it is :class:`TorchStyleAdam`, the
  same step with the first moment stored in bf16, as ``torch_style_adam(
  mu_dtype="bfloat16")`` does (``torch.optim.Adam`` keeps its moments in
  the parameters' dtype);
- the margin head gets the labels in training (``needs_labels``);
- on a mesh (``model.mesh``, ``parallel/shardings.shard_model``) the
  loss's denominator is the global batch's and the gradients are
  all-reduced before the optimizer steps (``parallel/step.py``): JAX's
  sharded step (its ``parallel/step.py`` over ``train/step.py:182-260``);
- ``table_update="lazy"`` (JAX ``build_train_step_fn`` ``:238-296``): the
  step differentiates zero offsets added to the gathered rows instead of
  the tables, which enter as constants, and hands the offsets' gradients
  with the ids they read to :class:`~code2vec_tpu_torch.train.table_opt.
  LazyTableAdam`; no ``[vocab, dim]`` gradient is formed.
"""

from __future__ import annotations

import contextlib
import functools
import math
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from code2vec_tpu_torch.analysis.contracts import shape_contract, spec
from code2vec_tpu_torch.obs.trace import get_tracer
from code2vec_tpu_torch.ops.embed import collect_split_rows
from code2vec_tpu_torch.parallel.distributed import all_reduce_sum
from code2vec_tpu_torch.parallel.mesh import AXIS_DATA
from code2vec_tpu_torch.train.table_opt import TABLE_PARAMS, LazyTableAdam

BATCH_KEYS = ("starts", "paths", "ends", "labels", "example_mask")

# the contract on every step's inputs (analysis/contracts.py; JAX
# STEP_STATE_CONTRACT / STEP_BATCH_CONTRACT), checked on every call from
# shapes and dtypes alone (no sync), so a shape-skewed batch raises at the
# step instead of broadcasting (an example_mask [B, 1] would turn the loss
# into a B x B sum). Symbols bind per call: bucketed runs check each
# ladder width's [B, L_b] on its own. The training master tables are f32
# on every step path: quantized (int8/bf16) storage serves and evaluates
# (``table_dtype``, ``quant_tables``), and a step over it would train on
# dequantization noise. JAX's ``step`` counter has no counterpart here:
# the optimizer counts its steps.
STEP_STATE_CONTRACT = {
    "terminal_embedding": {"weight": spec(None, torch.float32)},
    "path_embedding": {"weight": spec(None, torch.float32)},
}
STEP_BATCH_CONTRACT = {
    "starts": spec("B,L", "int"),
    "paths": spec("B,L", "int"),
    "ends": spec("B,L", "int"),
    "labels": spec("B", "int"),
    "example_mask": spec("B", "float"),
}


def contract_step(fn):
    """Apply the shared model/batch contract to a ``(model, ..., batch,
    ...)`` step function: the train and eval steps, which the dense, lazy,
    mesh and device-epoch paths all go through."""
    return shape_contract(model=STEP_STATE_CONTRACT, batch=STEP_BATCH_CONTRACT)(fn)


def weighted_nll(logits: torch.Tensor, labels: torch.Tensor, class_weights: torch.Tensor,
                 example_mask: torch.Tensor, group=None) -> torch.Tensor:
    """``sum(w nll) / max(sum(w), 1e-12)``. With ``group`` (the data line of
    a mesh, each rank holding its rows) the denominator is the global
    batch's, all-reduced first, so the ranks' values add up to the global
    loss and their gradients to its gradient (a mean of per-rank means
    would be another loss whenever the ranks' weight sums differ)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    w = class_weights[labels.long()] * example_mask
    return (nll * w).sum() / torch.clamp(all_reduce_sum(w.sum(), group), min=1e-12)


def _data_group(model):
    mesh = getattr(model, "mesh", None)
    return None if mesh is None else mesh.group(AXIS_DATA)


MU_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class TorchStyleAdam(torch.optim.Optimizer):
    """Adam with coupled L2 and the first moment stored in ``mu_dtype``:
    the step of optax 0.2.6's ``add_decayed_weights`` + ``scale_by_adam(
    mu_dtype)`` + ``scale(-lr)`` (JAX ``torch_style_adam``), op for op:

    - ``g += wd * p`` (only with a weight decay);
    - ``mu = (1 - b1) * g + b1' * mu_stored`` in f32, ``b1'`` being ``b1``
      rounded to the stored dtype (JAX's weak-typed ``b1`` becomes a bf16
      constant, 0.8984375 for 0.9) and the product f32: the jitted JAX step
      keeps it unrounded (XLA's excess precision), as measured on optax
      0.2.6;
    - ``nu = (1 - b2) * g * g + b2 * nu`` in f32;
    - ``p += -lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)``, the
      bias corrections in f32, from the f32 ``mu``;
    - only the stored ``mu`` is rounded to ``mu_dtype`` (nearest even).

    ``load_state_dict`` keeps the stored moment in the run's ``mu_dtype``
    (the base class would cast it to the parameters' dtype)."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, mu_dtype: torch.dtype = torch.bfloat16):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay, mu_dtype=mu_dtype))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            wd, lr, eps, mu_dtype = (group[k] for k in ("weight_decay", "lr", "eps", "mu_dtype"))
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if wd:
                    g = g + p * wd
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p, dtype=mu_dtype)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                t = np.float32(state["step"])
                mu_stored, nu = state["exp_avg"], state["exp_avg_sq"]
                b1_stored = float(torch.tensor(b1, dtype=mu_dtype))
                mu = g * (1.0 - b1) + mu_stored.float() * b1_stored
                nu.mul_(b2).add_(g * g * (1.0 - b2))
                bc1 = float(np.float32(1.0) - np.float32(b1) ** t)
                bc2 = float(np.float32(1.0) - np.float32(b2) ** t)
                update = (mu / bc1) / ((nu / bc2).sqrt_() + eps)
                p.add_(update.mul_(-lr))
                mu_stored.copy_(mu)
        return loss

    def load_state_dict(self, state_dict) -> None:
        super().load_state_dict(state_dict)
        for group in self.param_groups:
            for p in group["params"]:
                state = self.state.get(p)
                if state:
                    state["exp_avg"] = state["exp_avg"].to(self.defaults["mu_dtype"])


def make_optimizer(model: torch.nn.Module, config) -> torch.optim.Optimizer:
    """torch Adam with the config's rate, betas and coupled weight decay;
    :class:`TorchStyleAdam` when ``adam_mu_dtype`` stores mu in bf16. With
    ``table_update="lazy"`` that Adam steps the non-table parameters and
    :class:`LazyTableAdam` the tables' touched rows (no weight decay). A
    model with a ``nesterov_momentum`` (``models/code2seq.Code2Seq``) gets
    torch SGD with Nesterov momentum at it, dense tables only."""
    if model.nesterov_momentum is not None:
        return torch.optim.SGD(model.parameters(), lr=config.lr,
                               momentum=model.nesterov_momentum, nesterov=True,
                               weight_decay=config.weight_decay)
    kw = dict(lr=config.lr, betas=(config.beta_min, config.beta_max), eps=1e-8,
              weight_decay=config.weight_decay)
    mu_dtype = getattr(config, "adam_mu_dtype", "float32")
    table_update = getattr(config, "table_update", "dense")

    def adam(params):
        if mu_dtype == "float32":
            return torch.optim.Adam(params, **kw)
        return TorchStyleAdam(params, mu_dtype=MU_DTYPES[mu_dtype], **kw)

    if table_update == "dense":
        return adam(model.parameters())
    if table_update != "lazy":
        raise ValueError(f"table_update must be 'dense' or 'lazy', got {table_update!r}")
    tables = [model.terminal_embedding.weight, model.path_embedding.weight]
    rest = [p for p in model.parameters() if all(p is not t for t in tables)]
    mesh = getattr(model, "mesh", None)
    offsets = None
    if mesh is not None:  # a model axis's row shards step their own rows
        from code2vec_tpu_torch.parallel.shardings import shard_start

        offsets = [shard_start(t.shape[0], model.shard_entries[name], mesh)
                   for t, name in zip(tables, TABLE_PARAMS)]
    return LazyTableAdam(tables, adam(rest), lr=config.lr, betas=kw["betas"], eps=kw["eps"],
                         mu_dtype=MU_DTYPES[mu_dtype], row_offsets=offsets)


def adam_mu_dtype(optimizer: torch.optim.Optimizer) -> str:
    """The first-moment storage of ``optimizer``: ``"bfloat16"`` or
    ``"float32"`` (what a checkpoint records and a resume checks)."""
    dt = optimizer.defaults.get("mu_dtype", torch.float32)
    return next(name for name, d in MU_DTYPES.items() if d == dt)


def table_update(optimizer: torch.optim.Optimizer) -> str:
    """``"lazy"`` or ``"dense"``: how ``optimizer`` steps the tables (what
    a checkpoint records and a resume checks)."""
    return "lazy" if isinstance(optimizer, LazyTableAdam) else "dense"


def weight_decay(state_dict: dict) -> float:
    """The coupled weight decay in an optimizer's ``state_dict`` (the dense
    Adam's: the lazy tables take none)."""
    return float(state_dict.get("dense", state_dict)["param_groups"][0]["weight_decay"])


# the param-group entries a checkpoint restores: the parameters' places and
# LazyTableAdam's shared step count, from which its bias correction goes on.
# Every other entry (lr, betas, eps, weight_decay, mu_dtype, and
# torch.optim.Adam's foreach, fused, capturable, differentiable, maximize
# and amsgrad) is a setting of the run that resumes, as JAX builds its optax
# chain from the run's config and restores only the arrays
RESTORED_GROUP_KEYS = ("params", "step")


def load_optimizer_state(optimizer: torch.optim.Optimizer, state_dict: dict) -> None:
    """``optimizer.load_state_dict(state_dict)``, keeping the group settings
    ``optimizer`` was built with (those of a ``LazyTableAdam``'s dense Adam
    too): the checkpoint gives the moments and the step counts, the run its
    own rate, betas, eps and weight decay."""
    parts = [optimizer] + ([optimizer.dense] if isinstance(optimizer, LazyTableAdam) else [])
    settings = [[{k: v for k, v in group.items() if k not in RESTORED_GROUP_KEYS}
                 for group in part.param_groups] for part in parts]
    optimizer.load_state_dict(state_dict)
    for part, groups in zip(parts, settings):
        for group, own in zip(part.param_groups, groups):
            group.update(own)


# Python's sum() of floats from 3.12 on compensates (Neumaier); JAX's epoch
# loss is such a sum, so the port's fold replays it step by step
_COMPENSATED_SUM = sys.version_info >= (3, 12)


def fold_losses(values, state: tuple[float, float]) -> tuple[float, float]:
    """Fold ``values`` into ``state`` = ``(sum, compensation)`` in float64,
    left to right, the additions of CPython's ``sum(values, start)`` (its
    float loop, ``builtin_sum_impl``): the fold of a list in pieces equals
    the fold of the whole."""
    f, c = state
    for x in values:
        t = f + x
        if _COMPENSATED_SUM:
            c += (f - t) + x if abs(f) >= abs(x) else (x - t) + f
        f = t
    return f, c


def fold_value(state: tuple[float, float]) -> float:
    """The value ``sum()`` returns for a fold state."""
    f, c = state
    return f + c if c and math.isfinite(c) else f


class StepTally:
    """An epoch's train steps: their losses kept on the device, summed as
    JAX sums them (``loop.py:512-515``, ``float(sum(map(float, losses),
    loss_offset))``): each f32 loss read as a Python float and folded left
    in float64 from ``offset`` (a float, or a resumed epoch's fold state)
    by :func:`fold_losses`, so a resumed epoch's total is bitwise the
    uninterrupted one's; and the speed of the steps after the first (warm)
    one, timed with CUDA events on a card (no synchronisation until
    :meth:`result`), the host clock on the CPU."""

    def __init__(self, device: torch.device, offset: float | tuple[float, float] = 0.0):
        self.cuda = torch.device(device).type == "cuda"
        self.losses: list[torch.Tensor] = []
        self.contexts = 0  # real contexts of the steps after the first
        self.start = None
        # the fold so far and how many of ``losses`` it covers
        self._fold = ((float(offset), 0.0) if isinstance(offset, (int, float))
                      else tuple(map(float, offset)))
        self._summed = 0

    def _mark(self):
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    def add(self, loss: torch.Tensor, contexts: int) -> None:
        """A step enqueued: its loss and its real (non-PAD, unmasked)
        contexts."""
        self.losses.append(loss)
        if self.start is None:
            self.start = self._mark()
        else:
            self.contexts += contexts

    def partial(self) -> tuple[float, float]:
        """The fold state of the losses so far (a mid-epoch save's partial
        sum): only the losses added since the last call are read back."""
        new = self.losses[self._summed:]
        if new:
            self._fold = fold_losses(torch.stack(new).cpu().tolist(), self._fold)
            self._summed = len(self.losses)
        return self._fold

    def result(self) -> tuple[float, dict]:
        """``(the fold of the losses, speed)``: ``train_steps``, and
        ``steps_per_s`` / ``contexts_per_s`` over the steps after the
        first (None with fewer than two)."""
        if not self.losses:
            return fold_value(self._fold), {"train_steps": 0, "steps_per_s": None,
                                            "contexts_per_s": None}
        end = self._mark()
        if self.cuda:
            end.synchronize()
            seconds = self.start.elapsed_time(end) / 1e3
        else:
            seconds = end - self.start
        timed = len(self.losses) - 1
        ok = timed and seconds > 0
        speed = {
            "train_steps": len(self.losses),
            "steps_per_s": timed / seconds if ok else None,
            "contexts_per_s": self.contexts / seconds if ok else None,
        }
        return fold_value(self.partial()), speed


def to_device(batch: dict[str, np.ndarray], device: torch.device) -> dict[str, torch.Tensor]:
    """The step's inputs on ``device``, in tensors that own their memory:
    a card gets asynchronous copies from pinned memory (the pinning copy
    reads the host arrays before this returns), the CPU copies. So the host
    arrays may be rebuilt once this returns, as a feed worker's recycled
    arena slot is (``data/parallel_feed.py``); the copies run on the
    current stream (a prefetcher's own, ``train/prefetch.py``)."""
    out = {}
    for key in BATCH_KEYS:
        if device.type == "cuda":
            t = torch.from_numpy(np.ascontiguousarray(batch[key]))
            out[key] = t.pin_memory().to(device, non_blocking=True)
        else:
            out[key] = torch.from_numpy(np.array(batch[key]))
    return out


def forward_backward(model, batch: dict[str, torch.Tensor], class_weights: torch.Tensor,
                     embed_offsets=None) -> torch.Tensor:
    """Training-mode forward and backward of one batch (gradients land in
    ``.grad``); returns the loss, still on the device. A model that
    ``owns_loss`` (``models/code2seq.Code2Seq``) gives its own ``loss(batch)``
    in place of the head and the NLL. The backward runs under the model's
    ``step_scope`` (code2seq's f32 with TF32 off, as its loss). Under a tracer the
    two halves are the ``forward`` and ``backward`` spans, timed on the
    device (``obs/trace.py``); on the card a dense step's ``backward`` span
    carries ``table_grad_split_rows``, K6's rows in runs longer than one
    chunk (``ops/embed.collect_split_rows``)."""
    model.train()
    labels = batch["labels"]
    tracer, device = get_tracer(), labels.device
    split_rows = tracer.enabled and device.type == "cuda" and embed_offsets is None
    own = getattr(model, "owns_loss", False)
    with tracer.span("forward", "train", device):
        if own:
            loss, group = model.loss(batch), None
        else:
            logits, _, _ = model(batch["starts"], batch["paths"], batch["ends"],
                                 labels=labels if model.config.angular_margin_loss else None,
                                 embed_offsets=embed_offsets)
            group = _data_group(model)
            loss = weighted_nll(logits, labels, class_weights, batch["example_mask"], group)
    with tracer.span("backward", "train", device) as span, model.step_scope(), (
            collect_split_rows(device) if split_rows else contextlib.nullcontext()) as split:
        loss.backward()
        if split is not None:
            span.args["table_grad_split_rows"] = split
    # on a mesh: the global loss, the same on every rank
    return all_reduce_sum(loss.detach(), group)


def zero_offsets(config, shape, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The lazy step's ``(off_se [B, 2L, Et], off_p [B, L, Ep])``: one zero
    in the compute dtype, expanded (no ``B x L`` buffer), each a leaf that
    takes a gradient."""
    b, l = shape
    zero = torch.zeros((), dtype=config.dtype, device=device)
    return (zero.expand(b, 2 * l, config.terminal_embed_size).requires_grad_(),
            zero.expand(b, l, config.path_embed_size).requires_grad_())


def lazy_forward_backward(model, batch: dict[str, torch.Tensor], class_weights: torch.Tensor):
    """The lazy step's forward and backward: ``(loss, table_grads)``, the
    non-table gradients in ``.grad`` and ``table_grads`` the tables'
    ``[(ids, slots), ...]`` (terminal: ``[starts; ends]`` flattened; path:
    ``paths``; slots f32 ``[N, dim]``)."""
    offsets = zero_offsets(model.config, batch["starts"].shape, batch["starts"].device)
    loss = forward_backward(model, batch, class_weights, embed_offsets=offsets)
    return loss, slot_grads(batch, offsets)


def slot_grads(batch: dict[str, torch.Tensor], offsets) -> list:
    """The tables' ``[(ids, slots), ...]`` from the offsets' gradients."""
    term_ids = torch.cat([batch["starts"], batch["ends"]], dim=1).reshape(-1)
    return [(ids, off.grad.reshape(-1, off.shape[-1]).float())
            for ids, off in zip((term_ids, batch["paths"].reshape(-1)), offsets)]


def _spanned(step):
    """``step`` inside the ``train_step`` span when a tracer is installed,
    its contract check included (the check is the span's self time)."""

    @functools.wraps(step)
    def spanned(*args, **kwargs):
        tracer = get_tracer()
        if not tracer.enabled:
            return step(*args, **kwargs)
        with tracer.span("train_step", "train"):
            return step(*args, **kwargs)

    return spanned


@_spanned
@contract_step
def train_step(model, optimizer, batch: dict[str, torch.Tensor],
               class_weights: torch.Tensor) -> torch.Tensor:
    """One optimizer step (lazy when ``optimizer`` is a
    :class:`LazyTableAdam`); returns the batch's loss on the device. Under
    a tracer: the ``train_step`` span, and inside it ``forward``,
    ``backward``, ``grad_sync`` (on a mesh) and ``optimizer``, each timed
    on the device; a lazy ``optimizer`` span carries each table's
    ``<table>_rows_processed`` and ``<table>_rows_touched``."""
    optimizer.zero_grad(set_to_none=True)
    mesh = getattr(model, "mesh", None)
    tracer, device = get_tracer(), batch["labels"].device
    if isinstance(optimizer, LazyTableAdam):
        loss, table_grads = lazy_forward_backward(model, batch, class_weights)
        if mesh is not None:
            from code2vec_tpu_torch.parallel.step import gather_slot_grads, sync_gradients

            with tracer.span("grad_sync", "train", device):
                sync_gradients(model, mesh)
                table_grads = gather_slot_grads(table_grads, mesh)
        with tracer.span("optimizer", "train", device) as span:
            optimizer.step(table_grads)
            if tracer.enabled:
                span.args.update(optimizer.rows_read())
    else:
        loss = forward_backward(model, batch, class_weights)
        if mesh is not None:
            from code2vec_tpu_torch.parallel.step import sync_gradients

            with tracer.span("grad_sync", "train", device):
                sync_gradients(model, mesh)
        with tracer.span("optimizer", "train", device):
            optimizer.step()
    return loss


@contract_step
@torch.no_grad()
def eval_step(model, batch: dict[str, torch.Tensor], class_weights: torch.Tensor,
              quant_tables=None) -> dict[str, torch.Tensor]:
    """Eval-mode forward: the batch-mean loss, argmax predictions, the max
    logit (the reference's prediction "prob", main.py:411), code vectors
    and attention (``:299-338``). A model that ``owns_loss`` gives its own
    ``evaluate(batch)``: the loss, its greedy predictions and their log
    probabilities."""
    if getattr(model, "owns_loss", False):
        return model.evaluate(batch)
    model.eval()
    labels = batch["labels"]
    logits, code_vector, attention = model(
        batch["starts"], batch["paths"], batch["ends"],
        labels=labels if model.config.angular_margin_loss else None, quant_tables=quant_tables)
    group = _data_group(model)
    return {
        # on a mesh the global batch's loss; the per-row outputs stay this rank's
        "loss": all_reduce_sum(
            weighted_nll(logits, labels, class_weights, batch["example_mask"], group), group),
        "preds": logits.argmax(dim=-1),
        "max_logit": logits.amax(dim=-1),
        "code_vector": code_vector,
        "attention": attention,
    }
