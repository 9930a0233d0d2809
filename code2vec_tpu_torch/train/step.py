"""Train and eval steps.

Counterpart of ``code2vec_tpu/train/step.py``:

- the loss is log-softmax + class-weighted NLL with the example mask,
  ``sum(w nll mask) / max(sum(w mask), 1e-12)`` (``:178-187``; torch
  NLLLoss's weighted mean, reference main.py:129-130);
- the optimizer is ``torch.optim.Adam(lr, (beta_min, beta_max), eps=1e-8,
  weight_decay)``, whose coupled L2 (added to the gradient before the
  moments) is what the JAX ``torch_style_adam`` reproduces (``:94-123``);
- the margin head gets the labels in training (``needs_labels``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

BATCH_KEYS = ("starts", "paths", "ends", "labels", "example_mask")


def weighted_nll(logits: torch.Tensor, labels: torch.Tensor, class_weights: torch.Tensor,
                 example_mask: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    w = class_weights[labels.long()] * example_mask
    return (nll * w).sum() / torch.clamp(w.sum(), min=1e-12)


def make_optimizer(model: torch.nn.Module, config) -> torch.optim.Adam:
    """torch Adam with the config's rate, betas and coupled weight decay."""
    return torch.optim.Adam(model.parameters(), lr=config.lr,
                            betas=(config.beta_min, config.beta_max), eps=1e-8,
                            weight_decay=config.weight_decay)


def to_device(batch: dict[str, np.ndarray], device: torch.device) -> dict[str, torch.Tensor]:
    """The step's inputs on ``device`` (pinned, asynchronous copies to a
    card, so the host can build the next batch meanwhile)."""
    out = {}
    for key in BATCH_KEYS:
        t = torch.from_numpy(np.ascontiguousarray(batch[key]))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[key] = t
    return out


def forward_backward(model, batch: dict[str, torch.Tensor],
                     class_weights: torch.Tensor) -> torch.Tensor:
    """Training-mode forward and backward of one batch (gradients land in
    ``.grad``); returns the loss, still on the device."""
    model.train()
    labels = batch["labels"]
    logits, _, _ = model(batch["starts"], batch["paths"], batch["ends"],
                         labels=labels if model.config.angular_margin_loss else None)
    loss = weighted_nll(logits, labels, class_weights, batch["example_mask"])
    loss.backward()
    return loss.detach()


def train_step(model, optimizer, batch: dict[str, torch.Tensor],
               class_weights: torch.Tensor) -> torch.Tensor:
    """One optimizer step; returns the batch's loss on the device."""
    optimizer.zero_grad(set_to_none=True)
    loss = forward_backward(model, batch, class_weights)
    optimizer.step()
    return loss


@torch.no_grad()
def eval_step(model, batch: dict[str, torch.Tensor], class_weights: torch.Tensor,
              quant_tables=None) -> dict[str, torch.Tensor]:
    """Eval-mode forward: the batch-mean loss, argmax predictions, the max
    logit (the reference's prediction "prob", main.py:411), code vectors
    and attention (``:299-338``)."""
    model.eval()
    labels = batch["labels"]
    logits, code_vector, attention = model(
        batch["starts"], batch["paths"], batch["ends"],
        labels=labels if model.config.angular_margin_loss else None, quant_tables=quant_tables)
    return {
        "loss": weighted_nll(logits, labels, class_weights, batch["example_mask"]),
        "preds": logits.argmax(dim=-1),
        "max_logit": logits.amax(dim=-1),
        "code_vector": code_vector,
        "attention": attention,
    }
