"""Training checkpoints: the loop's state at an epoch boundary.

Counterpart of ``code2vec_tpu/checkpoint.py`` without orbax, async saves
or mid-epoch cursors (ROADMAP §A.2). A checkpoint is one ``torch.save``
file per slot in the model dir: ``checkpoint_best.pt`` (written on a new
best F1) and ``checkpoint_last.pt`` (every ``checkpoint_cycle`` epochs).
Each holds the model's and the optimizer's ``state_dict``, the
:class:`TrainMeta`, the host data generator's state (the next epoch's
subsample and batch order), the dropout generator's state and, with
``--device_epoch``, the device sampler's, so ``--resume`` continues the
stream the uninterrupted run would have seen.
The optimizer's first moments are saved in their own dtype (bf16 with
``--adam_mu_dtype bfloat16``); a resume under the other dtype raises, as the
JAX restore does, and so does a resume under the other ``--table_update``
(the optimizer states differ: JAX ``checkpoint.py:666-675``).
"""

from __future__ import annotations

import copy
import logging
import os
from dataclasses import asdict, dataclass, field

import numpy as np
import torch

logger = logging.getLogger(__name__)

SLOTS = ("best", "last")


@dataclass
class TrainMeta:
    """Host-side loop state saved with the weights."""

    epoch: int = 0  # the next epoch to run
    best_f1: float | None = None
    last_loss: float | None = None
    last_accuracy: float | None = None
    bad_count: int = 0
    history: list[dict] = field(default_factory=list)
    # the vocab pad multiple the tables were built with (their shapes
    # depend on it), validated on restore
    vocab_pad_multiple: int | None = None
    # Adam's first-moment storage dtype (--adam_mu_dtype), validated on
    # restore; None (a checkpoint from before the field) reads as float32
    adam_mu_dtype: str | None = None
    # the tables' optimizer (--table_update), validated on restore; None (a
    # checkpoint from before the field) reads as dense
    table_update: str | None = None


def slot_path(out_dir: str, slot: str) -> str:
    if slot not in SLOTS:
        raise ValueError(f"checkpoint slot must be one of {SLOTS}, got {slot!r}")
    return os.path.join(out_dir, f"checkpoint_{slot}.pt")


def save_checkpoint(out_dir: str, slot: str, model, optimizer, meta: TrainMeta,
                    np_rng: np.random.Generator, sampler: torch.Generator | None = None) -> str:
    """Write ``slot`` atomically (a temp file, then a rename); the meta
    records the optimizer's first-moment dtype and table update.
    ``sampler`` is the device-epoch sampler's generator, if any."""
    from code2vec_tpu_torch.train.step import adam_mu_dtype, table_update

    meta.adam_mu_dtype = adam_mu_dtype(optimizer)
    meta.table_update = table_update(optimizer)
    gen = model.dropout_generator(next(model.parameters()).device)
    state = {
        "model": model.state_dict(),
        "optimizer": optimizer.state_dict(),
        "meta": asdict(meta),
        "np_rng_state": copy.deepcopy(np_rng.bit_generator.state),
        "dropout_rng_state": gen.get_state(),
        "sampler_rng_state": None if sampler is None else sampler.get_state(),
    }
    path = slot_path(out_dir, slot)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def clear_checkpoints(out_dir: str) -> None:
    """A fresh run starts from no checkpoint: a stale slot of an earlier
    run in the same dir could otherwise win a later ``--resume``."""
    for slot in SLOTS:
        path = slot_path(out_dir, slot)
        if os.path.exists(path):
            os.remove(path)


def restore_checkpoint(out_dir: str, model, optimizer, np_rng: np.random.Generator,
                       vocab_pad_multiple: int, prefer_best: bool = False,
                       sampler: torch.Generator | None = None) -> TrainMeta | None:
    """Load the newest slot (the one whose meta says the later epoch; the
    best slot with ``prefer_best``) into ``model``, ``optimizer`` (may be
    None), ``np_rng`` and ``sampler`` (the device-epoch sampler's
    generator, may be None; a checkpoint of a host-path run holds no
    sampler state, and the sampler then stays freshly seeded, which is
    logged); return its meta, or None when there is none. An
    optimizer whose first moments are stored in another dtype than the
    checkpoint's, or that steps the tables otherwise (``--table_update``),
    raises with the flag that resumes it."""
    found = []
    for slot in SLOTS:
        path = slot_path(out_dir, slot)
        if os.path.exists(path):
            state = torch.load(path, map_location="cpu", weights_only=False)
            found.append((slot, state))
    if not found:
        return None
    if prefer_best and any(slot == "best" for slot, _ in found):
        _, state = next(f for f in found if f[0] == "best")
    else:
        _, state = max(found, key=lambda f: f[1]["meta"]["epoch"])
    meta = TrainMeta(**state["meta"])
    if meta.vocab_pad_multiple is not None and meta.vocab_pad_multiple != vocab_pad_multiple:
        raise ValueError(
            f"the checkpoint in {out_dir} was built with vocab_pad_multiple="
            f"{meta.vocab_pad_multiple}, this run uses {vocab_pad_multiple}: the table "
            "shapes differ; pass --vocab_pad_multiple "
            f"{meta.vocab_pad_multiple} to resume it"
        )
    if optimizer is not None:
        from code2vec_tpu_torch.train.step import adam_mu_dtype, table_update

        saved_update, want_update = meta.table_update or "dense", table_update(optimizer)
        if saved_update != want_update:
            raise ValueError(
                f"the checkpoint in {out_dir} was saved with --table_update {saved_update} but "
                f"this run uses {want_update}; pass --table_update {saved_update} to resume it "
                "(the optimizer states differ)"
            )
        saved_mu, want_mu = meta.adam_mu_dtype or "float32", adam_mu_dtype(optimizer)
        if saved_mu != want_mu:
            raise ValueError(
                f"the checkpoint in {out_dir} stores Adam first moments as {saved_mu} but "
                f"this run uses {want_mu}; pass --adam_mu_dtype {saved_mu} to resume it"
            )
    model.load_state_dict(state["model"])
    if optimizer is not None:
        optimizer.load_state_dict(state["optimizer"])
    np_rng.bit_generator.state = state["np_rng_state"]
    device = next(model.parameters()).device
    model.dropout_generator(device).set_state(state["dropout_rng_state"])
    if sampler is not None:
        if state.get("sampler_rng_state") is not None:
            sampler.set_state(state["sampler_rng_state"])
        else:
            logger.info("the checkpoint in %s holds no device-epoch sampler state (a host-path "
                        "run's): the sampler starts from the run's seed", out_dir)
    return meta
