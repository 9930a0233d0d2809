"""Training checkpoints: the loop's state at an epoch boundary or inside
an epoch, written synchronously or on a thread.

Counterpart of ``code2vec_tpu/checkpoint.py`` without orbax. A checkpoint
is one ``torch.save`` file per slot in the model dir:
``checkpoint_best.pt`` (written on a new best F1) and
``checkpoint_last.pt`` (every ``checkpoint_cycle`` epochs, every
``checkpoint_every_steps`` steps with a mid-epoch data cursor, and on
SIGTERM). Each holds the model's and the optimizer's ``state_dict``, the
:class:`TrainMeta` (with the optimizer steps taken and the cursor), the
host data generator's state, the dropout generator's state and, with
``--device_epoch``, the device sampler's, so ``--resume`` continues the
stream the uninterrupted run would have seen.

The crash-window rules of the JAX module (``:154-246``), for one file a
slot:

- a save is atomic: the state is written to ``<slot file>.tmp<pid>`` and
  ``os.replace``d over the slot, so a re-save of a slot (at the same step
  too) never leaves it unpublished;
- the ``mid_save`` fault point sits between the temp write and the
  replace: a ``kill`` there leaves the previous checkpoint restorable and a
  ``.tmp*`` file that restore never reads and the next
  :class:`CheckpointWriter` (or :func:`clear_checkpoints`) sweeps, whatever
  its pid; a slot file that does not load (cut short by other means) is
  skipped by restore with a warning;
- the meta of a slot is the meta of its own arrays (one file);
- a best save prunes a ``last`` slot it supersedes.

:class:`CheckpointWriter` runs the loop's saves: synchronously, or with
``async_save`` a snapshot (every tensor copied to host memory the snapshot
owns, before :meth:`CheckpointWriter.save` returns: ``state_dict()``
returns the live tensors the next optimizer step updates in place) and a
persist thread, at most one save in flight; a persist failure is stored
and re-raised at the next save or at :meth:`CheckpointWriter.finish`.

On a mesh (a model given ``parallel/shardings.shard_model``) a slot holds
global tensors: every rank gathers its shards over the model line, rank 0
writes the file JAX's orbax write would hold plus a
``checkpoint_<slot>.shardings.json`` sidecar in JAX's ``pytree_spec_doc``
format (also kept in the file), and the ranks then meet at a barrier. The
async writer persists on rank 0 only. On restore every rank reads the
file, validates the saved specs against its mesh (SC001, SC002) and
slices its shards of the global tensors (JAX's divisibility rule), so a
restore onto another mesh shape (``saved_mesh_shape``) is a re-slice (JAX
``checkpoint.py:19-20``, ``:616-731``).

The optimizer's first moments are saved in their own dtype (bf16 with
``--adam_mu_dtype bfloat16``); a resume under the other dtype raises, as the
JAX restore does, and so does a resume under the other ``--table_update``
(the optimizer states differ: JAX ``checkpoint.py:666-675``) or with a
weight decay where the checkpoint had none, or none where it had one (JAX's
optax chain gains or loses ``add_decayed_weights``, and orbax refuses the
other tree).

A resume takes from the checkpoint what training made: the weights, the
moments, the step counts, the generators and the data cursor. The
optimizer's settings (lr, betas, eps, the weight decay's value) stay the
resuming run's (``train/step.load_optimizer_state``), as JAX rebuilds its
chain from the run's config and restores only the arrays.
"""

from __future__ import annotations

import copy
import json
import logging
import os
import pickle
import re
import threading
import time
from dataclasses import asdict, dataclass, field

import numpy as np
import torch

from code2vec_tpu_torch import faultinject

logger = logging.getLogger(__name__)

SLOTS = ("best", "last")
_STAGING = re.compile(r"^checkpoint_(?:best|last)\.pt\.tmp\d+$")


@dataclass
class TrainMeta:
    """Host-side loop state saved with the weights."""

    epoch: int = 0  # the next epoch to run (the one to re-enter, with a cursor)
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
    # optimizer steps taken: with ``epoch`` it orders the slots (a
    # checkpoint from before the field reads as 0)
    step: int = 0
    # the data cursor (train/loop._data_cursor): {"epoch", "step",
    # "feed_batch", "np_rng_state", "jax_rng", "partial_train_loss",
    # "bucket_positions"}; step 0 at an epoch boundary, None in a checkpoint
    # from before the field
    cursor: dict | None = None


def slot_path(out_dir: str, slot: str) -> str:
    if slot not in SLOTS:
        raise ValueError(f"checkpoint slot must be one of {SLOTS}, got {slot!r}")
    return os.path.join(out_dir, f"checkpoint_{slot}.pt")


def sidecar_path(out_dir: str, slot: str) -> str:
    """The slot's ``shardings.json`` sidecar (a mesh run's)."""
    return os.path.join(out_dir, f"checkpoint_{slot}.shardings.json")


def _writes(model) -> bool:
    """Whether this rank writes the model dir: rank 0 of a mesh, or a run
    without one."""
    mesh = getattr(model, "mesh", None)
    return mesh is None or mesh.rank == 0


def _meet(model) -> None:
    """A mesh's ranks wait for each other (a save is on disk for all)."""
    if getattr(model, "mesh", None) is not None:
        from code2vec_tpu_torch.parallel.distributed import barrier

        barrier()


def _slot_key(meta: dict) -> tuple[int, int]:
    """The order of two saves: the later epoch, then the later step (a
    mid-epoch save re-enters its epoch, so it sorts after the boundary
    save that opened the epoch and before the one that closes it)."""
    return int(meta["epoch"]), int(meta.get("step", 0))


def _state_dict(model, optimizer, meta: TrainMeta, np_rng: np.random.Generator,
                sampler: torch.Generator | None) -> dict:
    """What a slot holds, with the live tensors of ``model`` and
    ``optimizer``; the meta records the optimizer's first-moment dtype and
    table update."""
    from code2vec_tpu_torch.train.step import adam_mu_dtype, table_update

    meta.adam_mu_dtype = adam_mu_dtype(optimizer)
    meta.table_update = table_update(optimizer)
    gen = model.dropout_generator(next(model.parameters()).device)
    mesh = getattr(model, "mesh", None)
    if mesh is None:
        model_sd, optim_sd, doc = model.state_dict(), optimizer.state_dict(), None
    else:
        from code2vec_tpu_torch.parallel.shardings import pytree_spec_doc, unshard_state

        # collective: every rank gathers its shards to the global tensors
        model_sd, optim_sd = unshard_state(mesh, model, optimizer)
        doc = pytree_spec_doc(mesh, model, optimizer)
    return {
        "model": model_sd,
        "optimizer": optim_sd,
        "shardings": doc,
        "meta": asdict(meta),
        "np_rng_state": copy.deepcopy(np_rng.bit_generator.state),
        "dropout_rng_state": gen.get_state(),
        "sampler_rng_state": None if sampler is None else sampler.get_state(),
    }


def _host_copy(obj, pinned: dict | None, key: tuple = ()):
    """``obj`` with every tensor copied to host memory of its own (the rest
    deep-copied). With ``pinned`` a card's tensor goes, without waiting,
    into the page-locked buffer kept there under its place in ``obj``."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        if pinned is None or not t.is_cuda:
            return t.to("cpu", copy=True)
        buf = pinned.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = pinned[key] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return buf.copy_(t, non_blocking=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v, pinned, key + (k,)) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v, pinned, key + (i,)) for i, v in enumerate(obj))
    return copy.deepcopy(obj)


def snapshot_state(model, optimizer, meta: TrainMeta, np_rng: np.random.Generator,
                   sampler: torch.Generator | None = None, pinned: dict | None = None) -> dict:
    """The slot's state for an async save, owning its memory: nothing the
    next optimizer step updates in place is shared. On a card the copy to
    host memory waits for the steps enqueued before it: it is what the
    loop blocks on, as ``jax.device_get`` is in JAX. ``pinned`` (a dict the
    caller keeps from one snapshot to the next, and reuses only once the
    previous snapshot is written) holds page-locked buffers that the card
    copies into at full rate, one synchronisation for them all."""
    state = _host_copy(_state_dict(model, optimizer, meta, np_rng, sampler), pinned)
    if pinned and torch.cuda.is_available():
        torch.cuda.current_stream().synchronize()
    return state


def _read(path: str, mmap: bool = False) -> dict | None:
    """A slot file's state, or None (with a warning) when it does not load."""
    try:
        return torch.load(path, map_location="cpu", weights_only=False, mmap=mmap)
    except (RuntimeError, EOFError, OSError, pickle.UnpicklingError) as exc:
        logger.warning("skipping unreadable checkpoint %s (%s; a save cut short?)", path, exc)
        return None


def _publish(out_dir: str, slot: str, state: dict) -> str:
    """Write ``state`` to the slot atomically (the temp file, then one
    ``os.replace``); a best save then prunes a ``last`` slot it supersedes."""
    path = slot_path(out_dir, slot)
    tmp = f"{path}.tmp{os.getpid()}"
    step = state["meta"].get("step", 0)
    torch.save(state, tmp)
    faultinject.fault_point("mid_save", slot=slot, step=step)
    os.replace(tmp, path)
    if state.get("shardings") is not None:
        sidecar = sidecar_path(out_dir, slot)
        with open(f"{sidecar}.tmp{os.getpid()}", "w", encoding="utf-8") as f:
            json.dump(state["shardings"], f, indent=1)
        os.replace(f"{sidecar}.tmp{os.getpid()}", sidecar)
    if slot == "best":
        last = slot_path(out_dir, "last")
        if os.path.exists(last):
            head = _read(last, mmap=True)
            if head is None or _slot_key(head["meta"]) <= _slot_key(state["meta"]):
                os.remove(last)
    faultinject.fault_point("post_save", slot=slot, step=step)
    return path


def save_checkpoint(out_dir: str, slot: str, model, optimizer, meta: TrainMeta,
                    np_rng: np.random.Generator, sampler: torch.Generator | None = None) -> str:
    """Write ``slot`` synchronously and atomically. ``sampler`` is the
    device-epoch sampler's generator, if any."""
    faultinject.fault_point("pre_save", slot=slot)
    state = _state_dict(model, optimizer, meta, np_rng, sampler)
    path = _publish(out_dir, slot, state) if _writes(model) else slot_path(out_dir, slot)
    _meet(model)
    return path


def sweep_staging_files(out_dir: str) -> None:
    """Remove the ``.tmp<pid>`` files of saves cut short (killed between
    the temp write and the replace), whatever process wrote them: restore
    never reads them, and each is checkpoint-sized."""
    if not os.path.isdir(out_dir):
        return
    for name in os.listdir(out_dir):
        if _STAGING.match(name):
            logger.info("sweeping the staging file %s of a save cut short", name)
            try:
                os.remove(os.path.join(out_dir, name))
            except FileNotFoundError:
                pass


def clear_checkpoints(out_dir: str) -> None:
    """A fresh run starts from no checkpoint: a stale slot of an earlier
    run in the same dir could otherwise win a later ``--resume``. Staging
    files are swept too."""
    for slot in SLOTS:
        for path in (slot_path(out_dir, slot), sidecar_path(out_dir, slot)):
            if os.path.exists(path):
                os.remove(path)
    sweep_staging_files(out_dir)


class CheckpointWriter:
    """The loop's saves, synchronous or asynchronous behind one interface.

    With ``async_save`` :meth:`save` takes a :func:`snapshot_state` (the
    only part the loop waits for), hands it to a persist thread and
    returns: the next steps overlap the disk write. At most one save is in
    flight (a save first waits out the previous persist), and a persist
    failure is stored and re-raised into the loop at the next :meth:`save`
    or at :meth:`finish`. Synchronously :meth:`save` writes the live state
    and raises its own failure.

    ``saves`` records each save: its slot, mode, the ms the loop was held
    (the whole save when synchronous, the snapshot when asynchronous) and
    the persist's seconds (set by the thread when it ends). An async
    snapshot of a card's state goes into page-locked buffers the writer
    keeps for the run (one set: the previous persist has ended before the
    next snapshot is taken).

    Telemetry (JAX ``checkpoint.py:493-556``): the whole sync save is a
    ``checkpoint_save.persist`` span (``mode="sync"``); an async save is a
    ``checkpoint_save.snapshot`` span on the loop's thread and a
    ``checkpoint_save.persist`` span (``mode="async"``) on the persist
    thread. Each save that reaches the disk emits ``checkpoint_saved``
    (slot, path, step, ``async``, and the caller's fields) into
    ``events``."""

    def __init__(self, out_dir: str, async_save: bool = False, events=None, tracer=None):
        from code2vec_tpu_torch.obs.trace import get_tracer

        self.out_dir = out_dir
        self.async_save = bool(async_save)
        self.events = events
        self.tracer = tracer or get_tracer()
        self.saves: list[dict] = []
        self._thread: threading.Thread | None = None
        self._failure: BaseException | None = None
        self._lock = threading.Lock()
        self._pinned: dict = {}
        sweep_staging_files(out_dir)

    def check(self) -> None:
        """Re-raise a stored persist failure."""
        with self._lock:
            failure, self._failure = self._failure, None
        if failure is not None:
            raise failure

    def wait(self) -> None:
        """Block until no save is in flight (a failure stays stored)."""
        thread = self._thread
        if thread is not None:
            thread.join()
            self._thread = None

    def finish(self, model=None) -> None:
        """Drain the save in flight and raise its failure: the loop's
        barrier on a normal end (and, on a mesh, the ranks' barrier)."""
        self.wait()
        self.check()
        if model is not None:
            _meet(model)

    def close(self) -> None:
        """The ``finally`` form: drain and log a failure, so an exception
        already unwinding is not masked."""
        self.wait()
        with self._lock:
            failure, self._failure = self._failure, None
        if failure is not None:
            logger.error("the async checkpoint persist failed", exc_info=failure)

    def save(self, slot: str, model, optimizer, meta: TrainMeta, np_rng: np.random.Generator,
             sampler: torch.Generator | None = None, **event_fields) -> str:
        """Save into ``slot``; return the slot's path (asynchronously: the
        path the persist in flight will publish). ``event_fields`` (the
        epoch) ride the spans and the ``checkpoint_saved`` event."""
        self.wait()
        self.check()
        record = {"slot": slot, "async": self.async_save, "step": meta.step}
        self.saves.append(record)
        t0 = time.perf_counter()
        if not self.async_save:
            with self.tracer.span("checkpoint_save.persist", category="checkpoint", slot=slot,
                                  mode="sync", **event_fields):
                path = save_checkpoint(self.out_dir, slot, model, optimizer, meta, np_rng,
                                       sampler)
            record["blocking_ms"] = (time.perf_counter() - t0) * 1e3
            record["persist_s"] = record["blocking_ms"] / 1e3
            if _writes(model):
                self._emit(slot, path, record["step"], False, event_fields)
            return path
        faultinject.fault_point("pre_save", slot=slot)
        with self.tracer.span("checkpoint_save.snapshot", category="checkpoint", slot=slot,
                              **event_fields):
            state = snapshot_state(model, optimizer, meta, np_rng, sampler, self._pinned)
        record["blocking_ms"] = (time.perf_counter() - t0) * 1e3
        if not _writes(model):
            return slot_path(self.out_dir, slot)  # rank 0 persists a mesh's save
        self._thread = threading.Thread(target=self._persist,
                                        args=(slot, state, record, event_fields),
                                        name="c2v-ckpt-persist", daemon=True)
        self._thread.start()
        return slot_path(self.out_dir, slot)

    def _persist(self, slot: str, state: dict, record: dict, event_fields: dict) -> None:
        t0 = time.perf_counter()
        try:
            with self.tracer.span("checkpoint_save.persist", category="checkpoint", slot=slot,
                                  mode="async", **event_fields):
                _publish(self.out_dir, slot, state)
            record["persist_s"] = time.perf_counter() - t0
            self._emit(slot, slot_path(self.out_dir, slot), record["step"], True, event_fields)
        except BaseException as exc:  # noqa: BLE001 - re-raised in the loop
            with self._lock:
                self._failure = exc

    def _emit(self, slot, path, step, was_async, event_fields) -> None:
        if self.events is not None:
            self.events.emit("checkpoint_saved", slot=slot, path=str(path), step=int(step),
                             **{"async": was_async}, **event_fields)


def restore_checkpoint(out_dir: str, model, optimizer, np_rng: np.random.Generator,
                       vocab_pad_multiple: int, prefer_best: bool = False,
                       sampler: torch.Generator | None = None,
                       info: dict | None = None, mesh=None) -> TrainMeta | None:
    """Load the newest slot (the later epoch, then the later step; the
    best slot with ``prefer_best``) into ``model``, ``optimizer`` (may be
    None), ``np_rng`` and ``sampler`` (the device-epoch sampler's
    generator, may be None; a checkpoint of a host-path run holds no
    sampler state, and the sampler then stays freshly seeded, which is
    logged); return its meta (with its cursor), or None when there is
    none. ``info`` (a dict) receives the restored ``slot``, ``path``,
    ``saved_mesh_shape`` and ``resharded``. ``mesh``: the restoring run's
    (``model`` sharded on it): the saved specs are validated against it and
    the global tensors sliced to its shards (a checkpoint of another mesh
    shape, or of one device, restores by re-slicing). A slot file that does
    not load is skipped with a warning. The optimizer keeps its own settings
    (lr, betas, eps, weight decay) and takes the checkpoint's moments and
    step counts. An optimizer whose first moments are stored in another
    dtype than the checkpoint's, that steps the tables otherwise
    (``--table_update``), or that decays the weights where the checkpoint's
    did not (or not where it did: ``--weight_decay``) raises, before
    anything is loaded, with the flag that resumes it."""
    found = []
    for slot in SLOTS:
        path = slot_path(out_dir, slot)
        if os.path.exists(path):
            head = _read(path, mmap=True)  # the meta alone, without reading the arrays
            if head is not None:
                found.append((slot, path, _slot_key(head["meta"])))
            del head
    if not found:
        return None
    if prefer_best and any(slot == "best" for slot, _, _ in found):
        slot, path, _ = next(f for f in found if f[0] == "best")
    else:
        slot, path, _ = max(found, key=lambda f: f[2])
    if info is not None:
        info.update(slot=slot, path=path)
    state = _read(path)
    if state is None:
        return None
    meta = TrainMeta(**state["meta"])
    if meta.vocab_pad_multiple is not None and meta.vocab_pad_multiple != vocab_pad_multiple:
        raise ValueError(
            f"the checkpoint in {out_dir} was built with vocab_pad_multiple="
            f"{meta.vocab_pad_multiple}, this run uses {vocab_pad_multiple}: the table "
            "shapes differ; pass --vocab_pad_multiple "
            f"{meta.vocab_pad_multiple} to resume it"
        )
    model_sd, optim_sd = state["model"], state["optimizer"]
    if optimizer is not None:
        from code2vec_tpu_torch.train.step import (
            adam_mu_dtype,
            load_optimizer_state,
            table_update,
            weight_decay,
        )

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
        saved_wd, want_wd = weight_decay(optim_sd), weight_decay(optimizer.state_dict())
        if bool(saved_wd) != bool(want_wd):
            raise ValueError(
                f"the checkpoint in {out_dir} was saved with --weight_decay {saved_wd:g} but "
                f"this run uses {want_wd:g}; pass "
                + ("a non-zero --weight_decay" if saved_wd else "--weight_decay 0")
                + " to resume it (a zero weight decay has no decay step: the optimizer "
                "states differ)"
            )
    doc = state.get("shardings")
    saved_mesh_shape = doc.get("mesh_shape") if doc else None
    if mesh is not None:
        from code2vec_tpu_torch.analysis.sharding_check import validate_runtime_spec
        from code2vec_tpu_torch.parallel.shardings import shard_state

        problems = [p for key, entries in ((doc or {}).get("specs") or {}).items() if entries
                    for p in validate_runtime_spec(entries, mesh.axis_names, context=key)]
        if problems:
            raise ValueError(f"the checkpoint in {path} carries specs that do not fit the "
                             "restore mesh:\n  " + "\n  ".join(problems))
        model_sd, optim_sd = shard_state(mesh, model, model_sd, optimizer,
                                         optim_sd if optimizer is not None else None)
    if info is not None:
        info.update(saved_mesh_shape=saved_mesh_shape,
                    resharded=saved_mesh_shape != (dict(mesh.shape) if mesh is not None
                                                   else None))
    model.load_state_dict(model_sd)
    if optimizer is not None:
        load_optimizer_state(optimizer, optim_sd)
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
