"""The training loop (reference: main.py:118-248).

Counterpart of ``code2vec_tpu/train/loop.py`` (``model_config_from`` and
``class_weights_from`` at ``:273-381``, the ladder of ``:610-745``, the
host-pipeline epoch of ``train()`` at ``:1315-1761``) for the method-name
and variable-name tasks, alone or together (method rows first):

- the bag-width ladder, resolved once: with ``bucketed`` an explicit
  ``bucket_ladder`` or one derived from the corpus, and with
  ``max_contexts == 0`` long-bag rungs above ``max_path_length``, the
  epochs then built at the top rung so no context is truncated;
- a seeded split, then every epoch a fresh context subsample of the train
  split, a shuffled pass of train steps (losses accumulated on the device,
  read once per epoch), a fresh subsample of the test split, the eval pass
  and its metrics, both splits fed by ``data.pipeline.make_batch_source``
  (fixed ``L`` or bucketed; in RAM, streamed in chunks with
  ``stream_chunk_items``, or gathered from an mmap-backed CSR corpus),
  their plans built on ``feed_workers`` forked processes
  (``data/parallel_feed.py``, one pool from after the corpus load to the
  end of the run) and the batches copied ``prefetch_batches`` ahead on a
  thread (``train/prefetch.py``); ``profile_steps`` adds the steps'
  host-build / H2D / feed-wait / compute split to the epoch line;
- on a new best F1: the ``code.vec`` export (the epoch's own arrays, as
  the JAX in-RAM path reuses them, through the training model's eval
  step, so in its compute dtype), the best checkpoint and the served
  ``code2vec.model``; ``print_sample`` every ``print_sample_cycle``
  epochs; the reference's early stop, whose counter resets when the train
  loss OR the accuracy improves (``:1724-1736``);
- ``model="code2seq"`` (device epochs only): the model of
  :func:`code2seq_from` over expansion tables built from the vocab strings;
  the model answers the rest (``models/code2seq.Code2Seq``): its loss in
  the steps, its optimizer, each epoch's rate ``lr * epoch_lr_decay **
  epoch``, its ``score`` of the greedy-decoded names, its ``meta`` in the
  model dir, and no code-vector outputs (``code_vectors``);
- the optimizer of ``config.table_update`` (``train/step.make_optimizer``:
  the lazy table optimizer steps the tables' touched rows at every bag
  width, fixed, bucketed or long) and the tables' ``embed_grad``;
- elastic training (JAX ``:125-271``, ``:589-607``, ``:1132-1199``,
  ``:1240-1255``, ``:1365-1445``, ``:1769-1790``): every save goes through
  a :class:`~code2vec_tpu_torch.checkpoint.CheckpointWriter` (sync, or a
  host snapshot and a persist thread with ``async_checkpoint``);
  ``checkpoint_every_steps`` adds ``last``-slot saves inside an epoch with
  a data cursor (:func:`_data_cursor`, :class:`_EpochCursorHook`); SIGTERM
  (``train/preempt.py``) finishes the step in flight, saves and returns
  normally; ``--resume`` restores the cursor's generator states and
  replays the epoch's host stream to it (``data.pipeline.skip_batches``),
  so the resumed run's history is the uninterrupted run's bit for bit.
  The fault plan (``faultinject.py``) is installed from the config or
  ``C2V_FAULT_PLAN`` at each call. Device epochs save at epoch boundaries
  only, as in JAX. The one difference from JAX: the port's dropout stream
  is a stateful generator, not a key a step, so each cursor carries the
  dropout generator's state at its save step (under ``jax_rng``, JAX's
  name for the run's random state).

Telemetry (JAX ``:519-548``, ``:1255-1830``): the epoch's metrics go out
only as ``epoch`` and ``best_f1`` events of one ``obs.events.EventLog``
(a dispatch-only one when none is given), to which the ``sinks``
(``sinks.py``) are subscribed for the call and closed at its end; the log
opens with the run manifest (config, corpus, the analytic step costs of
each ladder rung with the card's peak, the card). The process-wide tracer
gets ``train_pass``, ``train_step`` (the first and the profiled steps),
``eval_pass``, ``stage_corpus``, ``resume_replay``, ``export_vectors`` and
``checkpoint_save`` spans; ``RecompileDetector`` counts the train and eval
steps' input signatures that appear after the warmup; each ``epoch`` event
carries a memory snapshot and the health counters. ``report_fn(epoch,
f1)`` (the search's pruning hook) may raise :class:`StopTraining`, which
ends the run normally; while it is set no checkpoint, vector export or
sample print is made. ``profile_dir`` gets a ``torch.profiler`` trace
(CPU and, on the card, CUDA activity) of the second epoch run.

The numpy generator is drawn in the JAX loop's order (split; then per
epoch the train subsample, the batch order, the test subsample), so both
trainers see the same batches from the same seed. Each epoch's line also
carries the train pass's steps/s and real contexts/s, timed from the end
of its first (warm) step.
"""

from __future__ import annotations

import copy
import functools
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from code2vec_tpu_torch import faultinject
from code2vec_tpu_torch.checkpoint import (
    CheckpointWriter,
    TrainMeta,
    clear_checkpoints,
    restore_checkpoint,
)
from code2vec_tpu_torch.data.parallel_feed import FeedPool, ParallelFeed
from code2vec_tpu_torch.data.pipeline import (
    build_epoch,
    derive_bucket_ladder,
    derive_longbag_ladder,
    empty_batch,
    make_batch_source,
    oov_rate,
    pad_batch_stream,
    pad_stats,
    parse_bucket_ladder,
    skip_batches,
    split_items,
    truncated_fraction_of_counts,
)
from code2vec_tpu_torch.metrics import evaluate
from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig
from code2vec_tpu_torch.obs import costs as obs_costs
from code2vec_tpu_torch.obs.events import EventLog, sink_consumer
from code2vec_tpu_torch.obs.runtime import RecompileDetector, RuntimeHealth, memory_snapshot
from code2vec_tpu_torch.obs.trace import get_tracer, set_tracer
from code2vec_tpu_torch.ops.autotune import pin_cache
from code2vec_tpu_torch.ops.backend import resolve_device
from code2vec_tpu_torch.sinks import MetricSink, logging_sink
from code2vec_tpu_torch.train.device_epoch import (
    BucketedEpochRunner,
    BucketedShardedEpochRunner,
    BucketedStagedCorpus,
    EpochRunner,
    ShardedEpochRunner,
    StagedCorpus,
    bucket_shard_staged,
    bucket_staged,
    concat_staged,
    place_staged,
    sampler_generator,
    shard_staged,
    stage_method_corpus,
    stage_variable_corpus,
)
from code2vec_tpu_torch.train.preempt import (
    PreemptionStop,
    coordinated_stop,
    install_sigterm_handler,
    preemption_guard,
    restore_sigterm_handler,
)
from code2vec_tpu_torch.train.prefetch import StepProfiler, device_batches
from code2vec_tpu_torch.train.step import (
    StepTally,
    eval_step,
    fold_value,
    make_optimizer,
    to_device,
    train_step,
)

logger = logging.getLogger(__name__)


class StopTraining(Exception):
    """Raised by a ``report_fn`` to end training early (the search's
    pruning hook); ``train()`` returns normally."""


@dataclass
class TrainResult:
    best_f1: float
    final_f1: float
    epochs_run: int
    history: list[dict] = field(default_factory=list)
    model: Code2Vec | None = None
    # the checkpoint writer's record of each save (CheckpointWriter.saves)
    checkpoint_saves: list[dict] = field(default_factory=list)


def _rng_state(np_rng: np.random.Generator) -> dict:
    return copy.deepcopy(np_rng.bit_generator.state)


def _data_cursor(epoch: int, step: int, feed_batch: int, np_rng_state: dict, jax_rng,
                 loss_fold: tuple[float, float] = (0.0, 0.0),
                 bucket_positions: dict | None = None) -> dict:
    """The cursor, JAX's keys (``loop.py:125-149``), the one constructor
    of mid-epoch and boundary saves. ``np_rng_state`` is the epoch's start
    state (everything the epoch streams is a function of it), ``step`` the
    batches consumed, ``feed_batch`` the batch size the replay must match,
    ``jax_rng`` the dropout generator's state at the save step (a list of
    its bytes), ``partial_train_loss`` the epoch's loss so far and
    ``bucket_positions`` the batches consumed per width. One key is the
    port's own: ``loss_fold``, the fold's ``(sum, compensation)`` state
    (``train/step.fold_losses``), which a resumed epoch goes on from."""
    return {
        "epoch": int(epoch),
        "step": int(step),
        "feed_batch": int(feed_batch),
        "np_rng_state": np_rng_state,
        "jax_rng": None if jax_rng is None else [int(x) for x in jax_rng],
        "partial_train_loss": fold_value(loss_fold),
        "loss_fold": [float(x) for x in loss_fold],
        "bucket_positions": dict(bucket_positions or {}),
    }


class _EpochCursorHook:
    """The host pass's bookkeeping behind mid-epoch saves and graceful
    preemption (JAX ``loop.py:152-271``). :meth:`after_step` counts the
    epoch's steps (from the replayed cursor on) and the batches a width,
    and saves the ``last`` slot with a cursor every ``every_steps`` steps
    and when the SIGTERM guard is set (on a mesh, read at those saves
    only: :meth:`_should_stop`), raising :class:`PreemptionStop`
    after that save. :meth:`after_pass` re-checks the guard at the stream's
    end: the prefetch producer drains on SIGTERM, so a stream may end
    early, and that pass must not be recorded as an epoch. ``save`` (None
    without a model dir) writes a slot; ``dropout_state`` reads the
    dropout generator's state."""

    def __init__(self, save, meta: TrainMeta, epoch: int, epoch_rng_state: dict,
                 dropout_state, guard, feed_batch: int, every_steps: int = 0, skip: int = 0,
                 widths: dict | None = None, mesh=None):
        self.save = save
        self.mesh = mesh
        self.meta = meta
        self.epoch = epoch
        self.epoch_rng_state = epoch_rng_state
        self.dropout_state = dropout_state
        self.guard = guard
        self.feed_batch = int(feed_batch)
        self.every_steps = int(every_steps)
        self.steps = int(skip)
        self.widths = {int(w): int(c) for w, c in (widths or {}).items()}

    def _save(self, tally: StepTally) -> None:
        self.meta.epoch = self.epoch  # the resume re-enters this epoch
        self.meta.cursor = _data_cursor(self.epoch, self.steps, self.feed_batch,
                                        self.epoch_rng_state, self.dropout_state(),
                                        tally.partial(), self.widths)
        with get_tracer().span("checkpoint_save", category="checkpoint", epoch=self.epoch,
                               slot="last", mid_epoch=True):
            self.save("last", epoch=self.epoch, mid_epoch=True)

    def _should_stop(self, at_collective_point: bool) -> bool:
        """Act on the guard: every step on one rank, but on a mesh of
        several ranks only at the points every rank reaches at the same step
        (the periodic-save steps and the stream's end; JAX ``loop.py:240-252``).
        There :func:`coordinated_stop` agrees on rank 0's flag through a
        broadcast, whose readback would otherwise sync host and device every
        step."""
        if self.mesh is None or self.mesh.size == 1:
            return self.guard.requested()
        return at_collective_point and coordinated_stop(self.guard, self.mesh)

    def after_step(self, tally: StepTally, width: int) -> None:
        self.widths[width] = self.widths.get(width, 0) + 1
        self.steps += 1
        self.meta.step += 1
        periodic = bool(self.every_steps and self.steps % self.every_steps == 0)
        stop = self._should_stop(periodic)
        if self.save is not None and (stop or periodic):
            self._save(tally)
        if stop:
            raise PreemptionStop(self.guard.reason or "requested")

    def after_pass(self, tally: StepTally) -> None:
        if self._should_stop(True):
            if self.save is not None:
                self._save(tally)
            raise PreemptionStop(self.guard.reason or "requested")


def model_config_from(config, data) -> Code2VecConfig:
    return Code2VecConfig(
        terminal_count=len(data.terminal_vocab),
        path_count=len(data.path_vocab),
        label_count=len(data.label_vocab),
        terminal_embed_size=config.terminal_embed_size,
        path_embed_size=config.path_embed_size,
        encode_size=config.encode_size,
        dropout_prob=config.dropout_prob,
        angular_margin_loss=config.angular_margin_loss,
        angular_margin=config.angular_margin,
        inverse_temp=config.inverse_temp,
        dtype=torch.bfloat16 if config.compute_dtype == "bfloat16" else torch.float32,
        use_pallas=config.use_pallas,
        pallas_impl=config.pallas_impl,
        pallas_chunk_l=config.pallas_chunk_l,
        pallas_softmax=config.pallas_softmax,
        # --max_contexts 0: widths above max_path_length are long-bag shapes,
        # which a kernel route streams through K4
        longbag_width=config.max_path_length if config.max_contexts == 0 else 0,
        table_dtype=config.table_dtype,
        attn_impl=config.attn_impl,
        encoder_impl=config.encoder_impl,
        vocab_pad_multiple=config.vocab_pad_multiple or max(config.model_axis, 1),
        embed_grad=config.embed_grad,
    )


def code2seq_from(config, data):
    """A ``models/code2seq.Code2Seq`` of the config's widths over the
    corpus's vocabularies, its expansion tables built from their strings
    (``data/expansion.py``); the rest at code2seq's java-large values."""
    from code2vec_tpu_torch.data.expansion import build_expansions
    from code2vec_tpu_torch.models.code2seq import EXPANSIONS, Code2Seq, Code2SeqConfig

    exp = build_expansions(data.terminal_vocab, data.path_vocab, data.label_vocab)
    c = Code2SeqConfig(subtoken_count=exp.subtoken_count, node_count=exp.node_count,
                       target_count=exp.target_count, embed_size=config.seq_embed_size,
                       rnn_size=config.seq_rnn_size, decoder_size=config.seq_decoder_size,
                       embed_dropout_prob=config.dropout_prob)
    return Code2Seq(c, {name: getattr(exp, name) for name in EXPANSIONS}, exp.target_names)


def build_mesh(config):
    """The ``(data, model, ctx)`` mesh of the config's axes over the
    process group, with JAX ``build_mesh``'s checks (``loop.py:323-366``);
    None when every axis is 1. Without a group of that many ranks it
    raises, naming torchrun."""
    if config.data_axis * config.model_axis * config.context_axis <= 1:
        return None
    if config.use_pallas and config.context_axis > 1:
        raise ValueError(
            "use_pallas with context_axis > 1 is not supported: every "
            "Pallas kernel variant (--pallas_impl pool_only | gather_split "
            "| fused | auto) pools the whole bag per device; drop "
            "--use_pallas (and its --pallas_impl/--pallas_block_b/"
            "--pallas_dma_depth knobs) to use the XLA path (default) for "
            "context parallelism"
        )
    if config.batch_size % config.data_axis:
        raise ValueError(f"batch_size {config.batch_size} not divisible by data_axis "
                         f"{config.data_axis}")
    if config.max_path_length % config.context_axis:
        raise ValueError(f"max_path_length {config.max_path_length} not divisible by "
                         f"context_axis {config.context_axis}")
    from code2vec_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(data=config.data_axis, model=config.model_axis, ctx=config.context_axis)


def host_shard_batch(config, data, mesh) -> int:
    """The rows a feed group builds a step from its corpus shard, after
    JAX's checks of the host-sharded feed (``loop.py:665``, ``:833-876``,
    ``:1243``, ``:1308``)."""
    from code2vec_tpu_torch.parallel.distributed import feed_groups

    feed_group, n_feed_groups = feed_groups(mesh)
    if tuple(data.shard) != (feed_group, n_feed_groups):
        raise ValueError(
            f"corpus shard {data.shard} does not match this process's feed group "
            f"({feed_group}, {n_feed_groups}); shard the corpus with "
            "load_corpus(shard=feed_groups(mesh)) — NOT by process index when the "
            "model/ctx axes span processes")
    if config.batch_size % n_feed_groups:
        raise ValueError(f"batch_size {config.batch_size} not divisible by "
                         f"{n_feed_groups} feed groups")
    if data.infer_variable:
        raise ValueError("host-sharded feeding supports the method task only; load the "
                         "corpus unsharded for infer_variable runs")
    if config.bucketed and config.stream_chunk_items:
        raise ValueError(
            "--bucketed + host-sharded feeding + --stream_chunk_items: a chunked text "
            "stream cannot follow the global bucket-width schedule; convert the corpus "
            "with tools/corpus_convert.py and feed it as --corpus_format csr (mmap "
            "batches are random-access, so the combination needs no streaming), or drop "
            "one flag")
    if config.checkpoint_every_steps:
        raise ValueError(
            "--checkpoint_every_steps does not compose with host-sharded feeding: the "
            "mid-epoch cursor records one host RNG state, but each feed group draws its "
            "own stream; use --checkpoint_cycle (epoch-boundary saves) instead")
    if config.feed_workers:
        raise ValueError(
            "--feed_workers does not compose with host-sharded feeding (the lockstep "
            "width schedule pads per host); each host already builds only 1/n_groups of "
            "every batch — drop --feed_workers or feed unsharded")
    if config.max_contexts == 0:
        raise ValueError(
            "--max_contexts 0 with a host-sharded corpus would derive a different longbag "
            "ladder on every host (each sees only its shard's length histogram); load the "
            "corpus unsharded or pin the full ladder explicitly in a follow-up run")
    return config.batch_size // n_feed_groups


def class_weights_from(config, data, device=None) -> torch.Tensor:
    """1/freq over the de-facto-uniform freq table by default (reference
    main.py:129-130); true inverse-occurrence or unweighted as opt-ins."""
    if config.class_weighting == "reference":
        freq = np.asarray(data.label_vocab.freq_list(), np.float32)
    elif config.class_weighting == "occurrence":
        freq = np.asarray(data.label_vocab.occurrence_list(), np.float32)
    elif config.class_weighting == "none":
        freq = np.ones(len(data.label_vocab), np.float32)
    else:
        raise ValueError(f"unknown class_weighting: {config.class_weighting!r}")
    return torch.from_numpy(1.0 / np.maximum(freq, 1.0)).to(device or "cpu")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_kind(device: torch.device) -> str:
    """The run's device as the manifest and the peak table name it."""
    if device.type == "cuda":
        return str(torch.cuda.get_device_name(device))
    return device.type


def release_device_memory() -> None:
    """Return the caching allocator's free blocks to the card (between the
    search's trials, once the last trial's tensors are gone)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def _step_cost(model_config, batch: int, width: int) -> dict:
    """A train step's analytic forward + backward cost at ``[batch, width]``."""
    fwd = obs_costs.analytic_forward_cost(
        batch, width, terminal_embed=model_config.terminal_embed_size,
        path_embed=model_config.path_embed_size, encode=model_config.encode_size,
        labels=model_config.padded(model_config.label_count))
    return obs_costs.train_step_cost(fwd)


def _manifest_costs(config, model_config, bucket_ladder, kind: str) -> dict:
    """The manifest's static cost block (JAX ``loop.py:386-412``): one
    step cost per ladder rung at the configured batch size, and the card's
    peak the ``mfu`` column divides by."""
    widths = list(bucket_ladder) if bucket_ladder else [config.max_path_length]
    return {"device_kind": kind, "peak_flops_per_s": obs_costs.peak_flops(kind),
            "cost_source": "analytic",
            "train_step": {str(w): _step_cost(model_config, config.batch_size, w)
                           for w in widths}}


def _signature(batch: dict, dtype) -> tuple:
    """A step's input signature for the recompile detector."""
    return (*batch["paths"].shape, str(dtype))


def _train_pass(model, optimizer, batches, class_weights, device, prefetch: int = 0,
                profiler: StepProfiler | None = None, hook: _EpochCursorHook | None = None,
                loss_offset: float | tuple[float, float] = 0.0,
                epoch: int | None = None, recompiles: RecompileDetector | None = None,
                place=None) -> tuple[float, dict]:
    """One epoch of host-fed train steps: ``(the left fold of the batch
    losses from loss_offset, speed)``, the losses read back once
    (:class:`StepTally`) unless a mid-epoch save reads the partial fold. A
    batch's real contexts are counted beside its copy, before the next pull
    may recycle its host arrays; a profiled step is synchronized before and
    after, and its analytic FLOPs feed the profiler's ``mfu``. Each step
    passes the ``train_step`` fault point, then ``hook`` (which may save,
    and raise :class:`PreemptionStop`); ``loss_offset`` is a resumed
    epoch's fold state, the pass covering the epoch's tail. The pass is a
    ``train_pass`` span; each step spans itself (``train/step.train_step``),
    the device edges of the steps before it read first (no wait).
    ``place`` (a mesh) cuts a host batch to this rank's rows and bag
    columns before its copy."""
    def feed(batch):
        if place is not None:
            batch = place(batch)
        valid = batch["example_mask"].astype(bool)
        return to_device(batch, device), int(np.count_nonzero(batch["starts"][valid]))

    tracer = get_tracer()
    dtype = model.config.dtype
    tally = StepTally(device, loss_offset)
    step = 0
    with tracer.span("train_pass", category="train", epoch=epoch):
        # on a mesh a stop is the ranks' common decision (the hook's
        # broadcast): a producer draining on its own rank's flag would leave
        # the others in a collective
        with device_batches(batches, feed, prefetch, profiler, device,
                            drain_on_preemption=hook is not None and place is None) as stream:
            for host_batch, (device_batch, contexts) in stream:
                sampled = profiler is not None and profiler.sampled(step)
                if recompiles is not None:
                    recompiles.observe("train_step", _signature(host_batch, dtype))
                tracer.poll()
                if sampled:
                    _sync(device)
                t0 = time.perf_counter()
                loss = train_step(model, optimizer, device_batch, class_weights)
                if sampled:
                    _sync(device)
                    b, w = host_batch["paths"].shape
                    profiler.record_compute(step, (time.perf_counter() - t0) * 1e3,
                                            flops=_step_cost(model.config, b, w)["flops"])
                tally.add(loss, contexts)
                faultinject.fault_point("train_step", step=step, epoch=epoch)
                if hook is not None:
                    hook.after_step(tally, int(host_batch["paths"].shape[1]))
                step += 1
        if hook is not None:
            hook.after_pass(tally)
    if profiler is not None:
        # the hook counts the whole epoch: a resumed pass's tail alone would
        # shrink the sampling stride of the later epochs
        profiler.observe_epoch_length(step if hook is None else hook.steps)
    return tally.result()


def resolve_ladder(config, data, counts: np.ndarray | None = None
                   ) -> tuple[tuple[int, ...] | None, int]:
    """``(bucket ladder or None, epoch-build context cap)``: the explicit
    ``bucket_ladder`` or one derived from the corpus's length histogram
    when ``bucketed``; with ``max_contexts == 0`` the long-bag rungs above
    ``max_path_length`` (multiples of ``pallas_chunk_l``) join it and the
    cap rises to the top rung (JAX ``loop.py:617-690``). The histogram is
    the methods' context counts even when the corpus trains the variable
    task only, as in JAX (``:627-629``): a variable row's contexts are a
    subset of its method's. ``counts`` replaces the corpus's counts (a
    host-sharded run derives its ladder from every shard's, gathered, so
    the feed groups agree on it)."""
    counts = np.diff(data.row_splits) if counts is None else counts
    ladder = None
    if config.bucketed:
        ladder = parse_bucket_ladder(config.bucket_ladder, config.max_path_length)
        if ladder is None:
            ladder = derive_bucket_ladder(counts, config.max_path_length)
        logger.info("bucketed batching: ladder %s", list(ladder))
    bag_width = config.max_path_length
    if config.max_contexts == 0:
        lengths, weights = np.unique(counts, return_counts=True)
        rungs = derive_longbag_ladder(lengths, weights, config.max_path_length,
                                      chunk_l=config.pallas_chunk_l)
        if rungs:
            ladder = tuple(ladder) + rungs
            bag_width = ladder[-1]
            logger.info("long bags: ladder extended to %s (nothing truncated)", list(ladder))
    return ladder, bag_width


def evaluate_epoch(config, data, model, batches, class_weights, prefetch: int = 0,
                   epoch: int | None = None, recompiles: RecompileDetector | None = None,
                   place=None, gather_hosts: bool = False):
    """The test pass over ``batches`` (an ``eval_pass`` span): ``(loss,
    accuracy, precision, recall, f1)``, the loss the sum of the batch
    means (reference main.py:283-284). Only a batch's per-row fields are
    read after the next pull (a feed worker delivers those as owned
    copies). On a mesh (``place`` cuts this rank's part of a host batch)
    the predictions are all-gathered over the data line (JAX
    ``_evaluate_batches``): every rank of a replicated feed gets the whole
    batch's; with ``gather_hosts`` (a host-sharded feed, each feed group
    holding its own rows) the labels and predictions of the pass are
    all-gathered at its end. Every rank computes the same F1."""
    from code2vec_tpu_torch.parallel.distributed import _all_gather, allgather_to_host

    device = class_weights.device
    dtype = model.config.dtype
    mesh = getattr(model, "mesh", None)
    data_group = mesh.group("data") if mesh is not None else None

    def feed(batch):
        return to_device(place(batch) if place is not None else batch, device)

    losses, expected, actual = [], [], []
    with get_tracer().span("eval_pass", category="eval", epoch=epoch), \
            device_batches(batches, feed, prefetch, device=device) as stream:
        for batch, device_batch in stream:
            if recompiles is not None:
                recompiles.observe("eval_step", _signature(batch, dtype))
            out = eval_step(model, device_batch, class_weights)
            preds = out["preds"]
            if data_group is not None and not gather_hosts:
                preds = _all_gather(preds, data_group, 0)
            valid = batch["example_mask"].astype(bool)
            losses.append(out["loss"])
            expected.append(batch["labels"][valid])
            actual.append((preds, valid))
    test_loss = float(torch.stack(losses).double().sum()) if losses else 0.0
    expected = np.concatenate(expected) if expected else np.zeros(0, np.int32)
    actual = (np.concatenate([p.cpu().numpy()[v] for p, v in actual]) if actual
              else np.zeros(0, np.int64))
    if gather_hosts and mesh is not None:
        expected = allgather_to_host(expected, mesh)
        actual = allgather_to_host(actual, mesh)
    return (test_loss, *evaluate(config.eval_method, expected, actual, data.label_vocab))


@dataclass
class DeviceEpochs:
    """The device-epoch feed of a run (``config.device_epoch``): both
    splits staged on the card, the runner, and what the loop reads from
    them without a device sync."""

    runner: EpochRunner | BucketedEpochRunner
    train: StagedCorpus | BucketedStagedCorpus
    test: StagedCorpus | BucketedStagedCorpus
    expected: np.ndarray  # the test labels in eval order
    pad: tuple[int, int]  # (real context slots, padded slots) of a train epoch
    generator: torch.Generator  # the sampler's shifts
    stage_seconds: float

    @property
    def staged_bytes(self) -> int:
        return self.train.nbytes + self.test.nbytes


def stage_host(data, item_idx, np_rng) -> StagedCorpus:
    """A split's host staging: its method rows, then its variable rows, for
    the tasks the corpus was loaded with (JAX ``loop.py:1017-1031``)."""
    parts = []
    if data.infer_method:
        parts.append(stage_method_corpus(data, item_idx, np_rng))
    if data.infer_variable:
        parts.append(stage_variable_corpus(data, item_idx, np_rng))
    staged = parts[0]
    for part in parts[1:]:
        staged = concat_staged(staged, part)
    return staged


def stage_device_epochs(config, data, train_idx, test_idx, np_rng, ladder, class_weights,
                        device, mesh=None) -> DeviceEpochs:
    """Stage the train then the test split (drawing ``np_rng`` in JAX
    ``loop.py:1017-1037``'s order, so before a restore) and build the
    runner: bucketed over ``ladder``, else at ``max_path_length``. The pad
    accounting is corpus-static: the sampler fills ``min(count, width)``
    slots a row every epoch (JAX ``:1096-1114``). On a mesh every rank
    stages the whole split (replicated), or with ``shard_staged_corpus``
    only its data coordinate's share of both splits (JAX ``:1055-1083``)."""
    t0 = time.perf_counter()
    with get_tracer().span("stage_corpus", category="train", items=len(train_idx)):
        host_train = stage_host(data, train_idx, np_rng)
    with get_tracer().span("stage_corpus", category="train", items=len(test_idx)):
        host_test = stage_host(data, test_idx, np_rng)
    b, chunk, prefetch = config.batch_size, config.device_chunk_batches, config.sample_prefetch
    shuffle = config.shuffle_variable_indexes
    if config.shard_staged_corpus:
        if mesh is None:
            raise ValueError("--shard_staged_corpus needs mesh axes (--data_axis > 1)")
        if ladder is not None:
            staged_train = bucket_shard_staged(host_train, ladder, mesh, device)
            staged_test = bucket_shard_staged(host_test, ladder, mesh, device)
            runner = BucketedShardedEpochRunner(class_weights, b, ladder, chunk, prefetch,
                                                shuffle, mesh)
        else:
            ladder = (config.max_path_length,)
            staged_train = shard_staged(host_train, mesh, device)
            staged_test = shard_staged(host_test, mesh, device)
            runner = ShardedEpochRunner(class_weights, b, config.max_path_length, chunk,
                                        prefetch, shuffle, mesh)
        # static for the run: the share-order labels, gathered once
        expected = staged_test.flat_labels(mesh)
        # the pad accounting counts the whole split, every share's rows
        counts = np.diff(np.asarray(host_train.row_splits).astype(np.int64))
    elif ladder is not None:
        staged_train = bucket_staged(host_train, ladder, device)
        staged_test = bucket_staged(host_test, ladder, device)
        expected = staged_test.host_labels()
        runner = BucketedEpochRunner(class_weights, b, ladder, chunk, prefetch, shuffle, mesh)
        counts = staged_train.counts
    else:
        ladder = (config.max_path_length,)
        staged_train = place_staged(host_train, device)
        staged_test = place_staged(host_test, device)
        expected = host_test.labels
        runner = EpochRunner(class_weights, b, config.max_path_length, chunk, prefetch, shuffle,
                             mesh)
        counts = staged_train.counts
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    feed = DeviceEpochs(runner=runner, train=staged_train, test=staged_test, expected=expected,
                        pad=pad_stats(counts, ladder, b),
                        generator=sampler_generator(config.random_seed, device),
                        stage_seconds=time.perf_counter() - t0)
    logger.info("device epochs: staged %d train / %d test contexts (%d bytes here) on %s in %.3fs",
                staged_train.n_contexts, staged_test.n_contexts, feed.staged_bytes, device,
                feed.stage_seconds)
    return feed


def train(
    config,
    data,
    out_dir: str | None = None,
    vectors_path: str | None = None,
    test_result_path: str | None = None,
    *,
    device: str | torch.device | None = None,
    initial_state_dict: dict | None = None,
    on_epoch: Callable[[dict], None] | None = None,
    sinks: tuple[MetricSink, ...] = (logging_sink,),
    report_fn: Callable[[int, float], None] | None = None,
    profile_dir: str | None = None,
    events: EventLog | None = None,
    tracer=None,
) -> TrainResult:
    """Train on a loaded corpus; the model runs on ``device`` (the card
    unless ``"cpu"`` is asked for). ``initial_state_dict`` replaces the
    seeded initialization (parity runs start from the JAX run's weights).
    ``on_epoch`` receives each epoch's metrics (the dict the ``epoch``
    event and the ``sinks`` carry, with its ``epoch``). With ``out_dir``
    the dir becomes a served model dir (``model_meta.json``,
    ``label_vocab.txt``, ``code2vec.model`` of the best epoch) holding the
    checkpoints.

    ``events`` / ``tracer`` wire the run into the telemetry (the CLI
    builds them from ``--events_dir`` / ``--trace_dir``); by default a
    dispatch-only log (the sinks still ride its stream) and the
    process-wide tracer. The caller closes and exports both. Sinks with a
    ``close()`` are closed at the end of this call. ``report_fn(epoch,
    f1)`` runs after each epoch's event and may raise
    :class:`StopTraining`; while it is set nothing is saved or exported.
    ``profile_dir`` gets a ``torch.profiler`` trace of the second epoch run
    (not the first, where the kernels build)."""
    from code2vec_tpu_torch.export import print_sample, write_code_vectors
    from code2vec_tpu_torch.predict import save_inference_meta, save_model_file, write_model_meta

    config.validate()
    # pin the schedule cache before the first forward, so --pallas_impl auto
    # looks its shapes up in the configured file (JAX loop.py:577-580)
    pin_cache(config.autotune_cache)
    if events is None:
        events = EventLog()  # dispatch-only: the sinks still ride the stream
    if tracer is None:
        tracer = get_tracer()
    health = RuntimeHealth()
    recompiles = RecompileDetector(events=events, health=health)
    # a search trial (report_fn) saves and exports nothing (JAX loop.py:1380, :1667-1717)
    saving = report_fn is None
    # elastic training: the fault plan (installed anew, its counters at 0, at
    # each call), the SIGTERM guard and the save orchestrator
    faultinject.install_plan(config.fault_plan or os.environ.get(faultinject.ENV_VAR))
    guard = preemption_guard()
    guard.clear()
    writer = (CheckpointWriter(out_dir, async_save=config.async_checkpoint, events=events,
                               tracer=tracer)
              if out_dir is not None and saving else None)
    # the tasks are fixed when the corpus is loaded: catch a mismatch (JAX loop.py:550-562)
    if (config.infer_method_name != data.infer_method
            or config.infer_variable_name != data.infer_variable):
        raise ValueError(
            "task flags disagree with the loaded corpus: config has "
            f"infer_method_name={config.infer_method_name}, "
            f"infer_variable_name={config.infer_variable_name} but the corpus was loaded "
            f"with infer_method={data.infer_method}, infer_variable={data.infer_variable}; "
            "pass matching flags to load_corpus"
        )
    dev = resolve_device(device)
    # the mesh (JAX build_mesh): one rank a card, cuda:LOCAL_RANK
    mesh = build_mesh(config)
    if mesh is not None:
        from code2vec_tpu_torch.parallel.distributed import rank_device

        dev = rank_device(dev)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
    kind = device_kind(dev)
    writes = mesh is None or mesh.rank == 0  # rank 0 writes the model dir
    # host-sharded feeding (JAX loop.py:826-901): each feed group (the ranks
    # of one data coordinate) builds its own B / data rows from its shard
    sharded_feed = data.shard is not None and mesh is not None
    if data.shard is not None and mesh is None and data.shard[1] > 1:
        raise ValueError("a host-sharded corpus requires mesh axes")
    feed_batch = host_shard_batch(config, data, mesh) if sharded_feed else config.batch_size
    if config.feed_workers and data.infer_variable:
        raise ValueError("--feed_workers supports the method task only: the variable-name "
                         "expansion interleaves per-item rng draws with data-dependent row "
                         "counts, so its builds cannot be planned ahead for workers; run "
                         "variable-task corpora with --feed_workers 0")
    ladder_counts = None
    if sharded_feed and config.bucketed and not config.bucket_ladder:
        from code2vec_tpu_torch.parallel.distributed import allgather_to_host

        ladder_counts = allgather_to_host(np.diff(data.row_splits), mesh)
    bucket_ladder, bag_width = resolve_ladder(config, data, ladder_counts)
    np_rng = np.random.default_rng(config.random_seed)
    global_train = global_test = None
    if data.shard is None:
        train_idx, test_idx = split_items(data.n_items, np_rng)
    else:
        # every rank draws the same GLOBAL split and keeps its shard's rows,
        # so a method's train/test membership does not depend on the rank
        global_train, global_test = split_items(data.global_n_items, np_rng)
        train_idx = data.local_rows_of_global(global_train)
        test_idx = data.local_rows_of_global(global_test)
    logger.info("train items: %d, test items: %d", len(train_idx), len(test_idx))
    logger.info("OOV rate: %s",
                oov_rate(data, train_idx, test_idx, exact=config.eval_method == "exact"))
    # the share of real train contexts the epoch-build cap drops, from the
    # method rows' geometry: the same every epoch (0 with max_contexts 0)
    truncated_ctx_fraction = (
        truncated_fraction_of_counts(np.diff(data.row_splits)[train_idx], bag_width)
        if data.infer_method and len(train_idx) else None)
    model_config = model_config_from(config, data)
    class_weights = class_weights_from(config, data, dev)
    if config.model == "code2seq":
        model = code2seq_from(config, data)
        score = model.score
    else:
        model = Code2Vec(model_config)
        score = functools.partial(evaluate, config.eval_method)
    if out_dir is not None and saving and writes:
        if model.code_vectors:
            # a fixed-L run records a corpus-derived ladder, so a server needs
            # no corpus to pick its shapes
            save_inference_meta(
                out_dir, config, model_config, data,
                bucket_ladder or derive_bucket_ladder(np.diff(data.row_splits),
                                                      config.max_path_length))
        else:
            write_model_meta(out_dir, model.meta())

    if initial_state_dict is not None:
        model.load_state_dict(initial_state_dict, strict=True)
    else:
        model.reset_parameters(torch.Generator().manual_seed(config.random_seed))
    model.to(dev)
    model.seed_dropout(config.random_seed)
    if mesh is not None:
        from code2vec_tpu_torch.parallel.shardings import shard_model

        # built whole (the seeded init of one device), then sliced: every
        # mesh starts from the world-1 weights
        shard_model(model, mesh)
    optimizer = make_optimizer(model, config)
    # the event log's first line (idempotent: a search wrote its own first);
    # built only when someone reads it
    if events.observed:
        from code2vec_tpu_torch.parallel.distributed import process_info

        events.write_manifest(
            config=config,
            # who this process is: its rank, the group's backend, the card
            **process_info(dev),
            mesh=mesh,
            corpus={"n_items": data.n_items, "terminal_vocab": len(data.terminal_vocab),
                    "path_vocab": len(data.path_vocab), "label_vocab": len(data.label_vocab),
                    "shard": list(data.shard) if data.shard is not None else None},
            # the analytic cost of each rung's step and the peak mfu divides by
            # (code2vec's closed form)
            costs=(_manifest_costs(config, model_config, bucket_ladder, kind)
                   if model.code_vectors else None),
        )
    # static [B, L] shapes are the design: a bucketed run meets one shape a
    # rung, its whole budget; anything beyond is churn
    expected = len(bucket_ladder) if bucket_ladder else None
    recompiles.track("train_step", expected_compiles=expected)
    recompiles.track("eval_step", expected_compiles=expected)
    if config.device_epoch and sharded_feed:
        # JAX loop.py:1083: a host-sharded corpus feeds from the host
        logger.warning("device_epoch requested with a host-sharded corpus; using the host "
                       "pipeline")
    feed = (stage_device_epochs(config, data, train_idx, test_idx, np_rng, bucket_ladder,
                                class_weights, dev, mesh)
            if config.device_epoch and not sharded_feed else None)

    meta = TrainMeta()
    batch_size = config.batch_size
    resume_cursor: dict | None = None
    if config.resume and out_dir is not None:
        restored_from: dict = {}
        # mesh-aware: the saved global tensors re-sliced to this run's mesh,
        # so a run saved on one mesh shape resumes on another
        restored = restore_checkpoint(out_dir, model, optimizer, np_rng,
                                      model_config.vocab_pad_multiple,
                                      sampler=feed.generator if feed else None,
                                      info=restored_from, mesh=mesh)
        if restored is not None:
            meta = restored
            events.emit("checkpoint_restored", slot=restored_from["slot"],
                        path=restored_from["path"], step=int(meta.step),
                        mesh_shape=dict(mesh.shape) if mesh is not None else None,
                        saved_mesh_shape=restored_from.get("saved_mesh_shape"),
                        resharded=bool(restored_from.get("resharded")))
            logger.info("resumed from epoch %d (best_f1=%s)", meta.epoch, meta.best_f1)
            resume_cursor, meta.cursor = meta.cursor, None
            if resume_cursor is not None and sharded_feed:
                # the cursor holds one host generator state, but each feed
                # group draws its own stream (JAX loop.py:1154)
                logger.warning("ignoring the checkpoint's data cursor under host-sharded "
                               "feeding; resuming at the epoch boundary")
                resume_cursor = None
        if resume_cursor is not None:
            cursor_step = int(resume_cursor.get("step", 0))
            if feed is not None and cursor_step > 0:
                raise ValueError(
                    "the checkpoint carries a mid-epoch cursor (a host-pipeline save), which "
                    "--device_epoch cannot replay; resume without --device_epoch, or restart "
                    "from an epoch-boundary checkpoint")
            cursor_batch = int(resume_cursor.get("feed_batch", feed_batch))
            if cursor_step > 0 and cursor_batch != feed_batch:
                raise ValueError(
                    f"the mid-epoch cursor was saved at batch size {cursor_batch} but this run "
                    f"feeds {feed_batch} rows per batch — the replay would skip the wrong "
                    "examples; resume with the original batch size (the batching config "
                    "changed since the checkpoint was saved), or restart without --resume")
            # the interrupted epoch's START state: everything the epoch
            # streams (subsample, batch order, bucket plan) is a function of it
            np_rng.bit_generator.state = resume_cursor["np_rng_state"]
            if resume_cursor.get("jax_rng") is not None:
                model.dropout_generator(dev).set_state(
                    torch.tensor(resume_cursor["jax_rng"], dtype=torch.uint8))
            if cursor_step > 0:
                logger.info("mid-epoch resume: replaying epoch %d to batch %d",
                            resume_cursor["epoch"], cursor_step)
    elif out_dir is not None and saving and writes:
        clear_checkpoints(out_dir)
    meta.vocab_pad_multiple = model_config.vocab_pad_multiple
    place = None
    if mesh is not None:
        from code2vec_tpu_torch.parallel.distributed import global_batch, local_to_global_batch

        # a host batch cut to this rank's rows (a replicated feed) and bag columns
        def place(batch, cut=local_to_global_batch if sharded_feed else global_batch):
            return cut(mesh, batch)
    # host-sharded lockstep (JAX loop.py:895-944): every rank runs the same
    # steps; a short shard pads with masked batches, a bucketed epoch follows
    # one width schedule every group agrees on
    n_groups = mesh.shape["data"] if sharded_feed else 1

    def synced_steps(global_idx: np.ndarray) -> int:
        shares = np.bincount(np.asarray(global_idx) % n_groups, minlength=n_groups)
        return max(-(-int(shares.max()) // feed_batch), 1)

    def global_width_counts(local_idx: np.ndarray) -> np.ndarray:
        from code2vec_tpu_torch.data.pipeline import bucket_batch_counts
        from code2vec_tpu_torch.parallel.distributed import allgather_to_host

        local_idx = np.asarray(local_idx)
        counts = data.row_splits[local_idx + 1] - data.row_splits[local_idx]
        mine = bucket_batch_counts(np.minimum(counts, bucket_ladder[-1]), bucket_ladder,
                                   feed_batch).astype(np.int64)
        return allgather_to_host(mine, mesh).reshape(n_groups, -1).max(axis=0)

    def width_schedule(width_counts: np.ndarray, epoch: int, shuffled: bool) -> np.ndarray:
        """The epoch's width sequence, the same on every rank: drawn from
        a generator of (run seed, epoch), not the per-group streams."""
        widths = np.repeat(np.asarray(bucket_ladder), width_counts)
        if shuffled:
            srng = np.random.default_rng([config.random_seed, 0x5EED, epoch])
            widths = widths[srng.permutation(len(widths))]
        return widths

    train_width_counts = test_width_counts = None
    if sharded_feed and bucket_ladder is not None:
        train_width_counts = global_width_counts(train_idx)
        test_width_counts = global_width_counts(test_idx)

    def sharded_wrap(batches, global_idx):
        if not sharded_feed:
            return batches
        return pad_batch_stream(batches, synced_steps(global_idx),
                                empty_batch(feed_batch, config.max_path_length))

    profiler = None
    if config.profile_steps > 0:
        if feed is not None:
            logger.warning("--profile_steps attributes the host input pipeline; device-epoch "
                           "mode enqueues whole chunks and is not profiled per step")
        else:
            # the sampled steps' mfu: analytic FLOPs over the card's peak
            profiler = StepProfiler(config.profile_steps, peak_flops=obs_costs.peak_flops(kind))
    if config.checkpoint_every_steps and feed is not None:
        logger.warning("--checkpoint_every_steps is a host-pipeline feature; device-epoch runs "
                       "dispatch whole chunks and save at epoch boundaries only")

    def dropout_state():
        return model.dropout_generator(dev).get_state().tolist()

    def boundary_cursor(next_epoch: int) -> dict:
        # step 0 and the CURRENT states, the ones the next epoch starts
        # from: a boundary resume continues the stream bitwise too
        return _data_cursor(next_epoch, 0, feed_batch, _rng_state(np_rng), dropout_state())

    def save(slot: str, **event_fields) -> None:
        writer.save(slot, model, optimizer, meta, np_rng,
                    sampler=feed.generator if feed else None, **event_fields)

    f1, epochs_completed = 0.0, 0
    start_epoch = epoch = meta.epoch
    pool = None
    profile = None
    # the sinks consume the SAME stream the event log records; subscribed
    # here, just before the try whose finally unsubscribes them, and the
    # run's tracer installed process-wide (for the data layers' spans) the
    # same way
    sinks_on_stream = events.subscribe(sink_consumer(sinks))
    restore_tracer = tracer is not get_tracer()
    previous_tracer = set_tracer(tracer) if restore_tracer else None
    # installed here, just before the try whose finally restores it: a
    # SIGTERM during the setup above takes the default disposition and
    # leaves the previous checkpoint as it was
    previous_sigterm = install_sigterm_handler()
    try:
        if feed is None:
            # the epochs are built at bag_width: the top rung in long-bag mode
            source_kw = dict(ladder=bucket_ladder, stream_chunk_items=config.stream_chunk_items,
                             shuffle_variable_indexes=config.shuffle_variable_indexes)
            train_source = make_batch_source(data, train_idx, feed_batch, bag_width, **source_kw)
            test_source = make_batch_source(data, test_idx, feed_batch, bag_width, **source_kw)
            if config.feed_workers:
                # one pool for both splits, forked before any thread of the run
                pool = FeedPool(data, config.feed_workers, batch_size,
                                int(train_source.ladder[-1]), health=health)
                train_source = ParallelFeed(train_source, pool)
                test_source = ParallelFeed(test_source, pool)
                logger.info("parallel host ingest: %d feed workers, %d arena slots",
                            pool.n_workers, pool.slots)
            logger.info("host feed: %s (ladder %s)", type(train_source).__name__,
                        list(train_source.ladder))

        def host_epoch(item_idx, epoch):
            # device epochs build no host arrays: the export and print_sample draw
            # a fresh subsample from a side generator seeded by (run seed, epoch),
            # so they cannot shift the main stream (JAX loop.py:1640-1661)
            return build_epoch(data, item_idx, bag_width,
                               np.random.default_rng([config.random_seed, 0xE902, epoch]),
                               config.shuffle_variable_indexes)

        for epoch in range(start_epoch, config.max_epoch):
            faultinject.fault_point("epoch_start", epoch=epoch)
            if coordinated_stop(guard, mesh):
                # preempted between epochs (or on the device path, which has no
                # step hook): save at the boundary and exit cleanly; a resume
                # cursor still pending (SIGTERM during the setup) is saved as it
                # is, since the model holds that cursor's mid-epoch state
                if writer is not None:
                    meta.epoch = epoch
                    meta.cursor = (resume_cursor if resume_cursor is not None
                                   else boundary_cursor(epoch))
                    with tracer.span("checkpoint_save", category="checkpoint", epoch=epoch,
                                     slot="last"):
                        save("last", epoch=epoch)
                raise PreemptionStop(guard.reason or "requested")
            if profile_dir is not None and epoch == start_epoch + 1:
                profile = _start_profile(dev)
            epoch_start = time.perf_counter()
            if profiler is not None:
                profiler.reset()
            epoch_rng_state = _rng_state(np_rng)
            skip, loss_offset, cursor_widths = 0, 0.0, None
            if resume_cursor is not None and epoch == start_epoch:
                skip = int(resume_cursor.get("step", 0))
                loss_offset = tuple(resume_cursor.get("loss_fold")
                                    or (resume_cursor.get("partial_train_loss", 0.0), 0.0))
                cursor_widths = resume_cursor.get("bucket_positions") or None
                resume_cursor = None
            replay = None
            if model.epoch_lr_decay != 1.0:
                # the epoch's rate, from the epoch alone (a resumed run's too)
                for group in optimizer.param_groups:
                    group["lr"] = config.lr * model.epoch_lr_decay ** epoch
            if feed is not None:
                with tracer.span("train_pass", category="train", epoch=epoch,
                                 mode="device_epoch"):
                    train_loss, speed = feed.runner.run_train_epoch(model, optimizer, feed.train,
                                                                    np_rng, feed.generator)
                meta.step += speed["train_steps"]
                with tracer.span("eval_pass", category="eval", epoch=epoch, mode="device_epoch"):
                    test_loss, preds, _ = feed.runner.run_eval_epoch(model, feed.test,
                                                                     feed.generator)
                accuracy, precision, recall, f1 = score(feed.expected, preds, data.label_vocab)
                # built on demand for the export and print_sample
                train_epoch = test_epoch = None
                source_pad = feed.pad
            else:
                hook = _EpochCursorHook(save if writer is not None else None, meta, epoch,
                                        epoch_rng_state, dropout_state, guard, feed_batch,
                                        config.checkpoint_every_steps, skip, cursor_widths,
                                        mesh=mesh)
                if train_width_counts is not None:
                    train_batches = train_source.scheduled_batches(
                        np_rng, width_schedule(train_width_counts, epoch, True))
                else:
                    train_batches = sharded_wrap(train_source.batches(np_rng, shuffle=True),
                                                 global_train)
                if skip:
                    # the stream made again from the cursor's state, less the
                    # batches the interrupted run consumed (host builds only)
                    t0 = time.perf_counter()
                    with tracer.span("resume_replay", category="train", epoch=epoch, skip=skip):
                        train_batches = skip_batches(train_batches, skip,
                                                     expect_widths=cursor_widths)
                    replay = {"replayed_batches": skip,
                              "replay_seconds": time.perf_counter() - t0}
                train_loss, speed = _train_pass(
                    model, optimizer, train_batches, class_weights, dev,
                    config.prefetch_batches, profiler, hook=hook, loss_offset=loss_offset,
                    epoch=epoch, recompiles=recompiles, place=place)
                if test_width_counts is not None:
                    test_batches = test_source.scheduled_batches(
                        np_rng, width_schedule(test_width_counts, epoch, False), shuffle=False)
                else:
                    test_batches = sharded_wrap(test_source.batches(np_rng, shuffle=False),
                                                global_test)
                test_loss, accuracy, precision, recall, f1 = evaluate_epoch(
                    config, data, model, test_batches, class_weights, config.prefetch_batches,
                    epoch=epoch, recompiles=recompiles, place=place,
                    gather_hosts=sharded_feed)
                # the epochs the passes were fed (the in-RAM source's; None from
                # the others), reused by the export and print_sample
                train_epoch, test_epoch = train_source.last_epoch, test_source.last_epoch
                source_pad = train_source.pad_stats()
            metrics = {
                "train_loss": train_loss, "test_loss": test_loss, "accuracy": accuracy,
                "precision": precision, "recall": recall, "f1": f1,
                "epoch_seconds": time.perf_counter() - epoch_start,
            }
            if feed is not None and epochs_completed == 0:
                metrics["stage_seconds"] = feed.stage_seconds
                metrics["staged_bytes"] = feed.staged_bytes
            if source_pad is not None:
                # real context slots over the slots fed (1.0 = no PAD slot encoded)
                real, slots = source_pad
                metrics["pad_efficiency"] = real / slots if slots else 1.0
                health.gauge("pad_efficiency").set(metrics["pad_efficiency"])
            if truncated_ctx_fraction is not None:
                metrics["truncated_context_fraction"] = truncated_ctx_fraction
                health.gauge("truncated_context_fraction").set(truncated_ctx_fraction)
            metrics.update(speed)
            if replay is not None:
                metrics.update(replay)  # a resumed epoch: its replay of the cursor
            if profiler is not None:
                attribution = profiler.summary()
                if attribution is not None:
                    # --profile_steps: the sampled steps' mean split (JAX loop.py:1589-1611)
                    metrics.update(attribution)
                for rec in profiler.per_step():
                    events.emit("step_sample", epoch=epoch, **rec)
            if profile is not None:
                _stop_profile(profile, profile_dir, epoch)
                profile = None
            epochs_completed += 1
            meta.history.append({"epoch": epoch, **metrics})
            events.emit("eval", epoch=epoch, metrics={
                k: metrics[k] for k in ("test_loss", "accuracy", "precision", "recall", "f1")})
            # the recompile check first, so this epoch's own count is in the
            # health block its epoch event carries
            recompiles.check(epoch)
            # the sinks consume this same emission (sink_consumer above)
            events.emit("epoch", epoch=epoch, metrics=metrics,
                        memory=memory_snapshot(health, dev), health=health.snapshot())
            if on_epoch is not None:
                on_epoch({"epoch": epoch, **metrics})
            if report_fn is not None:
                report_fn(epoch, f1)  # may raise StopTraining (the search's pruning)

            if (epoch > 1 and config.print_sample_cycle and epoch % config.print_sample_cycle == 0
                    and saving and not sharded_feed and model.code_vectors):  # whole batches
                if test_epoch is None:
                    test_epoch = host_epoch(test_idx, epoch)
                print_sample(data, model, test_epoch, batch_size, class_weights)

            if meta.best_f1 is None or meta.best_f1 < f1:
                events.emit("best_f1", epoch=epoch, metrics={"best_f1": f1})
                meta.best_f1 = f1
                if sharded_feed and vectors_path is not None:
                    logger.warning(
                        "vector export is not supported with host-sharded feeding (each feed "
                        "group holds 1/%d of the corpus); run a single-host export pass on the "
                        "saved checkpoint", n_groups)
                elif vectors_path is not None and saving and model.code_vectors:
                    if train_epoch is None:
                        train_epoch = host_epoch(train_idx, epoch)
                    if test_epoch is None:
                        test_epoch = host_epoch(test_idx, epoch)
                    with tracer.span("export_vectors", category="export", epoch=epoch):
                        write_code_vectors(data, model, train_epoch, test_epoch, batch_size,
                                           vectors_path, config.encode_size, class_weights,
                                           test_result_path)
                save_slot = "best" if writer is not None else None
            else:
                periodic = (writer is not None and bool(config.checkpoint_cycle)
                            and (epoch + 1) % config.checkpoint_cycle == 0)
                save_slot = "last" if periodic else None

            # the counter resets when train loss OR accuracy improves (main.py:233-242)
            if (meta.last_loss is None or train_loss < meta.last_loss
                    or meta.last_accuracy is None or meta.last_accuracy < accuracy):
                meta.last_loss = train_loss
                meta.last_accuracy = accuracy
                meta.bad_count = 0
            else:
                meta.bad_count += 1

            if save_slot is not None:
                meta.epoch = epoch + 1
                meta.cursor = boundary_cursor(epoch + 1)
                with tracer.span("checkpoint_save", category="checkpoint", epoch=epoch,
                                 slot=save_slot):
                    save(save_slot, epoch=epoch)
                if save_slot == "best" and model.code_vectors:
                    save_model_file(out_dir, model)

            if meta.bad_count > config.early_stop_patience:
                logger.info("early stop loss:%s, bad:%d", train_loss, meta.bad_count)
                if not sharded_feed and model.code_vectors:
                    if test_epoch is None:
                        test_epoch = host_epoch(test_idx, epoch)
                    print_sample(data, model, test_epoch, batch_size, class_weights)
                break
        # a persist failure fails the run, not a thread
        if writer is not None:
            writer.finish(model)
    except StopTraining:
        if writer is not None:
            writer.finish(model)
    except PreemptionStop as stop:
        # the checkpoint (with a model dir) is on disk: drain it and return
        # normally, the graceful half of the SIGTERM contract
        if writer is not None:
            writer.finish(model)
        events.emit("preempted", epoch=epoch, reason=str(stop))
        logger.warning("preemption (%s): %s; exiting cleanly after %d completed epochs, "
                       "%.3f s after the request", stop,
                       "state saved" if writer is not None else "NO checkpoint written (no "
                       "--model_path, or a search trial)", epochs_completed,
                       time.perf_counter() - (guard.requested_at or time.perf_counter()))
    except Exception as exc:
        try:
            events.emit("error", epoch=epoch, error=f"{type(exc).__name__}: {exc}")
        except Exception:  # telemetry must not mask the real failure
            logger.warning("could not emit the error event", exc_info=True)
        raise
    finally:
        restore_sigterm_handler(previous_sigterm)
        if pool is not None:
            pool.close()
        if writer is not None:
            # joins the persist thread and logs a stored failure (finish()
            # above raised it on the normal paths)
            writer.close()
        if restore_tracer:
            set_tracer(previous_tracer)
        events.unsubscribe(sinks_on_stream)
        # a sink with a buffered backend has a close() (tensorboard_sink);
        # one failing sink must not mask the result
        for sink in sinks:
            closer = getattr(sink, "close", None)
            if closer is not None:
                try:
                    closer()
                except Exception:
                    logger.warning("sink close() failed", exc_info=True)
        if profile is not None:
            # an epoch that raised: stop the profiler, keep what it traced
            try:
                _stop_profile(profile, profile_dir, epoch)
            except Exception:
                logger.warning("could not write the profiler trace", exc_info=True)

    if epochs_completed == 0 and meta.history:
        f1 = meta.history[-1].get("f1", 0.0)  # resumed a finished run
    return TrainResult(
        best_f1=meta.best_f1 if meta.best_f1 is not None else f1, final_f1=f1,
        epochs_run=epochs_completed, history=meta.history, model=model,
        checkpoint_saves=writer.saves if writer is not None else [],
    )


def _start_profile(device: torch.device):
    """A started ``torch.profiler`` of the CPU and, on the card, CUDA."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profile = torch.profiler.profile(activities=activities)
    profile.start()
    return profile


def _stop_profile(profile, profile_dir: str, epoch: int) -> str:
    """Stop ``profile`` and write its Chrome trace into ``profile_dir``."""
    profile.stop()
    os.makedirs(profile_dir, exist_ok=True)
    from code2vec_tpu_torch.obs.events import resolve_process_index

    path = os.path.join(profile_dir, f"profile-p{resolve_process_index()}-epoch{epoch}.json")
    profile.export_chrome_trace(path)
    logger.info("torch.profiler trace of epoch %d written to %s", epoch, path)
    return path
