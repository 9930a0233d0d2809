"""The training CLI: ``python -m code2vec_tpu_torch``.

Counterpart of ``code2vec_tpu/cli.py``, with the flag names the JAX CLI
and the reference use (main.py:37-81):

    python -m code2vec_tpu_torch --corpus_path d/corpus.txt \\
        --path_idx_path d/path_idxs.txt --terminal_idx_path d/terminal_idxs.txt

``--model code2seq --device_epoch`` trains code2seq (``models/code2seq.py``)
on the same corpus and vocab files: the vocab strings expand to subtokens,
nodes and target subtokens, ``--seq_*`` set its widths (code2seq's
java-large defaults), SGD with Nesterov momentum at ``--lr`` decays ×0.95
an epoch, and each epoch evaluates greedy-decoded names by subtoken
precision, recall and F1.
``--synthetic {tiny,small,parity10k,top11}`` trains on a generated corpus
instead. The run goes to the card; ``--device cpu`` (or the reference's
``--no_cuda``) runs the plain versions on the CPU. ``--model_path`` becomes
a model dir that ``python -m code2vec_tpu_torch.serve`` serves as it
stands. Each epoch prints one JSON line of metrics. ``--bucketed
[--bucket_ladder 25,50,100,200] [--max_contexts 0]`` batches by bag length,
and with ``--max_contexts 0`` feeds every context of every bag (long bags
stream through K4 on a kernel route). ``--compute_dtype bfloat16`` trains
(and evaluates and exports) the model in bf16, ``--adam_mu_dtype bfloat16``
stores Adam's first moments in bf16. ``--table_update lazy`` steps the
embedding tables' touched rows only (``torch.optim.SparseAdam``'s
semantics), ``--embed_grad {dense,segment,segment_sorted}`` is accepted for JAX
configurations (every mode runs one segment sum: K6 on the card,
``F.embedding``'s backward on the CPU). ``--device_epoch
[--device_chunk_batches 16] [--sample_prefetch true]`` stages both splits on
the card and samples each epoch's batches there.
``--infer_variable_name true [--infer_method_name false]
[--shuffle_variable_indexes true]`` trains the variable-name task (one example
per ``@var_*`` alias of a method), alone or beside the method-name task.
The host feed: ``--prefetch_batches N`` builds and copies batches ahead on a
thread, ``--feed_workers N`` builds them on forked processes,
``--stream_chunk_items N`` builds epochs in chunks (bounded RSS),
``--profile_steps N`` adds the steps' host-build / H2D / feed-wait / compute
split to the epoch line; every setting feeds the same batches. The corpus
is a ``corpus.txt`` (parsed natively, then cached beside it unless
``--no_corpus_cache``) or a CSR container from ``python -m
code2vec_tpu_torch.tools.corpus_convert`` (mmap-backed);
``--corpus_format`` fails when the file is not the format named.
Elastic training: ``--checkpoint_every_steps N`` also saves every N steps
with a mid-epoch cursor, so ``--resume`` continues inside the epoch;
``--async_checkpoint`` writes saves on a thread behind a host snapshot;
SIGTERM finishes the step in flight, saves and exits 0; ``--fault_plan``
(or ``C2V_FAULT_PLAN``) schedules faults for recovery drills.

The search: ``--find_hyperparams [--num_trials 100] [--hpo_sampler
tpe|random]`` runs a seeded TPE (or random) search with median pruning
(``hpo.py``) over the loaded corpus, each trial trained through the flags'
route; no trial writes a checkpoint or vectors. Telemetry: ``--env floyd``
adds one JSON line a metric on stdout, ``--env tensorboard`` TensorBoard
scalars under ``--tensorboard_dir`` (needs tensorboardX);
``--events_dir`` writes a JSONL event log (the run manifest first),
``--trace_dir`` a Chrome trace of the training layers, ``--profile_dir``
a ``torch.profiler`` trace of the second epoch (of the first trial in a
search). In the trace a ``--device_epoch`` run writes a ``train_chunk``
span a chunk (args ``steps``, ``rows``, ``real_contexts``, ``slots``,
``late_steps``) holding each step's ``sample`` and ``train_step``; every
``train_step`` (host-fed too) holds ``forward``, ``backward``,
``grad_sync`` (on a mesh) and ``optimizer`` (with ``--table_update lazy``
each table's ``<table>_rows_processed`` and ``<table>_rows_touched``). On
the card ``sample``, ``forward``, ``backward``, ``grad_sync`` and
``optimizer`` carry ``device_ms`` (the stream's time between CUDA events
at their edges, read without a sync) and ``drained`` (whether the card
had finished all the host had launched when the span began). Every step
is spanned, 4 to 6 spans a step, so a long run reaches the tracer's cap
of 1,000,000 spans: later spans (eval and checkpoint ones too) are left
out of the file and counted in its ``dropped_events``.

Several cards (JAX ``cli.py:168-186``, ``:246-252``, ``:511-535``):
``torchrun --nproc_per_node N -m code2vec_tpu_torch --data_axis D
--model_axis M --context_axis C`` with ``D * M * C == N`` trains on the
``(data, model, ctx)`` mesh (``parallel/``), each rank on
``cuda:LOCAL_RANK``: the process group is formed from torchrun's (or JAX's
``COORDINATOR_ADDRESS``/``NUM_PROCESSES``/``PROCESS_ID``) environment,
NCCL on the card, gloo with ``--device cpu``. ``--host_shard_corpus``
loads each feed group's round-robin share of the corpus;
``--shard_staged_corpus`` (with ``--device_epoch``) stages each rank's
share on its card.

``--use_pallas --pallas_impl auto [--autotune_cache FILE]`` runs each
``(batch, width)`` on the route the autotuner's cache names for it (``python
-m code2vec_tpu_torch.ops.autotune`` fills the file; a miss runs
``pool_only``).

The reference's ``--gpu`` and ``--num_workers`` are accepted and do
nothing (the card is ``--device``; the host feed is ``--feed_workers``).
JAX's TPU knobs ``--rng_impl``, ``--pallas_block_b`` and
``--pallas_dma_depth`` are accepted at their defaults and raise otherwise
(``TrainConfig.validate``).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

logger = logging.getLogger(__name__)

SYNTHETIC = ("tiny", "small", "parity10k", "top11")


def _strtobool(value: str) -> bool:
    lowered = value.strip().lower()
    if lowered in ("y", "yes", "t", "true", "on", "1"):
        return True
    if lowered in ("n", "no", "f", "false", "off", "0"):
        return False
    raise argparse.ArgumentTypeError(f"invalid truth value {value!r}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="code2vec_tpu_torch",
        description="code2vec on PyTorch/CUDA: train and export code vectors",
    )
    parser.add_argument("--random_seed", type=int, default=123)
    parser.add_argument("--corpus_path", type=str, default="./dataset/corpus.txt")
    parser.add_argument("--path_idx_path", type=str, default="./dataset/path_idxs.txt")
    parser.add_argument("--terminal_idx_path", type=str, default="./dataset/terminal_idxs.txt")
    parser.add_argument("--synthetic", type=str, default=None, choices=SYNTHETIC,
                        help="ignore the corpus flags and train on a generated corpus")

    parser.add_argument("--model", type=str, default="code2vec", choices=("code2vec", "code2seq"),
                        help="code2seq: a bi-LSTM path encoder and an attention decoder that "
                             "generates the name (device epochs, one card, f32, dense tables)")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--terminal_embed_size", type=int, default=100)
    parser.add_argument("--path_embed_size", type=int, default=100)
    parser.add_argument("--encode_size", type=int, default=300)
    parser.add_argument("--max_path_length", type=int, default=200)

    parser.add_argument("--model_path", type=str, default="./output")
    parser.add_argument("--vectors_path", type=str, default="./output/code.vec")
    parser.add_argument("--test_result_path", type=str, default=None)

    parser.add_argument("--max_epoch", type=int, default=40)
    parser.add_argument("--lr", type=float, default=0.01)
    parser.add_argument("--beta_min", type=float, default=0.9)
    parser.add_argument("--beta_max", type=float, default=0.999)
    parser.add_argument("--weight_decay", type=float, default=0.0)
    parser.add_argument("--dropout_prob", type=float, default=0.25)
    # code2seq's widths (its config.py, the java-large model)
    parser.add_argument("--seq_embed_size", type=int, default=128,
                        help="code2seq: subtoken, node and target embeddings")
    parser.add_argument("--seq_rnn_size", type=int, default=256,
                        help="code2seq: the path bi-LSTM's state, both directions")
    parser.add_argument("--seq_decoder_size", type=int, default=320)

    parser.add_argument("--device", type=str, default=None,
                        help="cuda (the default) or cpu (the plain versions)")
    parser.add_argument("--no_cuda", action="store_true", default=False,
                        help="the reference's flag: same as --device cpu")
    parser.add_argument("--gpu", type=str, default=None,
                        help="no-op (the reference's flag; the card is --device)")
    parser.add_argument("--num_workers", type=int, default=None,
                        help="no-op (the reference's flag; the host feed is --feed_workers)")

    # metric sinks and the search (main.py:66-71, JAX cli.py:92-105)
    parser.add_argument("--env", type=str, default=None, choices=(None, "tensorboard", "floyd"),
                        help="extra metric sink: tensorboard | floyd")
    parser.add_argument("--tensorboard_dir", type=str, default="runs",
                        help="scalar log dir for --env tensorboard")
    parser.add_argument("--find_hyperparams", action="store_true", default=False,
                        help="hyperparameter search over the reference's space instead of one run")
    parser.add_argument("--hpo_sampler", type=str, default="tpe", choices=("tpe", "random"),
                        help="the search's sampler (tpe is the reference's optuna default)")
    parser.add_argument("--num_trials", type=int, default=100)

    parser.add_argument("--print_sample_cycle", type=int, default=10)
    parser.add_argument("--eval_method", type=str, default="subtoken",
                        choices=("exact", "subtoken", "ave_subtoken"))

    parser.add_argument("--angular_margin_loss", action="store_true", default=False)
    parser.add_argument("--angular_margin", type=float, default=0.5)
    parser.add_argument("--inverse_temp", type=float, default=30.0)

    parser.add_argument("--infer_method_name", type=_strtobool, default=True)
    parser.add_argument("--infer_variable_name", type=_strtobool, default=False)
    parser.add_argument("--shuffle_variable_indexes", type=_strtobool, default=False)

    parser.add_argument("--use_pallas", action="store_true", default=False,
                        help="run the forward through the hand kernels (the JAX name)")
    parser.add_argument("--pallas_impl", type=str, default="pool_only",
                        choices=("pool_only", "gather_split", "fused", "auto"),
                        help="pool_only: K1/K1b after a plain encode; gather_split: K2; "
                             "fused: K3; auto: each shape's route from --autotune_cache")
    parser.add_argument("--pallas_block_b", type=int, default=8,
                        help="JAX's Pallas batch tile: 8 only (the card's kernels size their grids)")
    parser.add_argument("--pallas_dma_depth", type=int, default=2,
                        help="JAX's fused-kernel gather buffers: 2 only (K3 stages its own)")
    parser.add_argument("--pallas_chunk_l", type=int, default=128)
    parser.add_argument("--pallas_softmax", type=str, default="auto",
                        choices=("auto", "materialize", "online", "two_pass"))
    parser.add_argument("--table_dtype", type=str, default="f32",
                        choices=("f32", "bf16", "int8"),
                        help="embedding storage of --export_only; training takes f32")
    parser.add_argument("--autotune_cache", type=str, default="",
                        help="kernel-schedule cache of --pallas_impl auto (default "
                             "$C2V_AUTOTUNE_CACHE or ~/.cache/code2vec_tpu/"
                             "autotune_schedules.json; fill it with python -m "
                             "code2vec_tpu_torch.ops.autotune)")
    parser.add_argument("--attn_impl", type=str, default="xla", choices=("xla", "streaming"))
    parser.add_argument("--encoder_impl", type=str, default="concat",
                        choices=("concat", "split"))
    parser.add_argument("--class_weighting", type=str, default="reference",
                        choices=("reference", "occurrence", "none"))
    parser.add_argument("--vocab_pad_multiple", type=int, default=0)
    parser.add_argument("--checkpoint_cycle", type=int, default=0,
                        help="also checkpoint the last slot every N epochs")
    parser.add_argument("--resume", action="store_true", default=False,
                        help="resume from the checkpoint in --model_path (inside its epoch when it "
                             "holds a mid-epoch cursor)")
    parser.add_argument("--export_only", action="store_true", default=False,
                        help="restore the best checkpoint in --model_path and rewrite "
                             "--vectors_path (+ the test TSV) without training")
    parser.add_argument("--bucketed", action="store_true", default=False,
                        help="bucketed batching: each example goes to the narrowest width "
                             "of a ladder that holds its real contexts, in [B, L_b] batches")
    parser.add_argument("--bucket_ladder", type=str, default="",
                        help="comma list of bag widths ending at --max_path_length (e.g. "
                             "25,50,100,200); empty = derive one from the corpus")
    parser.add_argument("--max_contexts", type=int, default=-1,
                        help="per-example context cap: -1 = --max_path_length (long bags "
                             "are subsampled); 0 = unbounded (needs --bucketed): long-bag "
                             "rungs above the top width, streamed through K4 on a kernel "
                             "route")

    parser.add_argument("--compute_dtype", type=str, default="float32",
                        choices=("float32", "bfloat16"),
                        help="the model's compute dtype (parameters stay f32)")
    parser.add_argument("--adam_mu_dtype", type=str, default="float32",
                        choices=("float32", "bfloat16"),
                        help="storage of Adam's first moments (a resume must match)")
    parser.add_argument("--table_update", type=str, default="dense", choices=("dense", "lazy"),
                        help="lazy: Adam on the tables' touched rows only, from per-slot "
                             "gradients (no [vocab, dim] gradient; a resume must match)")
    parser.add_argument("--embed_grad", type=str, default="dense",
                        choices=("dense", "segment", "segment_sorted"),
                        help="the JAX package's choice of the tables' backward; accepted for "
                             "its configurations, every mode runs one segment sum (K6 on the "
                             "card, F.embedding's backward on the CPU)")

    parser.add_argument("--device_epoch", action="store_true", default=False,
                        help="stage both splits on the card once and sample each epoch's "
                             "batches there, --device_chunk_batches steps a chunk")
    parser.add_argument("--device_chunk_batches", type=int, default=16,
                        help="batches per device-epoch chunk")
    parser.add_argument("--sample_prefetch", type=_strtobool, default=False,
                        help="device-epoch chunks sample batch i+1 while stepping batch i "
                             "(a second CUDA stream; the same batches)")

    # the host feed and the corpus (JAX cli.py:216-243, :254)
    parser.add_argument("--corpus_format", type=str, default="auto",
                        choices=("auto", "text", "csr"),
                        help="corpus file format: text (L1 corpus.txt), "
                        "csr (memory-mapped binary container from "
                        "tools/corpus_convert.py — feeds training through "
                        "mmap views in bounded host RSS), or auto-detect "
                        "by magic (default)")
    parser.add_argument("--stream_chunk_items", type=int, default=0,
                        help="stream epochs in chunks of this many rows "
                        "instead of materializing [N, L] tensors (bounds "
                        "host RSS at java-large scale; 0 = materialize)")
    parser.add_argument("--prefetch_batches", type=int, default=0,
                        help="host-epoch input pipeline: build + transfer "
                        "this many batches ahead of compute on a background "
                        "thread (0 = synchronous; identical batches in "
                        "identical order)")
    parser.add_argument("--feed_workers", type=int, default=0,
                        help="parallel host ingest: execute each epoch's "
                        "batch plan on this many forked worker processes "
                        "(RNG stays on the coordinator — feed order, loss "
                        "history, and resume cursors are bitwise identical "
                        "to 0 = build on the coordinator). Method-task "
                        "host pipeline only; composes with bucketed/"
                        "streaming/mmap and --prefetch_batches")
    parser.add_argument("--profile_steps", type=int, default=0,
                        help="fence the first N train steps of each epoch "
                        "and log the host-build / H2D / feed-wait / "
                        "compute wall-time split (0 = off)")
    parser.add_argument("--no_corpus_cache", action="store_true", default=False,
                        help="disable the <corpus>.cache.npz sidecar that "
                             "makes repeat startups fast at top11 scale")

    # elastic training (JAX cli.py:278-298)
    parser.add_argument("--async_checkpoint", action="store_true", default=False,
                        help="async checkpointing: the loop blocks only for "
                             "the device-to-host snapshot; the disk write "
                             "overlaps the next steps on a background thread")
    parser.add_argument("--checkpoint_every_steps", type=int, default=0,
                        help="also save the last slot every N train steps "
                             "with a mid-epoch data cursor so --resume "
                             "restarts inside the epoch (0 = epoch-boundary "
                             "saves only)")
    parser.add_argument("--fault_plan", type=str, default="",
                        help="deterministic fault injection for recovery "
                             "drills (code2vec_tpu_torch/faultinject.py), e.g. "
                             "'train_step@10:sigterm,mid_save@1:raise' — "
                             "crashes the process ON PURPOSE")
    parser.add_argument("--rng_impl", type=str, default="threefry2x32",
                        choices=("threefry2x32", "rbg", "unsafe_rbg"),
                        help="JAX's dropout PRNG: threefry2x32 only (the port's dropout stream "
                             "is a torch.Generator)")

    # telemetry (JAX cli.py:299-312)
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace of epoch 2 here")
    parser.add_argument("--events_dir", type=str, default=None,
                        help="write a per-process JSONL event log here (the run manifest "
                             "first, then typed epoch / step_sample / checkpoint / eval / "
                             "recompile / error events; obs/events.py)")
    parser.add_argument("--trace_dir", type=str, default=None,
                        help="write a Chrome trace_event JSON here (spans of the extractor, "
                             "the input pipeline, the prefetch producer and the train / eval / "
                             "checkpoint phases; each step's train_step with forward, backward, "
                             "grad_sync and optimizer, and with --device_epoch a train_chunk "
                             "span a chunk with each step's sample; on the card the step's "
                             "parts carry device_ms and drained; every step is spanned, 4 to 6 "
                             "spans a step, and spans past the first 1,000,000 are counted as "
                             "dropped_events, not written; obs/trace.py)")

    # the mesh (parallel/; JAX cli.py:168-186, :246-252)
    parser.add_argument("--data_axis", type=int, default=1,
                        help="mesh data-parallel axis size")
    parser.add_argument("--model_axis", type=int, default=1,
                        help="mesh model-parallel axis size (shards the vocab tables and the "
                             "label head)")
    parser.add_argument("--context_axis", type=int, default=1,
                        help="mesh context-parallel axis size (shards the bag)")
    parser.add_argument("--host_shard_corpus", action="store_true", default=False,
                        help="each feed group (the ranks of one data coordinate) loads only "
                             "its round-robin share of the corpus")
    parser.add_argument("--shard_staged_corpus", action="store_true", default=False,
                        help="partition the device-staged corpus over the data axis instead "
                             "of replicating it (each card holds ~1/data_axis; needs "
                             "--device_epoch, context_axis 1)")
    return parser


_CONFIG_FLAGS = (
    "random_seed", "terminal_embed_size", "path_embed_size", "encode_size",
    "max_path_length", "batch_size", "max_epoch", "lr", "beta_min", "beta_max",
    "weight_decay", "dropout_prob", "angular_margin_loss", "angular_margin", "inverse_temp",
    "infer_method_name", "infer_variable_name", "shuffle_variable_indexes", "eval_method",
    "print_sample_cycle", "class_weighting", "use_pallas", "pallas_impl", "pallas_chunk_l",
    "pallas_softmax", "table_dtype", "attn_impl", "encoder_impl", "vocab_pad_multiple",
    "resume", "checkpoint_cycle", "compute_dtype", "data_axis", "model_axis", "context_axis",
    "adam_mu_dtype", "table_update", "embed_grad", "bucketed", "bucket_ladder", "max_contexts",
    "device_epoch", "device_chunk_batches", "sample_prefetch", "stream_chunk_items",
    "feed_workers", "prefetch_batches", "profile_steps", "async_checkpoint",
    "checkpoint_every_steps", "fault_plan", "rng_impl", "pallas_block_b", "pallas_dma_depth",
    "shard_staged_corpus", "autotune_cache", "model", "seq_embed_size", "seq_rnn_size",
    "seq_decoder_size",
)


def config_from_args(args: argparse.Namespace):
    from code2vec_tpu_torch.train.config import TrainConfig

    return TrainConfig(**{name: getattr(args, name) for name in _CONFIG_FLAGS})


def device_from_args(args: argparse.Namespace) -> str | None:
    if args.no_cuda:
        if args.device not in (None, "cpu"):
            raise SystemExit(f"--no_cuda contradicts --device {args.device}")
        return "cpu"
    return args.device


def sinks_from_args(args: argparse.Namespace) -> tuple:
    from code2vec_tpu_torch.sinks import floyd_sink, logging_sink, tensorboard_sink

    sinks = [logging_sink]
    if args.env == "floyd":
        sinks.append(floyd_sink)
    elif args.env == "tensorboard":
        sinks.append(tensorboard_sink(args.tensorboard_dir))
    return tuple(sinks)


def telemetry_from_args(args: argparse.Namespace):
    """``(EventLog | None, Tracer | None)`` from ``--events_dir`` /
    ``--trace_dir``; the tracer is also installed process-wide, so the
    data layers' spans (the native parse, the epoch builds) land in it."""
    events = tracer = None
    if args.events_dir:
        from code2vec_tpu_torch.obs.events import EventLog

        events = EventLog(args.events_dir)
    if args.trace_dir:
        from code2vec_tpu_torch.obs.trace import Tracer, set_tracer

        tracer = Tracer()
        set_tracer(tracer)
    return events, tracer


def close_telemetry(args: argparse.Namespace, events, tracer) -> None:
    """Export the trace and close the event log; a failure of either is
    logged, so it neither masks an exception unwinding nor skips the other."""
    if tracer is not None:
        from code2vec_tpu_torch.obs.trace import set_tracer

        set_tracer(None)
        try:
            path = tracer.export_dir(args.trace_dir)
            logger.info("chrome trace written to %s (open in Perfetto or chrome://tracing)", path)
        except Exception:
            logger.warning("could not write the chrome trace to %s", args.trace_dir,
                           exc_info=True)
    if events is not None:
        if events.path is not None:
            logger.info("event log written to %s", events.path)
        try:
            events.close()
        except Exception:
            logger.warning("could not close the event log", exc_info=True)


def _host_shard(args: argparse.Namespace) -> tuple[int, int] | None:
    """``--host_shard_corpus``'s ``(feed group, groups)``: the rank's data
    coordinate on the mesh (JAX ``cli.py:511-547``), not its rank, so the
    ranks of one data coordinate load the same share."""
    if not args.host_shard_corpus:
        return None
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if world == 1:
        logger.warning("--host_shard_corpus with a single process: launch with torchrun "
                       "--nproc_per_node N to form the process group; loading the full corpus")
        return None
    if args.data_axis * args.model_axis * args.context_axis <= 1:
        raise SystemExit("--host_shard_corpus requires mesh axes (--data_axis / --model_axis / "
                         "--context_axis)")
    from code2vec_tpu_torch.parallel.mesh import mesh_grid

    import numpy as np

    grid = mesh_grid(args.data_axis, args.model_axis, args.context_axis, world)
    return int(np.argwhere(grid == dist.get_rank())[0][0]), args.data_axis


def main(argv: list[str] | None = None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s: %(message)s",
                        datefmt="%m/%d/%Y %I:%M:%S %p")
    args = build_parser().parse_args(argv)
    if args.gpu is not None or args.num_workers is not None:
        logger.info("--gpu/--num_workers are no-ops here: the run's device is --device "
                    "(default cuda), the host feed's processes --feed_workers")
    config = config_from_args(args)
    config.validate(training=not args.export_only)
    device = device_from_args(args)
    # the process group of a mesh run (torchrun's environment; a no-op alone)
    from code2vec_tpu_torch.parallel.distributed import initialize_from_env

    formed = initialize_from_env(device)
    shard = _host_shard(args)

    from code2vec_tpu_torch.data.reader import load_corpus

    synth_dir = None
    if args.synthetic is not None:
        import tempfile

        from code2vec_tpu_torch.data.synth import SPECS, generate_corpus_files

        synth_dir = tempfile.TemporaryDirectory(prefix="c2v_synth_")
        logger.info("generating the %r synthetic corpus in %s", args.synthetic, synth_dir.name)
        paths = generate_corpus_files(synth_dir.name, SPECS[args.synthetic])
        args.corpus_path = paths["corpus"]
        args.path_idx_path = paths["path_idx"]
        args.terminal_idx_path = paths["terminal_idx"]
    # installed before the corpus load, so the parse and build spans land
    events, tracer = telemetry_from_args(args)
    try:
        if args.corpus_format != "auto":
            # fail loudly when the file is not what the flag says (a text path
            # after a conversion would parse the whole corpus into RAM)
            from code2vec_tpu_torch.formats.corpus_io import is_csr_corpus

            actual = "csr" if is_csr_corpus(args.corpus_path) else "text"
            if actual != args.corpus_format:
                raise SystemExit(
                    f"--corpus_format {args.corpus_format} but {args.corpus_path!r} is a "
                    f"{actual} corpus; convert with tools/corpus_convert.py or fix the flag")
        data = load_corpus(args.corpus_path, args.path_idx_path, args.terminal_idx_path,
                           infer_method=args.infer_method_name,
                           infer_variable=args.infer_variable_name,
                           cache=not args.no_corpus_cache, shard=shard)
        if args.model == "code2seq" and (args.find_hyperparams or args.export_only):
            raise SystemExit("--model code2seq trains and evaluates only: the search and "
                             "--export_only run code2vec")
        if args.find_hyperparams:
            from code2vec_tpu_torch.hpo import find_optimal_hyperparams

            study = find_optimal_hyperparams(
                data, config, n_trials=args.num_trials, seed=args.random_seed,
                sampler=args.hpo_sampler, events=events, device=device,
                sinks=sinks_from_args(args), profile_dir=args.profile_dir)
            best = study.best_trial
            logger.info("Number of finished trials: %d", len(study.trials))
            logger.info("Best trial value: %s", best.value)
            for key, value in best.params.items():
                logger.info("    %s: %s", key, value)
            return 0
        os.makedirs(args.model_path, exist_ok=True)
        for out_file in (args.vectors_path, args.test_result_path):
            if out_file and os.path.dirname(out_file):
                os.makedirs(os.path.dirname(out_file), exist_ok=True)
        if args.export_only:
            from code2vec_tpu_torch.export import export_from_checkpoint

            if not args.vectors_path:
                raise SystemExit("--export_only requires --vectors_path")
            f1 = export_from_checkpoint(config, data, args.model_path, args.vectors_path,
                                        args.test_result_path, device=device)
            logger.info("done: exported (test f1=%s)", f1)
            return 0

        from code2vec_tpu_torch.train.loop import train

        result = train(config, data, out_dir=args.model_path, vectors_path=args.vectors_path,
                       test_result_path=args.test_result_path, device=device,
                       on_epoch=lambda m: print(json.dumps(m), flush=True),
                       sinks=sinks_from_args(args), profile_dir=args.profile_dir,
                       events=events, tracer=tracer)
        logger.info("done: best_f1=%s after %d epochs", result.best_f1, result.epochs_run)
        return 0
    finally:
        close_telemetry(args, events, tracer)
        if synth_dir is not None:
            synth_dir.cleanup()
        if formed:
            # the group's transport threads stop here, not in the
            # interpreter's teardown (where gloo's can abort the process)
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
