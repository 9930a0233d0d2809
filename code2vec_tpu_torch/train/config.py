"""Training configuration (the reference's Option, main.py:93-115).

Own copy of ``code2vec_tpu/train/config.py``: the same field names and
defaults, so a JAX configuration reads the same here. The TPU knobs with no
meaning on the card (``pallas_block_b``, ``pallas_dma_depth``,
``rng_impl``) stay at their defaults: :meth:`TrainConfig.validate` rejects
any other value loudly instead of ignoring it. ``pallas_impl='auto'`` picks each shape's route
from the schedule cache at ``autotune_cache`` (``ops/autotune.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from code2vec_tpu_torch.ops.embed import GRAD_MODES

DTYPES = ("float32", "bfloat16")  # compute_dtype and adam_mu_dtype
TABLE_UPDATES = ("dense", "lazy")
MODELS = ("code2vec", "code2seq")


@dataclass(frozen=True)
class TrainConfig:
    # reproducibility: also seeds the train/test split
    random_seed: int = 123

    # the model: "code2vec", or "code2seq" (models/code2seq.py: a bi-LSTM path
    # encoder and an attention decoder over the same corpus, device epochs
    # only; its optimizer and rate decay are its own)
    model: str = "code2vec"

    # model dims (main.py:45-47) and the bag size (main.py:48)
    terminal_embed_size: int = 100
    path_embed_size: int = 100
    encode_size: int = 300
    max_path_length: int = 200

    # optimizer (main.py:55-58): torch Adam with coupled L2
    batch_size: int = 32
    max_epoch: int = 40
    lr: float = 0.01
    beta_min: float = 0.9
    beta_max: float = 0.999
    weight_decay: float = 0.0
    dropout_prob: float = 0.25

    # code2seq's widths (its config.py, the java-large model): EMBEDDINGS_SIZE,
    # RNN_SIZE (both directions) and DECODER_SIZE; dropout_prob is its
    # embeddings' dropout (the rest: models/code2seq.Code2SeqConfig)
    seq_embed_size: int = 128
    seq_rnn_size: int = 256
    seq_decoder_size: int = 320

    # loss head (main.py:73-75)
    angular_margin_loss: bool = False
    angular_margin: float = 0.5
    inverse_temp: float = 30.0

    # tasks (main.py:77-79): the method name, the variable names (one example
    # per @var_* alias), or both; shuffle_variable_indexes permutes the other
    # @var_* ids of a variable example every epoch
    infer_method_name: bool = True
    infer_variable_name: bool = False
    shuffle_variable_indexes: bool = False

    # eval + control (main.py:67-68; early stop main.py:233-242)
    eval_method: str = "subtoken"  # exact | subtoken | ave_subtoken
    print_sample_cycle: int = 10
    early_stop_patience: int = 10

    # "reference" = 1/freq over the de-facto-uniform freq table,
    # "occurrence" = true inverse-occurrence weights, "none" = unweighted
    class_weighting: str = "reference"

    # kernel routes of the forward and their knobs
    use_pallas: bool = False
    # the Pallas kernel's batch tile: the card's kernels size their own grids
    pallas_block_b: int = 8
    # pool_only (K1) | gather_split (K2) | fused (K3) | auto (the schedule cache's)
    pallas_impl: str = "pool_only"
    # the fused Pallas kernel's gather buffers: K3 stages its rows with cp.async
    pallas_dma_depth: int = 2
    pallas_chunk_l: int = 128
    pallas_softmax: str = "auto"
    # embedding storage of eval/export forwards; training takes f32 only
    table_dtype: str = "f32"
    attn_impl: str = "xla"  # the plain pool: "xla" | "streaming"
    encoder_impl: str = "concat"  # the plain encode: "concat" | "split"
    # JAX's choice of the tables' dense backward; here every mode is one segment
    # sum (ops/embed.py: K6 on the card, F.embedding's backward on the CPU)
    embed_grad: str = "dense"
    # pad the tables and the head to this multiple so they shard evenly over
    # the model axis; 0 = auto (model_axis); checkpoint shapes depend on it
    vocab_pad_multiple: int = 0
    # the kernel-schedule cache of pallas_impl='auto' ("" = $C2V_AUTOTUNE_CACHE or
    # ~/.cache/code2vec_tpu/autotune_schedules.json)
    autotune_cache: str = ""
    # JAX's dropout PRNG; the port's dropout stream is a torch.Generator
    rng_impl: str = "threefry2x32"

    # checkpoints: best-F1 always, plus the last slot every N epochs
    resume: bool = False
    checkpoint_cycle: int = 0

    # bucketed batching: each epoch's examples go to the narrowest width of
    # a static ladder that holds their real contexts, in [B, L_b] batches
    bucketed: bool = False
    # comma list of widths ending at max_path_length ("25,50,100,200");
    # empty = derive a geometric ladder from the corpus's length histogram
    bucket_ladder: str = ""
    # per-example context cap: -1 = max_path_length (long bags are
    # subsampled); 0 = unbounded (needs bucketed): the ladder grows long-bag
    # rungs above max_path_length and nothing is truncated
    max_contexts: int = -1

    # the model's compute dtype: "float32" | "bfloat16" (parameters,
    # gradients and the head stay f32)
    compute_dtype: str = "float32"
    # Adam's first-moment storage: "float32" | "bfloat16" (nu stays f32)
    adam_mu_dtype: str = "float32"
    # the tables' optimizer: "dense" (Adam over every row) or "lazy" (the
    # touched rows only, torch.optim.SparseAdam's semantics; train/table_opt.py)
    table_update: str = "dense"

    # device-resident epochs (train/device_epoch.py): both splits staged on
    # the card once, each epoch's batches sampled there, device_chunk_batches
    # steps enqueued per chunk; sample_prefetch samples batch i+1 before
    # stepping batch i (on a second CUDA stream)
    device_epoch: bool = False
    device_chunk_batches: int = 16
    sample_prefetch: bool = False

    # the host feed (data/pipeline.py, data/parallel_feed.py, train/prefetch.py):
    # stream_chunk_items builds epochs in chunks of that many items instead
    # of materializing [N, L] (0 = materialize); feed_workers forked processes
    # build each epoch's planned batches, every draw staying on the
    # coordinator (0 = build on it; method task, host-fed only);
    # prefetch_batches builds and copies that many batches ahead on a thread
    # (0 = synchronous); profile_steps splits that many steps an epoch into
    # host-build / H2D / feed-wait / compute ms (0 = off). Every setting
    # feeds the same batches in the same order.
    stream_chunk_items: int = 0
    feed_workers: int = 0
    prefetch_batches: int = 0
    profile_steps: int = 0

    # elastic training (checkpoint.py, train/preempt.py, faultinject.py):
    # async_checkpoint persists saves on a thread behind a host snapshot;
    # checkpoint_every_steps also saves the last slot every N train steps
    # with a mid-epoch data cursor (0 = epoch boundaries only); fault_plan
    # schedules faults for recovery drills (or C2V_FAULT_PLAN)
    async_checkpoint: bool = False
    checkpoint_every_steps: int = 0
    fault_plan: str = ""

    # the (data, model, ctx) mesh of one torch.distributed rank a card
    # (parallel/): the batch over data, the tables and the head over model,
    # the bag over ctx; shard_staged_corpus partitions the device-staged
    # corpus over the data axis (each rank stages ~1/data_axis of it)
    data_axis: int = 1
    model_axis: int = 1
    context_axis: int = 1
    shard_staged_corpus: bool = False

    def with_updates(self, **kw) -> "TrainConfig":
        return replace(self, **kw)

    def validate(self, training: bool = True) -> "TrainConfig":
        """Raise for a setting the port cannot honour (rather than
        silently training something else). ``training=False`` (an export
        pass) accepts a quantized ``table_dtype``."""
        if self.bucket_ladder and not self.bucketed:
            raise ValueError(
                "--bucket_ladder was given but --bucketed is off: the ladder would be "
                "ignored; add --bucketed or drop the ladder"
            )
        if self.max_contexts > 0:
            raise ValueError("max_contexts takes -1 (follow max_path_length) or 0 (unbounded "
                             "bags); set max_path_length itself for a bounded cap")
        if self.max_contexts == 0 and not self.bucketed:
            raise ValueError(
                "--max_contexts 0 (unbounded bags) requires --bucketed: without a ladder "
                "every example would pad to the longest bag in the corpus"
            )
        if self.max_contexts == 0 and self.device_epoch:
            raise ValueError("--max_contexts 0 does not compose with --device_epoch; drop one")
        if self.sample_prefetch and not self.device_epoch:
            raise ValueError("--sample_prefetch double-buffers the device-epoch sampler; it "
                             "requires --device_epoch")
        if self.device_chunk_batches < 1:
            raise ValueError(f"device_chunk_batches must be >= 1, got "
                             f"{self.device_chunk_batches}")
        for name, allowed in (("compute_dtype", DTYPES), ("adam_mu_dtype", DTYPES),
                              ("table_update", TABLE_UPDATES), ("embed_grad", GRAD_MODES),
                              ("model", MODELS)):
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, got {getattr(self, name)!r}")
        for name in ("stream_chunk_items", "feed_workers", "prefetch_batches", "profile_steps",
                     "checkpoint_every_steps"):
            if getattr(self, name) < 0:
                raise ValueError(f"--{name} must be >= 0, got {getattr(self, name)}")
        if self.feed_workers and self.device_epoch:
            raise ValueError("--feed_workers parallelizes the HOST batch pipeline; "
                             "--device_epoch samples batches on device and has no host builds "
                             "to parallelize: drop one flag")
        # TPU knobs with no counterpart on the card: JAX's defaults only
        tpu_only = {
            "rng_impl": ("threefry2x32", "the port's dropout stream is a torch.Generator "
                         "(Philox on the card); JAX's PRNG implementations do not exist here"),
            "pallas_block_b": (8, "the Pallas kernel's batch tile; the card's kernels size "
                               "their own grids from the batch and bag"),
            "pallas_dma_depth": (2, "the fused Pallas kernel's gather buffers; K3 stages its "
                                 "rows with cp.async in buffers of its own"),
        }
        for name, (default, why) in tpu_only.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r} has no meaning on the card ({why}); "
                    f"leave it at {default!r}")
        for name in ("data_axis", "model_axis", "context_axis"):
            if getattr(self, name) < 1:
                raise ValueError(f"--{name} must be >= 1, got {getattr(self, name)}")
        if self.shard_staged_corpus and not self.device_epoch:
            raise ValueError("--shard_staged_corpus shards the device-staged corpus; it "
                             "requires --device_epoch")
        if not (self.infer_method_name or self.infer_variable_name):
            raise ValueError("no task: turn on infer_method_name, infer_variable_name or both")
        if self.model == "code2seq":
            self._validate_code2seq()
        if training and self.table_dtype != "f32":
            raise ValueError(
                f"table_dtype={self.table_dtype!r} is not trainable: quantized tables serve "
                "eval/predict/export forwards; training keeps f32 master weights"
            )
        return self

    def _validate_code2seq(self) -> None:
        """code2seq trains through device epochs on one card, in f32, with
        dense tables, on the method-name task (ROADMAP F lists the rest)."""
        refused = [
            (not self.device_epoch, "the host feed: pass --device_epoch"),
            (self.use_pallas, "the kernel routes K1-K4 (--use_pallas): it has no code2vec pool"),
            (self.table_update != "dense", "lazy tables (--table_update lazy)"),
            (self.compute_dtype != "float32", "bf16 compute (--compute_dtype)"),
            (self.data_axis * self.model_axis * self.context_axis > 1,
             "meshes (--data_axis/--model_axis/--context_axis)"),
            (self.bucketed or self.max_contexts == 0, "bucketed and long bags"),
            (self.infer_variable_name or not self.infer_method_name,
             "the variable-name task"),
            (self.angular_margin_loss, "the angular-margin head"),
            (self.table_dtype != "f32", "quantized tables (--table_dtype)"),
        ]
        for bad, what in refused:
            if bad:
                raise NotImplementedError(f"--model code2seq does not support {what}")
        if self.seq_rnn_size % 2:
            raise ValueError(f"--seq_rnn_size {self.seq_rnn_size} holds two directions' "
                             "states: make it even")
