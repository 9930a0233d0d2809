"""The code2vec model as a PyTorch ``nn.Module``.

Counterpart of ``code2vec_tpu/models/code2vec.py`` (itself the reference
model/model.py:15-105):

  terminal/path embedding gathers
    -> [start; path; end] @ W (no bias) -> LayerNorm (eps 1e-6) -> tanh
    -> masked global-attention pooling
    -> output head: plain linear, or the additive-angular-margin cosine head

Parameters carry the reference ``state_dict`` names and layouts
(``interop.PLAIN_KEYS`` / ``MARGIN_KEYS``), so ``load_state_dict(...,
strict=True)`` takes a ``code2vec.model`` file or a converted JAX param
tree. With ``vocab_pad_multiple > 1`` the tables and the head are padded
like the JAX model's and the logits are sliced to ``label_count``.

``use_pallas`` + ``pallas_impl`` select the same kernel routes as the JAX
config: ``pool_only`` (K1 after a plain encode), ``gather_split`` (K2) or
``fused`` (K3); without ``use_pallas`` the forward is plain PyTorch.
``pallas_impl="auto"`` looks each ``(batch, width)`` up in the autotuner's
schedule cache (``ops/autotune.py``) once, keyed on the global batch on a
mesh, and runs the route it names (``xla`` is the plain route); a miss
runs ``pool_only``. Bag widths above ``longbag_width`` are long-bag
shapes: they are forced to the fused kernel with a streamed softmax (K4),
as the JAX model's ``_resolve_kernel`` does. On the CPU every kernel route
runs its plain version.

Training (``model.train()`` with ``0 < dropout_prob < 1``): the dropout
keep mask is drawn with ``torch.bernoulli`` from the module's own
generator (:meth:`Code2Vec.seed_dropout`), at ``(B, L, H)``, divided by
the keep probability, and applied after tanh on every route: by the plain
forward and before K1, and inside K2-K4 (the JAX model's ``drop_mask``,
``code2vec_tpu/models/code2vec.py:362-374``). The stream differs from
JAX's. Every route has a backward: K1b under K1, the recomputed plain
formulation under K2-K4. Quantized tables serve only: a training forward
with ``table_dtype != "f32"`` raises.

``dtype=torch.bfloat16`` is the JAX model's bf16 compute, with its casts
made explicit (no ``torch.autocast``, whose op lists differ): the gathered
rows and the encoder weight cast to bf16 and the encode in bf16, LayerNorm
in f32 on the widened contexts and cast back, tanh and the keep mask in
bf16 (``enc * drop.to(bf16)``), the pool in bf16 with the attention vector
cast to bf16 (K1/K1b over the bf16 contexts on ``pool_only``, K2 over bf16
rows on ``gather_split``, ``fused`` unchanged), and the code vector cast to
f32 for the f32 head. The plain route's keep mask differs from flax
``nn.Dropout``'s ``x / keep`` by the bf16 rounding of ``1/keep`` (at most
0.2%), a difference of the stream as the draw's is. Parameters, gradients
and the head stay f32.

The plain encode of ``pool_only`` and of the plain forward is a library
matmul, whose kernel cuBLAS chooses by the number of rows: on the card,
with gradients off (serving, evaluation), it runs over slabs of exactly
``ENCODE_SLAB_ROWS`` rows (:func:`encode_matmul`), so a context's encoding,
and a request's code vector, does not depend on the micro-batch it rides
in. Training, and the CPU (whose rows do not depend on the row count),
keep one matmul.

The lazy table optimizer (``train/table_opt.py``) trains through
``forward(embed_offsets=...)``: the tables enter detached and the zero
offsets added to the gathered rows take their per-slot gradients.
``embed_grad`` is JAX's choice of the dense tables' backward; every mode
runs one segment sum (``ops/embed.py``): K6 on the card, ``F.embedding``'s
backward on the CPU.

On a mesh (``parallel/shardings.shard_model`` sets ``mesh``) the forward
inserts what GSPMD inserts for the JAX model: a row-sharded table's rows
are gathered locally and all-reduced over the model line (identity
backward; K2 on ``gather_split`` and K1 on ``pool_only`` take them from
there), K3 gets both tables all-gathered whole, the column-sharded head's
logits are all-gathered along the labels (the code vector entering it
all-reduces its gradient), a ctx-sharded bag pools through
``parallel/context.py``, and the keep mask is the global batch's draw,
sliced to this rank's rows and bag columns.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, replace

import torch
import torch.nn as nn
import torch.nn.functional as F

from code2vec_tpu_torch.ops.attention import attention_pool, streaming_attention_pool
from code2vec_tpu_torch.ops.embed import GRAD_MODES, embedding_lookup
from code2vec_tpu_torch.ops.fused_encode_pool import COMPUTE_DTYPES, DEFAULT_CHUNK_L, LN_EPS
from code2vec_tpu_torch.ops.quant import TABLE_DTYPES, QuantTable, dequantize_rows

# rows per library matmul of the plain encode on the card without gradients:
# of 256-8,192 rows, the least summed cost over the parent's one matmul at
# 1x200 and 64x200 (tools/kernel_ab.py --forward; each slab is a launch)
ENCODE_SLAB_ROWS = 8192


def encode_matmul(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``x @ weight`` over the last dim of ``x [..., K]`` (``weight [K, N]``).
    On the card with gradients off the rows go through cuBLAS in slabs of
    exactly ``ENCODE_SLAB_ROWS`` (the last one zero-padded), so it runs the
    same kernel on every row however many there are: a row's bits do not
    depend on the batch (cuBLAS picks its kernel by the row count)."""
    if not x.is_cuda or torch.is_grad_enabled():
        return x @ weight
    lead, k = x.shape[:-1], x.shape[-1]
    rows = x.reshape(-1, k)
    n = rows.shape[0]
    slabs = -(-n // ENCODE_SLAB_ROWS)
    padded = rows.new_zeros((slabs * ENCODE_SLAB_ROWS, k))
    padded[:n] = rows
    out = torch.cat([slab @ weight for slab in padded.split(ENCODE_SLAB_ROWS)])
    return out[:n].reshape(*lead, weight.shape[-1])

PALLAS_IMPLS = ("pool_only", "gather_split", "fused", "auto")
PALLAS_SOFTMAX = ("auto", "materialize", "online", "two_pass")


@dataclass(frozen=True)
class Code2VecConfig:
    terminal_count: int
    path_count: int
    label_count: int
    terminal_embed_size: int = 100
    path_embed_size: int = 100
    encode_size: int = 300
    dropout_prob: float = 0.25
    angular_margin_loss: bool = False
    angular_margin: float = 0.5
    inverse_temp: float = 30.0
    dtype: torch.dtype = torch.float32  # compute dtype: float32 or bfloat16
    # the kernel routes of the forward (the JAX names are kept): "pool_only"
    # (K1), "gather_split" (K2), "fused" (K3), or "auto" (the schedule cache's)
    use_pallas: bool = False
    pallas_impl: str = "pool_only"
    # the streamed softmax's bag chunk on the CPU (JAX parity); the CUDA
    # kernels stream 32 contexts a step and refuse a value other than 128
    pallas_chunk_l: int = DEFAULT_CHUNK_L
    # bag-softmax numerics of the fused kernel: "materialize" (K3),
    # "online" / "two_pass" (K4, streamed), or "auto": materialize at widths
    # <= longbag_width (everywhere when it is 0), online above it
    pallas_softmax: str = "auto"
    # widths STRICTLY ABOVE this are long-bag shapes (0 = none): a kernel
    # forward there is forced to the fused kernel with a streamed softmax
    longbag_width: int = 0
    # embedding-table storage for the gathers: "f32" | "bf16" | "int8"
    table_dtype: str = "f32"
    attn_impl: str = "xla"  # "xla" | "streaming": the plain pool's formulation
    encoder_impl: str = "concat"  # "concat" | "split": the plain encode's formulation
    vocab_pad_multiple: int = 1
    # the tables' backward on the plain and pool_only routes (ops/embed.py):
    # "dense" | "segment" | "segment_sorted"
    embed_grad: str = "dense"

    def with_updates(self, **kw) -> "Code2VecConfig":
        return replace(self, **kw)

    def padded(self, count: int) -> int:
        m = max(self.vocab_pad_multiple, 1)
        return -(-count // m) * m


def route_config(config: Code2VecConfig, schedule) -> Code2VecConfig:
    """``config`` on the fixed route a schedule names (an
    ``ops.autotune.KernelSchedule``): ``xla`` is the plain forward, any
    other impl that kernel route with the schedule's softmax."""
    if schedule.impl == "xla":
        return config.with_updates(use_pallas=False)
    return config.with_updates(use_pallas=True, pallas_impl=schedule.impl,
                               pallas_softmax=schedule.softmax)


class Code2Vec(nn.Module):
    """``forward`` returns ``(logits, code_vector, attention)``; the margin
    head uses ``labels`` to place the training margin and serves plain
    scaled-cosine logits without them."""

    # what the train step and the loop ask of a model (models/code2seq.Code2Seq
    # answers otherwise): the steps apply the head's NLL under the process's
    # own precision settings; torch Adam at a fixed rate; the loop writes the
    # code-vector outputs (the serving meta, code2vec.model, the vector
    # export, print_sample) and the closed-form costs
    owns_loss = False
    step_scope = staticmethod(contextlib.nullcontext)
    nesterov_momentum = None
    epoch_lr_decay = 1.0
    code_vectors = True

    def __init__(self, config: Code2VecConfig) -> None:
        super().__init__()
        c = config
        if c.table_dtype not in TABLE_DTYPES:
            raise ValueError(
                f"unknown table_dtype {c.table_dtype!r}: expected one of {TABLE_DTYPES}"
            )
        if c.use_pallas and c.pallas_impl not in PALLAS_IMPLS:
            raise ValueError(
                f"unknown pallas_impl {c.pallas_impl!r}: expected one of {PALLAS_IMPLS}"
            )
        if c.dtype not in COMPUTE_DTYPES:
            raise ValueError(f"unknown compute dtype {c.dtype}: expected one of {COMPUTE_DTYPES}")
        if c.pallas_softmax not in PALLAS_SOFTMAX:
            raise ValueError(
                f"unknown pallas_softmax {c.pallas_softmax!r}: expected one of {PALLAS_SOFTMAX}"
            )
        if c.embed_grad not in GRAD_MODES:
            raise ValueError(f"unknown embed_grad {c.embed_grad!r}: expected one of {GRAD_MODES}")
        self.config = c
        in_features = 2 * c.terminal_embed_size + c.path_embed_size
        self.terminal_embedding = nn.Embedding(c.padded(c.terminal_count), c.terminal_embed_size)
        self.path_embedding = nn.Embedding(c.padded(c.path_count), c.path_embed_size)
        self.input_linear = nn.Linear(in_features, c.encode_size, bias=False)
        self.input_layer_norm = nn.LayerNorm(c.encode_size, eps=LN_EPS)
        self.attention_parameter = nn.Parameter(torch.empty(c.encode_size))
        if c.angular_margin_loss:
            self.output_linear = nn.Parameter(
                torch.empty(c.padded(c.label_count), c.encode_size)
            )
        else:
            self.output_linear = nn.Linear(c.encode_size, c.padded(c.label_count))
        self._dense_kernel_cache = None
        # pallas_impl="auto": (schedule cache, {lookup: (impl, softmax)})
        self._schedules = None
        # a mesh (parallel/shardings.shard_model): the sharded parameters'
        # specs; None on one device
        self.mesh = None
        self.shard_entries: dict[str, list] = {}
        self.dropout_seed = 0
        self._dropout_gen: torch.Generator | None = None
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Random weights with the JAX model's init families: std-normal
        tables, lecun-normal encoder and head, xavier-normal attention
        vector over the reference's [H, 1] shape, zero head bias."""
        c = self.config
        g = generator
        self.terminal_embedding.weight.normal_(generator=g)
        self.path_embedding.weight.normal_(generator=g)
        fan_in = self.input_linear.in_features
        self.input_linear.weight.normal_(std=math.sqrt(1.0 / fan_in), generator=g)
        self.input_layer_norm.weight.fill_(1.0)
        self.input_layer_norm.bias.zero_()
        self.attention_parameter.normal_(std=math.sqrt(2.0 / (c.encode_size + 1)), generator=g)
        if c.angular_margin_loss:
            rows, cols = self.output_linear.shape
            bound = math.sqrt(6.0 / (rows + cols))
            self.output_linear.uniform_(-bound, bound, generator=g)
        else:
            self.output_linear.weight.normal_(std=math.sqrt(1.0 / c.encode_size), generator=g)
            self.output_linear.bias.zero_()

    def seed_dropout(self, seed: int) -> None:
        """Reseed the dropout generator: the next training forward starts
        the keep-mask stream of ``seed`` on the input's device."""
        self.dropout_seed = int(seed)
        self._dropout_gen = None

    def dropout_generator(self, device: torch.device) -> torch.Generator:
        """The module's keep-mask generator on ``device`` (made from
        ``dropout_seed`` on first use there); checkpoints save its state.
        ``"cuda"`` names the current card, as ``"cuda:<index>"`` does: the
        generator is the same one."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        g = self._dropout_gen
        if g is None or g.device != device:
            g = torch.Generator(device=device)
            g.manual_seed(self.dropout_seed)
            self._dropout_gen = g
        return g

    def _keep_mask(self, shape, device) -> torch.Tensor | None:
        """The pre-scaled keep mask of a training forward (f32, one draw on
        every route and in every compute dtype), or None."""
        p = self.config.dropout_prob
        if not (self.training and 0.0 < p < 1.0):
            return None
        keep = 1.0 - p
        mesh = self.mesh
        if mesh is None:
            m = torch.empty(shape, dtype=torch.float32, device=device)
            return m.bernoulli_(keep, generator=self.dropout_generator(device)) / keep
        # replicated like JAX's dropout key: every rank draws the global
        # batch's mask from the same state and keeps its rows and bag columns
        b, l, h = shape
        nd, nc = mesh.shape["data"], mesh.shape["ctx"]
        d, c = mesh.coords["data"], mesh.coords["ctx"]
        m = torch.empty((b * nd, l * nc, h), dtype=torch.float32, device=device)
        m.bernoulli_(keep, generator=self.dropout_generator(device))
        return m[d * b:(d + 1) * b, c * l:(c + 1) * l] / keep

    def _dense_kernel(self) -> torch.Tensor:
        """``input_linear.weight`` in the kernels' [in, out] layout. With
        gradients on, the transposed view (the backward reaches the weight);
        otherwise made contiguous once per weight version."""
        w = self.input_linear.weight
        if w.requires_grad and torch.is_grad_enabled():
            return w.t()
        key = (w.data_ptr(), w._version, w.device)
        if self._dense_kernel_cache is None or self._dense_kernel_cache[0] != key:
            self._dense_kernel_cache = (key, w.detach().t().contiguous())
        return self._dense_kernel_cache[1]

    def resolve_kernel(self, batch: int, width: int,
                       device: torch.device | None = None) -> tuple[str | None, str]:
        """``(impl, softmax_mode)`` of a forward at ``[batch, width]`` (the
        global batch on a mesh) — the JAX model's ``_resolve_kernel``.
        ``None`` impl is the plain forward, as is ``"xla"`` (a cached
        schedule under ``pallas_impl="auto"``). A long-bag width (above
        ``longbag_width``) must stream: it is forced to ``fused`` with
        ``online``, or ``two_pass`` when that was asked for or cached."""
        c = self.config
        if not c.use_pallas:
            return None, "materialize"
        longbag = bool(c.longbag_width) and width > c.longbag_width
        if c.pallas_softmax != "auto":
            softmax = c.pallas_softmax
        else:
            softmax = "online" if longbag else "materialize"
        impl = c.pallas_impl
        if impl == "auto":
            impl, softmax = self._auto_schedule(int(batch), int(width), softmax, device)
        if longbag and (impl != "fused" or softmax == "materialize"):
            if softmax == "materialize":
                softmax = "online" if c.pallas_softmax in ("auto", "materialize") \
                    else c.pallas_softmax
            return "fused", softmax
        return impl, softmax

    def _auto_schedule(self, batch: int, width: int, softmax: str,
                       device: torch.device | None) -> tuple[str, str]:
        """The cached schedule's ``(impl, softmax)`` at ``[batch, width]``,
        looked up once per shape and per process cache (a hit or a miss on
        the counters, as JAX's one lookup a traced shape); a miss is the
        configured ``pool_only`` with ``softmax``."""
        from code2vec_tpu_torch.ops.autotune import KernelSchedule, get_cache, lookup_schedule

        c = self.config
        device = torch.device(device) if device is not None else self.attention_parameter.device
        cache = get_cache()
        if self._schedules is None or self._schedules[0] is not cache:
            self._schedules = (cache, {})
        memo = self._schedules[1]
        key = (c, batch, width, device.type)
        if key not in memo:
            default = KernelSchedule(impl="pool_only", softmax=softmax, source="config")
            sched = lookup_schedule(batch, width, c.terminal_embed_size, c.path_embed_size,
                                    c.encode_size, c.table_dtype, default=default,
                                    cache=cache, device=device)
            memo[key] = (sched.impl, sched.softmax)
        return memo[key]

    def quantize_tables(self) -> tuple[QuantTable, QuantTable] | None:
        """The ``(terminal, path)`` storage of ``config.table_dtype``, or
        None for f32 — serving quantizes once at load and passes it back
        as ``quant_tables``."""
        from code2vec_tpu_torch.ops.quant import quantize_table

        dt = self.config.table_dtype
        if dt == "f32":
            return None
        with torch.no_grad():
            # a mesh's row shards are quantized whole: a quantized table is
            # gathered by global id (the eval and export forwards)
            return (quantize_table(self._whole_table(self.terminal_embedding.weight,
                                                     "terminal"), dt),
                    quantize_table(self._whole_table(self.path_embedding.weight, "path"), dt))

    def forward(
        self,
        starts: torch.Tensor,  # int [B, L]
        paths: torch.Tensor,  # int [B, L]
        ends: torch.Tensor,  # int [B, L]
        labels: torch.Tensor | None = None,  # int [B], margin head only
        quant_tables: tuple[QuantTable, QuantTable] | None = None,
        embed_offsets: tuple[torch.Tensor, torch.Tensor] | None = None,
    ):
        """``embed_offsets``: optional ``(off_se [B, 2L, Et], off_p [B, L,
        Ep])`` zeros in the compute dtype, added to the gathered rows (the
        JAX model's ``embed_offsets``). The lazy table optimizer takes the
        tables' per-slot gradients from them: with offsets the tables enter
        as constants, so no ``[vocab, dim]`` gradient is formed and their
        ``.grad`` stays None. Zeros leave the forward bit-identical. K3/K4
        gather in-kernel and cannot add them; they enter only the backward's
        recompute there (zero by contract)."""
        c = self.config
        if self.training and c.table_dtype != "f32":
            raise ValueError(
                f"table_dtype={c.table_dtype!r} is not trainable: quantized tables serve "
                "eval/predict/export forwards; training keeps f32 master weights"
            )
        if c.table_dtype == "f32":
            t_store, p_store = self.terminal_embedding.weight, self.path_embedding.weight
            if embed_offsets is not None:
                t_store, p_store = t_store.detach(), p_store.detach()
        elif quant_tables is not None:
            t_store, p_store = quant_tables
        else:
            t_store, p_store = self.quantize_tables()
        mask = (starts > 0).float()  # PAD = 0 (model/model.py:64)
        b, width = starts.shape
        if self.mesh is not None:  # the schedule of the global batch, as JAX's jit traces it
            b, width = b * self.mesh.shape["data"], width * self.mesh.shape["ctx"]
        impl, softmax_mode = self.resolve_kernel(b, width, starts.device)
        if impl == "gather_split" and self._row_sharded():
            # a mesh's row-sharded tables: K2 takes its rows from the sharded
            # gather (the model line's all-reduce)
            from code2vec_tpu_torch.ops.fused_encode_pool import encode_attend_pool_rows

            cd = c.dtype
            drop = self._keep_mask((*starts.shape, c.encode_size), starts.device)
            e_se = self._lookup(t_store, torch.cat([starts, ends], dim=1), sharded="terminal")
            e_path = self._lookup(p_store, paths, sharded="path")
            if embed_offsets is not None:
                e_se, e_path = e_se + embed_offsets[0], e_path + embed_offsets[1]
            e_start, e_end = e_se.chunk(2, dim=1)
            code_vector, attention = encode_attend_pool_rows(
                e_start, e_path, e_end, mask, self._dense_kernel(), self.input_layer_norm.weight,
                self.input_layer_norm.bias, self.attention_parameter, drop, compute_dtype=cd)
        elif impl in ("fused", "gather_split"):
            from code2vec_tpu_torch.ops.fused_encode_pool import fused_encode_attend_pool

            drop = self._keep_mask((*starts.shape, c.encode_size), starts.device)
            off_se, off_p = embed_offsets if embed_offsets is not None else (None, None)
            # a mesh's row-sharded tables reach K3 whole, all-gathered over
            # the model line (JAX's fused op declares them replicated); the
            # backward keeps this rank's rows of the table gradient
            t_store, p_store = self._whole_table(t_store, "terminal"), \
                self._whole_table(p_store, "path")
            code_vector, attention = fused_encode_attend_pool(
                t_store, p_store, starts, paths, ends, mask,
                self._dense_kernel(), self.input_layer_norm.weight,
                self.input_layer_norm.bias, self.attention_parameter, drop, off_se, off_p,
                impl=impl, chunk_l=c.pallas_chunk_l, softmax_mode=softmax_mode,
                compute_dtype=c.dtype,
            )
        else:
            code_vector, attention = self._unfused_forward(
                t_store, p_store, starts, paths, ends, mask, impl, embed_offsets
            )
        if c.angular_margin_loss:
            logits = self._angular_margin_head(code_vector, labels)
        else:
            head_in = self._head_input(code_vector)
            logits = self._gather_logits(self.output_linear(head_in))[:, : c.label_count]
        return logits, code_vector, attention

    # -- a mesh's model axis (parallel/shardings.py) ------------------------

    def _sharded(self, key: str) -> bool:
        return self.mesh is not None and "model" in (self.shard_entries.get(key) or ())

    def _row_sharded(self) -> bool:
        return self._sharded("terminal_embedding.weight") or self._sharded("path_embedding.weight")

    def _model_group(self):
        return self.mesh.group("model") if self.mesh is not None else None

    def _whole_table(self, store, which: str):
        """A row-sharded f32 table all-gathered to its global rows."""
        if not self._sharded(f"{which}_embedding.weight") or isinstance(store, QuantTable):
            return store
        from code2vec_tpu_torch.parallel.distributed import gather_from_group

        return gather_from_group(store, self._model_group(), 0)

    def _head_input(self, code_vector: torch.Tensor) -> torch.Tensor:
        """The code vector entering a column-sharded head: the identity, its
        gradient all-reduced over the model line (each rank's head columns
        give a partial one)."""
        if not self._sharded("output_linear.weight") and not self._sharded("output_linear"):
            return code_vector
        from code2vec_tpu_torch.parallel.distributed import copy_to_group

        return copy_to_group(code_vector, self._model_group())

    def _gather_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """This rank's label columns all-gathered along the label axis."""
        if not self._sharded("output_linear.weight") and not self._sharded("output_linear"):
            return logits
        from code2vec_tpu_torch.parallel.distributed import gather_from_group

        return gather_from_group(logits, self._model_group(), -1)

    def _lookup(self, store, ids: torch.Tensor, sharded: str | None = None) -> torch.Tensor:
        """Rows at ``ids`` in the compute dtype (a gather, then the cast). A
        row-sharded table (``sharded`` names it) gathers the ids in this
        rank's rows, zeros elsewhere, all-reduced over the model line with
        the identity backward: each row is one rank's value plus zeros."""
        if isinstance(store, QuantTable):
            return dequantize_rows(store, ids).to(self.config.dtype)
        if sharded is not None and self._sharded(f"{sharded}_embedding.weight"):
            from code2vec_tpu_torch.parallel.distributed import reduce_from_group

            rows = store.shape[0]
            local = ids - self.mesh.coords["model"] * rows
            inside = (local >= 0) & (local < rows)
            got = embedding_lookup(store, torch.where(inside, local, 0), self.config.embed_grad)
            got = torch.where(inside[..., None], got, 0.0)
            return reduce_from_group(got, self._model_group()).to(self.config.dtype)
        return embedding_lookup(store, ids, self.config.embed_grad).to(self.config.dtype)

    def _unfused_forward(self, t_store, p_store, starts, paths, ends, mask, impl,
                         embed_offsets=None):
        """Plain gather + encode; the pool is K1 (``pool_only``) or plain.
        In the compute dtype ``cd`` as the JAX model: the encode (weight
        cast to ``cd``), LayerNorm in f32 cast back, tanh, keep mask and
        pool in ``cd``; the code vector is returned in f32. The terminal
        rows are gathered as ``[starts; ends]`` (plus ``off_se``) and split,
        as JAX ``_unfused_forward`` does."""
        c = self.config
        cd = c.dtype
        e_se = self._lookup(t_store, torch.cat([starts, ends], dim=1), sharded="terminal")
        e_path = self._lookup(p_store, paths, sharded="path")
        if embed_offsets is not None:
            e_se, e_path = e_se + embed_offsets[0], e_path + embed_offsets[1]
        e_start, e_end = e_se.chunk(2, dim=1)
        if c.encoder_impl == "split":
            kern = self._dense_kernel().to(cd)
            et, ep = e_start.shape[-1], e_path.shape[-1]
            contexts = (encode_matmul(e_start, kern[:et]) + encode_matmul(e_path, kern[et:et + ep])
                        + encode_matmul(e_end, kern[et + ep:]))
        elif c.encoder_impl == "concat":
            contexts = encode_matmul(torch.cat([e_start, e_path, e_end], dim=-1),
                                     self.input_linear.weight.to(cd).t())
        else:
            raise ValueError(
                f"unknown encoder_impl {c.encoder_impl!r}: expected 'concat' or 'split'"
            )
        contexts = torch.tanh(self.input_layer_norm(contexts.float()).to(cd))
        drop = self._keep_mask(contexts.shape, contexts.device)
        if drop is not None:
            contexts = contexts * drop.to(cd)
        attn = self.attention_parameter.to(cd)
        if self.mesh is not None and self.mesh.shape["ctx"] > 1:
            # a ctx-sharded bag: the streaming pool over the ctx line (plain
            # route only, as in JAX: build_mesh rejects use_pallas with it)
            from code2vec_tpu_torch.parallel.context import context_parallel_attention_pool

            code_vector, attention = context_parallel_attention_pool(self.mesh, contexts, mask,
                                                                     attn)
        elif impl == "pool_only":
            from code2vec_tpu_torch.ops.pool_kernel import attention_pool_kernel

            code_vector, attention = attention_pool_kernel(contexts, mask, attn)
        elif c.attn_impl == "streaming":
            code_vector, attention = streaming_attention_pool(contexts, mask, attn)
        elif c.attn_impl == "xla":
            code_vector, attention = attention_pool(contexts, mask, attn)
        else:
            raise ValueError(
                f"unknown attn_impl {c.attn_impl!r}: expected 'xla' or 'streaming'"
            )
        return code_vector.float(), attention

    def _angular_margin_head(self, code_vector, labels):
        """ArcFace-style head (model/model.py:71-80). Norms get ``+1e-12``
        (not ``F.normalize``, which clamps); ``labels=None`` serves the
        scaled cosine."""
        c = self.config
        weight = self.output_linear
        code_vector = self._head_input(code_vector)
        ncv = code_vector / (code_vector.norm(dim=-1, keepdim=True) + 1e-12)
        nw = weight / (weight.norm(dim=-1, keepdim=True) + 1e-12)
        cosine = self._gather_logits(ncv @ nw.t())[:, : c.label_count]
        if labels is None:
            return cosine * c.inverse_temp
        sine = torch.sqrt(torch.clamp(1.0 - cosine**2, 0.0, 1.0))
        phi = cosine * math.cos(c.angular_margin) - sine * math.sin(c.angular_margin)
        phi = torch.where(cosine > 0, phi, cosine)
        one_hot = F.one_hot(labels.long(), c.label_count).to(cosine.dtype)
        return (one_hot * phi + (1.0 - one_hot) * cosine) * c.inverse_temp
