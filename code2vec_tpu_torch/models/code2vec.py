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
``fused`` (K3); without ``use_pallas`` the forward is plain PyTorch. Bag
widths above ``longbag_width`` are long-bag shapes: they are forced to the
fused kernel with a streamed softmax (K4), as the JAX model's
``_resolve_kernel`` does. On the CPU every kernel route runs its plain
version.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch
import torch.nn as nn
import torch.nn.functional as F

from code2vec_tpu_torch.ops.attention import attention_pool, streaming_attention_pool
from code2vec_tpu_torch.ops.embed import embedding_lookup
from code2vec_tpu_torch.ops.fused_encode_pool import DEFAULT_CHUNK_L, LN_EPS
from code2vec_tpu_torch.ops.quant import TABLE_DTYPES, QuantTable, dequantize_rows

PALLAS_IMPLS = ("pool_only", "gather_split", "fused")
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
    # the kernel routes of the forward (the JAX names are kept): "pool_only"
    # (K1), "gather_split" (K2), "fused" (K3)
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

    def with_updates(self, **kw) -> "Code2VecConfig":
        return replace(self, **kw)

    def padded(self, count: int) -> int:
        m = max(self.vocab_pad_multiple, 1)
        return -(-count // m) * m


class Code2Vec(nn.Module):
    """``forward`` returns ``(logits, code_vector, attention)``; the margin
    head uses ``labels`` to place the training margin and serves plain
    scaled-cosine logits without them."""

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
        if c.pallas_softmax not in PALLAS_SOFTMAX:
            raise ValueError(
                f"unknown pallas_softmax {c.pallas_softmax!r}: expected one of {PALLAS_SOFTMAX}"
            )
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

    def _dense_kernel(self) -> torch.Tensor:
        """``input_linear.weight`` in the kernels' [in, out] layout, made
        contiguous once per weight version instead of once per forward."""
        w = self.input_linear.weight
        key = (w.data_ptr(), w._version, w.device)
        if self._dense_kernel_cache is None or self._dense_kernel_cache[0] != key:
            self._dense_kernel_cache = (key, w.detach().t().contiguous())
        return self._dense_kernel_cache[1]

    def resolve_kernel(self, width: int) -> tuple[str | None, str]:
        """``(impl, softmax_mode)`` of a forward at bag ``width`` — the JAX
        model's ``_resolve_kernel`` without the autotune lookup. ``None``
        impl is the plain forward. A long-bag width (above
        ``longbag_width``) must stream: it is forced to ``fused`` with
        ``online``, or ``two_pass`` when that was asked for."""
        c = self.config
        if not c.use_pallas:
            return None, "materialize"
        longbag = bool(c.longbag_width) and width > c.longbag_width
        if c.pallas_softmax != "auto":
            softmax = c.pallas_softmax
        else:
            softmax = "online" if longbag else "materialize"
        if longbag and (c.pallas_impl != "fused" or softmax == "materialize"):
            return "fused", (softmax if softmax != "materialize" else "online")
        return c.pallas_impl, softmax

    def quantize_tables(self) -> tuple[QuantTable, QuantTable] | None:
        """The ``(terminal, path)`` storage of ``config.table_dtype``, or
        None for f32 — serving quantizes once at load and passes it back
        as ``quant_tables``."""
        from code2vec_tpu_torch.ops.quant import quantize_table

        dt = self.config.table_dtype
        if dt == "f32":
            return None
        with torch.no_grad():
            return (quantize_table(self.terminal_embedding.weight, dt),
                    quantize_table(self.path_embedding.weight, dt))

    def forward(
        self,
        starts: torch.Tensor,  # int [B, L]
        paths: torch.Tensor,  # int [B, L]
        ends: torch.Tensor,  # int [B, L]
        labels: torch.Tensor | None = None,  # int [B], margin head only
        quant_tables: tuple[QuantTable, QuantTable] | None = None,
    ):
        c = self.config
        if c.table_dtype == "f32":
            t_store, p_store = self.terminal_embedding.weight, self.path_embedding.weight
        elif quant_tables is not None:
            t_store, p_store = quant_tables
        else:
            t_store, p_store = self.quantize_tables()
        mask = (starts > 0).float()  # PAD = 0 (model/model.py:64)
        impl, softmax_mode = self.resolve_kernel(starts.shape[1])
        if impl in ("fused", "gather_split"):
            if self.training and 0.0 < c.dropout_prob < 1.0:
                raise NotImplementedError(
                    "dropout inside the encode-pool kernels comes with the "
                    "training slice; call eval() to serve"
                )
            from code2vec_tpu_torch.ops.fused_encode_pool import fused_encode_attend_pool

            code_vector, attention = fused_encode_attend_pool(
                t_store, p_store, starts, paths, ends, mask,
                self._dense_kernel(), self.input_layer_norm.weight,
                self.input_layer_norm.bias, self.attention_parameter, impl=impl,
                chunk_l=c.pallas_chunk_l, softmax_mode=softmax_mode,
            )
        else:
            code_vector, attention = self._unfused_forward(
                t_store, p_store, starts, paths, ends, mask, impl
            )
        if c.angular_margin_loss:
            logits = self._angular_margin_head(code_vector, labels)
        else:
            logits = self.output_linear(code_vector)[:, : c.label_count]
        return logits, code_vector, attention

    def _lookup(self, store, ids: torch.Tensor) -> torch.Tensor:
        if isinstance(store, QuantTable):
            return dequantize_rows(store, ids)
        return embedding_lookup(store, ids)

    def _unfused_forward(self, t_store, p_store, starts, paths, ends, mask, impl):
        """Plain gather + encode; the pool is K1 (``pool_only``) or plain."""
        c = self.config
        e_start = self._lookup(t_store, starts)
        e_path = self._lookup(p_store, paths)
        e_end = self._lookup(t_store, ends)
        if c.encoder_impl == "split":
            kern = self._dense_kernel()
            et, ep = e_start.shape[-1], e_path.shape[-1]
            contexts = e_start @ kern[:et] + e_path @ kern[et:et + ep] + e_end @ kern[et + ep:]
        elif c.encoder_impl == "concat":
            contexts = self.input_linear(torch.cat([e_start, e_path, e_end], dim=-1))
        else:
            raise ValueError(
                f"unknown encoder_impl {c.encoder_impl!r}: expected 'concat' or 'split'"
            )
        contexts = torch.tanh(self.input_layer_norm(contexts))
        if 0.0 < c.dropout_prob < 1.0:
            contexts = F.dropout(contexts, c.dropout_prob, training=self.training)
        if impl == "pool_only":
            from code2vec_tpu_torch.ops.pool_kernel import attention_pool_kernel

            return attention_pool_kernel(contexts, mask, self.attention_parameter)
        if c.attn_impl == "streaming":
            return streaming_attention_pool(contexts, mask, self.attention_parameter)
        if c.attn_impl == "xla":
            return attention_pool(contexts, mask, self.attention_parameter)
        raise ValueError(
            f"unknown attn_impl {c.attn_impl!r}: expected 'xla' or 'streaming'"
        )

    def _angular_margin_head(self, code_vector, labels):
        """ArcFace-style head (model/model.py:71-80). Norms get ``+1e-12``
        (not ``F.normalize``, which clamps); ``labels=None`` serves the
        scaled cosine."""
        c = self.config
        weight = self.output_linear
        ncv = code_vector / (code_vector.norm(dim=-1, keepdim=True) + 1e-12)
        nw = weight / (weight.norm(dim=-1, keepdim=True) + 1e-12)
        cosine = (ncv @ nw.t())[:, : c.label_count]
        if labels is None:
            return cosine * c.inverse_temp
        sine = torch.sqrt(torch.clamp(1.0 - cosine**2, 0.0, 1.0))
        phi = cosine * math.cos(c.angular_margin) - sine * math.sin(c.angular_margin)
        phi = torch.where(cosine > 0, phi, cosine)
        one_hot = F.one_hot(labels.long(), c.label_count).to(cosine.dtype)
        return (one_hot * phi + (1.0 - one_hot) * cosine) * c.inverse_temp
