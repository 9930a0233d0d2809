"""K2/K3/K4: gather -> encode -> attend -> pool as hand-written Hopper kernels.

Counterpart of ``code2vec_tpu/ops/fused_encode_pool.py``. The whole
code2vec aggregation chain for a bag of path-contexts:

    x   = [start | path | end] rows      (two table gathers; end rows from
                                          the TERMINAL table)
    y   = x @ dense_kernel               ([2Et+Ep, H], JAX's in->out layout)
    enc = tanh(LayerNorm(y))             (eps 1e-6, biased variance)
    cv, w = masked attention pool of enc (ops/attention.py semantics)

Three kernels, one CUDA source (``csrc/fused_encode_pool.cu``):

- ``impl="gather_split"`` (K2): the rows are gathered and dequantized by
  PyTorch before the kernel; the kernel fuses encode->attend->pool;
- ``impl="fused"`` (K3): the kernel gathers the rows itself, by id, from
  an f32, bf16 or int8(+per-row scale) table, dequantizing on load — the
  gathered rows and encoded contexts never reach device memory;
- ``impl="fused"`` with ``softmax_mode="online"`` or ``"two_pass"`` (K4):
  the same chain with the bag softmax streamed chunk by chunk, as the TPU
  kernel does for long bags. ``online`` carries a running max, a rescaled
  denominator and a rescaled weighted sum; ``two_pass`` finds the row max
  first, then re-gathers and re-encodes every chunk against it.

On the card all three run one kernel grid: each batch row gets
:func:`stream_ctas` CTAs, each chunk of 32 contexts leaves its own softmax
partial (workspace ``[B, ceil(L / 32), H + 2]``) and a combine kernel
merges a row's partials in chunk order, so a row's result is bitwise the
same whatever S, and so whatever micro-batch the row rides in (the
hot-swap gate's invariant, ``serve/swap.py``).

:func:`reference_forward` is the plain version of the whole op (the
counterpart of ``xla_reference_forward``) and of K2/K3;
:func:`streamed_reference_forward` is the plain version of K4, the same
recurrence in PyTorch, ``chunk_l`` contexts at a time.
:func:`fused_encode_attend_pool` launches the kernel for CUDA tensors and
runs the plain version for CPU tensors. ``chunk_l`` (the TPU's lane tile)
is the plain version's chunk: the CUDA kernels step through a bag 32
contexts at a time (rows gathered with ``cp.async`` while the chunk before
is encoded on the tensor cores, in a 3xTF32 split that keeps f32 accuracy)
and refuse a ``chunk_l`` other than the default;
the result differs only by rounding.

Training: ``drop_mask`` (f32 ``[B, L, H]``, the dropout keep mask
pre-scaled by 1/keep, as the JAX op takes it) multiplies each encoded
context after tanh and before its score, inside K2, K3 and K4 (online, and
both passes of two_pass: pass A scores the masked rows, pass B sums the
same masked rows) and in every plain version. The backward is the JAX
op's ``_op_bwd``: :class:`_EncodePool` saves only the primal inputs and
its backward recomputes :func:`reference_forward` under autograd, giving
the gradients of ``dense_kernel``, ``ln_scale``, ``ln_bias``,
``attn_param`` and, for f32 tables, both tables. Like the JAX one it is
not a kernel.

The lazy table optimizer's zero offsets (``off_se`` ``[B, 2L, Et]``,
``off_p`` ``[B, L, Ep]``, in the compute dtype; JAX ``:740-760``) are added
to the gathered rows before K2 (``gather_split``) and after the gather of
the backward's recompute, which differentiates them. K3/K4 gather in-kernel
and cannot add them: they are zero by contract there and enter only the
backward. With the tables detached (no ``needs_input_grad``) the recompute
forms no table gradient.

``compute_dtype=torch.bfloat16`` (the model's bf16 compute, JAX
``static.compute``): ``gather_split`` gathers the rows in bf16 and K2 reads
them as they are, widening them in the kernel to the f32 encode (the JAX
split kernel does the same); ``fused`` is unchanged (K3/K4 gather f32 rows,
as the TPU kernel does). The backward recomputes :func:`reference_forward`
in bf16, as ``_xla_reference`` does: rows, ``W``, the matmuls, tanh, the
keep mask and the pool in bf16, LayerNorm and the softmax in f32.
"""

from __future__ import annotations

import ctypes

import torch

from code2vec_tpu_torch.analysis.contracts import shape_contract, spec
from code2vec_tpu_torch.ops import _build
from code2vec_tpu_torch.ops.attention import NINF, attention_pool, elementwise
from code2vec_tpu_torch.ops.backend import count_launch, resolve
from code2vec_tpu_torch.ops.embed import embedding_lookup
from code2vec_tpu_torch.ops.quant import QuantTable

FUSED_IMPLS = ("fused", "gather_split")
SOFTMAX_MODES = ("materialize", "online", "two_pass")
LN_EPS = 1e-6  # flax nn.LayerNorm default (fused_encode_pool.py:84)
DEFAULT_CHUNK_L = 128  # the TPU kernel's bag-chunk lane tile
CHUNK = 32  # contexts per chunk step, kChunk in csrc/pool.cuh
_TABLE_CODES = {"f32": 0, "bf16": 1, "int8": 2}
# K2's gathered rows: the compute dtype -> the row dtype code of its C entry
_ROW_CODES = {torch.float32: 0, torch.bfloat16: 1}
COMPUTE_DTYPES = tuple(_ROW_CODES)
_STREAM_MODES = {"online": 0, "two_pass": 1}


def kernel_name(impl: str, table_dtype: str, softmax_mode: str = "materialize",
                masked: bool = False, compute_dtype: torch.dtype = torch.float32) -> str:
    """The launch-count key of one kernel: ``gather_split`` (K2, f32 rows)
    or ``gather_split_bf16`` (K2 over bf16 rows), ``fused_<table dtype>``
    (K3) or ``<online|two_pass>_<table dtype>`` (K4), with ``_masked`` when
    it applied a dropout keep mask (training)."""
    if impl == "gather_split":
        name = "gather_split" + ("_bf16" if compute_dtype == torch.bfloat16 else "")
    elif softmax_mode != "materialize":
        name = f"{softmax_mode}_{table_dtype}"
    else:
        name = f"fused_{table_dtype}"
    return name + "_masked" if masked else name


def stream_ctas(b: int, l: int, sm_count: int) -> int:
    """K2/K3/K4's CTAs per batch row: one wave of the card over the batch
    (a CTA holds W and two row buffers, ~219 KB of shared memory at the
    top11 widths, so one fits on an SM), never more than the bag's chunks.
    The kernels take S from here alone; S decides only which CTA encodes
    which chunk, never the order in which a row's chunk partials merge."""
    chunks = -(-l // CHUNK)
    return max(1, min(chunks, sm_count // max(b, 1)))


def split_table(table) -> tuple[torch.Tensor, torch.Tensor | None, str]:
    if isinstance(table, QuantTable):
        return table.values, table.scale, table.table_dtype
    return table, None, "f32"


def gather_rows(table, ids: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Rows of an f32 master table (``embedding_lookup``, whose backward
    the recompute differentiates) or a QuantTable at ``ids``, dequantized
    in f32 and cast to ``dtype`` (JAX ``_gather_rows``)."""
    vals, scale, _ = split_table(table)
    if scale is None and vals.dtype == torch.float32:
        return embedding_lookup(vals, ids).to(dtype)
    rows = vals[ids].float()
    if scale is not None:
        rows = rows * scale[ids]
    return rows.to(dtype)


def encode_contexts(gs, gp, ge, dense_kernel, ln_scale, ln_bias,
                    compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Split-encode + LayerNorm + tanh over gathered rows — the plain
    encode (``xla_encode_contexts``): ``[s|p|e] @ W`` as three sliced
    matmuls on the same kernel, in ``compute_dtype`` (rows and ``W`` cast
    to it), LayerNorm in f32, tanh in ``compute_dtype``."""
    cd = compute_dtype
    et, ep = gs.shape[-1], gp.shape[-1]
    kern = dense_kernel.to(cd)
    x = gs.to(cd) @ kern[:et] + gp.to(cd) @ kern[et:et + ep] + ge.to(cd) @ kern[et + ep:]
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    xn = (x - mu) * torch.rsqrt(var + LN_EPS)
    return torch.tanh((xn * ln_scale.float() + ln_bias.float()).to(cd))


def encode_pool_reference(gs, gp, ge, mask, dense_kernel, ln_scale, ln_bias,
                          attn_param, drop_mask=None,
                          compute_dtype: torch.dtype = torch.float32):
    """The plain version of K2: encode (times the keep mask) then pool
    over gathered rows, in ``compute_dtype`` (JAX ``_xla_reference`` after
    its gather); f32 rows or bf16 rows widened: ``(cv [B, H] f32,
    weights [B, L] f32)``."""
    cd = compute_dtype
    enc = encode_contexts(gs, gp, ge, dense_kernel, ln_scale, ln_bias, cd)
    if drop_mask is not None:
        enc = enc * drop_mask.to(cd)
    cv, w = attention_pool(enc, mask.float(), attn_param.to(cd))
    return cv.float(), w


def gathered_rows(t_table, p_table, starts, paths, ends, off_se=None, off_p=None,
                  dtype: torch.dtype = torch.float32):
    """The start, path and end rows in ``dtype``, plus the lazy optimizer's
    offsets, ``off_se`` split into its starts and ends halves (JAX
    ``_xla_reference``)."""
    rows = [gather_rows(t_table, starts, dtype), gather_rows(p_table, paths, dtype),
            gather_rows(t_table, ends, dtype)]
    if off_se is None:
        return rows
    o_s, o_e = off_se.chunk(2, dim=1)
    return rows[0] + o_s, rows[1] + off_p, rows[2] + o_e


def reference_forward(t_table, p_table, starts, paths, ends, mask, dense_kernel,
                      ln_scale, ln_bias, attn_param, drop_mask=None, off_se=None, off_p=None,
                      compute_dtype: torch.dtype = torch.float32):
    """The plain version of K3 (and of the whole op): gather (plus the
    offsets), encode, keep mask, pool in ``compute_dtype`` — ``(cv [B, H]
    f32, weights [B, L] f32)``. In bf16 it is what the backward
    differentiates (JAX ``_xla_reference``)."""
    cd = compute_dtype
    return encode_pool_reference(
        *gathered_rows(t_table, p_table, starts, paths, ends, off_se, off_p, cd), mask,
        dense_kernel, ln_scale, ln_bias, attn_param, drop_mask, cd,
    )


def split_reference_forward(t_table, p_table, starts, paths, ends, mask, dense_kernel,
                            ln_scale, ln_bias, attn_param, drop_mask=None, off_se=None,
                            off_p=None, compute_dtype: torch.dtype = torch.float32):
    """The plain version of K2 under ``compute_dtype``: the rows gathered
    in it (plus the offsets), then the f32 encode and pool on them widened,
    as the JAX split kernel computes (and its compiled CPU strategy,
    ``_compiled_chain_forward``). Equal to :func:`reference_forward` for
    f32."""
    return encode_pool_reference(
        *gathered_rows(t_table, p_table, starts, paths, ends, off_se, off_p, compute_dtype),
        mask, dense_kernel, ln_scale, ln_bias, attn_param, drop_mask,
    )


def streamed_reference_forward(t_table, p_table, starts, paths, ends, mask, dense_kernel,
                               ln_scale, ln_bias, attn_param, drop_mask=None, *,
                               softmax_mode: str = "online", chunk_l: int = DEFAULT_CHUNK_L):
    """The plain version of K4: the TPU kernel's streamed recurrence
    (``fused_encode_pool.py:389-442``) in PyTorch, ``chunk_l`` contexts at a
    time. Each chunk is gathered, encoded and scored; its masked scores go
    to ``w`` and the chunk's encoded rows are dropped after the fold.

    - ``online``: ``m' = max(m, max s)``, ``d = d e^(m-m') + sum e^(s-m')``,
      ``acc = acc e^(m-m') + sum e^(s-m') enc``;
    - ``two_pass``: pass A stores every score and the row max ``m``,
      ``d = sum e^(w-m)``; pass B re-gathers and re-encodes each chunk and
      sums ``e^(w-m) enc`` with no rescaling.

    Finally ``w = e^(w-m) / d`` and ``cv = acc / d``."""
    if softmax_mode not in _STREAM_MODES:
        raise ValueError(f"softmax_mode must be 'online' or 'two_pass', got {softmax_mode!r}")
    if int(chunk_l) < 1:
        raise ValueError(f"chunk_l must be >= 1, got {chunk_l}")
    b, l = starts.shape
    h = dense_kernel.shape[-1]
    dev = starts.device
    attn = attn_param.float()
    maskf = mask.float()

    def encode(lo, hi):
        enc = encode_contexts(
            gather_rows(t_table, starts[:, lo:hi]), gather_rows(p_table, paths[:, lo:hi]),
            gather_rows(t_table, ends[:, lo:hi]), dense_kernel, ln_scale, ln_bias,
        )
        return enc if drop_mask is None else enc * drop_mask[:, lo:hi].float()

    def scores(enc, lo, hi):
        msk = maskf[:, lo:hi]
        return (enc * attn).sum(-1) * msk + (1.0 - msk) * NINF

    chunks = [(lo, min(lo + int(chunk_l), l)) for lo in range(0, l, int(chunk_l))]
    w = torch.empty((b, l), dtype=torch.float32, device=dev)
    m = torch.full((b, 1), float("-inf"), dtype=torch.float32, device=dev)
    d = torch.zeros((b, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h), dtype=torch.float32, device=dev)
    if softmax_mode == "online":
        for lo, hi in chunks:
            enc = encode(lo, hi)
            masked = scores(enc, lo, hi)
            w[:, lo:hi] = masked
            m_new = torch.maximum(m, masked.max(dim=-1, keepdim=True).values)
            scale = elementwise(torch.exp, m - m_new)
            e = elementwise(torch.exp, masked - m_new)
            d = d * scale + e.sum(-1, keepdim=True)
            acc = acc * scale + (e[:, :, None] * enc).sum(1)
            m = m_new
    else:
        for lo, hi in chunks:
            masked = scores(encode(lo, hi), lo, hi)
            w[:, lo:hi] = masked
            m = torch.maximum(m, masked.max(dim=-1, keepdim=True).values)
        d = elementwise(torch.exp, w - m).sum(-1, keepdim=True)
        for lo, hi in chunks:
            e = elementwise(torch.exp, w[:, lo:hi] - m)
            acc = acc + (e[:, :, None] * encode(lo, hi)).sum(1)
    return acc / d, elementwise(torch.exp, w - m) / d


def _lib():
    lib = _build.load("fused_encode_pool")
    if lib.c2v_encode_pool_gathered.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.c2v_encode_pool_gathered.argtypes = [i] + [p] * 12 + [i] * 6 + [p]
        lib.c2v_encode_pool_gathered.restype = i
        lib.c2v_encode_pool_fused.argtypes = (
            [i, p, p, p, p, ctypes.c_longlong, ctypes.c_longlong]
            + [p] * 12 + [i] * 6 + [p]
        )
        lib.c2v_encode_pool_fused.restype = i
        lib.c2v_encode_pool_stream.argtypes = (
            [i, i, p, p, p, p, ctypes.c_longlong, ctypes.c_longlong]
            + [p] * 13 + [i] * 6 + [p]
        )
        lib.c2v_encode_pool_stream.restype = i
    return lib


def _check(name: str, t: torch.Tensor, dtype, shape, dev) -> torch.Tensor:
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"encode-pool kernel: {name} must be {dtype} {tuple(shape)} on "
            f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    return t.contiguous()


def _launch_setup(b, l, h, et, ep, mask, drop_mask, dense_kernel, ln_scale, ln_bias,
                  attn_param, dev):
    """The checked mask, keep mask and parameters, the outputs and the
    softmax-partials workspace of one launch, and its CTAs a row."""
    if b < 1 or l < 1:
        raise ValueError(f"encode-pool kernel: empty batch or bag, ids {(b, l)}")
    f32 = torch.float32
    msk = _check("mask", mask, f32, (b, l), dev)
    drop = None if drop_mask is None else _check("drop_mask", drop_mask, f32, (b, l, h), dev)
    params = [
        _check("dense_kernel", dense_kernel, f32, (2 * et + ep, h), dev),
        _check("ln_scale", ln_scale, f32, (h,), dev),
        _check("ln_bias", ln_bias, f32, (h,), dev),
        _check("attn_param", attn_param, f32, (h,), dev),
    ]
    outs = [torch.empty((b, h), dtype=f32, device=dev), torch.empty((b, l), dtype=f32, device=dev)]
    n_ctas = stream_ctas(b, l, torch.cuda.get_device_properties(dev).multi_processor_count)
    # one softmax partial a chunk, merged in chunk order: a row's bits do
    # not depend on S, so not on the micro-batch it rides in
    part = torch.empty((b, -(-l // CHUNK), h + 2), dtype=f32, device=dev)
    return msk, drop, params, outs, part, n_ctas


def _launch_gathered(gs, gp, ge, mask, dense_kernel, ln_scale, ln_bias, attn_param,
                     drop_mask=None, compute_dtype: torch.dtype = torch.float32):
    """K2 over rows gathered outside it, in ``compute_dtype``."""
    dev = gs.device
    b, l, et = gs.shape
    ep, h = gp.shape[-1], dense_kernel.shape[-1]
    msk, drop, params, outs, part, n_ctas = _launch_setup(
        b, l, h, et, ep, mask, drop_mask, dense_kernel, ln_scale, ln_bias, attn_param, dev)
    cd = compute_dtype  # f32 or bf16 (checked by the callers)
    rows = [
        _check("g_start", gs, cd, (b, l, et), dev),
        _check("g_path", gp, cd, (b, l, ep), dev),
        _check("g_end", ge, cd, (b, l, et), dev),
    ]
    lib = _lib()
    name = kernel_name("gather_split", "f32", "materialize", drop is not None, cd)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.c2v_encode_pool_gathered(
            _ROW_CODES[cd], *(t.data_ptr() for t in rows + [msk]),
            None if drop is None else drop.data_ptr(),
            *(t.data_ptr() for t in params + outs),
            part.data_ptr(), b, l, et, ep, h, n_ctas, stream,
        )
    _build.check(lib, code, f"encode-pool kernel launch ({name})")
    count_launch(name)
    return tuple(outs)


def _launch(impl, softmax_mode, compute_dtype, t_table, p_table, starts, paths, ends, mask,
            dense_kernel, ln_scale, ln_bias, attn_param, drop_mask=None, off_se=None, off_p=None):
    if impl == "gather_split":
        rows = gathered_rows(t_table, p_table, starts, paths, ends, off_se, off_p, compute_dtype)
        return _launch_gathered(*rows, mask, dense_kernel, ln_scale, ln_bias, attn_param,
                                drop_mask, compute_dtype)
    t_vals, t_scale, table_dtype = split_table(t_table)
    p_vals, p_scale, _ = split_table(p_table)
    dev = starts.device
    b, l = starts.shape
    et, ep = t_vals.shape[1], p_vals.shape[1]
    h = dense_kernel.shape[-1]
    f32 = torch.float32
    msk, drop, params, outs, part, n_ctas = _launch_setup(
        b, l, h, et, ep, mask, drop_mask, dense_kernel, ln_scale, ln_bias, attn_param, dev)
    drop_ptr = None if drop is None else drop.data_ptr()
    part_ptr = part.data_ptr()
    lib = _lib()
    name = kernel_name(impl, table_dtype, softmax_mode, drop is not None, compute_dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        store = {"f32": f32, "bf16": torch.bfloat16, "int8": torch.int8}[table_dtype]
        tv = _check("terminal table", t_vals, store, t_vals.shape, dev)
        pv = _check("path table", p_vals, store, p_vals.shape, dev)
        ts = ps = None
        if table_dtype == "int8":
            ts = _check("terminal scale", t_scale, f32, (tv.shape[0], 1), dev)
            ps = _check("path scale", p_scale, f32, (pv.shape[0], 1), dev)
        ids = [
            _check(n, x.to(torch.int32), torch.int32, (b, l), dev)
            for n, x in (("starts", starts), ("paths", paths), ("ends", ends))
        ]
        tables = (
            _TABLE_CODES[table_dtype], tv.data_ptr(),
            ts.data_ptr() if ts is not None else None, pv.data_ptr(),
            ps.data_ptr() if ps is not None else None, tv.shape[0], pv.shape[0],
        )
        ptrs = ([t.data_ptr() for t in ids + [msk]] + [drop_ptr]
                + [t.data_ptr() for t in params + outs])
        if softmax_mode == "materialize":
            code = lib.c2v_encode_pool_fused(
                *tables, *ptrs, part_ptr, b, l, et, ep, h, n_ctas, stream,
            )
        else:
            rowmax = (torch.empty((b, n_ctas), dtype=f32, device=dev)
                      if softmax_mode == "two_pass" else None)
            code = lib.c2v_encode_pool_stream(
                _STREAM_MODES[softmax_mode], *tables, *ptrs, part_ptr,
                None if rowmax is None else rowmax.data_ptr(),
                b, l, et, ep, h, n_ctas, stream,
            )
    _build.check(lib, code, f"encode-pool kernel launch ({name})")
    count_launch(name)
    return tuple(outs)


def _forward(impl, softmax_mode, chunk_l, backend, compute_dtype, args):
    """The op's value: the plain version for CPU tensors, else the kernel.
    Only ``gather_split`` adds the offsets (the last two ``args``); K3/K4
    and their plain versions gather without them, as the JAX op does."""
    if resolve(args[2], backend) == "cpu":
        if impl == "gather_split":
            return split_reference_forward(*args, compute_dtype=compute_dtype)
        if softmax_mode == "materialize":
            return reference_forward(*args[:-2])
        return streamed_reference_forward(*args[:-2], softmax_mode=softmax_mode,
                                          chunk_l=chunk_l)
    if int(chunk_l) != DEFAULT_CHUNK_L:
        raise ValueError(
            f"chunk_l={chunk_l} sets the CPU plain version's chunk only; the CUDA "
            f"kernels stream {CHUNK} contexts a step (leave chunk_l at {DEFAULT_CHUNK_L})"
        )
    if impl != "gather_split":
        args = args[:-2]
    return _launch(impl, softmax_mode, compute_dtype, *args)


# positions of the differentiable inputs in the op's argument tuple
_DIFF_ARGS = {"t_table": 0, "p_table": 1, "dense_kernel": 6, "ln_scale": 7, "ln_bias": 8,
              "attn_param": 9, "off_se": 11, "off_p": 12}


class _EncodePool(torch.autograd.Function):
    """K2/K3/K4 forward, the JAX ``_op_bwd`` backward: only the primal
    inputs are saved, and the backward differentiates the recomputed
    :func:`reference_forward` (gather, offsets, split encode, LayerNorm,
    tanh, keep mask, pool) in the compute dtype. Quantized or detached
    tables are constants (no gradient)."""

    @staticmethod
    def forward(ctx, impl, softmax_mode, chunk_l, backend, compute_dtype, *args):
        cv, w = _forward(impl, softmax_mode, chunk_l, backend, compute_dtype, args)
        ctx.compute_dtype = compute_dtype
        tensors = [a if isinstance(a, torch.Tensor) else None for a in args]
        ctx.save_for_backward(*tensors)
        ctx.constants = [None if isinstance(a, torch.Tensor) else a for a in args]
        ctx.set_materialize_grads(False)  # an unused weights output sends no g_w
        return cv, w

    @staticmethod
    def backward(ctx, g_cv, g_w):
        args = [t if t is not None else c for t, c in zip(ctx.saved_tensors, ctx.constants)]
        needs = ctx.needs_input_grad[5:]
        diff = [i for i in _DIFF_ARGS.values() if needs[i]]
        grads = _recompute_vjp(reference_forward, ctx.compute_dtype, args, diff, g_cv, g_w)
        return (None, None, None, None, None, *grads)


def _recompute_vjp(forward, compute_dtype, args, diff, g_cv, g_w) -> list:
    """The gradients of ``forward(*args)`` recomputed under autograd, at the
    cotangents given, with respect to the args at positions ``diff`` (None
    elsewhere; zeros for an input the outputs do not reach)."""
    args = list(args)
    grads = [None] * len(args)
    outs = [(o, g) for o, g in zip((0, 1), (g_cv, g_w)) if g is not None]
    if diff and outs:
        with torch.enable_grad():
            for i in diff:
                args[i] = args[i].detach().requires_grad_(True)
            values = forward(*args, compute_dtype=compute_dtype)
            got = torch.autograd.grad([values[o] for o, _ in outs], [args[i] for i in diff],
                                      [g for _, g in outs], allow_unused=True)
        for i, g in zip(diff, got):
            grads[i] = g if g is not None else torch.zeros_like(args[i])
    return grads


# K2-K4's input contract (JAX ``FUSED_CONTRACT``), checked on every call
# before the launch wrappers' own device, contiguity and width checks
FUSED_CONTRACT = {
    "starts": spec("B,L", "int"),
    "paths": spec("B,L", "int"),
    "ends": spec("B,L", "int"),
    "mask": spec("B,L"),
    "dense_kernel": spec("D,H", "float"),
    "ln_scale": spec("H", "float"),
    "ln_bias": spec("H", "float"),
    "attn_param": spec("H", "float"),
}


@shape_contract(**FUSED_CONTRACT)
def fused_encode_attend_pool(
    t_table,  # f32 [Vt, Et] master table OR ops.quant.QuantTable
    p_table,  # f32 [Vp, Ep] master table OR ops.quant.QuantTable
    starts: torch.Tensor,  # int [B, L]
    paths: torch.Tensor,  # int [B, L]
    ends: torch.Tensor,  # int [B, L]
    mask: torch.Tensor,  # [B, L] (1 = real, 0 = PAD)
    dense_kernel: torch.Tensor,  # f32 [2*Et+Ep, H] (input_dense/kernel)
    ln_scale: torch.Tensor,  # f32 [H]
    ln_bias: torch.Tensor,  # f32 [H]
    attn_param: torch.Tensor,  # f32 [H]
    drop_mask: torch.Tensor | None = None,  # f32 [B, L, H] keep mask, pre-scaled by 1/keep
    off_se: torch.Tensor | None = None,  # [B, 2L, Et] zeros in compute_dtype (lazy tables)
    off_p: torch.Tensor | None = None,  # [B, L, Ep] zeros in compute_dtype (lazy tables)
    *,
    impl: str = "fused",
    chunk_l: int = DEFAULT_CHUNK_L,
    softmax_mode: str = "materialize",
    compute_dtype: torch.dtype = torch.float32,
    backend: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The whole aggregation chain: ``(code_vector [B, H] f32, attention
    [B, L] f32)``, differentiable in the parameters, f32 tables and the
    offsets (``off_se``/``off_p`` both or neither; added to the rows by
    ``gather_split``, zero by contract on ``fused``, whose kernels gather
    in-kernel: they enter the backward only). CUDA
    tensors launch K2 (``gather_split``), K3 (``fused``) or, with a chunked
    ``softmax_mode``, K4; CPU tensors run :func:`reference_forward`
    (materialize) or :func:`streamed_reference_forward` (``online``/
    ``two_pass``). The backward recomputes :func:`reference_forward` in
    ``compute_dtype``; with bf16, ``gather_split`` hands K2 bf16 rows
    (CPU: :func:`split_reference_forward`) and ``fused`` keeps its f32
    forward.

    A chunked softmax mode requires ``impl="fused"``: ``gather_split``
    materializes the whole bag's rows before its kernel runs, so streaming
    its softmax would bound nothing (the JAX rule). ``chunk_l`` sets the
    chunk of the CPU's plain version only; the CUDA kernels stream 32
    contexts a step, so on CUDA tensors any other value raises."""
    if impl not in FUSED_IMPLS:
        raise ValueError(f"impl must be one of {FUSED_IMPLS}, got {impl!r}")
    if softmax_mode not in SOFTMAX_MODES:
        raise ValueError(f"softmax_mode must be one of {SOFTMAX_MODES}, got {softmax_mode!r}")
    if softmax_mode != "materialize" and impl != "fused":
        raise ValueError(
            f"chunked softmax ({softmax_mode!r}) requires impl='fused': {impl!r} "
            "materializes the full bag before the kernel runs"
        )
    if int(chunk_l) < 1:
        raise ValueError(f"chunk_l must be >= 1, got {chunk_l}")
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, got {compute_dtype}")
    t_dtype = split_table(t_table)[2]
    p_dtype = split_table(p_table)[2]
    if t_dtype != p_dtype:
        raise ValueError(
            f"terminal/path tables must share a storage dtype, got "
            f"{t_dtype!r} vs {p_dtype!r}"
        )
    if (off_se is None) != (off_p is None):
        raise ValueError("off_se and off_p come together (the lazy table optimizer's offsets)")
    args = (t_table, p_table, starts, paths, ends, mask, dense_kernel,
            ln_scale, ln_bias, attn_param, drop_mask, off_se, off_p)
    wants_grad = torch.is_grad_enabled() and any(
        isinstance(a, torch.Tensor) and a.requires_grad for a in args)
    if wants_grad:
        return _EncodePool.apply(impl, softmax_mode, chunk_l, backend, compute_dtype, *args)
    return _forward(impl, softmax_mode, chunk_l, backend, compute_dtype, args)


class _EncodePoolRows(torch.autograd.Function):
    """K2 over rows gathered outside the op (a mesh's row-sharded gather);
    the backward differentiates the recomputed :func:`encode_pool_reference`
    in the rows and the parameters, as :class:`_EncodePool` does."""

    @staticmethod
    def forward(ctx, compute_dtype, backend, *args):
        ctx.compute_dtype = compute_dtype
        ctx.save_for_backward(*args)
        ctx.set_materialize_grads(False)
        return _rows_forward(compute_dtype, backend, args)

    @staticmethod
    def backward(ctx, g_cv, g_w):
        diff = [i for i, need in enumerate(ctx.needs_input_grad[2:]) if need]
        grads = _recompute_vjp(encode_pool_reference, ctx.compute_dtype, ctx.saved_tensors, diff,
                               g_cv, g_w)
        return (None, None, *grads)


def _rows_forward(compute_dtype, backend, args):
    if resolve(args[0], backend) == "cpu":
        return encode_pool_reference(*args)
    return _launch_gathered(*args, compute_dtype=compute_dtype)


def encode_attend_pool_rows(gs, gp, ge, mask, dense_kernel, ln_scale, ln_bias, attn_param,
                            drop_mask=None, *, compute_dtype: torch.dtype = torch.float32,
                            backend: str | None = None):
    """``gather_split``'s chain over rows gathered by the caller (``gs``,
    ``gp``, ``ge`` ``[B, L, E]`` in ``compute_dtype``): K2 for CUDA
    tensors, :func:`encode_pool_reference` (the f32 encode and pool of the
    rows widened, ``split_reference_forward``'s numerics) for CPU tensors;
    differentiable in the rows and the parameters."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, got {compute_dtype}")
    args = (gs, gp, ge, mask, dense_kernel, ln_scale, ln_bias, attn_param)
    if drop_mask is not None:
        args += (drop_mask,)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return _EncodePoolRows.apply(compute_dtype, backend, *args)
    return _rows_forward(compute_dtype, backend, args)
