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
  first, then re-gathers and re-encodes every chunk against it. On the card
  each batch row gets a fixed number of CTAs (:func:`stream_ctas`), so the
  workspace is O(B * S * H) at any bag length.

:func:`reference_forward` is the plain version of the whole op (the
counterpart of ``xla_reference_forward``) and of K2/K3;
:func:`streamed_reference_forward` is the plain version of K4, the same
recurrence in PyTorch, ``chunk_l`` contexts at a time.
:func:`fused_encode_attend_pool` launches the kernel for CUDA tensors and
runs the plain version for CPU tensors. ``chunk_l`` (the TPU's lane tile)
is the plain version's chunk: the CUDA kernels stream in steps of 32
contexts and refuse a ``chunk_l`` other than the default; the result differs only by
rounding. Forward only, f32 compute: the backward, bf16
compute, the dropout keep mask and the ``off_se``/``off_p`` offsets come
with the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from code2vec_tpu_torch.ops import _build
from code2vec_tpu_torch.ops.attention import NINF, attention_pool
from code2vec_tpu_torch.ops.backend import count_launch, resolve
from code2vec_tpu_torch.ops.pool_kernel import CHUNK, partials_workspace
from code2vec_tpu_torch.ops.quant import QuantTable

FUSED_IMPLS = ("fused", "gather_split")
SOFTMAX_MODES = ("materialize", "online", "two_pass")
LN_EPS = 1e-6  # flax nn.LayerNorm default (fused_encode_pool.py:84)
DEFAULT_CHUNK_L = 128  # the TPU kernel's bag-chunk lane tile
_TABLE_CODES = {"f32": 0, "bf16": 1, "int8": 2}
_STREAM_MODES = {"online": 0, "two_pass": 1}


def kernel_name(impl: str, table_dtype: str, softmax_mode: str = "materialize") -> str:
    """The launch-count key of one kernel: ``gather_split`` (K2),
    ``fused_<table dtype>`` (K3) or ``<online|two_pass>_<table dtype>`` (K4)."""
    if impl == "gather_split":
        return "gather_split"
    if softmax_mode != "materialize":
        return f"{softmax_mode}_{table_dtype}"
    return f"fused_{table_dtype}"


def stream_ctas(b: int, l: int, sm_count: int) -> int:
    """K4's CTAs per batch row: about two waves of the card's SMs over the
    batch, never more than the bag's 32-context chunks. It depends on B and
    the card, not on L beyond that cap, so the workspace is bounded."""
    chunks = -(-l // CHUNK)
    return max(1, min(chunks, -(-2 * sm_count // max(b, 1))))


def split_table(table) -> tuple[torch.Tensor, torch.Tensor | None, str]:
    if isinstance(table, QuantTable):
        return table.values, table.scale, table.table_dtype
    return table, None, "f32"


def gather_rows(table, ids: torch.Tensor) -> torch.Tensor:
    """Rows of an f32 master table or a QuantTable at ``ids``, as f32."""
    vals, scale, _ = split_table(table)
    rows = vals[ids].float()
    if scale is not None:
        rows = rows * scale[ids]
    return rows


def encode_contexts(gs, gp, ge, dense_kernel, ln_scale, ln_bias) -> torch.Tensor:
    """Split-encode + LayerNorm + tanh over gathered rows — the plain
    encode (``xla_encode_contexts``): ``[s|p|e] @ W`` as three sliced
    matmuls on the same kernel."""
    et, ep = gs.shape[-1], gp.shape[-1]
    kern = dense_kernel.float()
    x = gs @ kern[:et] + gp @ kern[et:et + ep] + ge @ kern[et + ep:]
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    xn = (x - mu) * torch.rsqrt(var + LN_EPS)
    return torch.tanh(xn * ln_scale.float() + ln_bias.float())


def encode_pool_reference(gs, gp, ge, mask, dense_kernel, ln_scale, ln_bias,
                          attn_param) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K2: encode then pool over gathered rows."""
    enc = encode_contexts(gs, gp, ge, dense_kernel, ln_scale, ln_bias)
    cv, w = attention_pool(enc, mask.float(), attn_param.float())
    return cv.float(), w


def reference_forward(t_table, p_table, starts, paths, ends, mask, dense_kernel,
                      ln_scale, ln_bias, attn_param):
    """The plain version of K3 (and of the whole op): gather, encode,
    pool — ``(cv [B, H] f32, weights [B, L] f32)``."""
    return encode_pool_reference(
        gather_rows(t_table, starts), gather_rows(p_table, paths),
        gather_rows(t_table, ends), mask, dense_kernel, ln_scale, ln_bias,
        attn_param,
    )


def streamed_reference_forward(t_table, p_table, starts, paths, ends, mask, dense_kernel,
                               ln_scale, ln_bias, attn_param, *, softmax_mode: str = "online",
                               chunk_l: int = DEFAULT_CHUNK_L):
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
        return encode_contexts(
            gather_rows(t_table, starts[:, lo:hi]), gather_rows(p_table, paths[:, lo:hi]),
            gather_rows(t_table, ends[:, lo:hi]), dense_kernel, ln_scale, ln_bias,
        )

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
            scale = torch.exp(m - m_new)
            e = torch.exp(masked - m_new)
            d = d * scale + e.sum(-1, keepdim=True)
            acc = acc * scale + (e[:, :, None] * enc).sum(1)
            m = m_new
    else:
        for lo, hi in chunks:
            masked = scores(encode(lo, hi), lo, hi)
            w[:, lo:hi] = masked
            m = torch.maximum(m, masked.max(dim=-1, keepdim=True).values)
        d = torch.exp(w - m).sum(-1, keepdim=True)
        for lo, hi in chunks:
            e = torch.exp(w[:, lo:hi] - m)
            acc = acc + (e[:, :, None] * encode(lo, hi)).sum(1)
    return acc / d, torch.exp(w - m) / d


def _lib():
    lib = _build.load("fused_encode_pool")
    if lib.c2v_encode_pool_gathered.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.c2v_encode_pool_gathered.argtypes = [p] * 11 + [i] * 5 + [p]
        lib.c2v_encode_pool_gathered.restype = i
        lib.c2v_encode_pool_fused.argtypes = (
            [i, p, p, p, p, ctypes.c_longlong, ctypes.c_longlong]
            + [p] * 11 + [i] * 5 + [p]
        )
        lib.c2v_encode_pool_fused.restype = i
        lib.c2v_encode_pool_stream.argtypes = (
            [i, i, p, p, p, p, ctypes.c_longlong, ctypes.c_longlong]
            + [p] * 12 + [i] * 6 + [p]
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


def _launch(impl, softmax_mode, t_table, p_table, starts, paths, ends, mask, dense_kernel,
            ln_scale, ln_bias, attn_param):
    t_vals, t_scale, table_dtype = split_table(t_table)
    p_vals, p_scale, _ = split_table(p_table)
    dev = starts.device
    b, l = starts.shape
    et, ep = t_vals.shape[1], p_vals.shape[1]
    h = dense_kernel.shape[-1]
    if b < 1 or l < 1:
        raise ValueError(f"encode-pool kernel: empty batch or bag, ids {(b, l)}")
    f32 = torch.float32
    kern = _check("dense_kernel", dense_kernel, f32, (2 * et + ep, h), dev)
    if kern.data_ptr() % 16:  # the kernel reads W as float4
        kern = kern.clone()
    params = [
        _check("mask", mask, f32, (b, l), dev),
        kern,
        _check("ln_scale", ln_scale, f32, (h,), dev),
        _check("ln_bias", ln_bias, f32, (h,), dev),
        _check("attn_param", attn_param, f32, (h,), dev),
    ]
    cv = torch.empty((b, h), dtype=f32, device=dev)
    w = torch.empty((b, l), dtype=f32, device=dev)
    outs = [cv, w]
    lib = _lib()
    name = kernel_name(impl, table_dtype, softmax_mode)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if impl == "gather_split":
            part = partials_workspace(b, l, h, dev)
            rows = [
                _check("g_start", gather_rows(t_table, starts), f32, (b, l, et), dev),
                _check("g_path", gather_rows(p_table, paths), f32, (b, l, ep), dev),
                _check("g_end", gather_rows(t_table, ends), f32, (b, l, et), dev),
            ]
            code = lib.c2v_encode_pool_gathered(
                *(t.data_ptr() for t in rows + params + outs),
                None if part is None else part.data_ptr(), b, l, et, ep, h, stream,
            )
        else:
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
            ptrs = [t.data_ptr() for t in ids + params + outs]
            if softmax_mode == "materialize":
                part = partials_workspace(b, l, h, dev)
                code = lib.c2v_encode_pool_fused(
                    *tables, *ptrs, None if part is None else part.data_ptr(),
                    b, l, et, ep, h, stream,
                )
            else:
                n_ctas = stream_ctas(b, l, torch.cuda.get_device_properties(dev).multi_processor_count)
                part = (torch.empty((b, n_ctas, h + 2), dtype=f32, device=dev)
                        if n_ctas > 1 else None)
                rowmax = (torch.empty((b, n_ctas), dtype=f32, device=dev)
                          if softmax_mode == "two_pass" else None)
                code = lib.c2v_encode_pool_stream(
                    _STREAM_MODES[softmax_mode], *tables, *ptrs,
                    None if part is None else part.data_ptr(),
                    None if rowmax is None else rowmax.data_ptr(),
                    b, l, et, ep, h, n_ctas, stream,
                )
    _build.check(lib, code, f"encode-pool kernel launch ({name})")
    count_launch(name)
    return cv, w


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
    *,
    impl: str = "fused",
    chunk_l: int = DEFAULT_CHUNK_L,
    softmax_mode: str = "materialize",
    backend: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The whole aggregation chain: ``(code_vector [B, H] f32, attention
    [B, L] f32)``. CUDA tensors launch K2 (``gather_split``), K3 (``fused``)
    or, with a chunked ``softmax_mode``, K4; CPU tensors run
    :func:`reference_forward` (materialize) or
    :func:`streamed_reference_forward` (``online``/``two_pass``).

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
    t_dtype = split_table(t_table)[2]
    p_dtype = split_table(p_table)[2]
    if t_dtype != p_dtype:
        raise ValueError(
            f"terminal/path tables must share a storage dtype, got "
            f"{t_dtype!r} vs {p_dtype!r}"
        )
    args = (t_table, p_table, starts, paths, ends, mask, dense_kernel,
            ln_scale, ln_bias, attn_param)
    if resolve(starts, backend) == "cpu":
        if softmax_mode == "materialize":
            return reference_forward(*args)
        return streamed_reference_forward(*args, softmax_mode=softmax_mode, chunk_l=chunk_l)
    if int(chunk_l) != DEFAULT_CHUNK_L:
        raise ValueError(
            f"chunk_l={chunk_l} sets the CPU plain version's chunk only; the CUDA "
            f"kernels stream {CHUNK} contexts a step (leave chunk_l at {DEFAULT_CHUNK_L})"
        )
    return _launch(impl, softmax_mode, *args)
