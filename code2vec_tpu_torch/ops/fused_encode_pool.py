"""K2/K3: gather -> encode -> attend -> pool as one hand-written Hopper kernel.

Counterpart of ``code2vec_tpu/ops/fused_encode_pool.py``. The whole
code2vec aggregation chain for a bag of path-contexts:

    x   = [start | path | end] rows      (two table gathers; end rows from
                                          the TERMINAL table)
    y   = x @ dense_kernel               ([2Et+Ep, H], JAX's in->out layout)
    enc = tanh(LayerNorm(y))             (eps 1e-6, biased variance)
    cv, w = masked attention pool of enc (ops/attention.py semantics)

Two kernels, one CUDA source (``csrc/fused_encode_pool.cu``):

- ``impl="gather_split"`` (K2): the rows are gathered and dequantized by
  PyTorch before the kernel; the kernel fuses encode->attend->pool;
- ``impl="fused"`` (K3): the kernel gathers the rows itself, by id, from
  an f32, bf16 or int8(+per-row scale) table, dequantizing on load — the
  gathered rows and encoded contexts never reach device memory.

:func:`reference_forward` is the plain version of both (the counterpart
of ``xla_reference_forward``). :func:`fused_encode_attend_pool` launches
the kernel for CUDA tensors and runs the plain version for CPU tensors.
Forward only, f32 compute: the backward, bf16 compute, the dropout keep
mask and the ``off_se``/``off_p`` offsets come with the training slice;
the streamed long-bag modes (K4) with the next serving slice.
"""

from __future__ import annotations

import ctypes

import torch

from code2vec_tpu_torch.ops import _build
from code2vec_tpu_torch.ops.attention import attention_pool
from code2vec_tpu_torch.ops.backend import count_launch, resolve
from code2vec_tpu_torch.ops.pool_kernel import partials_workspace
from code2vec_tpu_torch.ops.quant import QuantTable

FUSED_IMPLS = ("fused", "gather_split")
LN_EPS = 1e-6  # flax nn.LayerNorm default (fused_encode_pool.py:84)
_TABLE_CODES = {"f32": 0, "bf16": 1, "int8": 2}


def kernel_name(impl: str, table_dtype: str) -> str:
    """The launch-count key of one kernel: ``gather_split`` (K2) or
    ``fused_<table dtype>`` (K3)."""
    return "gather_split" if impl == "gather_split" else f"fused_{table_dtype}"


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
    return lib


def _check(name: str, t: torch.Tensor, dtype, shape, dev) -> torch.Tensor:
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"encode-pool kernel: {name} must be {dtype} {tuple(shape)} on "
            f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    return t.contiguous()


def _launch(impl, t_table, p_table, starts, paths, ends, mask, dense_kernel,
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
    part = partials_workspace(b, l, h, dev)
    outs = [cv, w]
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if impl == "gather_split":
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
            code = lib.c2v_encode_pool_fused(
                _TABLE_CODES[table_dtype], tv.data_ptr(),
                ts.data_ptr() if ts is not None else None, pv.data_ptr(),
                ps.data_ptr() if ps is not None else None,
                tv.shape[0], pv.shape[0],
                *(t.data_ptr() for t in ids + params + outs),
                None if part is None else part.data_ptr(), b, l, et, ep, h, stream,
            )
    _build.check(lib, code, f"encode-pool kernel launch ({impl}, {table_dtype})")
    count_launch(kernel_name(impl, table_dtype))
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
    backend: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The whole aggregation chain: ``(code_vector [B, H] f32, attention
    [B, L] f32)``. CUDA tensors launch K2 (``gather_split``) or K3
    (``fused``); CPU tensors run :func:`reference_forward`."""
    if impl not in FUSED_IMPLS:
        raise ValueError(f"impl must be one of {FUSED_IMPLS}, got {impl!r}")
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
        return reference_forward(*args)
    return _launch(impl, *args)
