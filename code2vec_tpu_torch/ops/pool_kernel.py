"""K1 and K1b: the masked attention pool and its backward as hand-written
Hopper kernels.

Counterpart of ``code2vec_tpu/ops/pallas_attention.py``
(``pallas_attention_pool``: kernel body ``_tile_pool``, backward
``_pool_bwd``): the model's ``pallas_impl="pool_only"`` route. Both
kernels are in ``csrc/pool.cu``, one launch per call: :func:`pool_ctas`
picks how many CTAs (one thread-block cluster) share a batch row of K1;
K1b streams the contexts in one pass through a persistent grid that
``csrc/pool.cu`` sizes itself (:func:`pool_bwd_grid`). The plain versions are
:func:`~code2vec_tpu_torch.ops.attention.attention_pool` on f32 inputs
and :func:`~code2vec_tpu_torch.ops.attention.pool_backward_reference`.

Contexts are f32 or bf16 (``compute_dtype="bfloat16"``), the attention
vector in the same dtype (the model casts it, as the JAX model does): the
kernels read bf16 as it is, widen it on load and do the f32 arithmetic,
as ``_tile_pool`` widens its tile and the JAX wrapper the attention vector
(``pallas_attention.py:50, 97``); K1b writes ``d_contexts`` in the
contexts' dtype (bf16 rounded to nearest even, as ``_pool_bwd`` casts).
The outputs and K1b's ``d_attn`` are f32. A CUDA tensor of another dtype,
or an attention vector in another dtype than the contexts', raises.

:func:`attention_pool_kernel` is one ``torch.autograd.Function``: its
forward launches K1 for CUDA tensors (the plain pool on the widened
inputs for CPU tensors, ``ops/backend.py``) and saves ``contexts, mask,
attn, cv, weights``; its backward launches K1b, which takes the row's
softmax term from the saved code vector (``pool_backward_reference`` on
the CPU, which needs no ``cv``), and returns ``d_attn`` in the attention
vector's own dtype, as ``_pool_bwd`` does, so a bf16 ``attn_param`` cast
from the f32 parameter passes it back through the cast. The mask gets no gradient.
"""

from __future__ import annotations

import ctypes

import torch

from code2vec_tpu_torch.ops import _build
from code2vec_tpu_torch.ops.attention import attention_pool, pool_backward_reference
from code2vec_tpu_torch.ops.backend import count_launch, resolve

KERNEL = "pool"
KERNEL_BWD = "pool_bwd"
CONTEXTS_PER_CTA = 64  # 8 warps x 8 contexts each in flight at H <= 128
MAX_CLUSTER = 8  # CTAs per row: the portable thread-block cluster size
RESIDENT_CTAS_PER_SM = 2  # 256 threads of ~100 registers each: two CTAs an SM
MAX_H = 1024  # 8 float4 slices per lane
# the contexts' dtypes the kernels read: the code each C entry point takes
CTX_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def pool_ctas(b: int, l: int, sm_count: int) -> int:
    """K1's CTAs per batch row, the size of the row's thread-block cluster:
    enough that each CTA's warps fetch their share of the bag in one round
    of loads (``CONTEXTS_PER_CTA``), at most ``MAX_CLUSTER`` and at most
    the card's resident CTAs (``RESIDENT_CTAS_PER_SM`` on each of
    ``sm_count`` SMs). The batch ``b`` does not enter: the cluster fixes the
    order in which a row's partials merge, so a row's bits would otherwise
    depend on the micro-batch it rides in (the hot-swap gate's invariant);
    a large batch runs in more waves instead."""
    del b
    return max(1, min(MAX_CLUSTER, -(-l // CONTEXTS_PER_CTA), sm_count * RESIDENT_CTAS_PER_SM))


def _lib():
    lib = _build.load("pool")
    if lib.c2v_pool_forward.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.c2v_pool_forward.argtypes = [i] + [p] * 5 + [i] * 4 + [p]
        lib.c2v_pool_forward.restype = i
        lib.c2v_pool_backward.argtypes = [i] + [p] * 11 + [i] * 4 + [p]
        lib.c2v_pool_backward.restype = i
        lib.c2v_pool_backward_grid.argtypes = [i] * 4 + [ctypes.POINTER(i),
                                                         ctypes.POINTER(ctypes.c_longlong)]
        lib.c2v_pool_backward_grid.restype = i
    return lib


def pool_bwd_grid(b: int, l: int, h: int, dtype: torch.dtype, device) -> tuple[int, int]:
    """K1b's persistent grid on the CUDA ``device`` for ``[b, l, h]``
    contexts of ``dtype``: ``(ctas, tasks)``. ``csrc/pool.cu`` cuts the
    bags into tasks of a few contexts of one row, one contiguous run of
    them per warp, on at most as many CTAs as the card holds at once."""
    lib = _lib()
    ctas, tasks = ctypes.c_int(), ctypes.c_longlong()
    with torch.cuda.device(device):
        code = lib.c2v_pool_backward_grid(CTX_DTYPES[dtype], b, l, h, ctypes.byref(ctas),
                                          ctypes.byref(tasks))
    _build.check(lib, code, "pool backward grid")
    return ctas.value, tasks.value


def _checked(what, contexts, **named):
    """``contexts`` (f32 or bf16), ``attn_param`` (the contexts' dtype) and
    the other ``named`` tensors (f32) made contiguous after checking each
    one's dtype and expected shape on the contexts' device."""
    b, l, h = contexts.shape
    dev = contexts.device
    shapes = {"contexts": (b, l, h), "mask": (b, l), "attn_param": (h,), "weights": (b, l),
              "cv": (b, h), "g_cv": (b, h), "g_w": (b, l)}
    if b < 1 or l < 1:
        raise ValueError(f"{what}: empty batch or bag, shape {(b, l, h)}")
    if not 1 <= h <= MAX_H:
        raise ValueError(f"{what}: encode width {h} outside 1..{MAX_H}")
    out = []
    for name, t in (("contexts", contexts), *named.items()):
        dtypes = ((contexts.dtype,) if name == "attn_param"
                  else tuple(CTX_DTYPES) if name == "contexts" else (torch.float32,))
        if t.device != dev or t.dtype not in dtypes or tuple(t.shape) != shapes[name]:
            raise ValueError(
                f"{what}: {name} must be {' or '.join(map(str, dtypes))} {shapes[name]} "
                f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        out.append(t.contiguous())
    return out


def kernel_key(base: str, contexts: torch.Tensor) -> str:
    """The launch-count key: ``pool`` / ``pool_bwd``, ``_bf16`` over bf16
    contexts."""
    return base + ("_bf16" if contexts.dtype == torch.bfloat16 else "")


def _launch(contexts, mask, attn_param):
    ctx, msk, attn = _checked("pool kernel", contexts, mask=mask, attn_param=attn_param)
    b, l, h = ctx.shape
    dev = ctx.device
    cv = torch.empty((b, h), dtype=torch.float32, device=dev)
    w = torch.empty((b, l), dtype=torch.float32, device=dev)
    ctas = pool_ctas(b, l, torch.cuda.get_device_properties(dev).multi_processor_count)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.c2v_pool_forward(CTX_DTYPES[ctx.dtype], ctx.data_ptr(), msk.data_ptr(),
                                    attn.data_ptr(), cv.data_ptr(), w.data_ptr(), b, l, h, ctas,
                                    stream)
    _build.check(lib, code, "pool kernel launch")
    count_launch(kernel_key(KERNEL, ctx))
    return cv, w


# K1b's ticket per (device, stream): one zeroed int that a launch's last
# CTA finds and leaves zeroed, kept so that a call needs no fill launch to
# zero it. Two launches that share a ticket must never overlap: eager
# launches on one stream do not, and a launch captured into a CUDA graph
# gets a ticket of its own, zeroed by a fill that each replay repeats, so
# a replay shares no ticket with an eager launch or another graph.
_tickets: dict[tuple[int, int], torch.Tensor] = {}


def _ticket(dev: torch.device, stream: int) -> torch.Tensor:
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(1, dtype=torch.int32, device=dev)
    key = (dev.index, stream)
    if key not in _tickets:
        _tickets[key] = torch.zeros(1, dtype=torch.int32, device=dev)
    return _tickets[key]


def pool_backward_kernel(contexts, mask, attn_param, weights, cv, g_cv, g_w=None):
    """K1b: ``(d_contexts [B, L, H], d_attn [H])`` on the card, the CUDA
    counterpart of ``pool_backward_reference``, from the forward's
    ``weights`` and code vector ``cv`` (the row's softmax term is
    ``<g_cv, cv> + <weights, g_w>``): ``d_contexts`` in the contexts' dtype
    (f32 or bf16), ``d_attn`` f32. Each CTA of the persistent grid writes
    its part of ``d_attn`` to a ``[G, H]`` scratch buffer; the last CTA to
    finish (found with the stream's ticket, ``_ticket``) adds them in CTA
    order, so a call is one kernel and bitwise repeatable."""
    named = dict(mask=mask, attn_param=attn_param, weights=weights, cv=cv, g_cv=g_cv)
    if g_w is not None:
        named["g_w"] = g_w
    ctx, *rest = _checked("pool backward kernel", contexts, **named)
    msk, attn, w, cv_, gcv = rest[:5]
    gw = rest[5] if g_w is not None else None
    b, l, h = ctx.shape
    dev = ctx.device
    ctas, _ = pool_bwd_grid(b, l, h, ctx.dtype, dev)
    d_ctx = torch.empty_like(ctx)
    part = torch.empty((ctas, h), dtype=torch.float32, device=dev)
    d_attn = torch.empty(h, dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ticket = _ticket(dev, stream)
        code = lib.c2v_pool_backward(
            CTX_DTYPES[ctx.dtype], ctx.data_ptr(), msk.data_ptr(), attn.data_ptr(), w.data_ptr(),
            cv_.data_ptr(), gcv.data_ptr(), None if gw is None else gw.data_ptr(),
            d_ctx.data_ptr(), part.data_ptr(), d_attn.data_ptr(), ticket.data_ptr(), b, l, h,
            ctas, stream)
    _build.check(lib, code, "pool backward kernel launch")
    count_launch(kernel_key(KERNEL_BWD, ctx))
    return d_ctx, d_attn


class _AttentionPool(torch.autograd.Function):
    """K1 forward, K1b backward; on the CPU their plain versions."""

    @staticmethod
    def forward(ctx, contexts, mask, attn_param, backend):
        if resolve(contexts, backend) == "cpu":
            cv, w = attention_pool(contexts.float(), mask, attn_param.float())
        else:
            cv, w = _launch(contexts, mask, attn_param)
        ctx.save_for_backward(contexts, mask, attn_param, cv, w)
        ctx.set_materialize_grads(False)  # an unused weights output sends no g_w
        return cv, w

    @staticmethod
    def backward(ctx, g_cv, g_w):
        contexts, mask, attn_param, cv, w = ctx.saved_tensors
        if g_cv is None:
            g_cv = torch.zeros(contexts.shape[0], contexts.shape[2], device=contexts.device)
        if contexts.device.type == "cpu":
            d_ctx, d_attn = pool_backward_reference(contexts, mask, attn_param, w, g_cv, g_w)
        else:
            d_ctx, d_attn = pool_backward_kernel(contexts, mask, attn_param, w, cv, g_cv, g_w)
        return d_ctx, None, d_attn.to(attn_param.dtype), None


def attention_pool_kernel(
    contexts: torch.Tensor,  # [B, L, H] f32 or bf16
    mask: torch.Tensor,  # [B, L] (1 = real, 0 = PAD)
    attn_param: torch.Tensor,  # [H], the contexts' dtype
    backend: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for ``ops.attention.attention_pool``: ``(cv [B, H] f32,
    weights [B, L] f32)``, differentiable in ``contexts`` and
    ``attn_param``. CUDA tensors launch K1 (and K1b in the backward); CPU
    tensors run ``attention_pool`` and ``pool_backward_reference`` in f32
    on the widened inputs."""
    return _AttentionPool.apply(contexts, mask.float(), attn_param, backend)
