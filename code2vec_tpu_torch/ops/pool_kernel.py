"""K1: the masked attention pool as a hand-written Hopper kernel.

Counterpart of ``code2vec_tpu/ops/pallas_attention.py``
(``pallas_attention_pool``, kernel body ``_tile_pool``): the model's
``pallas_impl="pool_only"`` route. The kernel is ``csrc/pool.cu``; its
plain version is :func:`~code2vec_tpu_torch.ops.attention.attention_pool`
on f32 inputs. :func:`attention_pool_kernel` launches the kernel for CUDA
tensors and runs the plain version for CPU tensors (``ops/backend.py``).
Forward only: the backward (``_pool_bwd``) comes with the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from code2vec_tpu_torch.ops import _build
from code2vec_tpu_torch.ops.attention import attention_pool
from code2vec_tpu_torch.ops.backend import count_launch, resolve

KERNEL = "pool"
CHUNK = 32  # contexts per CTA, kChunk in csrc/pool.cuh


def partials_workspace(b: int, l: int, h: int, dev) -> torch.Tensor | None:
    """The [B, chunks, H + 2] f32 softmax partials of bags longer than one
    chunk (csrc/pool.cuh), or None."""
    n_chunks = -(-l // CHUNK)
    if n_chunks == 1:
        return None
    return torch.empty((b, n_chunks, h + 2), dtype=torch.float32, device=dev)


def _launcher():
    lib = _build.load("pool")
    fn = lib.c2v_pool_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, fn


def _launch(contexts, mask, attn_param):
    b, l, h = contexts.shape
    dev = contexts.device
    for name, t, dtype, shape in (
        ("contexts", contexts, torch.float32, (b, l, h)),
        ("mask", mask, torch.float32, (b, l)),
        ("attn_param", attn_param, torch.float32, (h,)),
    ):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"pool kernel: {name} must be {dtype} {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
    if b < 1 or l < 1:
        raise ValueError(f"pool kernel: empty batch or bag, shape {(b, l, h)}")
    ctx, msk, attn = contexts.contiguous(), mask.contiguous(), attn_param.contiguous()
    cv = torch.empty((b, h), dtype=torch.float32, device=dev)
    w = torch.empty((b, l), dtype=torch.float32, device=dev)
    part = partials_workspace(b, l, h, dev)
    lib, fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(ctx.data_ptr(), msk.data_ptr(), attn.data_ptr(), cv.data_ptr(),
                  w.data_ptr(), None if part is None else part.data_ptr(), b, l, h, stream)
    _build.check(lib, code, "pool kernel launch")
    count_launch(KERNEL)
    return cv, w


def attention_pool_kernel(
    contexts: torch.Tensor,  # [B, L, H] f32
    mask: torch.Tensor,  # [B, L] (1 = real, 0 = PAD)
    attn_param: torch.Tensor,  # [H]
    backend: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for ``ops.attention.attention_pool``: ``(cv [B, H] f32,
    weights [B, L] f32)``. CUDA tensors launch K1; CPU tensors run
    ``attention_pool`` in f32."""
    if resolve(contexts, backend) == "cpu":
        return attention_pool(contexts.float(), mask.float(), attn_param.float())
    return _launch(contexts, mask.float(), attn_param.float())
