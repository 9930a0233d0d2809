"""K1: the masked attention pool as a hand-written Hopper kernel.

Counterpart of ``code2vec_tpu/ops/pallas_attention.py``
(``pallas_attention_pool``, kernel body ``_tile_pool``): the model's
``pallas_impl="pool_only"`` route. The kernel is ``csrc/pool.cu``, one
launch per call: :func:`pool_ctas` picks how many CTAs (one thread-block
cluster) share a batch row. Its plain version is
:func:`~code2vec_tpu_torch.ops.attention.attention_pool` on f32 inputs.
:func:`attention_pool_kernel` launches the kernel for CUDA tensors and
runs the plain version for CPU tensors (``ops/backend.py``).
Forward only: the backward (``_pool_bwd``) comes with the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from code2vec_tpu_torch.ops import _build
from code2vec_tpu_torch.ops.attention import attention_pool
from code2vec_tpu_torch.ops.backend import count_launch, resolve

KERNEL = "pool"
CONTEXTS_PER_CTA = 64  # 8 warps x 8 contexts each in flight at H <= 128
MAX_CLUSTER = 8  # CTAs per row: the portable thread-block cluster size
RESIDENT_CTAS_PER_SM = 2  # 256 threads of ~100 registers each: two CTAs an SM
MAX_H = 1024  # 8 float4 slices per lane


def pool_ctas(b: int, l: int, sm_count: int) -> int:
    """K1's CTAs per batch row, the size of the row's thread-block cluster:
    enough that each CTA's warps fetch their share of the bag in one round
    of loads (``CONTEXTS_PER_CTA``), at most ``MAX_CLUSTER``, and one CTA
    per row once the batch alone fills the card (``RESIDENT_CTAS_PER_SM``
    CTAs on each of ``sm_count`` SMs)."""
    fill = (sm_count * RESIDENT_CTAS_PER_SM) // max(b, 1)
    return max(1, min(MAX_CLUSTER, -(-l // CONTEXTS_PER_CTA), fill))


def _launcher():
    lib = _build.load("pool")
    fn = lib.c2v_pool_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
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
    if not 1 <= h <= MAX_H:
        raise ValueError(f"pool kernel: encode width {h} outside 1..{MAX_H}")
    ctx, msk, attn = contexts.contiguous(), mask.contiguous(), attn_param.contiguous()
    cv = torch.empty((b, h), dtype=torch.float32, device=dev)
    w = torch.empty((b, l), dtype=torch.float32, device=dev)
    ctas = pool_ctas(b, l, torch.cuda.get_device_properties(dev).multi_processor_count)
    lib, fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(ctx.data_ptr(), msk.data_ptr(), attn.data_ptr(), cv.data_ptr(),
                  w.data_ptr(), b, l, h, ctas, stream)
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
