"""K5: IVF-PQ cell scoring by LUT, as a hand-written Hopper kernel.

Counterpart of ``code2vec_tpu/ann/lut_kernel.py``. Given each query's LUT
``[M, 256]`` of subspace inner products and the index's cell-major storage
(codes ``[n_list, C, M]`` uint8, per-row scales and pad bias
``[n_list, C]`` f32), score every row of every probed cell::

    out[q, p, c] = scales[cell, c] * sum_m LUT[q, m, codes[cell, c, m]]
                   + bias[cell, c]          where cell = probed[q, p]

Pad rows carry scale 0 and bias ``-inf`` and score exactly ``-inf``.

:func:`lut_score_cells` launches the kernel (``csrc/lut_score.cu``) for
CUDA tensors and runs :func:`lut_score_cells_reference`, the gather-based
plain version (the counterpart of ``xla_lut_score_cells``), for CPU
tensors. The TPU kernel (``pallas_lut_score_cells``) and the GPU sketch
(``gpu_lut_score_cells``) are both this one kernel.
"""

from __future__ import annotations

import ctypes

import torch

from code2vec_tpu_torch.ann.pq import PQ_ENTRIES
from code2vec_tpu_torch.ops import _build
from code2vec_tpu_torch.ops.backend import count_launch, resolve

KERNEL = "lut_score"


def lut_score_cells_reference(lut, probed, codes, scales, bias) -> torch.Tensor:
    """The plain version: gather the probed cells' codes, index the
    flattened per-query LUT, sum over subspaces."""
    q, m, entries = lut.shape
    cells = probed.long()
    gathered = codes[cells].long()  # [Q, P, C, M]
    offsets = gathered + torch.arange(m, device=lut.device) * entries
    flat = lut.reshape(q, m * entries)
    rows = torch.arange(q, device=lut.device)[:, None, None, None]
    sums = flat[rows, offsets].sum(dim=-1)  # [Q, P, C]
    return scales[cells] * sums + bias[cells]


def _launch(lut, probed, codes, scales, bias) -> torch.Tensor:
    q, m, entries = lut.shape
    p = probed.shape[1]
    n_list, cap, m_codes = codes.shape
    dev = lut.device
    for name, t, dtype, shape in (
        ("lut", lut, torch.float32, (q, m, PQ_ENTRIES)),
        ("probed", probed, torch.int32, (q, p)),
        ("codes", codes, torch.uint8, (n_list, cap, m)),
        ("scales", scales, torch.float32, (n_list, cap)),
        ("bias", bias, torch.float32, (n_list, cap)),
    ):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"lut kernel: {name} must be {dtype} {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
    if q < 1 or p < 1 or cap < 1:
        raise ValueError(f"lut kernel: empty query, probe or cell, {(q, p, cap)}")
    args = [t.contiguous() for t in (lut, probed, codes, scales, bias)]
    out = torch.empty((q, p, cap), dtype=torch.float32, device=dev)
    lib = _build.load("lut_score")
    fn = lib.c2v_lut_score_cells
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(*(t.data_ptr() for t in args), out.data_ptr(), q, p, n_list, cap, m, stream)
    _build.check(lib, code, "lut kernel launch")
    count_launch(KERNEL)
    return out


def lut_score_cells(
    lut: torch.Tensor,  # f32 [Q, M, 256] per-query subspace LUT
    probed: torch.Tensor,  # int32 [Q, P] probed cell ids
    codes: torch.Tensor,  # uint8 [n_list, C, M] cell-major PQ codes
    scales: torch.Tensor,  # f32 [n_list, C] per-row scale (0 on pad rows)
    bias: torch.Tensor,  # f32 [n_list, C] (0 real, -inf pad)
    *,
    backend: str | None = None,
) -> torch.Tensor:
    """Score every row of every probed cell: f32 ``[Q, P, C]``. CUDA
    tensors launch K5; CPU tensors run :func:`lut_score_cells_reference`."""
    if resolve(lut, backend) == "cpu":
        return lut_score_cells_reference(lut, probed, codes, scales, bias)
    return _launch(lut, probed, codes, scales, bias)
