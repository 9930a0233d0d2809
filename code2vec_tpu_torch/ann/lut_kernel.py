"""K5: IVF-PQ cell scoring by LUT, as a hand-written Hopper kernel.

Counterpart of ``code2vec_tpu/ann/lut_kernel.py``. Given each query's LUT
``[M, 256]`` of subspace inner products and the index's cell-major storage
(codes ``[n_list, C, M]`` uint8, per-row scales and pad bias
``[n_list, C]`` f32), score every row of every probed cell::

    out[q, p, c] = scales[cell, c] * sum_m LUT[q, m, codes[cell, c, m]]
                   + bias[cell, c]          where cell = probed[q, p]

Pad rows carry scale 0 and bias ``-inf`` and score exactly ``-inf``.

:func:`lut_score_cells` launches the kernel (``csrc/lut_score.cu``, each
CTA scoring the tile of rows that :func:`lut_grid` gives in one or more of
a query's probed cells) for
CUDA tensors and runs :func:`lut_score_cells_reference`, the gather-based
plain version (the counterpart of ``xla_lut_score_cells``), for CPU
tensors. The TPU kernel (``pallas_lut_score_cells``) and the GPU sketch
(``gpu_lut_score_cells``) are both this one kernel.
"""

from __future__ import annotations

import ctypes

import torch

from code2vec_tpu_torch.analysis.contracts import shape_contract, spec
from code2vec_tpu_torch.ann.pq import PQ_ENTRIES
from code2vec_tpu_torch.ops import _build
from code2vec_tpu_torch.ops.backend import count_launch, resolve

KERNEL = "lut_score"
TILE_ALIGN = 32  # tile rows: whole warps
CTAS_PER_SM = 2  # the grid policy's aim; a CTA holds only its query's LUT


def _round_up(n: int, k: int) -> int:
    return -(-n // k) * k


def lut_grid(q: int, p: int, c: int, sm_count: int) -> tuple[int, int]:
    """K5's CTA work: ``(tile rows T, probed cells G)``, a CTA scoring T
    rows (a multiple of ``TILE_ALIGN``) in each of G probed cells of one
    query. The call's ``q * p * c`` rows are spread over ``CTAS_PER_SM``
    CTAs on each of ``sm_count`` SMs: a small call cuts each cell into
    tiles of equal size, a large one gives a CTA whole cells, several when
    that still fills the card, so that each query's LUT is staged as few
    times as filling the card allows."""
    per_cta = -(-(q * p * c) // (CTAS_PER_SM * sm_count))
    c_tiles = _round_up(c, TILE_ALIGN)
    if per_cta < c_tiles:
        t = _round_up(per_cta, TILE_ALIGN)
        return _round_up(-(-c // -(-c // t)), TILE_ALIGN), 1
    return c_tiles, max(1, min(p, per_cta // c_tiles))


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
    if args[0].data_ptr() % 16:  # the kernel copies the LUT 16 bytes at a time
        args[0] = args[0].clone()
    out = torch.empty((q, p, cap), dtype=torch.float32, device=dev)
    tile, cells = lut_grid(q, p, cap, torch.cuda.get_device_properties(dev).multi_processor_count)
    lib = _build.load("lut_score")
    fn = lib.c2v_lut_score_cells
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(*(t.data_ptr() for t in args), out.data_ptr(), q, p, n_list, cap, m, tile,
                  cells, stream)
    _build.check(lib, code, "lut kernel launch")
    count_launch(KERNEL)
    return out


# K5's input contract (JAX ``LUT_CONTRACT``), checked before the launch
# wrapper's own device, dtype, alignment and emptiness checks
LUT_CONTRACT = {
    "lut": spec("Q,M,J", "float"),
    "probed": spec("Q,P", "int"),
    "codes": spec("N,C,M", "int"),
    "scales": spec("N,C", "float"),
    "bias": spec("N,C", "float"),
}


@shape_contract(**LUT_CONTRACT)
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
