"""Operation and byte counts of the model and its kernels, and the chip's
peaks: the yardstick the roofline and utilization metrics divide by.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit (dense
rates, no sparsity). The port's f32 work runs either as plain f32 (cuBLAS
with TF32 off, the f32 FMA units) or as 3xTF32 products on the tensor
cores (K2-K4), so a whole step's share is stated against the TF32 tensor
rate, the highest rate any of its f32 work can reach: the share is a lower
bound and cannot pass 100%.

The counts are copied, not imported, from the program: the model's
closed-form forward (``obs/costs.analytic_forward_cost``), K1 and K1b's
bytes and K2-K4's bound (``chip_smoke.pool_bound``, ``pool_bwd_bound``,
``encode_pool_bound``).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
TF32_FLOP_PER_S = 495e12
F32_FLOP_PER_S = 67e12
# K2-K4 run each f32 encode product as three TF32 products (csrc/fused_encode_pool.cu)
TF32_PRODUCTS_F32 = 3


def forward_flops(batch: int, width: int, *, terminal_embed: int, path_embed: int,
                  encode: int, labels: int) -> float:
    """The model's forward at ``[batch, width]`` slots: encode matmul, label
    head, attention scores, weighted pool, LayerNorm, tanh and the bag's
    softmax (the closed form of ``obs/costs.analytic_forward_cost``)."""
    b, l = float(batch), float(width)
    concat = 2.0 * terminal_embed + path_embed
    return (2.0 * b * l * concat * encode + 2.0 * b * encode * labels + 2.0 * b * l * encode
            + 2.0 * b * l * encode + 10.0 * b * l * encode + 1.0 * b * l * encode + 5.0 * b * l)


def train_step_flops(batch: int, width: int, **dims) -> float:
    """A training step: forward plus backward, three forwards; nothing
    recomputed is counted."""
    return 3.0 * forward_flops(batch, width, **dims)


def dims_of(config: dict) -> dict:
    """The keyword arguments of :func:`forward_flops` from a configuration file."""
    return dict(terminal_embed=config["terminal_embed_size"], path_embed=config["path_embed_size"],
                encode=config["encode_size"], labels=config["label_count"])


def pool_bytes(batch: int, width: int, hidden: int, ctx_item: int = 4) -> int:
    """K1 (``csrc/pool.cu`` ``pool_kernel``): contexts read once, mask, the
    attention vector, the code vector and the weights written once."""
    return ctx_item * batch * width * hidden + 4 * (2 * batch * width + hidden + batch * hidden)


def pool_bwd_bytes(batch: int, width: int, hidden: int, ctx_item: int = 4) -> int:
    """K1b (``pool_bwd_kernel``): contexts read and their gradient written
    once, plus weights, mask, the weights' gradient, code vector, its
    gradient, the attention vector and its gradient."""
    return 2 * ctx_item * batch * width * hidden + 4 * (3 * batch * width + 2 * batch * hidden
                                                        + 2 * hidden)


def encode_pool_seconds(real_contexts: int, batch: int, width: int, *, terminal_embed: int,
                        path_embed: int, encode: int) -> float:
    """The least time of one K3 or K4 call over f32 tables: the larger of
    its operations' time (the encode's ``2 D H`` a needed context as three
    TF32 products, ``8 H`` of LayerNorm, tanh and pool at the f32 rate) and
    the time of the bytes every call moves whatever rows it gathers (ids,
    mask, weights, outputs). ``real_contexts`` counts each real context and
    one encode per all-PAD row, as ``chip_smoke.encode_pool_bound`` does."""
    d = 2 * terminal_embed + path_embed
    ops_s = (TF32_PRODUCTS_F32 * 2 * d * encode * real_contexts / TF32_FLOP_PER_S
             + 8 * encode * real_contexts / F32_FLOP_PER_S)
    fixed_bytes = 4 * (4 * batch * width + d * encode + 3 * encode + batch * encode
                       + batch * width)
    return max(ops_s, fixed_bytes / HBM_BYTES_PER_S)
