"""The numerics of the encode kernels' 3xTF32 split, on the CPU.

K2-K4 (``csrc/fused_encode_pool.cu``) run the encode ``x @ W`` on the
tensor cores: each operand is split as ``v = hi + lo`` with ``hi`` = v
rounded to TF32 (10 mantissa bits, to nearest, ties away from zero: the
low 13 bits cleared) and ``lo`` the exact rest, which the tensor core
reads truncated to TF32; the product is ``a_lo*b_hi + a_hi*b_lo +
a_hi*b_hi``. The card is not here, so this file emulates the split with
torch bit operations on numpy-seeded inputs at the top11 widths and at
encode 300, runs LayerNorm, tanh and the pool on the emulated encode, and
holds the result against the JAX package's ``xla_reference_forward`` on
the CPU. Each product of TF32 values is exact in float64, so the emulation
sums in float64 and rounds once: what it measures is the split's own
error, not the tensor core's summation order.

Three products stay within the kernels' tolerance (1e-5, ``chip_smoke.py``);
one TF32 product (``a_hi*b_hi``) does not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu.ops.fused_encode_pool import xla_reference_forward
from code2vec_tpu_torch.ops.attention import attention_pool
from code2vec_tpu_torch.ops.fused_encode_pool import LN_EPS

TOL = 1e-5  # the kernels' tolerance against their plain versions
DIMS = {"top11": (100, 100, 100), "encode300": (100, 100, 300)}


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32: to nearest, ties away from zero, 13 low bits cleared."""
    bits = x.float().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """x truncated to TF32, as the tensor core reads an operand's top 19 bits."""
    return (x.float().view(torch.int32) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32_round(x)
    return hi, tf32_trunc(x - hi)


def inputs(dims, B=4, L=24, seed=0):
    """Random tables, ids with PAD tails and one all-PAD row, and the
    encode's parameters, as numpy arrays."""
    et, ep, h = dims
    rng = np.random.default_rng(seed)
    vt, vp = 301, 157
    starts = rng.integers(1, vt, (B, L)).astype(np.int32)
    paths = rng.integers(1, vp, (B, L)).astype(np.int32)
    ends = rng.integers(1, vt, (B, L)).astype(np.int32)
    for i, n in enumerate(rng.integers(1, L + 1, B)):
        starts[i, n:] = paths[i, n:] = ends[i, n:] = 0
    starts[0], paths[0], ends[0] = (np.maximum(a[0], 1) for a in (starts, paths, ends))
    starts[-1] = paths[-1] = ends[-1] = 0
    d = 2 * et + ep
    return dict(
        t_table=rng.normal(size=(vt, et)).astype(np.float32),
        p_table=rng.normal(size=(vp, ep)).astype(np.float32),
        starts=starts, paths=paths, ends=ends, mask=(starts > 0).astype(np.float32),
        dense_kernel=(rng.normal(size=(d, h)) / np.sqrt(d)).astype(np.float32),
        ln_scale=(1.0 + 0.1 * rng.normal(size=h)).astype(np.float32),
        ln_bias=(0.1 * rng.normal(size=h)).astype(np.float32),
        attn_param=(0.08 * rng.normal(size=h)).astype(np.float32),
    )


def emulated_forward(inp, products: int):
    """The kernels' chain with the encode's operands split into TF32 parts:
    3 products (the kernels') or 1 (``a_hi*b_hi`` alone)."""
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    x = torch.cat([t["t_table"][t["starts"].long()], t["p_table"][t["paths"].long()],
                   t["t_table"][t["ends"].long()]], dim=-1)
    (x_hi, x_lo), (w_hi, w_lo) = split(x), split(t["dense_kernel"])
    y = x_hi.double() @ w_hi.double()
    if products == 3:
        y = y + x_lo.double() @ w_hi.double() + x_hi.double() @ w_lo.double()
    y = y.float()
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) ** 2).mean(-1, keepdim=True)
    enc = torch.tanh((y - mu) * torch.rsqrt(var + LN_EPS) * t["ln_scale"] + t["ln_bias"])
    cv, w = attention_pool(enc, t["mask"], t["attn_param"])
    return cv.numpy(), w.numpy()


def jax_forward(inp):
    order = ("t_table", "p_table", "starts", "paths", "ends", "mask", "dense_kernel",
             "ln_scale", "ln_bias", "attn_param")
    cv, w = xla_reference_forward(*(jnp.asarray(inp[k]) for k in order))
    return np.asarray(cv), np.asarray(w)


def max_err(got, ref):
    return max(float(np.abs(a - b).max()) for a, b in zip(got, ref))


def test_split_is_exact_and_tf32_shaped():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=4096).astype(np.float32) * 10.0 ** rng.integers(-6, 6, 4096))
    hi, lo = split(x)
    rest = x - hi
    assert torch.equal(hi.view(torch.int32) & 0x1FFF, torch.zeros_like(x, dtype=torch.int32))
    assert torch.equal(hi + rest, x)  # the rest is exact in f32
    assert bool((rest.abs() <= x.abs() * 2.0**-11).all())
    assert bool(((rest - lo).abs() <= rest.abs() * 2.0**-10).all())
    # ties go away from zero: 1 + 2^-11 lies halfway between two TF32 values
    tie = torch.tensor([1 + 2.0**-11, -(1 + 2.0**-11)])
    assert tf32_round(tie).tolist() == [1 + 2.0**-10, -(1 + 2.0**-10)]


@pytest.mark.parametrize("dims", list(DIMS.values()), ids=list(DIMS))
def test_three_tf32_products_are_within_the_kernel_tolerance(dims):
    inp = inputs(dims, seed=sum(dims))
    err = max_err(emulated_forward(inp, 3), jax_forward(inp))
    assert err <= TOL, err


@pytest.mark.parametrize("dims", list(DIMS.values()), ids=list(DIMS))
def test_one_tf32_product_is_not(dims):
    inp = inputs(dims, seed=sum(dims))
    err = max_err(emulated_forward(inp, 1), jax_forward(inp))
    assert err > TOL, err
