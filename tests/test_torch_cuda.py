"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: on a machine without a GPU every test skips (decided
inside the fixture, never at import). Run them on the card with

    python -m pytest -m cuda tests/test_torch_cuda.py -q --noconftest

(``--noconftest``: the suite's conftest pins JAX to the CPU, and the
card's machine needs no JAX for these tests.)

``chip_smoke.py`` covers the top11 widths; these cover what it does not:
dims that are not multiples of 4 (the scalar W and row paths), chunk
edges (L = 32, 33, 65), all-masked rows, ids out of range (clamped, as a
JAX gather clamps). Tolerance rtol = atol = 1e-5 (f32 compute on both
sides, TF32 off).
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU interpreter")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


def ids_and_tables(dev, B, L, Et, Ep, H, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    Vt, Vp = 301, 157
    t = torch.randn(Vt, Et, generator=g, device=dev)
    p = torch.randn(Vp, Ep, generator=g, device=dev)
    s = torch.randint(1, Vt, (B, L), generator=g, device=dev, dtype=torch.int32)
    pa = torch.randint(1, Vp, (B, L), generator=g, device=dev, dtype=torch.int32)
    e = torch.randint(1, Vt, (B, L), generator=g, device=dev, dtype=torch.int32)
    lens = torch.randint(1, L + 1, (B,), generator=g, device=dev)
    keep = torch.arange(L, device=dev)[None, :] < lens[:, None]
    keep[-1] = False
    s, pa, e = (x * keep for x in (s, pa, e))
    D = 2 * Et + Ep
    params = (
        torch.randn(D, H, generator=g, device=dev) / D**0.5,
        1 + 0.1 * torch.randn(H, generator=g, device=dev),
        0.1 * torch.randn(H, generator=g, device=dev),
        torch.randn(H, generator=g, device=dev) / H**0.5,
    )
    return t, p, s, pa, e, (s > 0).float(), params


@pytest.mark.parametrize("L", [1, 32, 33, 65])
@pytest.mark.parametrize("H", [13, 64, 100, 300])
def test_pool_kernel(dev, L, H):
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts
    from code2vec_tpu_torch.ops.attention import attention_pool
    from code2vec_tpu_torch.ops.pool_kernel import attention_pool_kernel

    g = torch.Generator(device=dev).manual_seed(L * H)
    ctx = torch.tanh(torch.randn(5, L, H, generator=g, device=dev))
    mask = (torch.rand(5, L, generator=g, device=dev) > 0.3).float()
    mask[:, 0] = 1.0
    mask[-1] = 0.0
    attn = torch.randn(H, generator=g, device=dev)
    reset_launch_counts()
    cv, w = attention_pool_kernel(ctx, mask, attn)
    cv_ref, w_ref = attention_pool(ctx, mask, attn)
    assert launch_counts() == {"pool": 1}
    torch.testing.assert_close(cv, cv_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(w, w_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dims", [(6, 5, 13), (8, 6, 12), (100, 100, 100), (100, 100, 300)],
                         ids=["odd", "small", "top11", "encode300"])
@pytest.mark.parametrize("L", [1, 33, 65])
@pytest.mark.parametrize("table_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("impl", ["gather_split", "fused"])
def test_encode_pool_kernel(dev, impl, table_dtype, L, dims):
    from code2vec_tpu_torch.ops.fused_encode_pool import (
        fused_encode_attend_pool,
        kernel_name,
        reference_forward,
    )
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts
    from code2vec_tpu_torch.ops.quant import quantize_table

    Et, Ep, H = dims
    t, p, s, pa, e, mask, params = ids_and_tables(dev, 4, L, Et, Ep, H, seed=L)
    if table_dtype != "f32":
        t, p = quantize_table(t, table_dtype), quantize_table(p, table_dtype)
    args = (t, p, s, pa, e, mask, *params)
    reset_launch_counts()
    cv, w = fused_encode_attend_pool(*args, impl=impl)
    cv_ref, w_ref = reference_forward(*args)
    assert launch_counts() == {kernel_name(impl, table_dtype): 1}
    torch.testing.assert_close(cv, cv_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(w, w_ref, rtol=1e-5, atol=1e-5)


def test_out_of_range_ids_are_clamped(dev):
    from code2vec_tpu_torch.ops.fused_encode_pool import fused_encode_attend_pool

    t, p, s, pa, e, mask, params = ids_and_tables(dev, 2, 8, 6, 5, 12)
    big = s.clone()
    big[0, 0] = 10**6
    cv, _ = fused_encode_attend_pool(t, p, big, pa, e, mask, *params)
    clamped = s.clone()
    clamped[0, 0] = t.shape[0] - 1
    cv_ref, _ = fused_encode_attend_pool(t, p, clamped, pa, e, mask, *params)
    torch.cuda.synchronize()
    torch.testing.assert_close(cv, cv_ref, rtol=0, atol=0)


def test_wrong_dtype_raises(dev):
    from code2vec_tpu_torch.ops.pool_kernel import attention_pool_kernel

    ctx = torch.zeros(2, 3, 8, device=dev, dtype=torch.float64)
    with pytest.raises(ValueError, match="must be torch.float32"):
        attention_pool_kernel(ctx, torch.ones(2, 3, device=dev), torch.ones(8, device=dev))
