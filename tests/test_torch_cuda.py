"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: on a machine without a GPU every test skips (decided
inside the fixture, never at import). Run them on the card with

    python -m pytest -m cuda tests/test_torch_cuda.py -q --noconftest

(``--noconftest``: the suite's conftest pins JAX to the CPU, and the
card's machine needs no JAX for these tests.)

``chip_smoke.py`` covers the top11 widths; these cover what it does not:
dims that are not multiples of 4 (the scalar W and row paths), chunk
edges (L = 32, 33, 65), all-masked rows, ids out of range (clamped, as a
JAX gather clamps); for K4 both streamed modes at L from one context to
4096 (one CTA per row up to the full wave), for K5 word and byte code
loads, pad slots, and the searcher's shortlist against its plain scoring.
Tolerance rtol = atol = 1e-5 (f32 compute on both sides, TF32 off); K5's
``-inf`` pad masks must be identical.
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


@pytest.mark.parametrize("dims", [(6, 5, 13), (100, 100, 100)], ids=["odd", "top11"])
@pytest.mark.parametrize("L", [1, 32, 33, 512, 2048, 4096])
@pytest.mark.parametrize("table_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("mode", ["online", "two_pass"])
def test_streamed_encode_pool_kernel(dev, mode, table_dtype, L, dims):
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts
    from code2vec_tpu_torch.ops.fused_encode_pool import (
        fused_encode_attend_pool,
        kernel_name,
        reference_forward,
        streamed_reference_forward,
    )
    from code2vec_tpu_torch.ops.quant import quantize_table

    Et, Ep, H = dims
    t, p, s, pa, e, mask, params = ids_and_tables(dev, 3, L, Et, Ep, H, seed=L + H)
    if table_dtype != "f32":
        t, p = quantize_table(t, table_dtype), quantize_table(p, table_dtype)
    args = (t, p, s, pa, e, mask, *params)
    reset_launch_counts()
    cv, w = fused_encode_attend_pool(*args, softmax_mode=mode)
    assert launch_counts() == {kernel_name("fused", table_dtype, mode): 1}
    cv_ref, w_ref = streamed_reference_forward(*args, softmax_mode=mode)
    torch.cuda.synchronize()
    torch.testing.assert_close(cv, cv_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(w, w_ref, rtol=1e-5, atol=1e-5)
    cv_m, w_m = reference_forward(*args)
    torch.testing.assert_close(cv, cv_m, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(w, w_m, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("Q", [1, 8])
@pytest.mark.parametrize("P", [1, 8])
@pytest.mark.parametrize("C", [128, 384])
@pytest.mark.parametrize("M", [6, 8, 20])
def test_lut_score_kernel(dev, M, C, P, Q):
    from code2vec_tpu_torch.ann.lut_kernel import lut_score_cells, lut_score_cells_reference
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts

    g = torch.Generator(device=dev).manual_seed(M * C + P * Q)
    n_list = 11
    lut = torch.randn(Q, M, 256, generator=g, device=dev)
    probed = torch.randint(0, n_list, (Q, P), generator=g, device=dev, dtype=torch.int32)
    codes = torch.randint(0, 256, (n_list, C, M), generator=g, device=dev).to(torch.uint8)
    scales = torch.rand(n_list, C, generator=g, device=dev)
    bias = torch.zeros(n_list, C, device=dev)
    counts = torch.randint(1, C + 1, (n_list,), generator=g, device=dev)
    pad = torch.arange(C, device=dev)[None, :] >= counts[:, None]
    scales[pad] = 0.0
    bias[pad] = float("-inf")
    reset_launch_counts()
    got = lut_score_cells(lut, probed, codes, scales, bias)
    assert launch_counts() == {"lut_score": 1}
    ref = lut_score_cells_reference(lut, probed, codes, scales, bias)
    torch.cuda.synchronize()
    assert torch.equal(torch.isneginf(got), torch.isneginf(ref))
    fin = torch.isfinite(ref)
    torch.testing.assert_close(got[fin], ref[fin], rtol=0, atol=1e-5)


def test_searcher_on_the_card_matches_its_plain_scoring(dev, monkeypatch):
    import numpy as np

    from code2vec_tpu_torch.ann import lut_kernel
    from code2vec_tpu_torch.ann.index import AnnSearcher, build_index, normalize_rows
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts

    rng = np.random.default_rng(0)
    centers = rng.normal(size=(64, 20)).astype(np.float32)
    rows = (centers[rng.integers(0, 64, 5000)]
            + 0.15 * rng.normal(size=(5000, 20))).astype(np.float32)
    index, unit = build_index(rows, n_list=32, m=20, kmeans_iters=10, pq_iters=8, device=dev)
    assert sorted(index.ids[index.ids >= 0].tolist()) == list(range(5000))
    searcher = AnnSearcher(index, n_probe=8, shortlist=100, device=dev)
    q = rows[:16] + 0.05 * rng.normal(size=(16, 20)).astype(np.float32)
    reset_launch_counts()
    s_k, i_k = searcher.search(q)
    assert launch_counts() == {"lut_score": 1}
    # the same searcher with its cells scored by K5's plain version
    monkeypatch.setattr(lut_kernel, "lut_score_cells", lut_kernel.lut_score_cells_reference)
    s_p, i_p = searcher.search(q)
    monkeypatch.undo()
    assert launch_counts() == {"lut_score": 1}
    for a, b in zip(i_k, i_p):
        assert set(a[a >= 0].tolist()) == set(b[b >= 0].tolist())
    qn = normalize_rows(q)
    truth = np.argsort(-(qn @ unit.T), axis=1)[:, :10]
    recall = 0.0
    for r in range(16):
        valid = i_k[r][i_k[r] >= 0]
        top10 = valid[np.argsort(-(unit[valid] @ qn[r]))][:10]
        recall += len(set(top10.tolist()) & set(truth[r].tolist())) / 160
    assert recall >= 0.95


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


def test_chunk_l_other_than_the_default_raises_on_the_card(dev):
    from code2vec_tpu_torch.ops.fused_encode_pool import fused_encode_attend_pool

    t, p, s, pa, e, mask, params = ids_and_tables(dev, 2, 40, 6, 5, 12)
    with pytest.raises(ValueError, match="chunk_l=64"):
        fused_encode_attend_pool(t, p, s, pa, e, mask, *params, softmax_mode="online",
                                 chunk_l=64)


def test_wrong_dtype_raises(dev):
    from code2vec_tpu_torch.ops.pool_kernel import attention_pool_kernel

    ctx = torch.zeros(2, 3, 8, device=dev, dtype=torch.float64)
    with pytest.raises(ValueError, match="must be torch.float32"):
        attention_pool_kernel(ctx, torch.ones(2, 3, device=dev), torch.ones(8, device=dev))
