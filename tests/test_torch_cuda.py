"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: on a machine without a GPU every test skips (decided
inside the fixture, never at import). Run them on the card with

    python -m pytest -m cuda tests/test_torch_cuda.py -q --noconftest

(``--noconftest``: the suite's conftest pins JAX to the CPU, and the
card's machine needs no JAX for these tests.)

``chip_smoke.py`` covers the top11 widths; these cover what it does not:
for K1 every cluster size (1 to 8 CTAs a row), repeatable bits and one
CUDA kernel per call;
dims that are not multiples of 4 or 8 (narrower row copies, zero-padded
tensor-core tiles), edges of the 32-context chunk step (``CHUNK`` +- 1 and
beyond), encode 300 (W streamed through shared memory in tiles), all-masked
rows, ids out of range (clamped, as a JAX gather clamps); for K4 both
streamed modes at L from one context to 4096 (one CTA per row up to the
full wave) and B = 1 / 64 at L = 2048 on the card's ``stream_ctas`` grid;
for K5 many tiles per cell, one, or several cells per CTA, word and byte
code loads, sources at any alignment, pad slots, clamped cell ids, and the
searcher's shortlist against its plain scoring; for K1b (the pool's
backward) its persistent grid below and at its cap, a weights cotangent
or none, a row's tasks spread over several CTAs, repeatable bits;
K2/K3/K4-online with the dropout keep mask; one train step on each kernel route against the
plain route's gradients; and the lazy table optimizer (``--table_update
lazy``): three lazy steps on each route against the plain lazy steps on the
CPU (untouched rows and moments bit for bit), its step under
``set_sync_debug_mode("error")`` and the profiler's op list of a step (no
dense table gradient); device-resident epochs: the sampler on the card bit
for bit the CPU sampler's for the same shifts, and ``sample_prefetch`` (a
second stream) the same batches and generator state as without it;
variable-task rows (one context, all PAD but still an example) through
K1, K1b, masked K2 and masked K3, a variable train step on each kernel
route, and the sampler's ``@var_*`` remap on the card bit for bit the CPU's;
K6 (the dense tables' gradient) against its plain version in f64 at top11's
step shapes with a 37% PAD run, at widths 100, 128 and 7, int32 and int64
ids, one id for every slot, all ids distinct, ids at ``V - 1``, no slot, rows
at an odd address, bitwise repeatable, its split rows counted exactly, two
launches a dense device-epoch step and none a lazy one, and the row-sharded
lookup's gradient;
the host prefetcher's copies on its own stream equal the synchronous copies,
and ``train()`` prefetched (also fed by workers forked from a process with a
live CUDA context) within rtol 1e-5 of the synchronous run's losses;
``pallas_impl="auto"`` with a hand-written cache naming each route in turn
launches that route's kernel and no other, its outputs bitwise the fixed
route's, and an ``xla`` LUT entry is a miss for the searcher on the card;
on a one-rank mesh the searcher (K5) and the exact index bitwise the
unmeshed ones, the k-means assignment row-local whatever the batch, and
the lazy rows of a table's row shard (touched or not) with no sync.
Tolerance rtol = atol = 1e-5 (the plain
versions in f32 with TF32 off, the kernels' encode in 3xTF32 on the
tensor cores); at top11 widths and one context the kernel's code vector is
within 2e-6 of a float64 evaluation, which one TF32 product (~1e-3) would
miss. K5's ``-inf`` pad masks must be identical.
"""

import math

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


@pytest.mark.parametrize("H", [13, 64, 100, 300])
@pytest.mark.parametrize("L", [1, 31, 32, 33, 200, 257, 2048])
@pytest.mark.parametrize("B", [1, 5, 64, 200])
def test_pool_kernel_grid(dev, B, L, H):
    """K1 on every cluster size pool_ctas gives (1 to 8 CTAs a row, in
    several waves at B = 200), the last row all-masked (uniform 1/L)."""
    from code2vec_tpu_torch.ops.attention import attention_pool
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts
    from code2vec_tpu_torch.ops.pool_kernel import attention_pool_kernel

    g = torch.Generator(device=dev).manual_seed(B * L + H)
    ctx = torch.tanh(torch.randn(B, L, H, generator=g, device=dev))
    lens = torch.randint(1, L + 1, (B,), generator=g, device=dev)
    lens[0] = L
    mask = (torch.arange(L, device=dev)[None, :] < lens[:, None]).float()
    if B > 1:
        mask[-1] = 0.0
    attn = torch.randn(H, generator=g, device=dev) / H**0.5
    reset_launch_counts()
    cv, w = attention_pool_kernel(ctx, mask, attn)
    assert launch_counts() == {"pool": 1}
    cv_ref, w_ref = attention_pool(ctx, mask, attn)
    torch.cuda.synchronize()
    torch.testing.assert_close(cv, cv_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(w, w_ref, rtol=1e-5, atol=1e-5)
    if B > 1:
        torch.testing.assert_close(w[-1], torch.full((L,), 1.0 / L, device=dev), rtol=1e-5,
                                   atol=1e-5)


def test_pool_kernel_scores_past_shared_memory(dev):
    """A CTA's share of a very long bag does not fit in shared memory
    (500,000 contexts over a cluster of 8, 62,500 scores a CTA): the raw
    scores then go through w itself."""
    from code2vec_tpu_torch.ops.attention import attention_pool
    from code2vec_tpu_torch.ops.pool_kernel import MAX_CLUSTER, attention_pool_kernel, pool_ctas

    B, L, H = 4, 500_000, 4
    ctas = pool_ctas(B, L, torch.cuda.get_device_properties(dev).multi_processor_count)
    assert ctas == MAX_CLUSTER and 4 * -(-L // ctas) > 227 * 1024
    g = torch.Generator(device=dev).manual_seed(5)
    ctx = torch.tanh(torch.randn(B, L, H, generator=g, device=dev))
    mask = (torch.rand(B, L, generator=g, device=dev) > 0.5).float()
    attn = torch.randn(H, generator=g, device=dev)
    cv, w = attention_pool_kernel(ctx, mask, attn)
    cv_ref, w_ref = attention_pool(ctx, mask, attn)
    torch.cuda.synchronize()
    torch.testing.assert_close(cv, cv_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(w, w_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,L", [(1, 2048), (5, 257), (64, 200)])
def test_pool_kernel_calls_are_bitwise_repeatable(dev, B, L):
    """A cluster leaves no state behind: two calls give identical bits."""
    from code2vec_tpu_torch.ops.pool_kernel import attention_pool_kernel

    g = torch.Generator(device=dev).manual_seed(B + L)
    ctx = torch.tanh(torch.randn(B, L, 100, generator=g, device=dev))
    mask = (torch.rand(B, L, generator=g, device=dev) > 0.2).float()
    attn = 0.08 * torch.randn(100, generator=g, device=dev)
    cv1, w1 = attention_pool_kernel(ctx, mask, attn)
    cv2, w2 = attention_pool_kernel(ctx, mask, attn)
    torch.cuda.synchronize()
    assert torch.equal(cv1, cv2) and torch.equal(w1, w2)


@pytest.mark.parametrize("B,L", [(1, 37), (1, 2048), (64, 200)])
def test_pool_kernel_is_one_cuda_kernel(dev, B, L):
    """One K1 call launches exactly one CUDA kernel (no combine step),
    counted by the profiler over CUDA activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from code2vec_tpu_torch.ops.pool_kernel import attention_pool_kernel

    ctx = torch.randn(B, L, 100, device=dev)
    mask = torch.ones(B, L, device=dev)
    attn = torch.randn(100, device=dev)
    attention_pool_kernel(ctx, mask, attn)  # build and load outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        attention_pool_kernel(ctx, mask, attn)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 1 and "pool_kernel" in kernels[0], kernels


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


ODD_DIMS = {"odd": (6, 5, 13), "odd2": (5, 9, 21), "top11": (100, 100, 100)}


@pytest.mark.parametrize("dims", list(ODD_DIMS.values()), ids=list(ODD_DIMS))
@pytest.mark.parametrize("edge", [-1, 0, 1, 33, 97])
@pytest.mark.parametrize("impl,mode", [("gather_split", "materialize"), ("fused", "materialize"),
                                       ("fused", "online"), ("fused", "two_pass")])
def test_encode_chunk_edges(dev, impl, mode, edge, dims):
    """Bags ending just before, on and after a chunk step, and in a later one."""
    from code2vec_tpu_torch.ops.fused_encode_pool import fused_encode_attend_pool, reference_forward
    from code2vec_tpu_torch.ops.fused_encode_pool import CHUNK

    L = CHUNK + edge
    t, p, s, pa, e, mask, params = ids_and_tables(dev, 3, L, *dims, seed=L)
    s[0] = s[0].clamp(min=1)  # the first row a full bag: its last slot is the edge
    pa[0], e[0] = pa[0].clamp(min=1), e[0].clamp(min=1)
    mask = (s > 0).float()
    args = (t, p, s, pa, e, mask, *params)
    cv, w = fused_encode_attend_pool(*args, impl=impl, softmax_mode=mode)
    cv_ref, w_ref = reference_forward(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(cv, cv_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(w, w_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("L", [33, 700])
@pytest.mark.parametrize("table_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("mode", ["online", "two_pass"])
def test_streamed_encode300_streams_w(dev, mode, table_dtype, L):
    """Encode 300: W ([300, 300], 360 KB) cannot stay in shared memory, so
    every chunk streams it through the ring of tiles."""
    from code2vec_tpu_torch.ops.fused_encode_pool import (
        fused_encode_attend_pool,
        reference_forward,
        streamed_reference_forward,
    )
    from code2vec_tpu_torch.ops.quant import quantize_table

    t, p, s, pa, e, mask, params = ids_and_tables(dev, 3, L, 100, 100, 300, seed=L)
    if table_dtype != "f32":
        t, p = quantize_table(t, table_dtype), quantize_table(p, table_dtype)
    args = (t, p, s, pa, e, mask, *params)
    cv, w = fused_encode_attend_pool(*args, softmax_mode=mode)
    cv_s, w_s = streamed_reference_forward(*args, softmax_mode=mode)
    cv_m, w_m = reference_forward(*args)
    torch.cuda.synchronize()
    for a, b in ((cv, cv_s), (w, w_s), (cv, cv_m), (w, w_m)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B", [1, 64])
@pytest.mark.parametrize("mode", ["online", "two_pass"])
def test_streamed_full_wave_at_2048(dev, mode, B):
    """L = 2048 on the card's grid: stream_ctas gives B=1 a CTA per chunk
    (64), B=64 a wave of the SMs (S = SMs // 64 CTAs per row)."""
    from code2vec_tpu_torch.ops.fused_encode_pool import (
        fused_encode_attend_pool,
        stream_ctas,
        streamed_reference_forward,
    )

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert stream_ctas(B, 2048, sms) == (64 if B == 1 else max(1, sms // 64))
    t, p, s, pa, e, mask, params = ids_and_tables(dev, B, 2048, 100, 100, 100, seed=B)
    args = (t, p, s, pa, e, mask, *params)
    cv, w = fused_encode_attend_pool(*args, softmax_mode=mode)
    cv_ref, w_ref = streamed_reference_forward(*args, softmax_mode=mode)
    torch.cuda.synchronize()
    torch.testing.assert_close(cv, cv_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(w, w_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl,mode", [("gather_split", "materialize"), ("fused", "materialize"),
                                       ("fused", "online"), ("fused", "two_pass")])
def test_code_vector_within_2e6_of_float64(dev, impl, mode):
    """Top11 widths, one context per row: the code vector is the encoded
    context itself. 3xTF32 keeps it within 2e-6 of the same function in
    float64; a single TF32 product is ~1e-3 off."""
    from code2vec_tpu_torch.ops.fused_encode_pool import LN_EPS, fused_encode_attend_pool

    g = torch.Generator(device=dev).manual_seed(7)
    t = torch.randn(5000, 100, generator=g, device=dev)
    p = torch.randn(4000, 100, generator=g, device=dev)
    ids = [torch.randint(1, v, (64, 1), generator=g, device=dev, dtype=torch.int32)
           for v in (5000, 4000, 5000)]
    W = torch.randn(300, 100, generator=g, device=dev) / 300**0.5
    lns = 1 + 0.1 * torch.randn(100, generator=g, device=dev)
    lnb = 0.1 * torch.randn(100, generator=g, device=dev)
    attn = 0.08 * torch.randn(100, generator=g, device=dev)
    mask = torch.ones(64, 1, device=dev)
    cv, _ = fused_encode_attend_pool(t, p, *ids, mask, W, lns, lnb, attn, impl=impl,
                                     softmax_mode=mode)
    s, pa, e = (x[:, 0].long() for x in ids)
    x = torch.cat([t[s], p[pa], t[e]], dim=1).double()
    y = x @ W.double()
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) ** 2).mean(-1, keepdim=True)
    cv64 = torch.tanh((y - mu) / torch.sqrt(var + LN_EPS) * lns.double() + lnb.double())
    err = (cv.double() - cv64).abs().max().item()
    assert err <= 2e-6, err


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


def lut_inputs(dev, Q, P, C, M, n_list=11, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    lut = torch.randn(Q, M, 256, generator=g, device=dev)
    probed = torch.randint(0, n_list, (Q, P), generator=g, device=dev, dtype=torch.int32)
    codes = torch.randint(0, 256, (n_list, C, M), generator=g, device=dev).to(torch.uint8)
    scales = torch.rand(n_list, C, generator=g, device=dev)
    bias = torch.zeros(n_list, C, device=dev)
    counts = torch.randint(1, C + 1, (n_list,), generator=g, device=dev)
    pad = torch.arange(C, device=dev)[None, :] >= counts[:, None]
    scales[pad] = 0.0
    bias[pad] = float("-inf")
    return lut, probed, codes, scales, bias


def assert_lut_matches(got, ref):
    assert torch.equal(torch.isneginf(got), torch.isneginf(ref))
    fin = torch.isfinite(ref)
    assert torch.isfinite(got[fin]).all()
    torch.testing.assert_close(got[fin], ref[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("Q,P", [(1, 16), (8, 32), (64, 16)])
@pytest.mark.parametrize("M", [6, 8, 16, 20, 32])
@pytest.mark.parametrize("C", [1, 100, 128, 2688, 3000])
def test_lut_score_tiles(dev, C, M, Q, P):
    """K5 on the grid lut_grid gives: many tiles per cell, one, or several
    cells per CTA; a ragged last tile; word and byte code reads."""
    from code2vec_tpu_torch.ann.lut_kernel import lut_score_cells, lut_score_cells_reference
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts

    args = lut_inputs(dev, Q, P, C, M, seed=C * M + Q * P)
    reset_launch_counts()
    got = lut_score_cells(*args)
    assert launch_counts() == {"lut_score": 1}
    ref = lut_score_cells_reference(*args)
    torch.cuda.synchronize()
    assert_lut_matches(got, ref)


@pytest.mark.parametrize("T,G", [(32, 1), (96, 1), (2688, 1), (2688, 2), (2688, 5), (4096, 16)])
@pytest.mark.parametrize("C", [100, 2688])
def test_lut_score_any_grid(dev, monkeypatch, C, T, G):
    """Every (tile rows, cells per CTA) the launcher takes gives the same
    scores, whatever lut_grid would pick: tiles past the cell, a last
    group of fewer than G cells (P = 16)."""
    from code2vec_tpu_torch.ann import lut_kernel

    args = lut_inputs(dev, 3, 16, C, 20, seed=T + G)
    monkeypatch.setattr(lut_kernel, "lut_grid", lambda *a: (T, G))
    got = lut_kernel.lut_score_cells(*args)
    ref = lut_kernel.lut_score_cells_reference(*args)
    torch.cuda.synchronize()
    assert_lut_matches(got, ref)


@pytest.mark.parametrize("offset", [1, 2, 4, 8])
@pytest.mark.parametrize("C,M", [(100, 20), (2688, 20), (128, 6)])
def test_lut_score_unaligned_views(dev, C, M, offset):
    """Codes, scales and bias (and the LUT) as views at an offset into a
    larger buffer: codes that are not word-aligned are read as bytes, a
    LUT that is not 16-byte aligned is copied first."""
    from code2vec_tpu_torch.ann.lut_kernel import lut_score_cells, lut_score_cells_reference

    lut, probed, codes, scales, bias = lut_inputs(dev, 4, 8, C, M, seed=offset)
    n = codes.numel()
    buf = torch.empty(n + 16, dtype=torch.uint8, device=dev)
    buf[offset:offset + n] = codes.flatten()
    codes_v = buf[offset:offset + n].view(codes.shape)
    assert codes_v.data_ptr() % 16 == offset % 16
    fbuf = torch.empty(2, scales.numel() + 4, device=dev)
    k = offset % 4
    fbuf[0, k:k + scales.numel()] = scales.flatten()
    fbuf[1, k:k + bias.numel()] = bias.flatten()
    scales_v = fbuf[0, k:k + scales.numel()].view(scales.shape)
    bias_v = fbuf[1, k:k + bias.numel()].view(bias.shape)
    lbuf = torch.empty(lut.numel() + 4, device=dev)
    lbuf[k:k + lut.numel()] = lut.flatten()
    lut_v = lbuf[k:k + lut.numel()].view(lut.shape)
    got = lut_score_cells(lut_v, probed, codes_v, scales_v, bias_v)
    ref = lut_score_cells_reference(lut, probed, codes, scales, bias)
    torch.cuda.synchronize()
    assert_lut_matches(got, ref)


def test_lut_score_clamps_probed_ids(dev):
    from code2vec_tpu_torch.ann.lut_kernel import lut_score_cells, lut_score_cells_reference

    lut, probed, codes, scales, bias = lut_inputs(dev, 2, 4, 300, 20)
    wild = probed.clone()
    wild[0, 0], wild[1, 3] = -5, 10**6
    clamped = wild.clamp(0, codes.shape[0] - 1)
    got = lut_score_cells(lut, wild, codes, scales, bias)
    ref = lut_score_cells_reference(lut, clamped, codes, scales, bias)
    torch.cuda.synchronize()
    assert_lut_matches(got, ref)


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


def test_meshed_retrieval_at_world1_on_the_card(dev):
    """A searcher and an exact index given a one-rank mesh launch K5 (the
    searcher) and answer bitwise as the unmeshed ones do."""
    import numpy as np

    from code2vec_tpu_torch.ann.index import AnnSearcher, build_index
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts
    from code2vec_tpu_torch.parallel.mesh import single_device_mesh
    from code2vec_tpu_torch.serve.retrieval import RetrievalIndex

    rng = np.random.default_rng(2)
    rows = rng.normal(size=(3001, 20)).astype(np.float32)
    q = rng.normal(size=(5, 20)).astype(np.float32)
    index, _ = build_index(rows, n_list=13, m=10, kmeans_iters=4, pq_iters=4, device=dev)
    mesh = single_device_mesh()
    outs = []
    for m in (None, mesh):
        reset_launch_counts()
        outs.append(AnnSearcher(index, n_probe=5, shortlist=64, mesh=m, device=dev).search(q))
        assert launch_counts() == {"lut_score": 1}
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    labels = [f"m{i}" for i in range(len(rows))]
    exact = [RetrievalIndex(labels, rows, mesh=m, device=dev).top_k_batch(q, 7)
             for m in (None, mesh)]
    assert exact[0] == exact[1]


def test_kmeans_assignment_is_row_local_on_the_card(dev):
    """cuBLAS picks its kernel by the row count (a 10 x 16 product's rows
    moved between 1,200 and 600 rows): the assignment runs in fixed slabs,
    so a row's cell, and its distances, do not depend on the batch, as a
    data axis splits it."""
    import numpy as np

    from code2vec_tpu_torch.ann.kmeans import ASSIGN_SLAB_ROWS, _nearest

    g = torch.Generator(device=dev).manual_seed(0)
    for n, k, e in ((1200, 10, 16), (ASSIGN_SLAB_ROWS + 300, 1000, 100), (16384, 256, 5)):
        x = torch.randn(n, e, generator=g, device=dev)
        c = torch.randn(k, e, generator=g, device=dev)
        whole = _nearest(x, c)
        for parts in (2, 3):
            step = -(-n // parts)
            halves = torch.cat([_nearest(x[lo:lo + step], c) for lo in range(0, n, step)])
            assert torch.equal(halves, whole), (n, k, e, parts)
    assert np.array_equal(_nearest(x[:1], c).cpu().numpy(), whole[:1].cpu().numpy())


@pytest.mark.parametrize("touched", [True, False], ids=["touched", "untouched"])
def test_lazy_rows_over_a_row_shard_on_the_card(dev, touched):
    """``lazy_rows`` on a table's second half (its global ids' shard) never
    waits for the card, untouched shard included, and steps the rows the
    whole table's step steps; an untouched shard keeps every bit."""
    from code2vec_tpu_torch.train.table_opt import lazy_rows

    g = torch.Generator(device=dev).manual_seed(5)
    vocab, dim, n = 64, 16, 4096
    table = torch.randn(vocab, dim, generator=g, device=dev)
    mu, nu = torch.rand(vocab, dim, generator=g, device=dev), torch.rand(
        vocab, dim, generator=g, device=dev)
    hi = vocab if touched else vocab // 2
    ids = torch.randint(0, hi, (n,), generator=g, device=dev)
    slots = torch.randn(n, dim, generator=g, device=dev)
    whole = [t.clone() for t in (table, mu, nu)]
    lazy_rows(*whole, ids, slots, 0.01, 0.9, 0.999, 1e-8)
    shard = [t[vocab // 2:].clone() for t in (table, mu, nu)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        lazy_rows(*shard, ids, slots, 0.01, 0.9, 0.999, 1e-8, row_lo=vocab // 2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for got, want, before in zip(shard, whole, (table, mu, nu)):
        if touched:
            torch.testing.assert_close(got, want[vocab // 2:], rtol=1e-5, atol=1e-6)
        else:
            assert torch.equal(got, before[vocab // 2:])


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


def pool_backward_inputs(dev, B, L, H, seed, dtype=torch.float32):
    """K1b's inputs: contexts and attention vector in ``dtype``, and ``w``
    and ``cv`` from one ``attention_pool`` call on those contexts (widened),
    as K1 gives them to K1b in training."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ctx = torch.tanh(torch.randn(B, L, H, generator=g, device=dev)).to(dtype)
    lens = torch.randint(1, L + 1, (B,), generator=g, device=dev)
    lens[0] = L
    mask = (torch.arange(L, device=dev)[None, :] < lens[:, None]).float()
    if B > 1:
        mask[-1] = 0.0
    attn = (torch.randn(H, generator=g, device=dev) / H**0.5).to(dtype)
    from code2vec_tpu_torch.ops.attention import attention_pool

    cv, w = attention_pool(ctx.float(), mask, attn.float())
    g_cv = torch.randn(B, H, generator=g, device=dev)
    g_w = torch.randn(B, L, generator=g, device=dev)
    return ctx, mask, attn, w, cv, g_cv, g_w


@pytest.mark.parametrize("with_gw", [False, True])
@pytest.mark.parametrize("H", [13, 100, 300])
@pytest.mark.parametrize("L", [1, 37, 200, 2048])
@pytest.mark.parametrize("B", [1, 5, 64, 1024])
def test_pool_backward_kernel(dev, B, L, H, with_gw):
    """K1b against pool_backward_reference, the last row all-masked (its
    d_ctx is w g_cv, no score term): one context a row, rows that end
    inside a task, tasks of 8 and 2 contexts, grids below and at the
    persistent grid's cap."""
    from code2vec_tpu_torch.ops.attention import pool_backward_reference
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts
    from code2vec_tpu_torch.ops.pool_kernel import pool_backward_kernel

    if B * L * H > 40_000_000:
        pytest.skip("the reference's [B, L, H] temporaries: covered at top11 by chip_smoke")
    ctx, mask, attn, w, cv, g_cv, g_w = pool_backward_inputs(dev, B, L, H, B * L + H)
    g_w = g_w if with_gw else None
    reset_launch_counts()
    d_ctx, d_attn = pool_backward_kernel(ctx, mask, attn, w, cv, g_cv, g_w)
    assert launch_counts() == {"pool_bwd": 1}
    r_ctx, r_attn = pool_backward_reference(ctx, mask, attn, w, g_cv, g_w)
    torch.cuda.synchronize()
    torch.testing.assert_close(d_ctx, r_ctx, rtol=0, atol=1e-5)
    torch.testing.assert_close(d_attn, r_attn, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_pool_backward_grid_splits_rows_over_warps(dev, dtype):
    """K1b's persistent grid at B = 300, L = 700, H = 100: 88 tasks a row
    over the capped grid's warps, so a row's tasks land on several warps
    and CTAs and the runs end in a ragged tail. Two calls give the same
    bits, and both agree with the plain version."""
    from code2vec_tpu_torch.ops.attention import pool_backward_reference
    from code2vec_tpu_torch.ops.pool_kernel import pool_backward_kernel, pool_bwd_grid

    B, L, H = 300, 700, 100
    warps = 8  # a CTA's warps, kWarps in csrc/pool.cu
    ctas, tasks = pool_bwd_grid(B, L, H, dtype, dev)
    assert tasks == B * 88 and ctas < tasks // warps and tasks % (ctas * warps) != 0
    ctx, mask, attn, w, cv, g_cv, g_w = pool_backward_inputs(dev, B, L, H, 11, dtype)
    first = pool_backward_kernel(ctx, mask, attn, w, cv, g_cv, g_w)
    second = pool_backward_kernel(ctx, mask, attn, w, cv, g_cv, g_w)
    r_ctx, r_attn = pool_backward_reference(ctx, mask, attn, w, g_cv, g_w)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    d_ctx, d_attn = first
    if dtype == torch.float32:
        torch.testing.assert_close(d_ctx, r_ctx, rtol=0, atol=1e-5)
    else:
        assert ((d_ctx.double() - r_ctx.double()).abs() <= 1e-5 + bf16_ulp(r_ctx)).all()
    torch.testing.assert_close(d_attn, r_attn, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_pool_backward_in_a_cuda_graph(dev, dtype):
    """K1b captured into a CUDA graph and replayed between eager calls on
    the capture's stream and the default one: the captured launch has a
    ticket of its own, so every replay and every eager call gives the same
    bits."""
    from code2vec_tpu_torch.ops.pool_kernel import pool_backward_kernel

    args = pool_backward_inputs(dev, 64, 200, 100, 5, dtype)
    eager = pool_backward_kernel(*args)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        pool_backward_kernel(*args)  # warm-up: builds and loads the kernel
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = pool_backward_kernel(*args)
    for _ in range(3):
        graph.replay()
        with torch.cuda.stream(side):
            again = pool_backward_kernel(*args)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(captured, eager))
        assert all(torch.equal(x, y) for x, y in zip(again, eager))


@pytest.mark.parametrize("B,L", [(1, 2048), (64, 200)])
def test_pool_backward_is_bitwise_repeatable(dev, B, L):
    """No float atomics: the d_attn partials are summed in a fixed order."""
    from code2vec_tpu_torch.ops.pool_kernel import pool_backward_kernel

    args = pool_backward_inputs(dev, B, L, 100, 3)
    a = pool_backward_kernel(*args)
    b = pool_backward_kernel(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dims", [(6, 5, 13), (100, 100, 100)], ids=["odd", "top11"])
@pytest.mark.parametrize("L", [1, 33, 200])
@pytest.mark.parametrize("impl,mode", [("gather_split", "materialize"), ("fused", "materialize"),
                                       ("fused", "online"), ("fused", "two_pass")])
def test_encode_pool_kernel_with_keep_mask(dev, impl, mode, L, dims):
    """K2/K3/K4 with the dropout keep mask against the plain version."""
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts
    from code2vec_tpu_torch.ops.fused_encode_pool import (
        fused_encode_attend_pool,
        kernel_name,
        reference_forward,
    )

    Et, Ep, H = dims
    t, p, s, pa, e, mask, params = ids_and_tables(dev, 6, L, Et, Ep, H, seed=L + 1)
    g = torch.Generator(device=dev).manual_seed(L)
    drop = torch.empty(6, L, H, device=dev).bernoulli_(0.75, generator=g) / 0.75
    args = (t, p, s, pa, e, mask, *params, drop)
    reset_launch_counts()
    cv, w = fused_encode_attend_pool(*args, impl=impl, softmax_mode=mode)
    assert launch_counts() == {kernel_name(impl, "f32", mode, masked=True): 1}
    cv_ref, w_ref = reference_forward(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(cv, cv_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(w, w_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,L", [(2, 2048), (3, 1000), (64, 513)])
def test_keep_mask_with_two_pass_matches_the_streamed_plain_version(dev, B, L):
    """Masked K4 two_pass at long bags, several CTAs a row (each indexes the
    mask by its own chunks), against ``streamed_reference_forward`` with
    the same mask: pass A must score the masked rows that pass B sums."""
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts
    from code2vec_tpu_torch.ops.fused_encode_pool import (
        fused_encode_attend_pool,
        stream_ctas,
        streamed_reference_forward,
    )

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert stream_ctas(B, L, sms) > 1
    t, p, s, pa, e, mask, params = ids_and_tables(dev, B, L, 100, 100, 100, seed=L)
    g = torch.Generator(device=dev).manual_seed(B)
    drop = torch.empty(B, L, 100, device=dev).bernoulli_(0.75, generator=g) / 0.75
    args = (t, p, s, pa, e, mask, *params, drop)
    reset_launch_counts()
    cv, w = fused_encode_attend_pool(*args, softmax_mode="two_pass")
    assert launch_counts() == {"two_pass_f32_masked": 1}
    cv_ref, w_ref = streamed_reference_forward(*args, softmax_mode="two_pass")
    cv_nomask, _ = fused_encode_attend_pool(*args[:-1], softmax_mode="two_pass")
    torch.cuda.synchronize()
    torch.testing.assert_close(cv, cv_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(w, w_ref, rtol=1e-5, atol=1e-5)
    assert (cv - cv_nomask).abs().max() > 1e-3  # the mask was applied


@pytest.mark.parametrize("route", ["pool_only", "gather_split", "fused"])
def test_train_step_on_kernel_route_matches_plain_gradients(dev, route):
    """One train step (dropout 0) on a kernel route: the loss and every
    parameter's gradient against the plain route's, from the same weights."""
    import numpy as np

    from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts
    from code2vec_tpu_torch.train.step import forward_backward

    cfg = Code2VecConfig(terminal_count=301, path_count=157, label_count=19,
                         terminal_embed_size=16, path_embed_size=12, encode_size=24,
                         dropout_prob=0.0)
    base = Code2Vec(cfg).to(dev)
    rng = np.random.default_rng(0)
    s = rng.integers(0, 301, (32, 50))
    s[:, :5] = rng.integers(1, 301, (32, 5))
    batch = {
        "starts": torch.tensor(s, device=dev),
        "paths": torch.tensor(rng.integers(1, 157, (32, 50)) * (s > 0), device=dev),
        "ends": torch.tensor(rng.integers(1, 301, (32, 50)) * (s > 0), device=dev),
        "labels": torch.tensor(rng.integers(0, 19, 32), device=dev),
        "example_mask": torch.ones(32, device=dev),
    }
    weights = torch.ones(19, device=dev)
    grads = {}
    for name, c in (("plain", cfg), (route, cfg.with_updates(use_pallas=True, pallas_impl=route))):
        model = Code2Vec(c).to(dev)
        model.load_state_dict(base.state_dict())
        reset_launch_counts()
        loss = forward_backward(model, batch, weights)
        grads[name] = (loss, {k: p.grad.clone() for k, p in model.named_parameters()})
        if name != "plain":
            key = {"pool_only": "pool_bwd", "gather_split": "gather_split",
                   "fused": "fused_f32"}[route]
            assert launch_counts().get(key, 0) == 1, launch_counts()
    torch.testing.assert_close(grads[route][0], grads["plain"][0], rtol=1e-4, atol=0)
    for k, g in grads["plain"][1].items():
        torch.testing.assert_close(grads[route][1][k], g, rtol=1e-3, atol=1e-5, msg=k)


# ---------------------------------------------------------------------------
# bf16 compute: K1 / K1b over bf16 contexts, K2 over bf16 rows
# ---------------------------------------------------------------------------


def bf16_ulp(x):
    """One bf16 ulp at each element's magnitude (8 significant bits)."""
    mag = x.abs().double().clamp_min(2.0**-126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


@pytest.mark.parametrize("H", [13, 64, 100, 300])
@pytest.mark.parametrize("L", [1, 33, 200, 2048])
@pytest.mark.parametrize("B", [1, 5, 64])
def test_pool_kernel_over_bf16_contexts(dev, B, L, H):
    """K1 reading bf16 contexts (8-byte loads, scalar loads at H = 13)
    against the f32 plain pool on the widened contexts, every cluster size
    pool_ctas gives; the last row all-masked."""
    from code2vec_tpu_torch.ops.attention import attention_pool
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts
    from code2vec_tpu_torch.ops.pool_kernel import attention_pool_kernel

    g = torch.Generator(device=dev).manual_seed(B * L + H)
    ctx = torch.tanh(torch.randn(B, L, H, generator=g, device=dev)).to(torch.bfloat16)
    mask = (torch.rand(B, L, generator=g, device=dev) > 0.3).float()
    mask[:, 0] = 1.0
    if B > 1:
        mask[-1] = 0.0
    attn = (torch.randn(H, generator=g, device=dev) / H**0.5).to(torch.bfloat16)
    reset_launch_counts()
    cv, w = attention_pool_kernel(ctx, mask, attn)
    assert launch_counts() == {"pool_bf16": 1}
    cv_ref, w_ref = attention_pool(ctx.float(), mask, attn.float())
    torch.cuda.synchronize()
    assert cv.dtype == w.dtype == torch.float32
    torch.testing.assert_close(cv, cv_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(w, w_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_gw", [False, True])
@pytest.mark.parametrize("H", [13, 100, 300])
@pytest.mark.parametrize("L", [1, 37, 200, 2048])
@pytest.mark.parametrize("B", [1, 5, 64, 1024])
def test_pool_backward_kernel_over_bf16_contexts(dev, B, L, H, with_gw):
    """K1b reading bf16 contexts and writing bf16 d_contexts: within the
    f32 K1b's atol 1e-5 plus one bf16 ulp of the plain version's value (the
    f32 values, which may differ by rounding, as the f32 kernel's do, are
    each rounded to nearest even once); d_attn f32 within rtol 1e-4 and
    atol 1e-5 plus 1e-6 of its largest element (a sum over B * L terms,
    taken in another order than the plain version's einsum: at 1024 x 37
    the f32 K1b reads 5e-5 off on elements of 0.1 beside ones of 200)."""
    from code2vec_tpu_torch.ops.attention import pool_backward_reference
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts
    from code2vec_tpu_torch.ops.pool_kernel import pool_backward_kernel

    if B * L * H > 40_000_000:
        pytest.skip("the reference's [B, L, H] temporaries: covered at top11 by chip_smoke")
    ctx, mask, attn, w, cv, g_cv, g_w = pool_backward_inputs(dev, B, L, H, B * L + H + 1,
                                                             torch.bfloat16)
    g_w = g_w if with_gw else None
    reset_launch_counts()
    d_ctx, d_attn = pool_backward_kernel(ctx, mask, attn, w, cv, g_cv, g_w)
    assert launch_counts() == {"pool_bwd_bf16": 1}
    r_ctx, r_attn = pool_backward_reference(ctx, mask, attn, w, g_cv, g_w)
    torch.cuda.synchronize()
    assert d_ctx.dtype == torch.bfloat16 and d_attn.dtype == torch.float32
    diff = (d_ctx.double() - r_ctx.double()).abs()
    assert (diff <= 1e-5 + bf16_ulp(r_ctx)).all(), diff.max()
    torch.testing.assert_close(d_attn, r_attn, rtol=1e-4,
                               atol=1e-5 + 1e-6 * r_attn.abs().max().item())


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dims", [(6, 5, 13), (8, 6, 12), (100, 100, 100), (100, 100, 300)],
                         ids=["odd", "small", "top11", "encode300"])
@pytest.mark.parametrize("L", [1, 33, 65, 200])
def test_encode_pool_kernel_over_bf16_rows(dev, L, dims, masked):
    """K2 under bf16 compute (rows gathered in bf16, widened in the kernel,
    two TF32 products) against its plain version, the f32 encode of the
    widened rows."""
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts
    from code2vec_tpu_torch.ops.fused_encode_pool import (
        fused_encode_attend_pool,
        split_reference_forward,
    )

    Et, Ep, H = dims
    t, p, s, pa, e, mask, params = ids_and_tables(dev, 6, L, Et, Ep, H, seed=L + 3)
    drop = None
    if masked:
        g = torch.Generator(device=dev).manual_seed(L)
        drop = torch.empty(6, L, H, device=dev).bernoulli_(0.75, generator=g) / 0.75
    args = (t, p, s, pa, e, mask, *params, drop)
    reset_launch_counts()
    cv, w = fused_encode_attend_pool(*args, impl="gather_split", compute_dtype=torch.bfloat16)
    key = "gather_split_bf16" + ("_masked" if masked else "")
    assert launch_counts() == {key: 1}
    cv_ref, w_ref = split_reference_forward(*args, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    torch.testing.assert_close(cv, cv_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(w, w_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("L", [33, 200])
def test_k2_two_products_on_bf16_rows_give_what_three_give(dev, L, masked):
    """A widened bf16 row is exact in TF32, so its third product adds zero:
    K2 over bf16 rows equals the f32 K2 (three products) fed the same rows
    widened, bit for bit."""
    from code2vec_tpu_torch.ops.fused_encode_pool import fused_encode_attend_pool

    t, p, s, pa, e, mask, params = ids_and_tables(dev, 8, L, 100, 100, 100, seed=L)
    drop = None
    if masked:
        g = torch.Generator(device=dev).manual_seed(L + 1)
        drop = torch.empty(8, L, 100, device=dev).bernoulli_(0.75, generator=g) / 0.75
    two = fused_encode_attend_pool(t, p, s, pa, e, mask, *params, drop, impl="gather_split",
                                   compute_dtype=torch.bfloat16)
    t16, p16 = t.to(torch.bfloat16).float(), p.to(torch.bfloat16).float()
    three = fused_encode_attend_pool(t16, p16, s, pa, e, mask, *params, drop,
                                     impl="gather_split")
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(two, three))


def test_bf16_dtypes_the_kernels_do_not_take_raise(dev):
    from code2vec_tpu_torch.ops.fused_encode_pool import fused_encode_attend_pool
    from code2vec_tpu_torch.ops.pool_kernel import attention_pool_kernel

    mask = torch.ones(2, 3, device=dev)
    with pytest.raises(ValueError, match="must be torch.float32 or torch.bfloat16"):
        attention_pool_kernel(torch.zeros(2, 3, 8, device=dev, dtype=torch.float16), mask,
                              torch.ones(8, device=dev))
    for attn_dtype in (torch.float16, torch.float32):  # the contexts' dtype only
        with pytest.raises(ValueError, match="attn_param must be torch.bfloat16"):
            attention_pool_kernel(torch.zeros(2, 3, 8, device=dev, dtype=torch.bfloat16), mask,
                                  torch.ones(8, device=dev, dtype=attn_dtype))
    t, p, s, pa, e, mask, params = ids_and_tables(dev, 2, 5, 6, 5, 12)
    with pytest.raises(ValueError, match="compute_dtype"):
        fused_encode_attend_pool(t, p, s, pa, e, mask, *params, impl="gather_split",
                                 compute_dtype=torch.float16)


@pytest.mark.parametrize("route", ["plain", "pool_only", "gather_split", "fused"])
def test_bf16_train_step_on_the_card_matches_the_cpu(dev, route):
    """One bf16-compute train step (dropout 0) on the card against the same
    model on the CPU (the plain versions): the loss within 2^-7 relative
    and every gradient within 2^-5 of its largest element (cuBLAS and the
    CPU round bf16 products apart); each kernel route launches its bf16
    kernels."""
    import numpy as np

    from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts
    from code2vec_tpu_torch.train.step import forward_backward

    kernel = dict(use_pallas=True, pallas_impl=route) if route != "plain" else {}
    cfg = Code2VecConfig(terminal_count=301, path_count=157, label_count=19,
                         terminal_embed_size=16, path_embed_size=12, encode_size=24,
                         dropout_prob=0.0, dtype=torch.bfloat16, **kernel)
    base = Code2Vec(cfg)
    rng = np.random.default_rng(1)
    s = rng.integers(0, 301, (32, 50))
    s[:, :5] = rng.integers(1, 301, (32, 5))
    host = {
        "starts": torch.tensor(s),
        "paths": torch.tensor(rng.integers(1, 157, (32, 50)) * (s > 0)),
        "ends": torch.tensor(rng.integers(1, 301, (32, 50)) * (s > 0)),
        "labels": torch.tensor(rng.integers(0, 19, 32)),
        "example_mask": torch.ones(32),
    }
    out = {}
    for where in ("cpu", dev):
        model = Code2Vec(cfg).to(where)
        model.load_state_dict(base.state_dict())
        reset_launch_counts()
        loss = forward_backward(model, {k: v.to(where) for k, v in host.items()},
                                torch.ones(19, device=where))
        out[str(where)] = (loss.cpu(), {k: p.grad.cpu() for k, p in model.named_parameters()})
        counts = launch_counts()
    # K6 once a table lookup: [starts; ends] and paths, or each of the three
    want = {"plain": {"table_grad": 2},
            "pool_only": {"pool_bf16": 1, "pool_bwd_bf16": 1, "table_grad": 2},
            "gather_split": {"gather_split_bf16": 1, "table_grad": 3},
            "fused": {"fused_f32": 1, "table_grad": 3}}[route]
    assert counts == want
    (loss, grads), (ref_loss, ref_grads) = out[str(dev)], out["cpu"]
    torch.testing.assert_close(loss, ref_loss, rtol=2.0**-7, atol=0)
    for k, g in ref_grads.items():
        torch.testing.assert_close(grads[k], g, rtol=0, atol=2.0**-5 * g.abs().max().item(),
                                   msg=k)


# ---------------------------------------------------------------------------
# the lazy table optimizer (--table_update lazy)
# ---------------------------------------------------------------------------

LAZY_DIMS = dict(terminal_count=301, path_count=157, label_count=19, terminal_embed_size=16,
                 path_embed_size=12, encode_size=24, dropout_prob=0.0)


def lazy_batches(n, B=32, L=50, seed=2):
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        s = rng.integers(0, 301, (B, L))
        s[:, :5] = rng.integers(1, 301, (B, 5))
        out.append({
            "starts": torch.tensor(s),
            "paths": torch.tensor(rng.integers(1, 157, (B, L)) * (s > 0)),
            "ends": torch.tensor(rng.integers(1, 301, (B, L)) * (s > 0)),
            "labels": torch.tensor(rng.integers(0, 19, B)),
            "example_mask": torch.ones(B),
        })
    return out


def lazy_model(route, where, seed=5):
    from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig

    kernel = dict(use_pallas=True, pallas_impl=route) if route != "plain" else {}
    model = Code2Vec(Code2VecConfig(**LAZY_DIMS, **kernel))
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(where)


@pytest.mark.parametrize("route", ["plain", "pool_only", "gather_split", "fused"])
def test_lazy_steps_on_the_card_match_the_cpu_plain_steps(dev, route):
    """Three lazy steps (dropout 0) on the card's route against the plain
    route's on the CPU from the same weights: each step's loss (rtol 1e-4)
    and the tables' per-slot and the other parameters' gradients (atol 1e-5
    / rtol 1e-3, the route differential's); after each step every
    parameter and the tables' two moments, over every row, within the lazy
    step's tolerance against JAX (atol 3e-5 / rtol 1e-4); the rows a step
    leaves untouched, and their moments, bit for bit unchanged; the tables
    get no ``.grad``; the route's kernels launched once a step."""
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts
    from code2vec_tpu_torch.train.config import TrainConfig
    from code2vec_tpu_torch.train.step import lazy_forward_backward, make_optimizer

    batches = lazy_batches(3)
    cfg = TrainConfig(lr=0.01, table_update="lazy")
    runs, states = {}, {}
    for name, where in (("cpu", "cpu"), ("card", dev)):
        model = lazy_model(route if name == "card" else "plain", where)
        opt = make_optimizer(model, cfg)
        weights = torch.ones(19, device=where)
        tables = [model.terminal_embedding.weight, model.path_embedding.weight]
        steps = []
        reset_launch_counts()
        for host in batches:
            batch = {k: v.to(where) for k, v in host.items()}
            before = [(t.detach().clone(), opt.state[t]["exp_avg"].clone(),
                       opt.state[t]["exp_avg_sq"].clone()) for t in tables]
            opt.zero_grad(set_to_none=True)
            loss, table_grads = lazy_forward_backward(model, batch, weights)
            assert all(t.grad is None for t in tables)
            steps.append((loss.cpu(), [s.cpu() for _, s in table_grads],
                          {k: p.grad.cpu() for k, p in model.named_parameters()
                           if p.grad is not None}))
            opt.step(table_grads)
            for t, prev, (ids, _) in zip(tables, before, table_grads):
                untouched = torch.ones(t.shape[0], dtype=torch.bool, device=t.device)
                untouched[ids.long()] = False
                now = (t.detach(), opt.state[t]["exp_avg"], opt.state[t]["exp_avg_sq"])
                for a, b in zip(now, prev):
                    assert torch.equal(a[untouched], b[untouched])
            state = {k: p.detach().cpu().clone() for k, p in model.named_parameters()}
            for k, t in zip(("terminal", "path"), tables):
                state[f"{k} mu"] = opt.state[t]["exp_avg"].cpu().clone()
                state[f"{k} nu"] = opt.state[t]["exp_avg_sq"].cpu().clone()
            states.setdefault(name, []).append(state)
        runs[name] = steps
        counts = launch_counts()
    want = {"plain": {}, "pool_only": {"pool": 3, "pool_bwd": 3},
            "gather_split": {"gather_split": 3}, "fused": {"fused_f32": 3}}[route]
    assert counts == want
    for (loss, slots, grads), (ref_loss, ref_slots, ref_grads) in zip(runs["card"], runs["cpu"]):
        torch.testing.assert_close(loss, ref_loss, rtol=1e-4, atol=0)
        for a, b in zip(slots, ref_slots):
            torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-5)
        assert grads.keys() == ref_grads.keys()
        for k, g in ref_grads.items():
            torch.testing.assert_close(grads[k], g, rtol=1e-3, atol=1e-5, msg=k)
    for i, (state, ref_state) in enumerate(zip(states["card"], states["cpu"])):
        assert state.keys() == ref_state.keys()
        for k, v in ref_state.items():
            torch.testing.assert_close(state[k], v, rtol=1e-4, atol=3e-5, msg=f"step {i}: {k}")


@pytest.mark.parametrize("route", ["plain", "fused"])
def test_lazy_table_step_never_waits_for_the_card(dev, route):
    """A warm lazy step's table optimizer (and the whole step) under
    ``torch.cuda.set_sync_debug_mode("error")``: no device-to-host sync."""
    from code2vec_tpu_torch.train.config import TrainConfig
    from code2vec_tpu_torch.train.step import (
        lazy_forward_backward,
        make_optimizer,
        train_step,
    )

    model = lazy_model(route, dev)
    opt = make_optimizer(model, TrainConfig(lr=0.01, table_update="lazy"))
    weights = torch.ones(19, device=dev)
    batches = [{k: v.to(dev) for k, v in b.items()} for b in lazy_batches(3)]
    train_step(model, opt, batches[0], weights)
    opt.zero_grad(set_to_none=True)
    _, table_grads = lazy_forward_backward(model, batches[1], weights)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        opt.step(table_grads)
        train_step(model, opt, batches[2], weights)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_lazy_step_forms_no_dense_table_gradient(dev):
    """The profiler's op list of a lazy step: no table gradient (K6's
    ``table_grad_level`` kernel, or ``F.embedding``'s backward) and no
    ``[V, E]``-sized zero or ``index_put``; a dense step shows K6."""
    from torch.profiler import ProfilerActivity, profile

    from code2vec_tpu_torch.train.config import TrainConfig
    from code2vec_tpu_torch.train.step import make_optimizer, train_step

    weights = torch.ones(19, device=dev)
    batch = {k: v.to(dev) for k, v in lazy_batches(1)[0].items()}
    table_shapes = {(301, 16), (157, 12)}
    found = {}
    for update in ("dense", "lazy"):
        model = lazy_model("plain", dev)
        opt = make_optimizer(model, TrainConfig(lr=0.01, table_update=update))
        train_step(model, opt, batch, weights)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            train_step(model, opt, batch, weights)
            torch.cuda.synchronize()
        found[update] = sorted({
            "table_grad_level" if "table_grad_level" in e.name else e.name
            for e in prof.events()
            if e.name == "aten::embedding_dense_backward" or "table_grad_level" in e.name
            or (e.name in ("aten::zero_", "aten::zeros", "aten::index_put_", "aten::index_put",
                           "aten::index_add_")
                and any(tuple(s) in table_shapes for s in (e.input_shapes or [])))})
        if update == "lazy":
            assert model.terminal_embedding.weight.grad is None
            assert model.path_embedding.weight.grad is None
    assert found["dense"] == ["table_grad_level"], found
    assert found["lazy"] == [], found


def staged_on(dev, lens, seed=0):
    import numpy as np

    from code2vec_tpu_torch.train.device_epoch import StagedCorpus

    rng = np.random.default_rng(seed)
    splits = np.zeros(len(lens) + 1, np.int32)
    np.cumsum(lens, out=splits[1:])
    ctx = rng.integers(1, 1000, (int(splits[-1]), 3)).astype(np.int32)
    labels = rng.integers(0, 7, len(lens)).astype(np.int32)
    return StagedCorpus(*(torch.from_numpy(x).to(dev) for x in (ctx, splits, labels)),
                        len(lens), np.asarray(lens, np.int64))


def test_device_sampler_on_the_card_matches_the_cpu(dev):
    from code2vec_tpu_torch.train.device_epoch import sample_batch_from_shift

    lens = [5, 8, 1, 0, 13, 400, 200, 201]
    corpus = staged_on(dev, lens)
    rows = torch.tensor([0, 1, 2, 3, 4, 5, 6, 7, 0, 0], dtype=torch.int32, device=dev)
    valid = torch.tensor([1.0] * 8 + [0.0] * 2, device=dev)
    shift = torch.randint(0, 1 << 30, (10, 1), generator=torch.Generator(device=dev).manual_seed(1),
                          device=dev)
    args = (corpus.contexts, corpus.row_splits, corpus.labels, rows, valid, 200, shift)
    got = sample_batch_from_shift(*args)
    want = sample_batch_from_shift(*(a.cpu() if torch.is_tensor(a) else a for a in args))
    for k in want:
        assert got[k].device.type == "cuda" and got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k].cpu(), want[k]), k


@pytest.mark.parametrize("bag", [8, 200])
def test_device_prefetch_on_the_card_samples_the_same_batches(dev, bag):
    """``sample_prefetch`` samples on a second stream: the batches (read
    after the chunk, from the consuming stream) and the generator's state
    afterwards equal the unprefetched runner's."""
    import numpy as np

    from code2vec_tpu_torch.train.device_epoch import EpochRunner, sampler_generator

    corpus = staged_on(dev, list(np.random.default_rng(2).integers(0, 300, 100)))
    order = np.random.default_rng(3).permutation(100)
    out = []
    for prefetch in (False, True):
        runner = EpochRunner(torch.ones(7, device=dev), 16, bag, 4, prefetch)
        g = sampler_generator(0, dev)
        batches = [{k: v.clone() for k, v in b.items()}
                   for lo, nb, nv in runner._chunk_plan(100)
                   for b in runner._batches(corpus, order, lo, nb, nv, g)]
        torch.cuda.synchronize()
        out.append((batches, g.get_state()))
    (a, sa), (b, sb) = out
    assert len(a) == len(b) == 7 and torch.equal(sa, sb)
    for x, y in zip(a, b):
        for k in x:
            assert torch.equal(x[k], y[k]), k


# ---------------------------------------------------------------------------
# variable-name rows: short rows and all-PAD rows that are real examples
# ---------------------------------------------------------------------------

def variable_mask(dev, B, L, seed=0):
    """A variable-task batch's shape of bag: rows 0 and B/2 all PAD (an
    alias no context touches, still an example), a quarter of the rows one
    context, the rest 2-40 contexts, PAD after."""
    g = torch.Generator(device=dev).manual_seed(seed)
    lens = torch.randint(2, min(40, L) + 1, (B,), generator=g, device=dev)
    lens[: B // 4 + 1] = 1
    lens[0] = lens[B // 2] = 0
    return (torch.arange(L, device=dev)[None, :] < lens[:, None]).float()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,L", [(64, 8), (64, 200), (1024, 200)])
def test_pool_and_backward_on_variable_rows(dev, B, L, dtype):
    """K1 and K1b against the plain pool and its backward: an all-PAD row
    pools uniformly (1/L a slot) and its d_ctx is w g_cv."""
    from code2vec_tpu_torch.ops.attention import attention_pool, pool_backward_reference
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts
    from code2vec_tpu_torch.ops.pool_kernel import attention_pool_kernel, pool_backward_kernel

    H = 100
    g = torch.Generator(device=dev).manual_seed(B + L)
    mask = variable_mask(dev, B, L, B + L)
    ctx = torch.tanh(torch.randn(B, L, H, generator=g, device=dev)).to(dtype)
    attn = (torch.randn(H, generator=g, device=dev) / H**0.5).to(dtype)
    reset_launch_counts()
    cv, w = attention_pool_kernel(ctx, mask, attn)
    cv_ref, w_ref = attention_pool(ctx.float(), mask, attn.float())
    torch.testing.assert_close(cv, cv_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(w, w_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(w[0], torch.full((L,), 1.0 / L, device=dev), rtol=1e-6, atol=0)
    g_cv = torch.randn(B, H, generator=g, device=dev)
    d_ctx, d_attn = pool_backward_kernel(ctx, mask, attn, w_ref, cv_ref, g_cv, None)
    bf16 = dtype == torch.bfloat16
    assert launch_counts() == ({"pool_bf16": 1, "pool_bwd_bf16": 1} if bf16 else
                               {"pool": 1, "pool_bwd": 1})
    r_ctx, r_attn = pool_backward_reference(ctx, mask, attn, w_ref, g_cv, None)
    torch.cuda.synchronize()
    diff = (d_ctx.double() - r_ctx.double()).abs()
    assert (diff <= 1e-5 + (bf16_ulp(r_ctx) if bf16 else 0.0)).all(), diff.max()
    torch.testing.assert_close(d_attn, r_attn, rtol=1e-4,
                               atol=1e-5 + 1e-6 * r_attn.abs().max().item())


@pytest.mark.parametrize("B", [64, 1024])
@pytest.mark.parametrize("impl", ["gather_split", "fused"])
def test_masked_encode_pool_on_variable_rows(dev, impl, B):
    """Masked K2 / K3 (the dropout keep mask, as training runs them) at
    top11 widths on variable rows, against the plain version."""
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts
    from code2vec_tpu_torch.ops.fused_encode_pool import (
        fused_encode_attend_pool,
        kernel_name,
        reference_forward,
    )

    L = 200
    t, p, s, pa, e, _, params = ids_and_tables(dev, B, L, 100, 100, 100, seed=B)
    mask = variable_mask(dev, B, L, B)
    s, pa, e = (torch.where(mask > 0, x.clamp(min=1), 0).int() for x in (s, pa, e))
    g = torch.Generator(device=dev).manual_seed(B + 1)
    drop = torch.empty(B, L, 100, device=dev).bernoulli_(0.75, generator=g) / 0.75
    args = (t, p, s, pa, e, mask, *params, drop)
    reset_launch_counts()
    cv, w = fused_encode_attend_pool(*args, impl=impl)
    assert launch_counts() == {kernel_name(impl, "f32", "materialize", masked=True): 1}
    cv_ref, w_ref = reference_forward(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(cv, cv_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(w, w_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(w[B // 2], torch.full((L,), 1.0 / L, device=dev), rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("route", ["pool_only", "gather_split", "fused"])
def test_variable_train_step_on_kernel_route_matches_plain(dev, route):
    """One step (dropout 0) on a batch the device sampler draws from
    staged variable rows, the remap on: the loss and every gradient on the
    kernel route against the plain route's."""
    import numpy as np

    from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts
    from code2vec_tpu_torch.train.device_epoch import StagedCorpus, sample_batch
    from code2vec_tpu_torch.train.step import forward_backward

    rng = np.random.default_rng(0)
    lens = [0, 1, 1, 1, 3, 17, 0, 40, 250] + list(rng.integers(0, 30, 55))
    splits = np.zeros(len(lens) + 1, np.int32)
    np.cumsum(lens, out=splits[1:])
    ctx = rng.integers(1, 157, (int(splits[-1]), 3)).astype(np.int32)
    ctx[:, 0] = rng.integers(1, 301, len(ctx))
    ctx[:, 2] = rng.integers(1, 301, len(ctx))
    var_ids = np.arange(2, 14, dtype=np.int32)
    corpus = StagedCorpus(*(torch.from_numpy(x).to(dev) for x in (
        ctx, splits, rng.integers(0, 19, len(lens)).astype(np.int32))), len(lens),
        np.asarray(lens, np.int64), torch.from_numpy(var_ids).to(dev),
        torch.ones(len(lens), dtype=torch.int32, device=dev))
    batch = sample_batch(corpus, torch.arange(len(lens), dtype=torch.int32, device=dev),
                         torch.ones(len(lens), device=dev), 200,
                         torch.Generator(device=dev).manual_seed(1), shuffle_variable_ids=True)
    cfg = Code2VecConfig(terminal_count=301, path_count=157, label_count=19,
                         terminal_embed_size=100, path_embed_size=100, encode_size=100,
                         dropout_prob=0.0)
    base = Code2Vec(cfg).to(dev)
    weights = torch.ones(19, device=dev)
    grads = {}
    for name, c in (("plain", cfg), (route, cfg.with_updates(use_pallas=True, pallas_impl=route))):
        model = Code2Vec(c).to(dev)
        model.load_state_dict(base.state_dict())
        reset_launch_counts()
        loss = forward_backward(model, batch, weights)
        grads[name] = (loss, {k: p.grad.clone() for k, p in model.named_parameters()})
        if name != "plain":
            key = {"pool_only": "pool_bwd", "gather_split": "gather_split",
                   "fused": "fused_f32"}[route]
            assert launch_counts().get(key, 0) == 1, launch_counts()
    torch.testing.assert_close(grads[route][0], grads["plain"][0], rtol=1e-4, atol=0)
    for k, g in grads["plain"][1].items():
        torch.testing.assert_close(grads[route][1][k], g, rtol=1e-3, atol=1e-5, msg=k)


def test_device_remap_on_the_card_matches_the_cpu(dev):
    """The sampler's remap (argsort, searchsorted, take_along_dim) on the
    card bit for bit the CPU's, for the same shifts and uniform draw."""
    import numpy as np

    from code2vec_tpu_torch.train.device_epoch import sample_batch_from_shift

    rng = np.random.default_rng(4)
    lens = [0, 1, 5, 40, 300, 7]
    splits = np.zeros(len(lens) + 1, np.int32)
    np.cumsum(lens, out=splits[1:])
    ctx = rng.integers(1, 40, (int(splits[-1]), 3)).astype(np.int32)
    var_ids = torch.tensor([3, 5, 9, 20], dtype=torch.int32)
    flags = torch.tensor([0, 1, 1, 0, 1, 1], dtype=torch.int32)
    rows = torch.tensor([0, 1, 2, 3, 4, 5, 5, 0], dtype=torch.int32)
    shift = torch.randint(0, 1 << 30, (8, 1), generator=torch.Generator().manual_seed(1))
    u = torch.rand((8, 4), generator=torch.Generator().manual_seed(2))
    args = (torch.from_numpy(ctx), torch.from_numpy(splits), torch.arange(6, dtype=torch.int32),
            rows, torch.ones(8), 64, shift, var_ids, flags, u)
    want = sample_batch_from_shift(*args)
    got = sample_batch_from_shift(*(a.to(dev) if torch.is_tensor(a) else a for a in args))
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k


# ---------------------------------------------------------------------------
# the host feed on the card: the prefetcher's copy stream, feed workers
# forked from a process whose CUDA context is live
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workers", [0, 2])
def test_prefetch_on_the_card_feeds_the_sync_batches(dev, tmp_path, workers):
    """Batches copied on the prefetcher's own stream, read on the consuming
    stream, equal the synchronous copies; ``train()`` prefetched (and fed by
    workers) gives the synchronous run's losses within rtol 1e-5."""
    import numpy as np

    from code2vec_tpu_torch.data import pipeline, reader, synth
    from code2vec_tpu_torch.train import loop
    from code2vec_tpu_torch.train.config import TrainConfig
    from code2vec_tpu_torch.train.prefetch import device_batches
    from code2vec_tpu_torch.train.step import to_device

    paths = synth.generate_corpus_files(tmp_path, synth.SPECS["tiny"])
    data = reader.load_corpus(paths["corpus"], paths["path_idx"], paths["terminal_idx"],
                              cache=False, native=False)
    source = pipeline.EpochSource(data, np.arange(data.n_items), 16, 40, ladder=(10, 20, 40))
    sync = [to_device(b, dev) for b in source.batches(np.random.default_rng(1))]
    with device_batches(source.batches(np.random.default_rng(1)), lambda b: to_device(b, dev),
                        prefetch=2, device=dev) as stream:
        got = [{k: v.clone() for k, v in d.items()} for _, d in stream]
    torch.cuda.synchronize()
    assert len(got) == len(sync) == 13
    for a, b in zip(sync, got):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    cfg = TrainConfig(terminal_embed_size=8, path_embed_size=6, encode_size=12, batch_size=16,
                      max_path_length=40, max_epoch=2, random_seed=5, print_sample_cycle=0,
                      use_pallas=True, pallas_impl="fused")
    want = loop.train(cfg, data, device=dev)
    fed = loop.train(cfg.with_updates(prefetch_batches=2, feed_workers=workers), data,
                     device=dev)
    for a, b in zip(want.history, fed.history):
        for key in ("train_loss", "test_loss"):
            np.testing.assert_allclose(b[key], a[key], rtol=1e-5)


@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
def test_mid_epoch_kill_and_resume_on_the_card_is_bitwise(dev, tmp_path, async_save):
    """A small fused run (masked K3, dropout 0.25 from the card's generator)
    killed with ``raise`` at a step inside epoch 1, after that epoch's
    mid-epoch save, and resumed on the card: the history and the final
    weights bitwise the uninterrupted run's."""
    from code2vec_tpu_torch import faultinject
    from code2vec_tpu_torch.data import reader, synth
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts
    from code2vec_tpu_torch.train import loop
    from code2vec_tpu_torch.train.config import TrainConfig

    paths = synth.generate_corpus_files(tmp_path, synth.SPECS["tiny"])
    data = reader.load_corpus(paths["corpus"], paths["path_idx"], paths["terminal_idx"],
                              cache=False, native=False)
    cfg = TrainConfig(terminal_embed_size=32, path_embed_size=32, encode_size=64, batch_size=32,
                      max_path_length=32, max_epoch=3, print_sample_cycle=0, checkpoint_cycle=1,
                      dropout_prob=0.25, use_pallas=True, pallas_impl="fused",
                      async_checkpoint=async_save)
    whole = loop.train(cfg, data, str(tmp_path / "whole"), device=dev)
    reset_launch_counts()
    with pytest.raises(faultinject.FaultInjected):
        loop.train(cfg.with_updates(checkpoint_every_steps=3, fault_plan="train_step@9:raise"),
                   data, str(tmp_path / "killed"), device=dev)
    resumed = loop.train(cfg.with_updates(resume=True), data, str(tmp_path / "killed"),
                         device=dev)
    assert launch_counts().get("fused_f32_masked", 0) >= 9
    assert resumed.history[1]["replayed_batches"] == 3
    assert len(resumed.history) == len(whole.history) == 3
    for a, b in zip(whole.history, resumed.history):
        for key in ("train_loss", "test_loss", "accuracy", "precision", "recall", "f1"):
            assert a[key] == b[key], (a["epoch"], key, a[key], b[key])
    want, got = whole.model.state_dict(), resumed.model.state_dict()
    for k in want:
        assert torch.equal(want[k], got[k]), k


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True], ids=["keep", "masked"])
def test_k2_over_rows_gathered_outside_is_gather_split(dev, cd, masked):
    """A mesh's row-sharded tables hand K2 rows gathered outside the op
    (``encode_attend_pool_rows``): the same launch as ``gather_split``'s,
    bitwise, and its backward is the recomputed plain version's."""
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts
    from code2vec_tpu_torch.ops.fused_encode_pool import (
        encode_attend_pool_rows,
        encode_pool_reference,
        fused_encode_attend_pool,
        gathered_rows,
        kernel_name,
    )

    t, p, s, pa, e, mask, params = ids_and_tables(dev, 8, 200, 100, 100, 100, seed=5)
    drop = None
    if masked:
        g = torch.Generator(device=dev).manual_seed(9)
        drop = torch.empty(8, 200, 100, device=dev).bernoulli_(0.75, generator=g) / 0.75
    rows = gathered_rows(t, p, s, pa, e, dtype=cd)
    reset_launch_counts()
    cv, w = encode_attend_pool_rows(*rows, mask, *params, drop, compute_dtype=cd)
    want = fused_encode_attend_pool(t, p, s, pa, e, mask, *params, drop, impl="gather_split",
                                    compute_dtype=cd)
    key = kernel_name("gather_split", "f32", "materialize", masked, cd)
    assert launch_counts() == {key: 2}
    assert torch.equal(cv, want[0]) and torch.equal(w, want[1])
    leaves = [r.detach().requires_grad_() for r in rows] + [
        x.detach().requires_grad_() for x in params]
    cv, _ = encode_attend_pool_rows(*leaves[:3], mask, *leaves[3:], drop, compute_dtype=cd)
    got = torch.autograd.grad(cv.sum(), leaves)
    ref_leaves = [x.detach().requires_grad_() for x in leaves]
    ref, _ = encode_pool_reference(*ref_leaves[:3], mask, *ref_leaves[3:], drop,
                                   compute_dtype=cd)
    for a, b in zip(got, torch.autograd.grad(ref.sum(), ref_leaves)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


AUTO_ROUTES = {  # route -> (impl, softmax, the one kernel its forward launches)
    "xla": ("xla", "materialize", None),
    "pool_only": ("pool_only", "materialize", "pool"),
    "gather_split": ("gather_split", "materialize", "gather_split"),
    "fused": ("fused", "materialize", "fused_f32"),
    "online": ("fused", "online", "online_f32"),
    "two_pass": ("fused", "two_pass", "two_pass_f32"),
}


@pytest.mark.parametrize("route", list(AUTO_ROUTES))
def test_auto_launches_the_cached_routes_kernel_only(dev, tmp_path, route):
    from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig, route_config
    from code2vec_tpu_torch.ops import autotune as at
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts

    impl, softmax, kernel = AUTO_ROUTES[route]
    B, L = 8, 72
    cfg = Code2VecConfig(terminal_count=301, path_count=157, label_count=11,
                         terminal_embed_size=24, path_embed_size=16, encode_size=40,
                         dropout_prob=0.0, use_pallas=True, pallas_impl="auto")
    sched = at.KernelSchedule(impl=impl, softmax=softmax, backend="gpu")
    cache = at.ScheduleCache(str(tmp_path / "at.json"))
    cache.put(at.ShapeKey(at.device_kind(dev), B, L, 24, 16, 40, "f32"), sched)
    cache.save()
    at.get_cache(cache.path)
    try:
        with torch.device(dev):
            model = Code2Vec(cfg).eval()
            fixed = Code2Vec(route_config(cfg, sched)).eval()
        fixed.load_state_dict(model.state_dict())
        _, _, s, pa, e, _, _ = ids_and_tables(dev, B, L, 24, 16, 40, seed=2)
        with torch.no_grad():
            model(s, pa, e)  # builds and loads the kernels
            torch.cuda.synchronize()
            reset_launch_counts()
            got = model(s, pa, e)
            torch.cuda.synchronize()
            counts = launch_counts()
            want = fixed(s, pa, e)
        assert counts == ({} if kernel is None else {kernel: 1}), counts
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    finally:
        at.reset_cache()


def test_an_xla_lut_entry_is_a_miss_on_the_card(dev, tmp_path):
    import numpy as np

    from code2vec_tpu_torch.ann.index import AnnSearcher, build_index
    from code2vec_tpu_torch.ops import autotune as at
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts

    rows = np.random.default_rng(0).normal(size=(2000, 32)).astype(np.float32)
    index, _ = build_index(rows, n_list=16, m=8, seed=0, kmeans_iters=4, pq_iters=4,
                           device=dev)
    meta = index.meta
    cache = at.ScheduleCache(str(tmp_path / "at.json"))
    cache.put(at.LutShapeKey(at.device_kind(dev), meta["m"], meta["n_list"], meta["capacity"],
                             64), at.LutSchedule(impl="xla", backend="gpu"))
    searcher = AnnSearcher(index, n_probe=4, shortlist=64, device=dev, cache=cache)
    assert searcher.schedule == at.default_lut_schedule(dev)
    assert searcher.describe()["schedule"]["impl"] == "pallas"
    reset_launch_counts()
    searcher.search(rows[:3])
    assert launch_counts().get("lut_score", 0) == 1


@pytest.mark.parametrize("site", ["K1", "K2", "K3", "K4 online", "K5"])
def test_contracts_raise_before_a_launch_and_never_sync(dev, site):
    """A malformed CUDA input raises ``ContractError`` at the kernel entry
    before its wrapper launches anything, and the check alone on healthy
    CUDA tensors runs under ``set_sync_debug_mode("error")``."""
    from code2vec_tpu_torch.analysis.contracts import ContractError
    from code2vec_tpu_torch.ann.lut_kernel import lut_score_cells
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts
    from code2vec_tpu_torch.ops.fused_encode_pool import fused_encode_attend_pool
    from code2vec_tpu_torch.ops.pool_kernel import attention_pool_kernel

    g = torch.Generator(device=dev).manual_seed(20)
    if site == "K1":
        fn = attention_pool_kernel
        args = dict(contexts=torch.randn(4, 9, 13, generator=g, device=dev),
                    mask=torch.ones(4, 9, device=dev),
                    attn_param=torch.randn(13, generator=g, device=dev))
        bad = dict(args, attn_param=args["attn_param"][:-1])
    elif site == "K5":
        fn = lut_score_cells
        args = dict(lut=torch.randn(2, 4, 256, generator=g, device=dev),
                    probed=torch.zeros(2, 3, dtype=torch.int32, device=dev),
                    codes=torch.zeros(5, 32, 4, dtype=torch.uint8, device=dev),
                    scales=torch.ones(5, 32, device=dev), bias=torch.zeros(5, 32, device=dev))
        bad = dict(args, probed=args["probed"].float())
    else:
        t, p, s, pa, e, mask, (W, lns, lnb, attn) = ids_and_tables(dev, 4, 40, 8, 6, 16)
        impl, mode = {"K2": ("gather_split", "materialize"), "K3": ("fused", "materialize"),
                      "K4 online": ("fused", "online")}[site]

        def fn(**a):
            return fused_encode_attend_pool(**a, impl=impl, softmax_mode=mode)

        fn.check = fused_encode_attend_pool.check
        args = dict(t_table=t, p_table=p, starts=s, paths=pa, ends=e, mask=mask,
                    dense_kernel=W, ln_scale=lns, ln_bias=lnb, attn_param=attn)
        bad = dict(args, mask=mask[..., None])
    torch.cuda.synchronize()
    reset_launch_counts()
    with pytest.raises(ContractError):
        fn(**bad)
    with pytest.raises(ContractError):  # a Python scalar where a tensor goes
        fn(**dict(args, attn_param=1.0) if "attn_param" in args else dict(args, lut=1.0))
    torch.cuda.synchronize()
    assert launch_counts() == {}
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn.check(**args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    fn(**args)
    assert sum(launch_counts().values()) >= 1


# ---------------------------------------------------------------------------
# spans inside device epochs (obs/trace.py): timed on the card, no sync
# ---------------------------------------------------------------------------

def heavy_chunk_case(dev, update):
    """Device epochs the card sets the pace of: batch 1024 at bag 200, width
    128, encode 384 and a 100,000-label head in f32 (a step ~5 ms on the
    card, ~1 ms of the host's launches), 8 steps a chunk over 8,192 rows."""
    import numpy as np

    from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig
    from code2vec_tpu_torch.train.config import TrainConfig
    from code2vec_tpu_torch.train.device_epoch import (
        EpochRunner,
        StagedCorpus,
        sampler_generator,
    )
    from code2vec_tpu_torch.train.step import make_optimizer

    rng = np.random.default_rng(0)
    n, vocab, labels = 8192, 50_000, 100_000
    lens = rng.integers(1, 300, n)
    splits = np.zeros(n + 1, np.int32)
    np.cumsum(lens, out=splits[1:])
    ctx = rng.integers(1, vocab, (int(splits[-1]), 3)).astype(np.int32)
    corpus = StagedCorpus(*(torch.from_numpy(x).to(dev) for x in (
        ctx, splits, rng.integers(0, labels, n).astype(np.int32))), n, lens.astype(np.int64))
    cfg = Code2VecConfig(terminal_count=vocab, path_count=vocab, label_count=labels,
                         terminal_embed_size=128, path_embed_size=128, encode_size=384,
                         dropout_prob=0.25, use_pallas=True, pallas_impl="pool_only")
    with torch.device(dev):
        model = Code2Vec(cfg)
    opt = make_optimizer(model, TrainConfig(lr=0.001, table_update=update))
    runner = EpochRunner(torch.ones(labels, device=dev), 1024, 200, 8)
    order = rng.permutation(n)
    g = sampler_generator(0, dev)

    def chunk():
        from code2vec_tpu_torch.train.step import StepTally

        runner.train_chunk(model, opt, corpus, order, 0, 8, n, g, StepTally(dev))

    return chunk


@pytest.mark.parametrize("update", ["dense", "lazy"])
def test_traced_ranges_sum_to_the_step_time(dev, update):
    """The ``sample``, ``forward``, ``backward`` and ``optimizer`` spans'
    device times of a chunk sum to within 3% of its time between two CUDA
    events around it; a lazy step's spans count the touched rows."""
    from code2vec_tpu_torch.obs.trace import Tracer, set_tracer

    chunk = heavy_chunk_case(dev, update)
    chunk()
    torch.cuda.synchronize()
    tracer = Tracer()
    previous = set_tracer(tracer)
    try:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        chunk()
        b.record()
    finally:
        set_tracer(previous)
    torch.cuda.synchronize()
    whole = a.elapsed_time(b)
    summary = tracer.summary()
    ranges = {k: summary[k] for k in ("sample", "forward", "backward", "optimizer")}
    assert all(r["count"] == r["device_count"] == 8 for r in ranges.values()), summary
    total = sum(r["device_ms"] for r in ranges.values())
    assert abs(total - whole) <= 0.03 * whole, (total, whole, summary)
    args = summary["optimizer"]["args"]
    if update == "lazy":
        assert args["terminal_rows_processed"] == 8 * 1024 * 400
        assert 0 < args["terminal_rows_touched"] <= 8 * 50_000
    else:
        assert "terminal_rows_touched" not in args


def test_tracing_adds_no_sync(dev):
    """Under ``set_sync_debug_mode("warn")`` a traced chunk (lazy tables,
    the device edges of the chunk before it read at its start) warns of no
    more syncs than the same chunk untraced."""
    import warnings

    from code2vec_tpu_torch.obs.trace import Tracer, set_tracer

    chunk = heavy_chunk_case(dev, "lazy")
    tracer = Tracer()
    counts = {}
    for kind in ("untraced", "traced", "traced again"):
        previous = set_tracer(tracer if kind != "untraced" else None)
        chunk()
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                chunk()
            finally:
                torch.cuda.set_sync_debug_mode("default")
                set_tracer(previous)
        counts[kind] = sum("synchroniz" in str(w.message) for w in seen)
        torch.cuda.synchronize()
    assert counts["traced"] <= counts["untraced"] and counts["traced again"] <= counts["untraced"]
    assert tracer.summary()["train_step"]["count"] == 32


def test_drained_is_false_through_a_device_bound_chunk(dev):
    """A chunk enqueued behind another: every edged span finds work the
    card has not finished, so ``drained`` is false on each and the chunk
    counts no late step; after a sync the next span finds the card
    drained."""
    import time

    from code2vec_tpu_torch.obs.trace import Tracer, set_tracer

    chunk = heavy_chunk_case(dev, "dense")
    chunk()
    torch.cuda.synchronize()
    tracer = Tracer()
    previous = set_tracer(tracer)
    try:
        chunk()
        between = time.perf_counter_ns()
        chunk()
        torch.cuda.synchronize()
        chunk()
    finally:
        set_tracer(previous)
    torch.cuda.synchronize()
    first, second = tracer.summary(end_ns=between), tracer.summary(start_ns=between)
    edged = ("sample", "forward", "backward", "optimizer")
    assert first["sample"]["count"] + second["sample"]["count"] == 24
    events = [e for e in tracer.chrome_trace()["traceEvents"] if e.get("name") in edged]
    assert all("drained" in e["args"] for e in events[1:]), events[:2]
    late = [e["args"]["late_steps"] for e in tracer.chrome_trace()["traceEvents"]
            if e.get("name") == "train_chunk"]
    assert late[1] == 0, late
    assert late[2] >= 1, late  # its first sample found the card drained by the sync
    assert tracer.drained_edges >= 1


# ---------------------------------------------------------------------------
# K6: the dense tables' gradient (ops/embed.py, csrc/table_grad.cu)
# ---------------------------------------------------------------------------

TOP11_TABLES = {"terminal": (360_633, (1024, 400)), "path": (342_846, (1024, 200))}
# case -> (rows of the table, ids' shape, width, id dtype)
K6_CASES = {
    "top11_terminal": (*TOP11_TABLES["terminal"], 100, torch.int32),
    "top11_path": (*TOP11_TABLES["path"], 100, torch.int64),
    "width128_int32": (300_000, (512, 400), 128, torch.int32),
    "width128_int64": (300_000, (512, 400), 128, torch.int64),
    "width7": (1000, (64, 200), 7, torch.int32),
    "one_id": (10, (100_000,), 100, torch.int32),
    "distinct": (70_000, (70_000,), 100, torch.int64),
    "last_row": (1000, (3000,), 100, torch.int32),
    "empty": (50, (0,), 100, torch.int32),
    "one_slot": (50, (1,), 100, torch.int64),
}


def k6_ids(dev, case, generator):
    v, shape, _, dtype = K6_CASES[case]
    n = math.prod(shape)
    if case == "one_id":
        return torch.full(shape, 5, dtype=dtype, device=dev)
    if case == "distinct":
        return torch.randperm(v, generator=generator, device=dev).to(dtype).view(shape)
    if case == "last_row":
        return torch.full(shape, v - 1, dtype=dtype, device=dev)
    ids = torch.randint(2, v, (n,), generator=generator, device=dev, dtype=dtype)
    ids[torch.rand(n, generator=generator, device=dev) < 0.374] = 0  # the bags' PAD share
    return ids.view(shape)


def split_rows_of(ids):
    """Rows in runs of equal ids longer than one chunk of K6 (32)."""
    if ids.numel() == 0:
        return 0
    counts = torch.bincount(ids.reshape(-1).long())
    return int(counts[counts > 32].sum())


@pytest.mark.parametrize("case", list(K6_CASES) + ["odd_address"])
def test_table_grad_matches_the_f64_reference(dev, case):
    """K6 against ``table_grad_reference`` in f64: each element within
    1e-6 of the sum of its rows' magnitudes (f32 sums of chunks of 32 and a
    few levels of pieces), two calls bitwise equal, one launch a call, and
    its split rows exactly the rows in runs longer than a chunk. ``odd_address``:
    rows one float off 16-byte alignment (the scalar path)."""
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts
    from code2vec_tpu_torch.ops.embed import (
        collect_split_rows,
        table_grad_kernel,
        table_grad_reference,
    )

    g = torch.Generator(device=dev).manual_seed(len(case))
    ids = k6_ids(dev, "width7" if case == "odd_address" else case, g)
    v, _, e, _ = K6_CASES["width7" if case == "odd_address" else case]
    if case == "odd_address":
        e = 8
        rows = torch.randn(ids.numel() * e + 1, generator=g, device=dev)[1:].view(*ids.shape, e)
    else:
        rows = torch.randn(*ids.shape, e, generator=g, device=dev)
    reset_launch_counts()
    with collect_split_rows(dev) as split:
        got = table_grad_kernel(ids, rows, v)
    again = table_grad_kernel(ids, rows, v)
    assert launch_counts() == {"table_grad": 2}
    want = table_grad_reference(ids, rows.double(), v)
    mass = table_grad_reference(ids, rows.double().abs(), v)
    torch.cuda.synchronize()
    assert got.shape == (v, e) and got.dtype == torch.float32
    assert torch.equal(got, again)
    assert ((got.double() - want).abs() <= 1e-6 * mass + 1e-12).all()
    assert split.item() == split_rows_of(ids)


@pytest.mark.parametrize("mode", ["dense", "segment", "segment_sorted"])
def test_embedding_lookup_backward_is_k6_in_every_mode(dev, mode):
    """``embedding_lookup``'s forward is the gather bit for bit; its
    backward is one K6 launch, bitwise a direct call's, in every mode."""
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts
    from code2vec_tpu_torch.ops.embed import embedding_lookup, table_grad_kernel

    g = torch.Generator(device=dev).manual_seed(4)
    ids = k6_ids(dev, "width128_int32", g)
    table = torch.randn(300_000, 128, generator=g, device=dev, requires_grad=True)
    rows = embedding_lookup(table, ids, mode)
    assert torch.equal(rows, table.detach()[ids])
    cot = torch.randn_like(rows)
    reset_launch_counts()
    rows.backward(cot)
    assert launch_counts() == {"table_grad": 1}
    assert torch.equal(table.grad, table_grad_kernel(ids, cot, 300_000))


def test_table_grad_of_the_row_sharded_lookup(dev):
    """The mesh's row-sharded lookup (ids outside the shard read row 0,
    their rows zeroed after): the shard's gradient is the reference's over
    the shard's own slots, and row 0 the sum of its real slots only."""
    from code2vec_tpu_torch.ops.embed import embedding_lookup, table_grad_reference

    g = torch.Generator(device=dev).manual_seed(6)
    ids = k6_ids(dev, "top11_terminal", g)
    rows, lo = 180_317, 180_316  # the second of two shards
    store = torch.randn(rows, 100, generator=g, device=dev, requires_grad=True)
    local = ids - lo
    inside = (local >= 0) & (local < rows)
    got = embedding_lookup(store, torch.where(inside, local, 0))
    got = torch.where(inside[..., None], got, 0.0)
    cot = torch.randn_like(got)
    got.backward(cot)
    want = table_grad_reference(local[inside], cot[inside].double(), rows)
    mass = table_grad_reference(local[inside], cot[inside].double().abs(), rows)
    torch.cuda.synchronize()
    assert ((store.grad.double() - want).abs() <= 1e-6 * mass + 1e-12).all()


@pytest.mark.parametrize("update", ["dense", "lazy"])
def test_table_grad_launches_in_a_device_epoch_chunk(dev, update):
    """A chunk of 8 dense ``pool_only`` device-epoch steps launches K6 16
    times (each table once a step) and its traced ``backward`` spans count
    the split rows; a lazy chunk launches none and counts none."""
    from code2vec_tpu_torch.obs.trace import Tracer, set_tracer
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts

    chunk = heavy_chunk_case(dev, update)
    chunk()
    torch.cuda.synchronize()
    reset_launch_counts()
    chunk()
    torch.cuda.synchronize()
    assert launch_counts().get("table_grad", 0) == (16 if update == "dense" else 0)
    tracer = Tracer()
    previous = set_tracer(tracer)
    try:
        chunk()
    finally:
        set_tracer(previous)
    args = tracer.summary()["backward"]["args"]
    if update == "dense":
        # the PAD runs alone: > 32 rows a step, at most every slot of 8 steps
        assert 8 * 33 <= args["table_grad_split_rows"] <= 8 * 1024 * 600, args
    else:
        assert "table_grad_split_rows" not in args, args
