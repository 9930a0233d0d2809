#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of code2vec on one NVIDIA H100.

    python3 chip_smoke.py [--json_out PATH]

Phases (each one that fails prints its traceback; any failure exits 1 and
the final result line is not printed):

1. device  — require CUDA and compute capability 9.0; print the card's
   name and power limit (``nvidia-smi``) and the torch/CUDA versions;
2. build   — compile every ``code2vec_tpu_torch/csrc/*.cu`` with ``nvcc``
   for sm_90a (one process per source, in parallel);
3. kernels — K1 (pool), K2 (encode-pool over gathered rows) and K3
   (encode-pool with the gather inside; f32, bf16 and int8 tables) at the
   top11 widths, B in {1, 8, 64} x L in {1, 37, 200}; K4 (the streamed
   softmax, online and two_pass x f32/bf16/int8) at B in {1, 8, 64} x L in
   {512, 1024, 2048}; the first row of every batch a full bag, PAD tails
   in the others and, when B > 1, one all-masked row; each
   held against its plain PyTorch version (max |err| <= 1e-5, f32 compute
   on both sides, TF32 off) and timed with CUDA events (median of 30
   launches after warmup, L2 flushed before each launch);
4. serve   — a top11-width model dir with random weights from a seed,
   served through the port's own ``build_server`` with each kernel route
   (K3 with f32, int8 and bf16 tables, K2, K1): 96 predict/embed requests
   per route, bag lengths 1-400 (over-long bags are subsampled), part one
   at a time and part pipelined so they coalesce. Every response must be
   ok and finite, every code vector must match the same model run without
   kernels on the card (rtol 2e-4, atol 2e-5), top-1 labels must agree,
   nothing may warm after startup, and each route's kernel must have been
   launched. The launch counts are reset just before each route is served
   and read just after;
5. longbag — the same model with the long-bag rungs that
   ``derive_longbag_ladder`` gives above 200 (512, 1024, 2048), served
   through ``--longbag_widths`` once per K4 variant (online and two_pass x
   f32/bf16/int8 tables): 96 requests, three quarters with 1-200 contexts
   and one quarter with 201-2048 (log-uniform, one of 2048), mixed
   predict/embed, one at a time and pipelined. Code vectors within 1e-5 of
   the model without kernels, K4 launched, nothing warmed after startup;
6. retrieval — a synthetic clustered corpus made as ``bench.py`` makes its
   ANN corpus (1,000,000 rows at dim 100, the served encode width; 8,192
   true clusters, noise 0.12), an IVF-PQ index built on the card (n_list
   1,000, m 20, shortlist 256) and saved; K5 held against its plain
   version at Q in {1, 8, 64} x n_probe in {8, 16} on the index's shapes;
   then a server with ``--retrieval_backend ann`` answers 64 ``neighbors``
   queries one at a time in the ``vector`` form on ``exact`` and on
   ``ann``, and 16 in the ``contexts`` form on each. Reports p50/p99 per
   backend, recall@10 of ann against exact at n_probe 8/16/32, the probed
   fraction, and fails if the ann shortlists differ (as id sets) from the
   same searcher with the plain scoring or K5 never launched;
7. the line ``{"kernels": [...]}`` (per kernel: route, source, the TPU
   kernel it replaces, launches on its serve route, max error, times at
   the headline shape and the bound), then, last, the result line.

With ``--json_out`` the per-shape kernel records and serving numbers are
also written to that file.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

TOP11 = dict(terminal_count=360_633, path_count=342_846, label_count=8_000,
             terminal_embed_size=100, path_embed_size=100, encode_size=100)
BAG, LADDER, BATCH_SIZES = 200, (25, 50, 100, 200), (1, 8, 64)
SHAPES = [(b, l) for b in (1, 8, 64) for l in (1, 37, 200)]
TIMED_SHAPE = (64, 200)
LONG_SHAPES = [(b, l) for b in (1, 8, 64) for l in (512, 1024, 2048)]
LONG_TIMED_SHAPE = (64, 2048)
LONGBAG_RUNGS = (512, 1024, 2048)
K4_MODES = ("online", "two_pass")
# the retrieval corpus (bench.py's ANN corpus at the served encode width)
ANN_N, ANN_DIM, ANN_CLUSTERS, ANN_NOISE = 1_000_000, 100, 8192, 0.12
ANN_NLIST, ANN_M, ANN_SHORTLIST, ANN_PROBE = 1000, 20, 256, 16
ANN_QUERIES, ANN_CONTEXT_QUERIES = 64, 16
K5_SHAPES = [(q, p) for q in (1, 8, 64) for p in (8, 16)]
K5_TIMED_SHAPE = (1, ANN_PROBE)  # a neighbors query: one at a time
TOL = 1e-5  # kernel vs plain version, f32 compute on both sides
SERVE_RTOL, SERVE_ATOL = 2e-4, 2e-5
N_TIMED = 30
# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth, and f32 on
# the FMA pipes (the kernels compute in f32 without tensor cores)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


# ---------------------------------------------------------------------------
# phase 3: kernels
# ---------------------------------------------------------------------------


class KernelBench:
    def __init__(self, torch, dev):
        self.torch = torch
        self.dev = dev
        self.flush_buf = torch.empty(96 * 2**20, dtype=torch.uint8, device=dev)

    def time_ms(self, fn) -> float:
        """Median device milliseconds of one call over N_TIMED launches,
        each with a cold L2 (a 96 MB write before it, outside the timed
        events). The card is held busy (``torch.cuda._sleep``) while the
        host enqueues the call, so host launch overhead is not timed."""
        torch = self.torch
        for _ in range(3):
            fn()
        times = []
        for _ in range(N_TIMED):
            self.flush_buf.zero_()
            torch.cuda._sleep(4_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))


def bag_keep(torch, dev, g, B, L):
    """[B, L] real-context mask: the first row a full bag of L, the others
    uniform in 1..L with PAD tails, and the last row all-PAD when B > 1."""
    lens = torch.randint(1, L + 1, (B,), generator=g, device=dev)
    lens[0] = L
    if B > 1:
        lens[-1] = 0
    return torch.arange(L, device=dev)[None, :] < lens[:, None]


def pool_inputs(torch, dev, g, B, L, H):
    ctx = torch.tanh(torch.randn(B, L, H, generator=g, device=dev))
    mask = bag_keep(torch, dev, g, B, L).float()
    attn = 0.08 * torch.randn(H, generator=g, device=dev)
    return ctx, mask, attn


def id_inputs(torch, dev, g, B, L):
    c = TOP11
    s = torch.randint(1, c["terminal_count"], (B, L), generator=g, device=dev, dtype=torch.int32)
    p = torch.randint(1, c["path_count"], (B, L), generator=g, device=dev, dtype=torch.int32)
    e = torch.randint(1, c["terminal_count"], (B, L), generator=g, device=dev, dtype=torch.int32)
    keep = bag_keep(torch, dev, g, B, L)
    s, p, e = (x * keep for x in (s, p, e))
    return s, p, e, (s > 0).float()


def pool_bound(B, L, H):
    nbytes = 4 * (B * L * H + 2 * B * L + H + B * H)
    flops = 4 * B * L * H
    return nbytes, flops


def encode_pool_bound(torch, s, p, e, mask, table_dtype, H):
    """Bytes of the rows these ids need (each distinct row once) plus ids,
    mask, weights and outputs; flops of encode + LayerNorm/tanh/pool for
    the contexts the function needs: each real one, plus one encode per
    all-PAD row (its uniform weights average one repeated row); a PAD slot
    of a row with real contexts has weight exactly 0 and needs none."""
    c = TOP11
    B, L = s.shape
    et, ep = c["terminal_embed_size"], c["path_embed_size"]
    d = 2 * et + ep
    item = {"f32": 4, "bf16": 2, "int8": 1}[table_dtype]
    scale = 4 if table_dtype == "int8" else 0
    t_rows = torch.unique(torch.cat([s.flatten(), e.flatten()])).numel()
    p_rows = torch.unique(p.flatten()).numel()
    nbytes = (t_rows * (et * item + scale) + p_rows * (ep * item + scale)
              + 4 * (4 * B * L + d * H + 3 * H + B * H + B * L))
    real = int(mask.sum().item()) + int((mask.sum(dim=1) == 0).sum().item())
    flops = (2 * d * H + 8 * H) * real
    return nbytes, flops


def bound_of(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch, dev) -> dict:
    import torch.nn.functional as F

    from code2vec_tpu_torch.ops.attention import NINF, attention_pool
    from code2vec_tpu_torch.ops.fused_encode_pool import (
        fused_encode_attend_pool,
        reference_forward,
        streamed_reference_forward,
    )
    from code2vec_tpu_torch.ops.pool_kernel import attention_pool_kernel
    from code2vec_tpu_torch.ops.quant import quantize_table

    c = TOP11
    H, D = c["encode_size"], 2 * c["terminal_embed_size"] + c["path_embed_size"]
    g = torch.Generator(device=dev).manual_seed(1234)
    bench = KernelBench(torch, dev)
    t_f32 = torch.randn(c["terminal_count"], c["terminal_embed_size"], generator=g, device=dev)
    p_f32 = torch.randn(c["path_count"], c["path_embed_size"], generator=g, device=dev)
    tables = {"f32": (t_f32, p_f32)}
    for dt in ("bf16", "int8"):
        tables[dt] = (quantize_table(t_f32, dt), quantize_table(p_f32, dt))
    W = torch.randn(D, H, generator=g, device=dev) / math.sqrt(D)
    lns = 1.0 + 0.1 * torch.randn(H, generator=g, device=dev)
    lnb = 0.1 * torch.randn(H, generator=g, device=dev)
    attn = 0.08 * torch.randn(H, generator=g, device=dev)

    specs = [  # (name, launch key, source, replaces, impl, table dtype, softmax, shapes)
        ("K1 pool", "pool", "code2vec_tpu_torch/csrc/pool.cu",
         "code2vec_tpu/ops/pallas_attention.py:114", None, None, None, SHAPES),
        ("K2 encode_pool gather_split", "gather_split",
         "code2vec_tpu_torch/csrc/fused_encode_pool.cu",
         "code2vec_tpu/ops/fused_encode_pool.py:651", "gather_split", "f32", "materialize",
         SHAPES),
    ] + [
        (f"K3 encode_pool fused {dt}", f"fused_{dt}",
         "code2vec_tpu_torch/csrc/fused_encode_pool.cu",
         "code2vec_tpu/ops/fused_encode_pool.py:651", "fused", dt, "materialize", SHAPES)
        for dt in ("f32", "bf16", "int8")
    ] + [
        (f"K4 encode_pool {mode} {dt}", f"{mode}_{dt}",
         "code2vec_tpu_torch/csrc/fused_encode_pool.cu",
         "code2vec_tpu/ops/fused_encode_pool.py:651", "fused", dt, mode, LONG_SHAPES)
        for mode in K4_MODES for dt in ("f32", "bf16", "int8")
    ]
    records = {}
    for name, key, source, replaces, impl, dt, mode, shapes in specs:
        rows = []
        for B, L in shapes:
            library = None
            if impl is None:
                ctx, mask, a = pool_inputs(torch, dev, g, B, L, H)
                kernel = lambda: attention_pool_kernel(ctx, mask, a)  # noqa: E731
                plain = lambda: attention_pool(ctx, mask, a)  # noqa: E731
                add_mask = ((1.0 - mask) * NINF)[:, None, :]

                def library():
                    return F.scaled_dot_product_attention(
                        a.expand(B, 1, H), ctx, ctx, attn_mask=add_mask, scale=1.0
                    )

                nbytes, flops = pool_bound(B, L, H)
            else:
                s, p, e, mask = id_inputs(torch, dev, g, B, L)
                T, P = tables[dt]
                args = (T, P, s, p, e, mask, W, lns, lnb, attn)
                kernel = lambda: fused_encode_attend_pool(  # noqa: E731
                    *args, impl=impl, softmax_mode=mode)
                if mode == "materialize":
                    plain = lambda: reference_forward(*args)  # noqa: E731
                else:
                    plain = lambda: streamed_reference_forward(  # noqa: E731
                        *args, softmax_mode=mode)
                nbytes, flops = encode_pool_bound(torch, s, p, e, mask, dt, H)
            cv, w = kernel()
            cv_ref, w_ref = plain()
            torch.cuda.synchronize()
            if not (torch.isfinite(cv).all() and torch.isfinite(w).all()):
                raise AssertionError(f"{name} at {(B, L)}: non-finite output")
            err = max((cv - cv_ref).abs().max().item(), (w - w_ref).abs().max().item())
            if mode == "materialize" or impl is None:
                torch.testing.assert_close(cv, cv_ref, rtol=TOL, atol=TOL)
                torch.testing.assert_close(w, w_ref, rtol=TOL, atol=TOL)
            elif err > TOL:
                raise AssertionError(f"{name} at {(B, L)}: max |err| {err:.3e} > {TOL}")
            bound_s, bound_by = bound_of(nbytes, flops)
            row = {
                "B": B, "L": L, "max_abs_err": err,
                "ms": bench.time_ms(kernel), "plain_ms": bench.time_ms(plain),
                "library_ms": bench.time_ms(library) if library else None,
                "bound_ms": bound_s * 1e3, "bound_by": bound_by,
                "bytes": nbytes, "flops": flops,
            }
            rows.append(row)
            print(f"kernel {name:32s} B={B:3d} L={L:4d} max_abs_err={err:.3e} "
                  f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                  f"library_ms={row['library_ms']} bound_ms={row['bound_ms']:.4f} "
                  f"({bound_by})", flush=True)
        timed = LONG_TIMED_SHAPE if shapes is LONG_SHAPES else TIMED_SHAPE
        records[name] = dict(key=key, source=source, replaces=replaces, rows=rows,
                             timed=timed)
    print("kernels checked: " + ", ".join(f"{n}: ok" for n in records), flush=True)
    return records


# ---------------------------------------------------------------------------
# phase 4: serve
# ---------------------------------------------------------------------------


def write_model_dir(torch, path: Path, device, seed: int = 0) -> None:
    from code2vec_tpu_torch import interop
    from code2vec_tpu_torch.formats.vocab_io import write_vocab
    from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig

    c = TOP11
    cfg = Code2VecConfig(**c)
    with torch.device(device):
        model = Code2Vec(cfg)
    model.reset_parameters(torch.Generator(device=device).manual_seed(seed))
    interop.save_state_dict(model.state_dict(), str(path), cfg)
    meta = dict(c, angular_margin_loss=False, angular_margin=0.5, inverse_temp=30.0,
                vocab_pad_multiple=1, max_path_length=BAG, infer_method_name=True,
                infer_variable_name=False, table_dtype="f32", bucket_ladder=list(LADDER))
    (path / "model_meta.json").write_text(json.dumps(meta))
    write_vocab(path / "label_vocab.txt", ((i, f"label{i}") for i in range(c["label_count"])))
    # "@question" takes terminal index 1, so the file holds count-1 names
    write_vocab(path / "terminal_idxs.txt",
                ((i, f"t{i}" if i else "<PAD/>") for i in range(c["terminal_count"] - 1)))
    write_vocab(path / "path_idxs.txt",
                ((i, f"p{i}" if i else "<PAD/>") for i in range(c["path_count"])))


def make_requests(n_requests: int, seed: int, lengths=None) -> list[dict]:
    c = TOP11
    rng = np.random.default_rng(seed)
    if lengths is None:
        lengths = np.clip(rng.lognormal(np.log(60), 1.0, n_requests).astype(int), 1, 400)
        lengths[:4] = (1, 200, 201, 400)
    reqs = []
    for i, n in enumerate(lengths):
        ctx = np.stack([
            rng.integers(1, c["terminal_count"], n),
            rng.integers(1, c["path_count"], n),
            rng.integers(0, c["terminal_count"], n),
        ], axis=1)
        reqs.append({"id": i, "op": "predict" if i % 2 == 0 else "embed",
                     "contexts": ctx.tolist(), "top_k": 5, "include_vector": True})
    return reqs


def longbag_lengths(n_requests: int, seed: int) -> np.ndarray:
    """Three quarters of the bags 1-200 contexts, one quarter 201-2048,
    both log-uniform, shuffled; the first long one is exactly 2048."""
    rng = np.random.default_rng(seed)
    n_long = n_requests // 4
    short = np.exp(rng.uniform(0, np.log(BAG), n_requests - n_long)).astype(int)
    long = np.exp(rng.uniform(np.log(BAG + 1), np.log(LONGBAG_RUNGS[-1]), n_long)).astype(int)
    long[0] = LONGBAG_RUNGS[-1]
    lengths = np.clip(np.concatenate([short, long]), 1, LONGBAG_RUNGS[-1])
    # the 2048 bag is served one at a time and pipelined (the second copy)
    order = rng.permutation(n_requests)
    lengths = lengths[order]
    lengths[np.flatnonzero(lengths == LONGBAG_RUNGS[-1])[0]] = BAG + 7
    lengths[0], lengths[-1] = LONGBAG_RUNGS[-1], LONGBAG_RUNGS[-1]
    return lengths


def serve_route(torch, model_dir: Path, impl: str, table_dtype: str, requests, smi,
                device, *, extra=(), ladder=LADDER, rtol=SERVE_RTOL, atol=SERVE_ATOL) -> dict:
    from code2vec_tpu_torch.data.pipeline import nearest_bucket_width
    from code2vec_tpu_torch.models.code2vec import Code2Vec
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts
    from code2vec_tpu_torch.predict import softmax_top_k, subsample
    from code2vec_tpu_torch.serve.__main__ import build_parser, build_server

    args = build_parser().parse_args([
        "--model_path", str(model_dir),
        "--terminal_idx_path", str(model_dir / "terminal_idxs.txt"),
        "--path_idx_path", str(model_dir / "path_idxs.txt"),
        "--table_dtype", table_dtype, "--pallas_impl", impl,
        "--batch_sizes", ",".join(map(str, BATCH_SIZES)), "--deadline_ms", "2",
        "--device", str(device), *extra,
    ])
    max_width = ladder[-1]
    label = f"{impl}/{table_dtype}" + (f" {' '.join(extra)}" if extra else "")
    reset_launch_counts()
    t0 = time.perf_counter()
    server = build_server(args)
    startup_s = time.perf_counter() - t0
    n_seq = len(requests) // 3
    latencies, responses = [], []
    try:
        for req in requests[:n_seq]:
            t = time.perf_counter()
            responses.append(server.handle(req))
            latencies.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        resolvers = [server.handle_async(req) for req in requests[n_seq:]]
        responses += [r() for r in resolvers]
        pipelined_s = time.perf_counter() - t
        health = server.handle({"op": "health"})
    finally:
        server.close()
    counts = launch_counts()

    # the same model without kernels, on the card, at full f32 precision
    predictor = server.predictor
    with torch.device("meta"):
        plain = Code2Vec(predictor.config.with_updates(use_pallas=False))
    plain.load_state_dict(predictor.model.state_dict(), assign=True)
    plain.eval()
    worst, top1_agree, coalesced = 0.0, 0, 0
    for req, resp in zip(requests, responses):
        if not resp.get("ok"):
            raise AssertionError(f"request {req['id']} failed: {resp}")
        (entry,) = resp["methods"]
        cv = np.asarray(entry["code_vector"], np.float32)
        if not np.isfinite(cv).all():
            raise AssertionError(f"request {req['id']}: non-finite code vector")
        coalesced = max(coalesced, entry["timing"]["coalesced"])
        ctx = np.asarray(subsample(req["contexts"], max_width), np.int32)
        width = nearest_bucket_width(len(ctx), ladder)
        ids = np.zeros((3, 1, width), np.int32)
        ids[:, 0, : len(ctx)] = ctx.T
        with torch.inference_mode():
            logits_ref, cv_ref, _ = plain(
                *(torch.from_numpy(x).to(predictor.device) for x in ids),
                quant_tables=predictor.quant_tables,
            )
        cv_ref = cv_ref[0].cpu().numpy()
        worst = max(worst, float(np.abs(cv - cv_ref).max()))
        np.testing.assert_allclose(cv, cv_ref, rtol=rtol, atol=atol)
        if req["op"] == "predict":
            ref = logits_ref[0].cpu().numpy()
            ref_top = softmax_top_k(ref, TOP11["label_count"], 1)[0][0]
            served = int(entry["predictions"][0]["name"].removeprefix("label"))
            # a served top-1 that ties the reference's within the logit
            # tolerance is the same answer up to rounding
            top1_agree += served == ref_top or ref[ref_top] - ref[served] <= SERVE_ATOL
    n_predict = sum(r["op"] == "predict" for r in requests)
    if top1_agree != n_predict:
        raise AssertionError(f"{label}: top-1 agrees on {top1_agree}/{n_predict}")
    if health["post_warmup_compiles"] != 0:
        raise AssertionError(f"{label}: post-warmup compiles {health}")
    if health["ladder"] != list(ladder):
        raise AssertionError(f"{label}: served ladder {health['ladder']}, expected {ladder}")
    if coalesced < 2:
        raise AssertionError(f"{label}: pipelined requests never coalesced")
    long_lat = [t for t, req in zip(latencies, requests) if len(req["contexts"]) > BAG]
    result = {
        "route": impl, "table_dtype": table_dtype, "requests": len(requests),
        "startup_s": startup_s, "launches": counts,
        "sequential_p50_ms": float(np.percentile(latencies, 50)),
        "sequential_p99_ms": float(np.percentile(latencies, 99)),
        "sequential_long_p50_ms": float(np.percentile(long_lat, 50)) if long_lat else None,
        "sequential_long_n": len(long_lat),
        "pipelined_requests_per_s": (len(requests) - n_seq) / pipelined_s,
        "max_coalesced": coalesced, "max_abs_err_vs_plain": worst,
        "top1_agree": f"{top1_agree}/{n_predict}",
        "post_warmup_compiles": health["post_warmup_compiles"],
        "executables": health["executables"],
    }
    print(f"serve {label}: {len(requests)} requests ok, startup "
          f"{startup_s:.2f}s, one-at-a-time p50 {result['sequential_p50_ms']:.3f} ms "
          f"p99 {result['sequential_p99_ms']:.3f} ms (bags > {BAG}: p50 "
          f"{result['sequential_long_p50_ms']} ms over {len(long_lat)}), pipelined "
          f"{result['pipelined_requests_per_s']:.1f} req/s (max {coalesced} coalesced), "
          f"max |cv - plain| {worst:.3e}, top-1 {result['top1_agree']}, "
          f"post-warmup compiles 0, launches {counts} [{smi}]", flush=True)
    return result


SERVE_ROUTES = [  # (route, table dtype, kernel launch key it must show)
    ("fused", "f32", "fused_f32"),
    ("fused", "int8", "fused_int8"),
    ("fused", "bf16", "fused_bf16"),
    ("gather_split", "f32", "gather_split"),
    ("pool_only", "f32", "pool"),
]


def phase_serve(torch, smi, device, model_dir: Path) -> dict:
    requests = make_requests(96, seed=7)
    out = {}
    for impl, dt, key in SERVE_ROUTES:
        res = serve_route(torch, model_dir, impl, dt, requests, smi, device)
        if res["launches"].get(key, 0) < 1:
            raise AssertionError(f"route {impl}/{dt} never launched kernel {key}")
        out[key] = res
        torch.cuda.empty_cache()
    return out


def phase_longbag(torch, smi, device, model_dir: Path) -> dict:
    """The long-bag route once per K4 variant: the ladder gains the rungs
    derive_longbag_ladder gives above the training bag for this traffic."""
    from code2vec_tpu_torch.data.pipeline import derive_longbag_ladder

    lengths = longbag_lengths(96, seed=11)
    hist_len, hist_w = np.unique(lengths, return_counts=True)
    rungs = derive_longbag_ladder(hist_len, hist_w, BAG)
    if rungs != LONGBAG_RUNGS:
        raise AssertionError(f"derive_longbag_ladder gave {rungs}, expected {LONGBAG_RUNGS}")
    requests = make_requests(96, seed=13, lengths=lengths)
    extra = ["--longbag_widths", ",".join(map(str, rungs))]
    out = {}
    for mode in K4_MODES:
        for dt in ("f32", "bf16", "int8"):
            key = f"{mode}_{dt}"
            res = serve_route(torch, model_dir, "fused", dt, requests, smi, device,
                              extra=extra + ["--pallas_softmax", mode] * (mode != "online"),
                              ladder=LADDER + rungs, rtol=0.0, atol=TOL)
            if res["launches"].get(key, 0) < 1:
                raise AssertionError(f"long-bag route {key} never launched K4")
            out[key] = res
            torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 6: retrieval
# ---------------------------------------------------------------------------


def ann_corpus():
    """bench.py's clustered ANN corpus at the served encode width: rows
    around 8,192 true centers, queries = perturbed corpus points."""
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(ANN_CLUSTERS, ANN_DIM)).astype(np.float32)
    member = rng.integers(0, ANN_CLUSTERS, ANN_N)
    rows = (centers[member] + ANN_NOISE * rng.normal(size=(ANN_N, ANN_DIM))).astype(np.float32)
    q_src = rng.integers(0, ANN_N, ANN_QUERIES)
    queries = (rows[q_src] + 0.05 * rng.normal(size=(ANN_QUERIES, ANN_DIM))).astype(np.float32)
    return rows, queries


def lut_bound(probed, counts, cap, m):
    """Bytes K5 must move: the real rows of each distinct probed cell once
    (M code bytes, scale and bias per row), the LUT, the probed ids and
    every score slot (pad slots are written ``-inf``); ops: M adds + 2 per
    real row scored."""
    q, p = probed.shape
    cells, counts = probed.cpu().numpy(), np.asarray(counts, np.int64)
    rows_once = int(counts[np.unique(cells)].sum())
    nbytes = rows_once * (m + 8) + 4 * (q * m * 256 + q * p + q * p * cap)
    return nbytes, int(counts[cells].sum()) * (m + 2)


def same_shortlist(scores_a, ids_a, scores_b, ids_b) -> bool:
    """Equal as id sets: every id scoring above the cut is in both (ids
    within 1e-5 of the cut may trade places), and as many of each."""
    for sa, ia, sb, ib in zip(scores_a, ids_a, scores_b, ids_b):
        fa, fb = np.isfinite(sa), np.isfinite(sb)
        if fa.sum() != fb.sum():
            return False
        if not fa.any():
            continue
        cut = sa[fa].min()
        if set(ia[fa & (sa > cut + 1e-5)].tolist()) != set(ib[fb & (sb > cut + 1e-5)].tolist()):
            return False
    return True


def phase_retrieval(torch, smi, device, model_dir: Path) -> dict:
    from code2vec_tpu_torch.ann import lut_kernel
    from code2vec_tpu_torch.ann.index import AnnSearcher, build_index, save_index
    from code2vec_tpu_torch.ann.lut_kernel import lut_score_cells, lut_score_cells_reference
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts
    from code2vec_tpu_torch.serve.__main__ import build_parser, build_server
    from code2vec_tpu_torch.serve.retrieval import AnnRetrievalIndex, RetrievalIndex

    t0 = time.perf_counter()
    rows, queries = ann_corpus()
    labels = [f"m{i}" for i in range(ANN_N)]
    corpus_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    index, unit = build_index(rows, n_list=ANN_NLIST, m=ANN_M, seed=0, kmeans_iters=20,
                              pq_iters=15, device=device)
    build_s = time.perf_counter() - t0
    cap = index.meta["capacity"]
    print(f"ann index: N={ANN_N} dim={ANN_DIM} n_list={ANN_NLIST} m={ANN_M} capacity={cap} "
          f"built on the card in {build_s:.1f}s (corpus made in {corpus_s:.1f}s) [{smi}]",
          flush=True)
    if not np.array_equal(np.sort(index.ids[index.ids >= 0]), np.arange(ANN_N)) or \
            int(index.cell_counts.sum()) != ANN_N:
        raise AssertionError("ann index: not every row lands in exactly one cell")
    path = model_dir / "ann.index"
    save_index(str(path), index, unit, labels,
               defaults={"n_probe": ANN_PROBE, "shortlist": ANN_SHORTLIST})

    # K5 against its plain version on the index's shapes
    bench = KernelBench(torch, device)
    searcher = AnnSearcher(index, n_probe=max(p for _, p in K5_SHAPES), shortlist=ANN_SHORTLIST,
                           device=device)
    g = np.random.default_rng(3)
    k5_rows = []
    for q, n_probe in K5_SHAPES:
        qs = rows[g.integers(0, ANN_N, q)] + 0.05 * g.normal(size=(q, ANN_DIM)).astype(np.float32)
        qd = torch.from_numpy(qs / np.linalg.norm(qs, axis=1, keepdims=True)).to(device)
        cell_scores = qd @ searcher._centroids.T + searcher._cell_bias[None, :]
        probed = torch.topk(cell_scores, n_probe, dim=1).indices.to(torch.int32)
        lut = torch.einsum("qmd,mjd->qmj", qd.reshape(q, ANN_M, ANN_DIM // ANN_M),
                           searcher._codebooks).contiguous()
        args = (lut, probed, searcher._codes, searcher._scales, searcher._bias)
        kernel = lambda: lut_score_cells(*args)  # noqa: E731
        plain = lambda: lut_score_cells_reference(*args)  # noqa: E731
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        if not torch.equal(torch.isneginf(got), torch.isneginf(ref)):
            raise AssertionError(f"K5 at Q={q} P={n_probe}: -inf masks differ")
        fin = torch.isfinite(ref)
        err = (got[fin] - ref[fin]).abs().max().item()
        if err > TOL:
            raise AssertionError(f"K5 at Q={q} P={n_probe}: max |err| {err:.3e} > {TOL}")
        nbytes, flops = lut_bound(probed, index.cell_counts, cap, ANN_M)
        bound_s, bound_by = bound_of(nbytes, flops)
        row = {"Q": q, "P": n_probe, "max_abs_err": err, "ms": bench.time_ms(kernel),
               "plain_ms": bench.time_ms(plain), "library_ms": None,
               "bound_ms": bound_s * 1e3, "bound_by": bound_by, "bytes": nbytes,
               "flops": flops}
        k5_rows.append(row)
        print(f"kernel K5 lut_score Q={q:2d} P={n_probe:2d} C={cap} max_abs_err={err:.3e} "
              f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
              f"bound_ms={row['bound_ms']:.4f} ({bound_by})", flush=True)
    del searcher
    exact = RetrievalIndex(labels, rows, device=device)

    # the server: the model dir, the ann backend from the saved container
    args = build_parser().parse_args([
        "--model_path", str(model_dir),
        "--terminal_idx_path", str(model_dir / "terminal_idxs.txt"),
        "--path_idx_path", str(model_dir / "path_idxs.txt"),
        "--batch_sizes", ",".join(map(str, BATCH_SIZES)), "--device", str(device),
        "--retrieval_backend", "ann", "--ann_index_path", str(path),
    ])
    server = build_server(args)
    ctx_requests = make_requests(ANN_CONTEXT_QUERIES, seed=17)
    answers, timing = {}, {}
    try:
        ann = server.retrieval
        health = server.handle({"op": "health"})
        if health["retrieval"]["backend"] != "ann" or health["retrieval"]["size"] != ANN_N:
            raise AssertionError(f"retrieval health block: {health['retrieval']}")
        for backend, index_ in (("exact", exact), ("ann", ann)):
            server.retrieval = index_
            server.handle({"op": "neighbors", "vector": queries[0].tolist(), "top_k": 10})
            reset_launch_counts()
            lat, got = [], []
            for i in range(ANN_QUERIES):
                t = time.perf_counter()
                resp = server.handle({"op": "neighbors", "vector": queries[i].tolist(),
                                      "top_k": 10})
                lat.append((time.perf_counter() - t) * 1e3)
                if not resp.get("ok") or len(resp["neighbors"]) != 10:
                    raise AssertionError(f"{backend} neighbors query {i}: {resp}")
                got.append([int(n["name"][1:]) for n in resp["neighbors"]])
            ctx_lat = []
            for req in ctx_requests:
                req = {"op": "neighbors", "contexts": req["contexts"], "top_k": 10}
                t = time.perf_counter()
                resp = server.handle(req)
                ctx_lat.append((time.perf_counter() - t) * 1e3)
                (entry,) = resp["methods"]
                if len(entry["neighbors"]) != 10 or "code_vector" in entry:
                    raise AssertionError(f"{backend} contexts-form neighbors: {resp}")
            counts = launch_counts()
            answers[backend] = got
            timing[backend] = {
                "vector_p50_ms": float(np.percentile(lat, 50)),
                "vector_p99_ms": float(np.percentile(lat, 99)),
                "contexts_p50_ms": float(np.percentile(ctx_lat, 50)),
                "contexts_p99_ms": float(np.percentile(ctx_lat, 99)),
                "launches": counts,
            }
            print(f"neighbors {backend}: {ANN_QUERIES} vector queries one at a time p50 "
                  f"{timing[backend]['vector_p50_ms']:.3f} ms p99 "
                  f"{timing[backend]['vector_p99_ms']:.3f} ms; {ANN_CONTEXT_QUERIES} contexts "
                  f"queries p50 {timing[backend]['contexts_p50_ms']:.3f} ms p99 "
                  f"{timing[backend]['contexts_p99_ms']:.3f} ms; launches {counts} [{smi}]",
                  flush=True)
        server.retrieval = ann
    finally:
        server.close()
    if timing["ann"]["launches"].get("lut_score", 0) < 1:
        raise AssertionError("the ann neighbors queries never launched K5")

    # the searcher with K5 against the same searcher with the plain scoring:
    # search() looks K5's wrapper up in its module at call time
    s_k, i_k = ann.searcher.search(queries)
    lut_kernel.lut_score_cells = lut_score_cells_reference
    try:
        s_p, i_p = ann.searcher.search(queries)
    finally:
        lut_kernel.lut_score_cells = lut_score_cells
    if not same_shortlist(s_k, i_k, s_p, i_p):
        raise AssertionError("ann shortlists with K5 differ from the plain scoring's")
    exact_sets = [set(a) for a in answers["exact"]]
    recall = {}
    for n_probe in (8, 16, 32):
        arm = AnnRetrievalIndex(labels, unit, index, n_probe=n_probe, shortlist=ANN_SHORTLIST,
                                device=device)
        hits = sum(len({int(n[1:]) for n, _ in arm.top_k(queries[i], 10)} & exact_sets[i])
                   for i in range(ANN_QUERIES))
        recall[n_probe] = {"recall@10": hits / (10 * ANN_QUERIES),
                           "probed_fraction": arm.probed_fraction(queries)}
        del arm
    served = sum(len(set(a) & e) for a, e in zip(answers["ann"], exact_sets))
    print(f"ann recall@10 vs exact: {json.dumps(recall)}; served (n_probe {ANN_PROBE}) "
          f"{served / (10 * ANN_QUERIES):.4f}", flush=True)
    return {"build_s": build_s, "capacity": cap, "k5_rows": k5_rows, "timing": timing,
            "recall": recall, "served_recall@10": served / (10 * ANN_QUERIES),
            "launches": timing["ann"]["launches"]}


# ---------------------------------------------------------------------------


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--json_out", default=None,
                        help="also write the per-shape kernel records and serve numbers here")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    failed = []

    def phase(name, fn, *a):
        print(f"== phase {name}", flush=True)
        try:
            return fn(*a)
        except Exception:  # noqa: BLE001 - every phase reports, the run fails
            traceback.print_exc()
            failed.append(name)
            return None

    def device():
        cap = torch.cuda.get_device_capability(0)
        if cap != (9, 0):
            raise RuntimeError(f"needs compute capability 9.0 (Hopper), got {cap}")
        smi = nvidia_smi()
        print(smi)
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} visible", flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        return smi

    def build():
        sys.path.insert(0, str(ROOT))
        from code2vec_tpu_torch.ops import _build

        t0 = time.perf_counter()
        libs = _build.build_all()
        print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f}s", flush=True)
        for name, log in sorted(_build.build_log.items()):
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")
        return libs

    smi = phase("device", device)
    if smi is None or phase("build", build) is None:
        return 1
    dev = torch.device("cuda")
    kernels = phase("kernels", phase_kernels, torch, dev)
    with tempfile.TemporaryDirectory(prefix="c2v_smoke_") as tmp:
        model_dir = Path(tmp)
        t0 = time.perf_counter()
        write_model_dir(torch, model_dir, dev)
        print(f"model dir at top11 widths written in {time.perf_counter() - t0:.1f}s", flush=True)
        serve = phase("serve", phase_serve, torch, smi, dev, model_dir)
        longbag = phase("longbag", phase_longbag, torch, smi, dev, model_dir)
        retrieval = phase("retrieval", phase_retrieval, torch, smi, dev, model_dir)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1

    routes = {**serve, **longbag}
    line = []
    for name, rec in kernels.items():
        timed = next(r for r in rec["rows"] if (r["B"], r["L"]) == rec["timed"])
        line.append({
            "name": name, "route": "cuda", "source": rec["source"],
            "replaces": rec["replaces"],
            "launches": routes[rec["key"]]["launches"][rec["key"]],
            "max_abs_err": max(r["max_abs_err"] for r in rec["rows"]),
            "ms": timed["ms"], "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
            "library_ms": timed["library_ms"],
        })
    k5 = retrieval["k5_rows"]
    timed = next(r for r in k5 if (r["Q"], r["P"]) == K5_TIMED_SHAPE)
    line.append({
        "name": "K5 lut_score", "route": "cuda",
        "source": "code2vec_tpu_torch/csrc/lut_score.cu",
        "replaces": "code2vec_tpu/ann/lut_kernel.py:206",
        "launches": retrieval["launches"]["lut_score"],
        "max_abs_err": max(r["max_abs_err"] for r in k5),
        "ms": timed["ms"], "plain_ms": timed["plain_ms"],
        "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"], "library_ms": None,
    })
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(
            {"card": smi, "torch": torch.__version__, "kernels": kernels, "serve": serve,
             "longbag": longbag, "retrieval": retrieval},
            indent=1,
        ))
    print(smi)
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
