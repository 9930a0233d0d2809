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
   top11 widths, B in {1, 8, 64} x L in {1, 37, 200}, PAD tails and one
   all-masked row in every batch, each held against its plain PyTorch
   version (rtol = atol = 1e-5, f32 compute on both sides, TF32 off) and
   timed with CUDA events (median of 30 launches after warmup, L2 flushed
   before each launch);
4. serve   — a top11-width model dir with random weights from a seed,
   served through the port's own ``build_server`` with each kernel route
   (K3 with f32, int8 and bf16 tables, K2, K1): >= 96 predict/embed
   requests per route, bag lengths 1-400 (over-long bags are subsampled),
   part one at a time and part pipelined so they coalesce. Every response
   must be ok and finite, every code vector must match the same model run
   without kernels on the card (rtol 2e-4, atol 2e-5), top-1 labels must
   agree, nothing may warm after startup, and each route's kernel must
   have been launched. The launch counts are reset just before each route
   is served and read just after;
5. the line ``{"kernels": [...]}`` (per kernel: route, source, the TPU
   kernel it replaces, launches on the serve phase, max error, times at
   B=64 x L=200 and the bound), then, last, the result line.

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


def pool_inputs(torch, dev, g, B, L, H):
    ctx = torch.tanh(torch.randn(B, L, H, generator=g, device=dev))
    lens = torch.randint(1, L + 1, (B,), generator=g, device=dev)
    mask = (torch.arange(L, device=dev)[None, :] < lens[:, None]).float()
    mask[-1] = 0.0  # one all-masked row in every batch
    attn = 0.08 * torch.randn(H, generator=g, device=dev)
    return ctx, mask, attn


def id_inputs(torch, dev, g, B, L):
    c = TOP11
    s = torch.randint(1, c["terminal_count"], (B, L), generator=g, device=dev, dtype=torch.int32)
    p = torch.randint(1, c["path_count"], (B, L), generator=g, device=dev, dtype=torch.int32)
    e = torch.randint(1, c["terminal_count"], (B, L), generator=g, device=dev, dtype=torch.int32)
    lens = torch.randint(1, L + 1, (B,), generator=g, device=dev)
    keep = torch.arange(L, device=dev)[None, :] < lens[:, None]
    keep[-1] = False  # one all-PAD row in every batch
    s, p, e = (x * keep for x in (s, p, e))
    return s, p, e, (s > 0).float()


def pool_bound(B, L, H):
    nbytes = 4 * (B * L * H + 2 * B * L + H + B * H)
    flops = 4 * B * L * H
    return nbytes, flops


def encode_pool_bound(torch, s, p, e, table_dtype, H):
    """Bytes of the rows these ids need (each distinct row once) plus ids,
    mask, weights and outputs; flops of encode + LayerNorm/tanh/pool."""
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
    flops = 2 * B * L * d * H + 8 * B * L * H
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

    specs = [
        ("K1 pool", "pool", "code2vec_tpu_torch/csrc/pool.cu",
         "code2vec_tpu/ops/pallas_attention.py:114", None, None),
        ("K2 encode_pool gather_split", "gather_split",
         "code2vec_tpu_torch/csrc/fused_encode_pool.cu",
         "code2vec_tpu/ops/fused_encode_pool.py:651", "gather_split", "f32"),
    ] + [
        (f"K3 encode_pool fused {dt}", f"fused_{dt}",
         "code2vec_tpu_torch/csrc/fused_encode_pool.cu",
         "code2vec_tpu/ops/fused_encode_pool.py:651", "fused", dt)
        for dt in ("f32", "bf16", "int8")
    ]
    records = {}
    for name, key, source, replaces, impl, dt in specs:
        rows = []
        for B, L in SHAPES:
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
                kernel = lambda: fused_encode_attend_pool(*args, impl=impl)  # noqa: E731
                plain = lambda: reference_forward(*args)  # noqa: E731
                nbytes, flops = encode_pool_bound(torch, s, p, e, dt, H)
            cv, w = kernel()
            cv_ref, w_ref = plain()
            torch.cuda.synchronize()
            if not (torch.isfinite(cv).all() and torch.isfinite(w).all()):
                raise AssertionError(f"{name} at {(B, L)}: non-finite output")
            err = max((cv - cv_ref).abs().max().item(), (w - w_ref).abs().max().item())
            torch.testing.assert_close(cv, cv_ref, rtol=TOL, atol=TOL)
            torch.testing.assert_close(w, w_ref, rtol=TOL, atol=TOL)
            bound_s, bound_by = bound_of(nbytes, flops)
            row = {
                "B": B, "L": L, "max_abs_err": err,
                "ms": bench.time_ms(kernel), "plain_ms": bench.time_ms(plain),
                "library_ms": bench.time_ms(library) if library else None,
                "bound_ms": bound_s * 1e3, "bound_by": bound_by,
                "bytes": nbytes, "flops": flops,
            }
            rows.append(row)
            print(f"kernel {name:32s} B={B:3d} L={L:3d} max_abs_err={err:.3e} "
                  f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                  f"library_ms={row['library_ms']} bound_ms={row['bound_ms']:.4f} "
                  f"({bound_by})", flush=True)
        records[name] = dict(key=key, source=source, replaces=replaces, rows=rows)
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


def make_requests(n_requests: int, seed: int) -> list[dict]:
    c = TOP11
    rng = np.random.default_rng(seed)
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


def serve_route(torch, model_dir: Path, impl: str, table_dtype: str, requests, smi,
                device) -> dict:
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
        "--device", str(device),
    ])
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
        ctx = np.asarray(subsample(req["contexts"], BAG), np.int32)
        width = nearest_bucket_width(len(ctx), LADDER)
        ids = np.zeros((3, 1, width), np.int32)
        ids[:, 0, : len(ctx)] = ctx.T
        with torch.inference_mode():
            logits_ref, cv_ref, _ = plain(
                *(torch.from_numpy(x).to(predictor.device) for x in ids),
                quant_tables=predictor.quant_tables,
            )
        cv_ref = cv_ref[0].cpu().numpy()
        worst = max(worst, float(np.abs(cv - cv_ref).max()))
        np.testing.assert_allclose(cv, cv_ref, rtol=SERVE_RTOL, atol=SERVE_ATOL)
        if req["op"] == "predict":
            ref = logits_ref[0].cpu().numpy()
            ref_top = softmax_top_k(ref, TOP11["label_count"], 1)[0][0]
            served = int(entry["predictions"][0]["name"].removeprefix("label"))
            # a served top-1 that ties the reference's within the logit
            # tolerance is the same answer up to rounding
            top1_agree += served == ref_top or ref[ref_top] - ref[served] <= SERVE_ATOL
    n_predict = sum(r["op"] == "predict" for r in requests)
    if top1_agree != n_predict:
        raise AssertionError(f"{impl}/{table_dtype}: top-1 agrees on {top1_agree}/{n_predict}")
    if health["post_warmup_compiles"] != 0:
        raise AssertionError(f"{impl}/{table_dtype}: post-warmup compiles {health}")
    if coalesced < 2:
        raise AssertionError(f"{impl}/{table_dtype}: pipelined requests never coalesced")
    result = {
        "route": impl, "table_dtype": table_dtype, "requests": len(requests),
        "startup_s": startup_s, "launches": counts,
        "sequential_p50_ms": float(np.percentile(latencies, 50)),
        "sequential_p99_ms": float(np.percentile(latencies, 99)),
        "pipelined_requests_per_s": (len(requests) - n_seq) / pipelined_s,
        "max_coalesced": coalesced, "max_abs_err_vs_plain": worst,
        "top1_agree": f"{top1_agree}/{n_predict}",
        "post_warmup_compiles": health["post_warmup_compiles"],
        "executables": health["executables"],
    }
    print(f"serve {impl}/{table_dtype}: {len(requests)} requests ok, startup "
          f"{startup_s:.2f}s, one-at-a-time p50 {result['sequential_p50_ms']:.3f} ms "
          f"p99 {result['sequential_p99_ms']:.3f} ms, pipelined "
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


def phase_serve(torch, smi, device) -> dict:
    requests = make_requests(96, seed=7)
    out = {}
    with tempfile.TemporaryDirectory(prefix="c2v_smoke_") as tmp:
        model_dir = Path(tmp)
        t0 = time.perf_counter()
        write_model_dir(torch, model_dir, device)
        print(f"model dir at top11 widths written in {time.perf_counter() - t0:.1f}s", flush=True)
        for impl, dt, key in SERVE_ROUTES:
            res = serve_route(torch, model_dir, impl, dt, requests, smi, device)
            if res["launches"].get(key, 0) < 1:
                raise AssertionError(f"route {impl}/{dt} never launched kernel {key}")
            out[key] = res
            torch.cuda.empty_cache()
    return out


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
    serve = phase("serve", phase_serve, torch, smi, dev)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1

    line = []
    for name, rec in kernels.items():
        timed = next(r for r in rec["rows"] if (r["B"], r["L"]) == TIMED_SHAPE)
        line.append({
            "name": name, "route": "cuda", "source": rec["source"],
            "replaces": rec["replaces"],
            "launches": serve[rec["key"]]["launches"][rec["key"]],
            "max_abs_err": max(r["max_abs_err"] for r in rec["rows"]),
            "ms": timed["ms"], "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
            "library_ms": timed["library_ms"],
        })
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(
            {"card": smi, "torch": torch.__version__, "kernels": kernels, "serve": serve},
            indent=1,
        ))
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
