#!/usr/bin/env python3
"""Time the port's kernels across checkouts of the PyTorch port on one
card, in turns (parent, change, change, parent).

    python3 code2vec_tpu_torch/tools/kernel_ab.py [--train_steps [--optimizer]] ROOT [ROOT ...]
    python3 code2vec_tpu_torch/tools/kernel_ab.py --forward ROOT [ROOT ...]

Each ROOT is a checkout holding ``code2vec_tpu_torch/`` and
``chip_smoke.py`` (for instance a ``git archive`` of a commit unpacked into
``build/``). First every ROOT's kernels are built, one process per
distinct ROOT, all at once. Then the ROOTs run in the order given, each in
a process of its own, on inputs made from one seed with the ROOT's own
``chip_smoke`` helpers (the same values in every process), each call
timed as that script times every kernel (``KernelBench``: the median of
30 launches, each after a 96 MB write that flushes L2).

By default a run times K1b, the attention pool's backward, at each of
``SHAPES`` (B x L x H: top11's train batch at its encode width of 100,
and at the default encode width of 300), over f32 and bf16 contexts,
held against ``pool_backward_reference``. A ROOT whose
``pool_backward_kernel`` takes no ``cv`` (the two-pass K1b) is called
without it. The builds print ptxas' report of ``csrc/pool.cu`` (registers
and spills per kernel), and each run the one-pass K1b's grid (``ctas``).
With ``--train_steps`` each run also takes the ROOT's
``chip_smoke.step_breakdown`` of a train step at the top11 recipe (batch
1024, bag 200, dropout 0.25; its train phase's corpus and config) on the
plain and ``pool_only`` routes, in f32 and in bf16 (compute and first
moments), with dense tables and, where the ROOT has them, lazy ones
(``--table_update lazy``), and reports the forward, backward and
optimizer device ms and the host's wall ms of a step. With
``--optimizer`` each ROOT with lazy tables also times
``LazyTableAdam.step`` alone on one batch's per-slot gradients (CUDA
events, 20 steps after 3 warm ones) and lists its ops by device time
(``torch.profiler``, 5 steps).

With ``--forward`` a run times the forward kernels instead:
``FORWARD_CASES`` (K2-K4 at their serving and training headline shapes),
K1 at ``POOL_SHAPES`` over f32 and bf16 contexts, and the ``pool_only``
route's whole forward (``Code2Vec`` at top11 widths, gradients off: the
plain encode, then K1) at ``POOL_ONLY_SHAPES``; a ROOT whose plain encode
runs in fixed slabs (``models/code2vec.ENCODE_SLAB_ROWS``) once at each of
``ENCODE_SLABS`` too.

Prints the card's name and power limit, one JSON line per run, and last a
JSON summary: per ROOT and case, the runs' times in milliseconds.
"""

from __future__ import annotations

import argparse
import inspect
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np

SHAPES = ((1024, 200, 100), (1024, 200, 300))  # B, L, H
SEED = 1234
KEEP = 0.75
# (case, impl, table dtype, softmax mode, masked, B, L)
FORWARD_CASES = [
    ("K2 f32 64x200", "gather_split", "f32", "materialize", False, 64, 200),
    ("K3 f32 64x200", "fused", "f32", "materialize", False, 64, 200),
    ("K3 bf16 64x200", "fused", "bf16", "materialize", False, 64, 200),
    ("K3 int8 64x200", "fused", "int8", "materialize", False, 64, 200),
    ("K4 online f32 64x2048", "fused", "f32", "online", False, 64, 2048),
    ("K4 two_pass f32 64x2048", "fused", "f32", "two_pass", False, 64, 2048),
    ("K2 f32 masked 1024x200", "gather_split", "f32", "materialize", True, 1024, 200),
    ("K3 f32 masked 1024x200", "fused", "f32", "materialize", True, 1024, 200),
    ("K4 online f32 masked 256x4096", "fused", "f32", "online", True, 256, 4096),
]
POOL_SHAPES = ((64, 200), (128, 200), (1024, 200))  # K1: B, L at H = 100
POOL_ONLY_SHAPES = ((1, 200), (8, 200), (64, 200), (128, 200))
ENCODE_SLABS = (256, 512, 1024, 2048, 8192)


STEP_ROUTES = ("plain", "pool_only")
STEP_KEYS = ("forward_ms", "backward_ms", "optimizer_ms", "step_wall_ms")


def optimizer_alone(torch, dev, data, config) -> dict:
    """``LazyTableAdam.step`` on one batch's per-slot gradients: its ms a
    step and its ops' device ms a step."""
    from torch.profiler import ProfilerActivity, profile

    from code2vec_tpu_torch.data.pipeline import build_method_epoch, iter_batches
    from code2vec_tpu_torch.models.code2vec import Code2Vec
    from code2vec_tpu_torch.train.loop import class_weights_from, model_config_from
    from code2vec_tpu_torch.train.step import lazy_forward_backward, make_optimizer, to_device

    rng = np.random.default_rng(2)
    items = rng.permutation(data.n_items)[:config.batch_size]
    epoch = build_method_epoch(data, items, config.max_path_length, rng)
    batch = to_device(next(iter_batches(epoch, config.batch_size)), dev)
    with torch.device(dev):
        model = Code2Vec(model_config_from(config, data))
    opt = make_optimizer(model, config)
    _, grads = lazy_forward_backward(model, batch, class_weights_from(config, data, dev))
    for _ in range(3):
        opt.step(grads)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    for _ in range(20):
        opt.step(grads)
    ev[1].record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            opt.step(grads)
        torch.cuda.synchronize()

    def device_ms(e):
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        return us / 1e3 / 5

    ops = sorted((e for e in prof.key_averages() if e.key.startswith("aten::")),
                 key=device_ms, reverse=True)
    return {"ms": ev[0].elapsed_time(ev[1]) / 20,
            "ops_ms": {e.key: device_ms(e) for e in ops[:16]}}


def train_steps(torch, chip_smoke, dev, optimizer: bool) -> dict:
    """The step breakdown of chip_smoke's train phase on ``STEP_ROUTES``,
    f32 and bf16, dense and (where the ROOT has it) lazy; with
    ``optimizer`` the lazy table step alone too."""
    from code2vec_tpu_torch.train.config import TrainConfig

    chip_smoke.TRAIN_ROUTES = {r: chip_smoke.TRAIN_ROUTES[r] for r in STEP_ROUTES}
    _, data = chip_smoke.train_corpus()
    config = TrainConfig(terminal_embed_size=100, path_embed_size=100, encode_size=100,
                         max_path_length=chip_smoke.BAG, batch_size=chip_smoke.TRAIN_BATCH,
                         dropout_prob=0.25, max_epoch=2, random_seed=0, print_sample_cycle=0)
    updates = ["dense"]
    try:
        config.with_updates(table_update="lazy").validate()
        updates.append("lazy")
    except NotImplementedError:  # a checkout from before the lazy table optimizer
        pass
    out = {}
    for update in updates:
        for name, dtype in (("f32", "float32"), ("bf16", "bfloat16")):
            cfg = config.with_updates(compute_dtype=dtype, adam_mu_dtype=dtype)
            if update == "lazy":
                cfg = cfg.with_updates(table_update="lazy")
            bd = chip_smoke.step_breakdown(torch, dev, data, cfg, "")
            out[f"{update} {name}"] = {r: {k: bd[r][k] for k in STEP_KEYS} for r in STEP_ROUTES}
            if update == "lazy" and optimizer:
                out[f"lazy {name} optimizer alone"] = optimizer_alone(torch, dev, data, cfg)
    return out


def forward_kernels(torch, chip_smoke, dev, bench) -> dict:
    """``FORWARD_CASES``, K1 at ``POOL_SHAPES`` and the ``pool_only``
    forward at ``POOL_ONLY_SHAPES`` (per encode slab where the ROOT has
    them): each case's ms."""
    from code2vec_tpu_torch.models import code2vec
    from code2vec_tpu_torch.ops.fused_encode_pool import fused_encode_attend_pool
    from code2vec_tpu_torch.ops.pool_kernel import attention_pool_kernel
    from code2vec_tpu_torch.ops.quant import quantize_table

    c = chip_smoke.TOP11
    H, D = c["encode_size"], 2 * c["terminal_embed_size"] + c["path_embed_size"]
    g = torch.Generator(device=dev).manual_seed(SEED)
    t_f32 = torch.randn(c["terminal_count"], c["terminal_embed_size"], generator=g, device=dev)
    p_f32 = torch.randn(c["path_count"], c["path_embed_size"], generator=g, device=dev)
    tables = {"f32": (t_f32, p_f32)}
    for dt in ("bf16", "int8"):
        tables[dt] = (quantize_table(t_f32, dt), quantize_table(p_f32, dt))
    W = torch.randn(D, H, generator=g, device=dev) / math.sqrt(D)
    lns = 1.0 + 0.1 * torch.randn(H, generator=g, device=dev)
    lnb = 0.1 * torch.randn(H, generator=g, device=dev)
    attn = 0.08 * torch.randn(H, generator=g, device=dev)
    out = {}
    for case, impl, dt, mode, masked, B, L in FORWARD_CASES:
        s, p, e, mask = chip_smoke.id_inputs(torch, dev, g, B, L)
        extra = ()
        if masked:
            extra = (torch.empty(B, L, H, device=dev).bernoulli_(KEEP, generator=g) / KEEP,)
        args = (*tables[dt], s, p, e, mask, W, lns, lnb, attn, *extra)
        out[case] = bench.time_ms(
            lambda: fused_encode_attend_pool(*args, impl=impl, softmax_mode=mode))
    for B, L in POOL_SHAPES:
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            ctx, mask, a = chip_smoke.pool_inputs(torch, dev, g, B, L, H)
            ctx, a = ctx.to(dtype), a.to(dtype)
            out[f"K1 {name} {B}x{L}"] = bench.time_ms(lambda: attention_pool_kernel(ctx, mask, a))
    with torch.device(dev):
        model = code2vec.Code2Vec(code2vec.Code2VecConfig(**c, use_pallas=True,
                                                          pallas_impl="pool_only"))
    model.eval()
    slabs = ENCODE_SLABS if hasattr(code2vec, "ENCODE_SLAB_ROWS") else (None,)
    for B, L in POOL_ONLY_SHAPES:
        s, p, e, _ = chip_smoke.id_inputs(torch, dev, g, B, L)

        def forward():
            with torch.inference_mode():
                return model(s, p, e, labels=None)

        for slab in slabs:
            if slab is not None:
                code2vec.ENCODE_SLAB_ROWS = slab
            key = f"pool_only forward {B}x{L}" + (f" slab {slab}" if slab else "")
            out[key] = bench.time_ms(forward)
    return out


def child(root: Path, build_only: bool, steps: bool, optimizer: bool, forward: bool) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from code2vec_tpu_torch.ops import _build

    _build.build_all()
    if build_only:  # with ptxas' report of the kernels' registers and spills
        return {"root": str(root), "built": True, "pool_ptxas": _build.build_log.get("pool")}
    import chip_smoke
    from code2vec_tpu_torch.ops import pool_kernel
    from code2vec_tpu_torch.ops.attention import attention_pool, pool_backward_reference
    from code2vec_tpu_torch.ops.pool_kernel import pool_backward_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    takes_cv = "cv" in inspect.signature(pool_backward_kernel).parameters
    grid = getattr(pool_kernel, "pool_bwd_grid", None)  # the one-pass K1b's
    bench = chip_smoke.KernelBench(torch, dev)
    if forward:
        return {"root": str(root), **forward_kernels(torch, chip_smoke, dev, bench)}
    out = {"root": str(root), "takes_cv": takes_cv}
    for B, L, H in SHAPES:
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            g = torch.Generator(device=dev).manual_seed(SEED)
            ctx, mask, a = chip_smoke.pool_inputs(torch, dev, g, B, L, H)
            ctx, a = ctx.to(dtype), a.to(dtype)
            cv, w = attention_pool(ctx.float(), mask, a.float())
            g_cv = torch.randn(B, H, generator=g, device=dev)
            g_w = torch.randn(B, L, generator=g, device=dev)
            extra = (cv,) if takes_cv else ()
            run = lambda: pool_backward_kernel(ctx, mask, a, w, *extra, g_cv, g_w)  # noqa: E731
            d_ctx, d_attn = run()
            r_ctx, r_attn = pool_backward_reference(ctx, mask, a, w, g_cv, g_w)
            torch.cuda.synchronize()
            out[f"{B}x{L}x{H} {name}"] = {
                "ms": bench.time_ms(run), "ms_min_max": list(bench.spread),
                "d_ctx_max_abs_err": (d_ctx.float() - r_ctx.float()).abs().max().item(),
                "d_attn_max_abs_err": (d_attn - r_attn).abs().max().item(),
                "ctas": grid(B, L, H, dtype, dev)[0] if grid else None,
            }
    if steps:
        out["train_steps"] = train_steps(torch, chip_smoke, dev, optimizer)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("roots", nargs="+", type=Path)
    parser.add_argument("--train_steps", action="store_true",
                        help="also time a train step's plain and pool_only routes")
    parser.add_argument("--optimizer", action="store_true",
                        help="with --train_steps, also time and profile the lazy table step")
    parser.add_argument("--forward", action="store_true",
                        help="time the forward kernels and the pool_only forward instead of K1b")
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--build_only", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        print(json.dumps(child(args.roots[0].resolve(), args.build_only, args.train_steps,
                               args.optimizer, args.forward)), flush=True)
        return 0

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    me = [sys.executable, str(Path(__file__).resolve()), "--child"]
    me += [f"--{flag}" for flag in ("train_steps", "optimizer", "forward") if getattr(args, flag)]
    roots = [r.resolve() for r in args.roots]
    builds = [subprocess.Popen([*me, "--build_only", str(r)]) for r in dict.fromkeys(roots)]
    if any(p.wait() != 0 for p in builds):
        print("kernel_ab: a build failed", file=sys.stderr)
        return 1
    summary: dict = {}
    for root in roots:
        res = subprocess.run([*me, str(root)], capture_output=True, text=True, timeout=1200)
        if res.returncode != 0:
            print(res.stderr, file=sys.stderr)
            return 1
        run = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps(run), flush=True)
        if args.forward:
            for key, ms in run.items():
                if key != "root":
                    summary.setdefault(str(root), {}).setdefault(key, []).append(ms)
            continue
        for B, L, H in SHAPES:
            for name in ("f32", "bf16"):
                key = f"{B}x{L}x{H} {name}"
                summary.setdefault(str(root), {}).setdefault(key, []).append(run[key]["ms"])
        for setting, res in run.get("train_steps", {}).items():
            if "ms" in res:  # the lazy table step alone
                summary[str(root)].setdefault(setting, []).append(res["ms"])
                continue
            for route, t in res.items():
                summary[str(root)].setdefault(f"{setting} {route}", []).append(
                    [t[k] for k in STEP_KEYS])
    print(json.dumps({"card": smi, "ms": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
