"""Long bags on the card: the attention pool alone, and the train step.

Counterpart of ``tools/bench_ctx.py`` (the reference caps bags at 200,
main.py:48; everything past 200 is what this framework adds). Two families
of rows, one card:

1. ``pool``: the attention pool's forward + backward (``sum(cv * cv)``)
   alone, at ``(batch, bag)`` of (1024, 200), (256, 1024), (64, 4096) and
   encode 100, in three formulations on the same inputs: the port's kernel
   pool (``ops/pool_kernel.attention_pool_kernel``: K1 forward, K1b
   backward; ``kernel_ms``), the ctx-parallel streaming pool
   (``parallel/context.context_parallel_attention_pool`` on a one-rank
   mesh, whose collectives are the identity; ``streaming_ms``) and the plain
   pool (``ops/attention.attention_pool`` under autograd; ``xla_ms``, JAX's
   name). Each row also gives the largest difference of the code vector
   and of both gradients between the kernel pool and the streaming one
   (``err_*``, :func:`scaled_err`).
2. ``step``: the device-epoch train step (``EpochRunner`` chunks, what a
   ``--device_epoch`` run steps) at (1024, 200), (256, 1024), (64, 4096),
   on a synthetic corpus whose methods hold ~0.8 x bag contexts, with
   top11's vocabs and widths, on ``pool_only`` with the top11 bag (200) as
   the training bag: K1/K1b at 200, and above it the long-bag route, K4
   (online) with the keep mask.

Each row runs in a child process in a process group of its own (killed as
a group at its timeout); the parent prints one JSON line per row, then a
markdown table::

    python -m code2vec_tpu_torch.tools.bench_ctx [--quick] [--device cpu]

``--quick`` runs the step at (256, 1024) and the pool at the first two
shapes.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

STEP_SHAPES = [(1024, 200), (256, 1024), (64, 4096)]
POOL_SHAPES = [(1024, 200), (256, 1024), (64, 4096)]
QUICK_STEP_SHAPES = [(256, 1024)]
QUICK_POOL_SHAPES = [(1024, 200), (256, 1024)]
TRAIN_BAG = 200  # top11's bag: wider bags take the long-bag route
ENCODE = 100
TOP11 = dict(n_terminals=360_631, n_paths=342_845, n_labels=8_000)


def pool_inputs(batch: int, bag: int, encode: int, device) -> tuple:
    """JAX's inputs: std-normal contexts and attention vector, ~90% real."""
    rng = np.random.default_rng(0)
    contexts = torch.from_numpy(rng.standard_normal((batch, bag, encode)).astype(np.float32))
    mask = torch.from_numpy((rng.random((batch, bag)) < 0.9).astype(np.float32))
    attn = torch.from_numpy(rng.standard_normal(encode).astype(np.float32))
    return contexts.to(device), mask.to(device), attn.to(device)


def pool_formulations(mask: torch.Tensor) -> dict:
    """``{name: pool(contexts, attn) -> (cv, weights)}`` over ``mask``."""
    from code2vec_tpu_torch.ops.attention import attention_pool
    from code2vec_tpu_torch.ops.pool_kernel import attention_pool_kernel
    from code2vec_tpu_torch.parallel.context import context_parallel_attention_pool
    from code2vec_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(data=1, model=1, ctx=1)
    return {
        "kernel": lambda c, a: attention_pool_kernel(c, mask, a),
        "streaming": lambda c, a: context_parallel_attention_pool(mesh, c, mask, a),
        "xla": lambda c, a: attention_pool(c, mask, a),
    }


def pool_value_and_grad(pool, contexts: torch.Tensor, attn: torch.Tensor) -> tuple:
    """``(cv, d contexts, d attn)`` of ``sum(cv * cv)`` through ``pool``."""
    c = contexts.detach().requires_grad_()
    a = attn.detach().requires_grad_()
    cv, _ = pool(c, a)
    d_c, d_a = torch.autograd.grad((cv * cv).sum(), (c, a))
    return cv.detach(), d_c, d_a


def measure_pool(batch: int, bag: int, device, encode: int = ENCODE) -> dict:
    """ms of each formulation's forward + backward, and the kernel pool's
    largest differences from the streaming pool."""
    from code2vec_tpu_torch.tools.profile_step import time_ms

    contexts, mask, attn = pool_inputs(batch, bag, encode, device)
    pools = pool_formulations(mask)
    row = {}
    for name, pool in pools.items():
        row[f"{name}_ms"] = round(time_ms(lambda: pool_value_and_grad(pool, contexts, attn),
                                          device, 20, warmup=2), 4)
    got = pool_value_and_grad(pools["kernel"], contexts, attn)
    want = pool_value_and_grad(pools["streaming"], contexts, attn)
    for name, g, w in zip(("cv", "d_ctx", "d_attn"), got, want):
        row[f"err_{name}"] = scaled_err(g, w)
    return row


def scaled_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """``max |got - want|`` over ``max(max |want|, 1)``: an absolute error
    for values up to 1, relative above (the gradients of ``sum(cv * cv)``
    over std-normal contexts reach the hundreds)."""
    return float((got - want).abs().max() / want.abs().max().clamp(min=1.0))


def measure_step(device, batch: int = 1024, bag: int = 200, chunk: int = 16, steps: int = 48,
                 n_methods: int | None = None, mean_contexts: float = 120.0,
                 max_contexts: int = 400) -> float:
    """ms a step of ``EpochRunner`` chunks (the device-epoch path) at top11's
    vocabs and widths on ``pool_only``: the port's copy of JAX's one timing
    harness (``tools/run_tpu_ablation.py:23``) at its winner recipe. Two
    chunks warm, then ``ceil(steps / chunk)`` are timed."""
    from code2vec_tpu_torch.data.synth import SynthSpec, corpus_data_from_raw, \
        generate_corpus_data
    from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig
    from code2vec_tpu_torch.tools.profile_step import time_ms
    from code2vec_tpu_torch.train.config import TrainConfig
    from code2vec_tpu_torch.train.device_epoch import (
        EpochRunner,
        place_staged,
        sampler_generator,
        stage_method_corpus,
    )
    from code2vec_tpu_torch.train.step import StepTally, make_optimizer

    spec = SynthSpec(n_methods=n_methods if n_methods is not None else max(batch * 8, 8192),
                     mean_contexts=mean_contexts, max_contexts=max_contexts, seed=0, **TOP11)
    data = corpus_data_from_raw(generate_corpus_data(spec))
    config = Code2VecConfig(
        terminal_count=len(data.terminal_vocab), path_count=len(data.path_vocab),
        label_count=len(data.label_vocab), terminal_embed_size=ENCODE, path_embed_size=ENCODE,
        encode_size=ENCODE, dropout_prob=0.25, use_pallas=True, pallas_impl="pool_only",
        longbag_width=TRAIN_BAG)
    model = Code2Vec(config)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(device)
    model.seed_dropout(0)
    optimizer = make_optimizer(model, TrainConfig(batch_size=batch, max_path_length=bag))
    cw = torch.ones(config.label_count, device=device)
    rng = np.random.default_rng(0)
    staged = place_staged(stage_method_corpus(data, np.arange(data.n_items), rng), device)
    runner = EpochRunner(cw, batch, bag, chunk)
    gen = sampler_generator(0, device)
    tally = StepTally(device)

    def run():
        rows = rng.integers(0, data.n_items, chunk * batch)
        runner.train_chunk(model, optimizer, staged, rows, 0, chunk, chunk * batch, gen, tally)

    n_chunks = -(-steps // chunk)
    ms = time_ms(run, device, n_chunks, warmup=2) / chunk
    losses = [float(x) for x in tally.losses[-chunk:]]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite losses at {batch}x{bag}: {losses}")
    return ms


def measure_long_bag_step(batch: int, bag: int, device, steps: int = 32) -> float:
    """ms a step at a long bag, on a corpus whose methods hold ~0.8 x bag
    contexts (JAX's recipe: chunk 8, ``max(4 * batch, 1024)`` methods)."""
    return measure_step(device, batch=batch, bag=bag, chunk=8, steps=steps,
                        n_methods=max(batch * 4, 1024), mean_contexts=0.8 * bag,
                        max_contexts=2 * bag)


def row_main(mode: str, batch: int, bag: int, device_arg: str | None) -> int:
    """One row in this process: its JSON line (with the kernel launches)."""
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts, \
        resolve_device

    try:
        device = resolve_device(device_arg)
        reset_launch_counts()
        if mode == "pool":
            row = {"kind": "pool", "batch": batch, "bag": bag,
                   **measure_pool(batch, bag, device)}
        else:
            ms = measure_long_bag_step(batch, bag, device)
            row = {"kind": "step", "batch": batch, "bag": bag, "ms_per_step": round(ms, 4),
                   "contexts_per_sec": round(batch * bag / ms * 1e3, 0)}
        row["launches"] = launch_counts()
        row["device"] = (torch.cuda.get_device_name(device) if device.type == "cuda"
                         else device.type)
    except Exception as e:  # noqa: BLE001 - the parent reads a structured row
        print(json.dumps({"batch": batch, "bag": bag, "error": str(e)[:300]}), flush=True)
        raise
    print(json.dumps(row), flush=True)
    return 0


def run_row(mode: str, batch: int, bag: int, device_arg: str | None, timeout_s: float) -> dict:
    """One row in a child in a process group of its own, killed as a group at
    ``timeout_s``; output through temp files (no pipe a grandchild holds)."""
    cmd = [sys.executable, "-m", "code2vec_tpu_torch.tools.bench_ctx",
           f"--{mode}-row", str(batch), str(bag)]
    if device_arg:
        cmd += ["--device", device_arg]
    with tempfile.TemporaryFile("w+") as out_f, tempfile.TemporaryFile("w+") as err_f:
        proc = subprocess.Popen(cmd, stdout=out_f, stderr=err_f, start_new_session=True)
        try:
            proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            return {"error": f"timeout {timeout_s:.0f}s"}
        out_f.seek(0)
        err_f.seek(0)
        stdout, stderr = out_f.read(), err_f.read()
    lines = [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]
    for row in reversed(lines):
        if "kind" in row or "error" in row:
            return row
    return {"error": f"rc={proc.returncode} {stderr[-300:]}"}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="code2vec_tpu_torch.tools.bench_ctx",
                                 description="long-bag pool and step rows (module docstring)")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--step-row", nargs=2, type=int, metavar=("BATCH", "BAG"), default=None,
                    help="internal: measure one step row in this process")
    ap.add_argument("--pool-row", nargs=2, type=int, metavar=("BATCH", "BAG"), default=None,
                    help="internal: measure one pool row in this process")
    ap.add_argument("--row-timeout", type=float, default=600.0,
                    help="a row's child budget, seconds (also capped by what is left of "
                    "--total-budget)")
    ap.add_argument("--total-budget", type=float,
                    default=float(os.environ.get("BENCH_CTX_BUDGET", 1680.0)),
                    help="the whole run's budget, seconds; rows that no longer fit are "
                    "skipped with an error row")
    ap.add_argument("--device", default=None,
                    help="torch device of the rows (default cuda; 'cpu' runs the plain "
                    "versions)")
    args = ap.parse_args(argv)
    if args.step_row is not None:
        return row_main("step", *args.step_row, args.device)
    if args.pool_row is not None:
        return row_main("pool", *args.pool_row, args.device)

    t0 = time.monotonic()
    steps = QUICK_STEP_SHAPES if args.quick else STEP_SHAPES
    pools = QUICK_POOL_SHAPES if args.quick else POOL_SHAPES
    rows, failed = [], False
    for mode, batch, bag in [("step", b, g) for b, g in steps] + [("pool", b, g)
                                                                  for b, g in pools]:
        remaining = args.total_budget - (time.monotonic() - t0)
        if remaining < 30:
            print(json.dumps({mode: f"b{batch}/bag{bag}",
                              "error": "skipped: total budget exhausted"}), flush=True)
            failed = True
            continue
        row = run_row(mode, batch, bag, args.device, min(args.row_timeout, remaining))
        if "error" in row:
            print(json.dumps({mode: f"b{batch}/bag{bag}", **row}), flush=True)
            failed = True
            continue
        rows.append(row)
        print(json.dumps(row), flush=True)

    print("\n| kind | batch | bag | ms (kernel / streaming / plain, or step) | ctx/s |")
    print("|---|---|---|---|---|")
    for r in rows:
        if r["kind"] == "pool":
            ms, cs = f"{r['kernel_ms']} / {r['streaming_ms']} / {r['xla_ms']}", ""
        else:
            ms, cs = f"{r['ms_per_step']}", f"{int(r['contexts_per_sec']):,}"
        print(f"| {r['kind']} | {r['batch']} | {r['bag']} | {ms} | {cs} |")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
