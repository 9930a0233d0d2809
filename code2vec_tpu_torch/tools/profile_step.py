"""Attribute the flagship train step to its parts on the card.

Counterpart of ``tools/profile_step.py``. At top11's widths (``bench.py``'s
synthetic corpus spec: 360,631 terminals, 342,845 paths, 8,000 labels, mean
120 contexts, at least 8,192 methods) it times each part of one step alone:
the mean of 30 calls between two CUDA events, after a warm call:

- ``sample``            the device-epoch sampler (``train/device_epoch.sample_batch``)
- ``forward``           the eval forward of the step's route
- ``forward/<route>``   the same on ``pool_only`` (K1), ``gather_split`` (K2),
                        ``fused`` (K3) and ``fused_int8`` (K3 over int8 tables)
- ``grad``              forward + backward, the table gradients included
- ``grad_frozen_tables``  the same with the tables frozen: ``grad`` minus it
                        is the tables' scatter and gradient
- ``adam``              the optimizer alone on precomputed gradients
- ``step``              one ``train_step``
- ``lazy_step``         one ``train_step`` under ``LazyTableAdam``
- ``chunk/N``           an ``EpochRunner.train_chunk`` of N steps, per step

The step's route is ``pool_only`` (K1 forward, K1b backward) unless
``PROF_KERNEL_VARIANTS`` names another. JAX's knobs, read from the
environment::

    PROF_BATCH (1024)  PROF_BAG (200)  PROF_CHUNK (16)
    PROF_DTYPE          float32 | bfloat16: the compute dtype
    PROF_ADAM_MU_DTYPE  float32 | bfloat16: Adam's first moments
    PROF_EMBED_GRAD     dense | segment | segment_sorted (``ops/embed.py``)
    PROF_ATTN_IMPL, PROF_ENCODER_IMPL   the plain route's formulations
    PROF_KERNEL_VARIANTS  auto | 1 (pool_only, with the forward/<route>
                        rows) | pool_only | gather_split | fused | xla (the
                        step's route, with the rows) | 0 (the plain route,
                        without them)
    PROF_TRACE_DIR      a torch.profiler Chrome trace of the chunk rows there
    PROF_RNG_IMPL       accepted and ignored (the port's dropout stream is a
                        torch.Generator); the first line names it

It prints one JSON line per row, an attribution line, then a markdown
table::

    python -m code2vec_tpu_torch.tools.profile_step [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROUTES = ("pool_only", "gather_split", "fused")
IGNORED = ("PROF_RNG_IMPL",)
# bench.py's synthetic corpus at top11's widths
TOP11_SPEC = dict(n_terminals=360_631, n_paths=342_845, n_labels=8_000, mean_contexts=120.0,
                  max_contexts=400, seed=0)


def time_ms(fn, device: torch.device, n: int, warmup: int = 1) -> float:
    """Mean ms of ``fn()`` over ``n`` calls after ``warmup``: CUDA events
    on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e3


def knobs(env=None) -> dict:
    """JAX's ``PROF_*`` knobs with JAX's defaults, and the port's step
    route they give."""
    env = os.environ if env is None else env
    variants = env.get("PROF_KERNEL_VARIANTS", "auto").strip().lower()
    if variants in ("auto", "1", "true", "yes", "on"):
        route, rows = "pool_only", True
    elif variants in ("0", "false", "no", "off"):
        route, rows = "xla", False
    elif variants in ROUTES + ("xla",):
        route, rows = variants, True
    else:
        raise ValueError(f"PROF_KERNEL_VARIANTS={variants!r}: expected auto, 0, 1 or one of "
                         f"{ROUTES + ('xla',)}")
    dtype = env.get("PROF_DTYPE", "float32").strip().lower()
    return {
        "batch": int(env.get("PROF_BATCH", 1024)),
        "bag": int(env.get("PROF_BAG", 200)),
        "chunk": int(env.get("PROF_CHUNK", 16)),
        "dtype": "bfloat16" if dtype in ("bfloat16", "bf16") else "float32",
        "embed_grad": env.get("PROF_EMBED_GRAD", "dense"),
        "adam_mu_dtype": env.get("PROF_ADAM_MU_DTYPE", "float32"),
        "attn_impl": env.get("PROF_ATTN_IMPL", "xla"),
        "encoder_impl": env.get("PROF_ENCODER_IMPL", "concat"),
        "route": route,
        "variant_rows": rows,
        "trace_dir": env.get("PROF_TRACE_DIR", "").strip(),
        "ignored": [k for k in IGNORED if k in env],
    }


def run(k: dict, device: torch.device, spec: dict | None = None, n: int = 30,
        n_chunks: int = 6, emit=print) -> dict:
    """Every row of ``k`` (:func:`knobs`) on ``device`` over a synthetic
    corpus of ``spec`` (top11's widths by default); each row is emitted
    as it lands. Returns ``{row: ms}``."""
    from code2vec_tpu_torch.data.synth import SynthSpec, corpus_data_from_raw, \
        generate_corpus_data
    from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig
    from code2vec_tpu_torch.train.config import TrainConfig
    from code2vec_tpu_torch.train.device_epoch import (
        EpochRunner,
        place_staged,
        sample_batch,
        sampler_generator,
        stage_method_corpus,
    )
    from code2vec_tpu_torch.train.step import (
        StepTally,
        forward_backward,
        make_optimizer,
        train_step,
    )

    B, L, chunk = k["batch"], k["bag"], k["chunk"]
    spec = dict(TOP11_SPEC if spec is None else spec)
    spec.setdefault("n_methods", max(B * 8, 8192))
    data = corpus_data_from_raw(generate_corpus_data(SynthSpec(**spec)))
    dtype = torch.bfloat16 if k["dtype"] == "bfloat16" else torch.float32

    def config(route, table_dtype="f32"):
        return Code2VecConfig(
            terminal_count=len(data.terminal_vocab), path_count=len(data.path_vocab),
            label_count=len(data.label_vocab), terminal_embed_size=100, path_embed_size=100,
            encode_size=100, dropout_prob=0.25, dtype=dtype, embed_grad=k["embed_grad"],
            attn_impl=k["attn_impl"], encoder_impl=k["encoder_impl"],
            use_pallas=route != "xla", pallas_impl=route if route != "xla" else "pool_only",
            table_dtype=table_dtype)

    tc = TrainConfig(batch_size=B, max_path_length=L, adam_mu_dtype=k["adam_mu_dtype"])
    rng = np.random.default_rng(0)
    staged = place_staged(stage_method_corpus(data, np.arange(data.n_items), rng), device)
    rows = torch.from_numpy(rng.integers(0, data.n_items, B).astype(np.int32)).to(device)
    valid = torch.ones(B, device=device)
    gen = sampler_generator(0, device)
    model = Code2Vec(config(k["route"]))
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(device)
    model.seed_dropout(0)
    cw = torch.ones(model.config.label_count, device=device)
    results: dict[str, float] = {}

    def bench(name, fn, count=n):
        results[name] = time_ms(fn, device, count)
        emit(json.dumps({"component": name, "ms": round(results[name], 3)}))

    bench("sample", lambda: sample_batch(staged, rows, valid, L, gen))
    batch = sample_batch(staged, rows, valid, L, gen)

    def forward_of(m, quant_tables=None):
        def fwd():
            with torch.no_grad():
                logits, _, _ = m(batch["starts"], batch["paths"], batch["ends"],
                                 quant_tables=quant_tables)
                return logits.float().sum()
        return fwd

    model.eval()
    bench("forward", forward_of(model))
    if k["variant_rows"]:
        for route in ROUTES:
            variant = _sharing(model, config(route))
            bench(f"forward/{route}", forward_of(variant.eval()))
        variant = _sharing(model, config("fused", "int8"))
        bench("forward/fused_int8", forward_of(variant.eval(), variant.quantize_tables()))

    def grad():
        model.zero_grad(set_to_none=True)
        return forward_backward(model, batch, cw)

    bench("grad", grad)
    tables = (model.terminal_embedding.weight, model.path_embedding.weight)
    for t in tables:
        t.requires_grad_(False)
    try:
        bench("grad_frozen_tables", grad)
    finally:
        for t in tables:
            t.requires_grad_(True)

    # the optimizer alone, on one step's gradients; the weights it moves
    # and its moments are put back after
    optimizer = make_optimizer(model, tc)
    grad()
    saved = [p.detach().clone() for p in model.parameters()]
    bench("adam", optimizer.step)
    with torch.no_grad():
        for p, s in zip(model.parameters(), saved):
            p.copy_(s)
    del saved
    optimizer = make_optimizer(model, tc)
    bench("step", lambda: train_step(model, optimizer, batch, cw))
    lazy_opt = make_optimizer(model, tc.with_updates(table_update="lazy"))
    bench("lazy_step", lambda: train_step(model, lazy_opt, batch, cw))
    del lazy_opt

    runner = EpochRunner(cw, B, L, chunk)
    order = rng.integers(0, data.n_items, chunk * B)  # JAX's rows: drawn with repeats
    tally = StepTally(device)

    def run_chunk():
        runner.train_chunk(model, optimizer, staged, order, 0, chunk, chunk * B, gen, tally)

    run_chunk()  # warm
    profiler = None
    if k["trace_dir"]:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda"
                                         else [])
        profiler = profile(activities=acts)
        profiler.__enter__()
    try:
        per_chunk = time_ms(run_chunk, device, n_chunks, warmup=0)
    finally:
        if profiler is not None:
            profiler.__exit__(None, None, None)
    if profiler is not None:
        os.makedirs(k["trace_dir"], exist_ok=True)
        path = os.path.join(k["trace_dir"], f"profile_step_chunk{chunk}.json")
        profiler.export_chrome_trace(path)
        emit(json.dumps({"trace": path}))
    results[f"chunk/{chunk}"] = per_chunk / chunk
    emit(json.dumps({"component": f"chunk/{chunk}", "ms": round(results[f"chunk/{chunk}"], 3)}))

    r = results
    emit(json.dumps({"attribution": {
        "sample": round(r["sample"], 3),
        "fwd": round(r["forward"], 3),
        "bwd_encoder": round(r["grad_frozen_tables"] - r["forward"], 3),
        "bwd_tables(scatter)": round(r["grad"] - r["grad_frozen_tables"], 3),
        "adam": round(r["adam"], 3),
        "sum_components": round(r["sample"] + r["grad"] + r["adam"], 3),
        "fused_step": round(r["step"], 3),
        "lazy_step": round(r["lazy_step"], 3),
        "chunk_per_step": round(r[f"chunk/{chunk}"], 3),
    }}))
    return results


def _sharing(model, config):
    """A ``Code2Vec`` of ``config`` over ``model``'s parameters (no copy)."""
    from code2vec_tpu_torch.models.code2vec import Code2Vec

    with torch.device("meta"):
        variant = Code2Vec(config)
    variant.load_state_dict(model.state_dict(keep_vars=True), assign=True)
    variant.seed_dropout(0)
    return variant


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="code2vec_tpu_torch.tools.profile_step",
        description="Attribute the flagship train step (PROF_* knobs in the environment; "
                    "see the module docstring)")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' times the plain versions on "
                        "the host)")
    args = parser.parse_args(argv)
    from code2vec_tpu_torch.ops.backend import launch_counts, reset_launch_counts, \
        resolve_device

    device = resolve_device(args.device)
    k = knobs()
    print(json.dumps({
        "device": str(device),
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "batch": k["batch"], "bag": k["bag"], "chunk": k["chunk"], "dtype": k["dtype"],
        "embed_grad": k["embed_grad"], "adam_mu_dtype": k["adam_mu_dtype"],
        "attn_impl": k["attn_impl"], "encoder_impl": k["encoder_impl"], "route": k["route"],
        "ignored": k["ignored"]}), flush=True)
    reset_launch_counts()
    results = run(k, device, emit=lambda line: print(line, flush=True))
    print(json.dumps({"launches": launch_counts()}), flush=True)
    print("\n| component | ms |")
    print("|---|---|")
    for name, ms in results.items():
        print(f"| {name} | {ms:.3f} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
