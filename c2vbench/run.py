"""One run of one cell: ``python3 -m c2vbench.run --workload <cell> --seed
<n> --seconds <s> --trace <0|1>``, from the root of a checkout.

Set-up is everything from this process's start to the window's: imports,
CUDA's start, the corpus and weights, the kernels' build (the first run in
a checkout compiles them into ``build/`` there) and the warm-up. The last
line of standard output is the result; the last lines of standard error
are the numbers compared, each beside its limit. The process exits with a
code other than 0, and prints no result, when the card or the cards the
cell asks for are missing, when the yardstick imports what it may not, or
when the JAX package or JAX itself was loaded by the time the window closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m c2vbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths (the
    port builds its CUDA libraries under ``build/code2vec_tpu_torch/``)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "c2vbench" / sub)


def main(argv=None) -> int:
    args = parse(argv)
    cache_dirs()
    from c2vbench import guard, harness

    bad = guard.yardstick_violations()
    if bad:
        print("the yardstick imports what it may not: " + ", ".join(bad), file=sys.stderr)
        return 3
    cell = harness.find_cell(harness.load_benchmark(ROOT), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    driver = harness.driver(cell.traffic["driver"])
    run = driver.run(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                     device=device, t_start=T_START)
    loaded = guard.forbidden_loaded()
    if loaded:
        print("loaded in the process that ran the card: " + ", ".join(loaded), file=sys.stderr)
        return 4
    metrics = harness.read_metrics(cell.per_layer if args.trace else cell.end_to_end, run)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": cell.chips,
           "memory_peak_bytes": run.memory_peak_bytes}
    if args.trace:
        dev["busy_s"], dev["window_s"] = run.trace.busy_s, run.trace.window_s
        print(f"trace: profiler clock less host clock at the window's start "
              f"{run.trace.clock_skew_us!r} us", file=sys.stderr)
    line = harness.result_line(run, metrics, dev, bool(args.trace))
    sys.stderr.flush()
    for name, c in run.checks.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
