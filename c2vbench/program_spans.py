"""The program's own spans over a training cell, read through the cell's own
driver (``drivers/train_device.run``) with the program's tracer
(``code2vec_tpu_torch/obs/trace.py``) installed around it: what a seam in the
driver's traced branch would hand the per-layer metrics, measured beside the
benchmark, which reads none of it yet.

    python3 -m c2vbench.program_spans --workload top11.train_device --seed <n> [--seed <m> ...]

For each seed the driver runs three times in one process, on the same
inputs: untraced; under a program ``Tracer``; and under the tracer with
``trace`` on, its profiler handed the program's spans as marks (each instant
named by its innermost span) so that the breakdown names each idle gap by
what the host was doing there. One JSON line a seed: each run's rate and
``enqueue_ms`` as the benchmark's readers compute them, the :func:`readings`
of the traced window and of the profiled run's steps before its profiler
started, the ranges' share of the traced window's time a step, the host's
self time a step by span, and the profiled run's breakdown.

:func:`readings` turns a tracer's ``summary()`` into the per-layer numbers.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

RANGES = {"sample": "train.sample_device_ms", "forward": "train.forward_device_ms",
          "backward": "train.backward_device_ms", "optimizer": "train.optimizer_device_ms"}


def readings(summary: dict) -> dict:
    """The per-layer numbers of a tracer's summary over device-epoch
    chunks: each range's device ms a step, the share of steps in which an
    edged span found the card drained, and the lazy tables' touched share
    of the rows their update reads and writes. A number whose spans the
    summary lacks is left out."""
    out = {}
    steps = summary.get("train_step", {}).get("count", 0)
    for name, metric in RANGES.items():
        row = summary.get(name)
        if steps and row and row["device_count"]:
            out[metric] = row["device_ms"] / steps
    chunk = summary.get("train_chunk", {}).get("args", {})
    if chunk.get("steps") and "late_steps" in chunk:
        out["train.host_late_pct"] = 100.0 * chunk["late_steps"] / chunk["steps"]
    opt = summary.get("optimizer", {}).get("args", {})
    processed = sum(v for k, v in opt.items() if k.endswith("_rows_processed"))
    touched = sum(v for k, v in opt.items() if k.endswith("_rows_touched"))
    if processed:
        out["train.lazy_rows_useful_pct"] = 100.0 * touched / processed
    return out


class _After:
    """A profiler's marks with more read only when they are iterated."""

    def __init__(self, marks: list, more):
        self.marks, self.more = marks, more

    def __iter__(self):
        yield from self.marks
        yield from self.more()


def _marked(tracer, made: list):
    """The driver's profiler, given ``tracer``'s spans since its start as
    marks; they are cut only when the trace is reduced, after the window's
    stop edge, so that the host's work on them idles no part of it."""
    from c2vbench.trace import Profiler

    class Marked(Profiler):
        def start(self):
            super().start()
            self.program_ns = time.perf_counter_ns()
            made.append(self)

        def stop(self):
            self.marks = _After(self.marks, lambda: tracer.marks(self.program_ns))
            return super().stop()

    return Marked


def _drive(cell, seed: int, seconds: float, device, tracer=None, trace: bool = False):
    """One run of the cell's driver under ``tracer``: ``(Run, window start
    and end in perf_counter_ns, the profiler's start or None)``."""
    from c2vbench.drivers import train_device
    from code2vec_tpu_torch.obs.trace import set_tracer

    made: list = []
    profiler = train_device.Profiler
    previous = set_tracer(tracer)
    if trace:
        train_device.Profiler = _marked(tracer, made)
    try:
        t_start = time.perf_counter()
        run = train_device.run(cell, seed, seconds, trace, device, t_start)
    finally:
        train_device.Profiler = profiler
        set_tracer(previous)
    c = run.counters
    t0 = round((t_start + c["setup_s"]) * 1e9)
    return run, t0, t0 + round(c["window_s"] * 1e9), made[0].program_ns if made else None


def _rates(run) -> dict:
    from c2vbench.harness import reader

    c = run.counters
    return {"correct": run.correct, "steps": c["steps"],
            "train_contexts_per_s": reader("train_contexts_per_s")(run),
            "train.enqueue_ms": reader("train.enqueue_ms")(run),
            "ms_per_step": 1e3 * c["window_s"] / c["steps"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m c2vbench.program_spans")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, action="append", required=True)
    p.add_argument("--seconds", type=float, default=None,
                   help="each run's window (default: the benchmark's run_seconds)")
    p.add_argument("--json_out", default=None)
    args = p.parse_args(argv)

    from c2vbench.run import cache_dirs

    cache_dirs()
    import torch

    from c2vbench import harness
    from code2vec_tpu_torch.obs.trace import Tracer

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    bench = harness.load_benchmark(ROOT)
    cell = harness.find_cell(bench, args.workload)
    seconds = args.seconds or bench["run_seconds"]
    for seed in args.seed:
        plain = _drive(cell, seed, seconds, device)[0]
        tracer = Tracer()
        traced, t0, t1, _ = _drive(cell, seed, seconds, device, tracer)
        summary = tracer.summary(t0, t1)
        profiled_tracer = Tracer()
        profiled, p0, _, prof_ns = _drive(cell, seed, seconds, device, profiled_tracer, True)
        read = readings(summary)
        rates = {"untraced": _rates(plain), "traced": _rates(traced),
                 "profiled": _rates(profiled)}
        steps = summary["train_step"]["count"]
        device_sum = sum(read.get(m, 0.0) for m in RANGES.values())
        trace = profiled.trace
        line = {
            "workload": args.workload, "seed": seed,
            "device": torch.cuda.get_device_name(device),
            "readings": read,
            "readings_before_profiler": readings(profiled_tracer.summary(p0, prof_ns)),
            "device_sum_ms": device_sum,
            "device_sum_share": device_sum / rates["traced"]["ms_per_step"],
            "host_self_ms": {k: v["self_ms"] / steps for k, v in summary.items()},
            "runs": rates,
            "on_cost_pct": 100.0 * (rates["untraced"]["train_contexts_per_s"]
                                    / rates["traced"]["train_contexts_per_s"] - 1.0),
            "profiled": {"window_s": trace.window_s, "busy_s": trace.busy_s,
                         "idle_pct": 100.0 * (1.0 - trace.busy_s / trace.window_s),
                         **trace.breakdown()},
        }
        text = json.dumps(line)
        if args.json_out:
            Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.json_out, "a") as f:
                f.write(text + "\n")
        print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
