"""What a run reads from ``BENCHMARK.json`` and the files it names, and
what it prints.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. The configuration is ``configs/<config>.json``; the traffic is
``traffic/<traffic>.json``, whose ``driver`` names ``drivers/<driver>.py``.
A metric is ``metrics/<metric>.py``, whose ``read(run)`` returns a number
or None (nothing to read: the metric is left out of the line). Adding a
file and an entry adds a configuration, a cell or a metric; no file here
lists them.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list


@dataclass
class Run:
    """What a driver hands back: the numbers the metrics read."""

    correct: bool
    attempted: int
    failed: int
    checks: dict  # {name: {"value", "limit"}}
    counters: dict = field(default_factory=dict)
    trace: object = None  # trace.TraceSummary of a traced run
    memory_peak_bytes: int = 0
    config: dict = field(default_factory=dict)


def sync(device) -> None:
    """Wait for the device (nothing to wait for on the CPU, where the
    tests drive a run)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    """The process's peak of device memory allocated, 0 on the CPU."""
    import torch

    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _listed(metric: dict, cell: str, reported: set) -> bool:
    """Whether ``cell`` reports ``metric``: named in its ``workloads``, or,
    without that key, wherever the metric it moves is reported."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in reported


def find_cell(bench: dict, name: str, base: Path = HERE) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json lists {sorted(cells)}")
    w = cells[name]
    config = load_json(base / "configs" / f"{w['config']}.json")
    traffic = load_json(base / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _listed(m, name, reported)]
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=e2e, per_layer=per_layer)


def driver(name: str):
    return importlib.import_module(f"c2vbench.drivers.{name}")


def reader(metric: str, base: Path = HERE):
    """``metrics/<metric>.py``'s ``read`` (the names hold dots, so the file
    is loaded by its path)."""
    path = base / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"c2vbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(entries: list, run: Run) -> dict:
    out = {}
    for m in entries:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(run: Run, metrics: dict, device: dict, trace: bool) -> dict:
    line = {"correct": bool(run.correct), "attempted": int(run.attempted),
            "failed": int(run.failed), "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        line["breakdown"] = run.trace.breakdown()
    line["checks"] = run.checks
    return line
