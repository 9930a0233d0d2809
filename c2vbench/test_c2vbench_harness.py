"""CPU tests of the benchmark: its file against the contract, the lookup of
configurations, traffic and metrics by name, the yardstick's counts, the
plain reference against the port at a tiny size (the port's kernels run
their plain versions on the CPU), the faults ``correct`` must catch, and
the import rules. Run with ``python -m pytest c2vbench -q``."""

from __future__ import annotations

import copy
import json
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

from c2vbench import compare, costs, guard, harness
from c2vbench.drivers import serve_embed, train_device

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark()


def tiny(config: str) -> dict:
    cfg = harness.load_json(harness.HERE / "configs" / f"{config}.json")
    cfg.update(terminal_count=500, path_count=400, label_count=50, terminal_embed_size=8,
               path_embed_size=8, encode_size=16, batch_size=32, max_path_length=20)
    cfg["corpus"].update(n_methods=300, median_contexts=12, max_contexts=60, signature_size=5)
    return cfg


def tiny_serve() -> dict:
    tr = harness.load_json(harness.HERE / "traffic" / "serve_embed.json")
    tr.update(pool_size=48, clients=4, warmup_seconds=0.3, long_max=600,
              longbag_widths=[512, 1024], check_requests=40)
    return tr


def traffic(name: str) -> dict:
    return harness.load_json(harness.HERE / "traffic" / f"{name}.json")


def train_run(tr: dict, seed: int = 2**31 + 99, seconds: float = 0.5):
    cell = harness.Cell("tiny", 1, tiny("top11"), tr, [], [])
    return train_device.run(cell, seed=seed, seconds=seconds, trace=False, device=CPU,
                            t_start=time.perf_counter())


# -- BENCHMARK.json against the contract ------------------------------------


def test_top_level_keys_and_paths(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["c2vbench"]
    assert bench["command"][:3] == ["python3", "-m", "c2vbench.run"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_keys(bench, section):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}[section]
    names = [e["name"] for e in bench[section]]
    assert len(names) == len(set(names))
    for e in bench[section]:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in ("config", "traffic"):
            if k in e:
                assert NAME.match(e[k])
        for k in e.get("reduced", ()):
            assert NAME.match(k)


def test_metrics_rules(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers: dict = {}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        reported = {w for w in cells if "workloads" not in e2e[m["moves"]]
                    or w in e2e[m["moves"]]["workloads"]}
        assert set(m["workloads"]) <= reported, m["name"]
        if m["name"].endswith("_roofline_pct") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        cell = harness.find_cell(bench, w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        assert w["chips"] in (1, 4)


def test_run_seconds_fit_the_check(bench):
    """A full check of 24 cells fits the driver's 43,200 s."""
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (bench["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


def test_config_files(bench):
    for c in bench["configs"]:
        assert c["file"].startswith("c2vbench/configs/")
        cfg = harness.load_json(harness.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert cfg["dtype"] == "float32"


# -- found by name ----------------------------------------------------------


def test_every_named_file_exists(bench):
    for w in bench["workloads"]:
        cell = harness.find_cell(bench, w["name"])
        assert harness.driver(cell.traffic["driver"]).run
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_adding_files_adds_a_cell(bench, tmp_path):
    """A configuration, a traffic mix and a metric added as files, and a
    cell added as entries, are found without editing a file."""
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(harness.HERE / sub, tmp_path / sub)
    cfg = tiny("top11")
    cfg["name"] = "top11_small"
    (tmp_path / "configs" / "top11_small.json").write_text(json.dumps(cfg))
    tr = traffic("train_device")
    tr["chunk_batches"] = 2
    (tmp_path / "traffic" / "train_short.json").write_text(json.dumps(tr))
    (tmp_path / "metrics" / "train.steps.py").write_text(
        "def read(run):\n    return run.counters.get('steps')\n")
    new = copy.deepcopy(bench)
    new["workloads"].append({"name": "top11_small.train_short", "config": "top11_small",
                             "traffic": "train_short", "chips": 1, "why": "test"})
    new["per_layer"].append({"name": "train.steps", "unit": "steps", "better": "higher",
                             "source": "host_clock", "layer": "device-epoch feed",
                             "moves": "train_contexts_per_s",
                             "workloads": ["top11_small.train_short"]})
    new["end_to_end"][0]["workloads"].append("top11_small.train_short")
    cell = harness.find_cell(new, "top11_small.train_short", base=tmp_path)
    assert cell.config["corpus"]["n_methods"] == 300 and cell.traffic["chunk_batches"] == 2
    assert [m["name"] for m in cell.per_layer] == ["train.steps"]
    run = train_device.run(cell, seed=5, seconds=0.2, trace=False, device=CPU,
                           t_start=time.perf_counter())
    assert harness.reader("train.steps", base=tmp_path)(run) == run.counters["steps"] > 0


def test_per_layer_metric_without_workloads_follows_its_moves(bench):
    new = copy.deepcopy(bench)
    new["per_layer"].append({"name": "x.everywhere", "unit": "%", "better": "higher",
                             "source": "device_trace", "layer": "device (H100)",
                             "moves": "train_contexts_per_s"})
    train = {w["name"] for w in new["workloads"] if "train" in w["traffic"]}
    for w in new["workloads"]:
        got = "x.everywhere" in {m["name"] for m in harness.find_cell(new, w["name"]).per_layer}
        assert got == (w["name"] in train)


# -- the yardstick's counts --------------------------------------------------


def test_forward_flops_hand_count():
    # B=2, L=3, D=2*4+5=13, H=6, labels=7
    b, l, d, h, n = 2, 3, 13, 6, 7
    hand = 2 * b * l * d * h + 2 * b * h * n + 4 * b * l * h + 11 * b * l * h + 5 * b * l
    got = costs.forward_flops(b, l, terminal_embed=4, path_embed=5, encode=h, labels=n)
    assert got == hand
    assert costs.train_step_flops(b, l, terminal_embed=4, path_embed=5, encode=h,
                                  labels=n) == 3 * hand


def test_top11_step_flops():
    cfg = harness.load_json(harness.HERE / "configs" / "top11.json")
    flops = costs.train_step_flops(1024, 200, **costs.dims_of(cfg))
    assert 42e9 < flops < 43.5e9


def test_pool_bytes_hand_count():
    b, l, h = 2, 3, 5
    # ctx 2*3*5 f32, mask 2*3, attn 5, cv 2*5, weights 2*3
    assert costs.pool_bytes(b, l, h) == 4 * (30 + 6 + 5 + 10 + 6)
    # ctx and d_ctx, w, mask, g_w, cv, g_cv, attn, d_attn
    assert costs.pool_bwd_bytes(b, l, h) == 4 * (60 + 18 + 20 + 10)
    assert costs.pool_bytes(b, l, h, ctx_item=2) == 2 * 30 + 4 * (6 + 5 + 10 + 6)


def test_encode_pool_seconds_hand_count():
    # D = 300, H = 100: 3 TF32 products of 2 D H, 8 H at the f32 rate
    ops = 3 * 2 * 300 * 100 * 10 / 495e12 + 8 * 100 * 10 / 67e12
    got = costs.encode_pool_seconds(10, 1, 16, terminal_embed=100, path_embed=100, encode=100)
    assert got == pytest.approx(max(ops, 4 * (64 + 30000 + 300 + 100 + 16) / 3.35e12))


# -- the reference against the port, and the faults --------------------------


@pytest.mark.parametrize("name", ["train_device", "train_lazy"])
def test_train_reference_matches_port(name):
    run = train_run(traffic(name))
    assert run.correct, run.checks
    assert run.attempted > 0 and run.failed == 0
    for c in run.checks.values():
        assert c["value"] < 1e-5


def _frozen_step(model, optimizer, batch, class_weights):
    from code2vec_tpu_torch.train.step import forward_backward

    optimizer.zero_grad(set_to_none=True)
    return forward_backward(model, batch, class_weights).detach()


def _half_batch_step(real):
    def step(model, optimizer, batch, class_weights):
        mask = batch["example_mask"].clone()
        mask[mask.shape[0] // 2:] = 0.0
        return real(model, optimizer, dict(batch, example_mask=mask), class_weights)

    return step


def _altered_loss_step(real):
    def step(model, optimizer, batch, class_weights):
        return real(model, optimizer, batch, class_weights) * (1.0 + 1e-4)

    return step


@pytest.mark.parametrize("fault", ["frozen", "half", "altered"])
@pytest.mark.parametrize("name", ["train_device", "train_lazy"])
def test_train_faults_fail(monkeypatch, name, fault):
    """A step that leaves the state unchanged, one that leaves half of the
    batch out (the mean over the rest), and one whose loss is altered where
    it is produced: each turns ``correct`` false."""
    from code2vec_tpu_torch.train import device_epoch

    real = device_epoch.train_step
    broken = {"frozen": lambda: _frozen_step, "half": lambda: _half_batch_step(real),
              "altered": lambda: _altered_loss_step(real)}[fault]()
    monkeypatch.setattr(device_epoch, "train_step", broken)
    run = train_run(traffic(name))
    assert not run.correct, run.checks


def test_train_control_fails_and_faults_read_high():
    """The reference planted with each fault reads far above the limits."""
    from c2vbench.corpus import draw_corpus
    from c2vbench.reference import follow_train
    from c2vbench.seeds import numpy_rng
    from c2vbench.weights import make_weights

    cfg, tr = tiny("top11"), traffic("train_device")
    corpus = draw_corpus(cfg, 7, CPU)
    rng = numpy_rng(7, "rows")
    order = rng.permutation(corpus.n_items)
    b = cfg["batch_size"]
    rows = [order[i * b:(i + 1) * b] for i in range(3)]
    w = make_weights(cfg, 7, CPU)
    ref = follow_train(cfg, tr, w, corpus, rows, 7)
    for fault in ("frozen", "half"):
        gaps = compare.train_gaps(follow_train(cfg, tr, w, corpus, rows, 7, fault=fault), ref)
        assert not compare.passed(compare.judge(gaps, tr["limits"])), (fault, gaps)


def serve_run(seed: int = 2**33 + 7):
    cell = harness.Cell("tiny", 1, tiny("top11"), tiny_serve(), [], [])
    return serve_embed.run(cell, seed=seed, seconds=1.0, trace=False, device=CPU,
                           t_start=time.perf_counter())


def test_serve_reference_matches_port():
    run = serve_run()
    assert run.correct, run.checks
    assert run.counters["compared"] > 0 and run.failed == 0
    assert harness.reader("serve.batch_rows_mean")(run) >= 1.0
    assert harness.reader("serve_contexts_per_s")(run) > 0


def test_serve_altered_answer_fails(monkeypatch):
    real = serve_embed.EngineCalls.__call__

    def altered(self, starts, paths, ends):
        logits, cv, attn = real(self, starts, paths, ends)
        cv = cv.copy()
        cv[0, 0] += 0.01
        return logits, cv, attn

    monkeypatch.setattr(serve_embed.EngineCalls, "__call__", altered)
    run = serve_run()
    assert not run.correct, run.checks


# -- imports ----------------------------------------------------------------


def test_yardstick_imports_nothing_forbidden():
    assert guard.yardstick_violations() == []
    for name in guard.YARDSTICK:
        assert (guard.HERE / name).exists()


def test_forbidden_names_compare_whole():
    assert guard.forbidden_loaded(["code2vec_tpu_torch", "code2vec_tpu_torch.ops",
                                   "jaxtyping", "flaxen"]) == []
    assert guard.forbidden_loaded(["code2vec_tpu.models", "jax.numpy", "jaxlib", "flax"]) == [
        "code2vec_tpu.models", "flax", "jax.numpy", "jaxlib"]


def test_a_run_loads_no_jax():
    """Everything a run imports, the program's modules on the timed paths
    with it, loads neither JAX nor the JAX package."""
    code = ("import c2vbench.run, c2vbench.control, c2vbench.drivers.train_device, "
            "c2vbench.drivers.serve_embed\n"
            "import code2vec_tpu_torch.models.code2vec, code2vec_tpu_torch.train.device_epoch, "
            "code2vec_tpu_torch.train.step, code2vec_tpu_torch.serve.__main__, "
            "code2vec_tpu_torch.serve.protocol, code2vec_tpu_torch.interop\n"
            "from c2vbench import guard\nprint(guard.forbidden_loaded())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_result_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and c2vbench/, a run
    exits with another code than 0 and prints no result."""
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "c2vbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "c2vbench.run", "--workload",
                          "top11.train_device", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
