"""The port's measuring tools (``code2vec_tpu_torch/tools/``) on the CPU.

- every tool byte-compiles and answers ``--help``;
- ``rehearse_java_large``'s ``gen`` writes the ``.npy`` files of JAX's
  ``phase_gen`` byte for byte at the same ``n_methods``, and a tiny
  rehearsal (2,000 methods, batch 32, bag 16, a cut model, two gloo CPU
  ranks for ``shard``) runs all five phases to finite losses;
- ``profile_step`` at 8x16 emits every row name of JAX's, and names the
  knobs it ignores;
- ``bench_ctx``'s pool formulations (the kernel pool, the ctx-parallel
  streaming pool, the plain pool) agree with JAX's
  ``ops/attention.attention_pool`` on the code vector and both gradients;
- ``memory_budget``'s measured line has JAX's keys and values where they
  do not depend on the process's RSS, and its budget lines are the
  java-large table's sizes (``docs/ARCHITECTURE.md``).
"""

import importlib
import importlib.util
import json
import math
import py_compile
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT_TOOLS = REPO / "code2vec_tpu_torch" / "tools"
JAX_TOOLS = REPO / "tools"
TOOL_NAMES = sorted(p.stem for p in PORT_TOOLS.glob("*.py") if p.stem != "__init__")


def load_jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"_jax_tool_{name}", JAX_TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", TOOL_NAMES)
def test_tool_compiles_and_answers_help(name, monkeypatch, capsys):
    py_compile.compile(str(PORT_TOOLS / f"{name}.py"), doraise=True)
    mod = importlib.import_module(f"code2vec_tpu_torch.tools.{name}")
    monkeypatch.setattr(sys, "argv", [name, "--help"])
    with pytest.raises(SystemExit) as exc:
        mod.main()
    assert exc.value.code == 0
    assert "usage:" in capsys.readouterr().out


def test_rehearsal_gen_is_jaxs_byte_for_byte(tmp_path):
    from code2vec_tpu_torch.tools import rehearse_java_large

    jax_tool = load_jax_tool("rehearse_java_large")
    jax_tool.phase_gen(str(tmp_path / "jax"), 3000)
    rehearse_java_large.phase_gen(str(tmp_path / "port"), 3000)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == ["ends.npy", "labels.npy", "paths.npy", "row_splits.npy", "starts.npy"]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_tiny_rehearsal_runs_every_phase(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "code2vec_tpu_torch.tools.rehearse_java_large",
         "--n_methods", "2000", "--batch", "32", "--bag", "16", "--steps", "2",
         "--chunk_items", "512", "--data_axis", "2", "--n_hosts", "2", "--vocab_rows", "5000",
         "--n_labels", "100", "--device", "cpu", "--work_dir", str(tmp_path / "rjl")],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    assert any(r.get("done") for r in lines)
    assert {"gen", "guard", "hostshard", "stream", "shard"} <= {r.get("phase") for r in lines}
    assert any(r.get("overflow_guard") == "fired" for r in lines)
    finals = [r for r in lines if "final_loss" in r]
    assert {r["phase"] for r in finals} == {"stream", "shard"}
    assert sorted(r.get("rank", 0) for r in finals if r["phase"] == "shard") == [0, 1]
    assert all(math.isfinite(r["final_loss"]) for r in finals)
    assert not (tmp_path / "rjl").exists()  # removed without --keep


def jax_profile_rows(chunk: int) -> set[str]:
    """The row names of JAX's ``tools/profile_step.py``, read from its source
    (it runs at import)."""
    src = (JAX_TOOLS / "profile_step.py").read_text()
    names = set(re.findall(r'bench\(\s*"([^"]+)"', src))
    assert 'for impl in ("pool_only", "gather_split", "fused"):' in src
    assert 'bench(f"forward/{impl}"' in src and 'results[f"chunk/{CHUNK}"]' in src
    return names | {f"forward/{impl}" for impl in ("pool_only", "gather_split", "fused")} \
        | {f"chunk/{chunk}"}


def test_profile_step_emits_every_jax_row():
    from code2vec_tpu_torch.tools import profile_step

    k = profile_step.knobs({"PROF_BATCH": "8", "PROF_BAG": "16", "PROF_CHUNK": "2",
                            "PROF_RNG_IMPL": "unsafe_rbg"})
    assert k["route"] == "pool_only" and k["ignored"] == ["PROF_RNG_IMPL"]
    lines = []
    spec = dict(n_methods=64, n_terminals=300, n_paths=250, n_labels=12, mean_contexts=20.0,
                max_contexts=40, seed=0)
    results = profile_step.run(k, torch.device("cpu"), spec=spec, n=2, n_chunks=1,
                               emit=lines.append)
    rows = [json.loads(line) for line in lines]
    emitted = {r["component"] for r in rows if "component" in r}
    assert emitted == set(results) == jax_profile_rows(2)
    assert all(ms > 0 and math.isfinite(ms) for ms in results.values())
    assert any("attribution" in r for r in rows)
    assert profile_step.knobs({"PROF_KERNEL_VARIANTS": "0"})["route"] == "xla"
    assert profile_step.knobs({"PROF_KERNEL_VARIANTS": "fused"})["route"] == "fused"


@pytest.mark.parametrize("shape", [(4, 24, 16), (2, 200, 100)])
def test_bench_ctx_pools_agree_with_jaxs_attention_pool(shape):
    import jax
    import jax.numpy as jnp

    from code2vec_tpu.ops.attention import attention_pool as jax_attention_pool
    from code2vec_tpu_torch.tools import bench_ctx

    contexts, mask, attn = bench_ctx.pool_inputs(*shape, device="cpu")

    def loss(c, a):
        cv, _ = jax_attention_pool(c, jnp.asarray(mask.numpy()), a)
        return jnp.sum(cv * cv), cv

    (_, cv), (d_c, d_a) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(contexts.numpy()), jnp.asarray(attn.numpy()))
    want = [torch.from_numpy(np.array(x)) for x in (cv, d_c, d_a)]
    for name, pool in bench_ctx.pool_formulations(mask).items():
        got = bench_ctx.pool_value_and_grad(pool, contexts, attn)
        for what, g, w in zip(("cv", "d_ctx", "d_attn"), got, want):
            assert bench_ctx.scaled_err(g, w) <= 1e-5, (name, what)


def test_memory_budget_lines_equal_jaxs(monkeypatch, capsys):
    from code2vec_tpu_torch.tools import memory_budget

    argv = ["--n_methods", "3000", "--batches", "2", "--chunk_items", "1024"]
    monkeypatch.setattr(sys, "argv", ["memory_budget.py"] + argv)
    monkeypatch.chdir(REPO)
    load_jax_tool("memory_budget").main()
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    memory_budget.main(argv)
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    ours = lines[0]
    assert set(ours) == set(theirs)
    for key in ("mode", "n_methods", "bag", "rows_touched"):
        assert ours[key] == theirs[key], key
    # the java-large table of docs/ARCHITECTURE.md ("Memory budget at
    # java-large scale"): ~23 GB, 38.4 GB, 157 MB, ~2.9 GB, ~0.9 GB, ~0.11 GB
    sizes = [round(b["bytes"] / 1e9, 2) for b in memory_budget.budget()]
    assert sizes == [23.04, 38.4, 0.16, 2.88, 0.87, 0.11]
    assert [b["budget"] for b in lines[1:]] == [b["budget"] for b in memory_budget.budget(
        chunk_items=1024)]
