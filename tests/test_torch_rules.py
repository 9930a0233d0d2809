"""Rules of the port: no JAX inside it, no silent CPU fallback.

- No ``.py`` under ``code2vec_tpu_torch/``, nor ``chip_smoke.py``, imports
  ``jax``, ``flax``, ``optax``, ``orbax`` or ``code2vec_tpu`` (AST scan).
- Every port module imports in a fresh interpreter with those names
  blocked in ``sys.modules``.
- Entry points not asked for the CPU raise when no GPU is visible.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "code2vec_tpu_torch"
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "code2vec_tpu")
FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"), str(path))):
        if isinstance(node, ast.Import):
            roots |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    assert not imported_roots(path) & set(BANNED), path


def test_every_module_imports_with_jax_blocked():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )
    script = (
        "import sys\n"
        f"for name in {BANNED!r}: sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "print('ok', len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the no-fallback rule is checked where there is none")


def test_predictor_without_device_raises(no_gpu, tmp_path):
    from code2vec_tpu_torch.predict import Predictor

    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(str(tmp_path), str(tmp_path / "t.txt"), str(tmp_path / "p.txt"))


def test_build_server_without_device_raises(no_gpu, tmp_path):
    from code2vec_tpu_torch.serve.__main__ import build_parser, build_server

    args = build_parser().parse_args([
        "--model_path", str(tmp_path), "--terminal_idx_path", "t.txt",
        "--path_idx_path", "p.txt",
    ])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_server(args)


def test_explicit_cuda_device_raises_without_gpu(no_gpu):
    from code2vec_tpu_torch.ops.backend import resolve_device

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    from code2vec_tpu_torch.ops import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    assert not (tmp_path / "build").exists()


def test_build_key_covers_every_source():
    from code2vec_tpu_torch.ops import _build

    names = {p.name for p in _build.CSRC.glob("*.cu*")}
    assert {"pool.cu", "pool.cuh", "fused_encode_pool.cu"} <= names
    assert _build.build_key() == _build.build_key()
