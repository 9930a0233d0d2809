"""Rules of the port: no JAX inside it, no silent CPU fallback.

- No ``.py`` under ``code2vec_tpu_torch/``, nor ``chip_smoke.py``, imports
  ``jax``, ``flax``, ``optax``, ``orbax`` or ``code2vec_tpu`` (AST scan).
- Every port module imports in a fresh interpreter with those names
  blocked in ``sys.modules``.
- Entry points not asked for the CPU raise when no GPU is visible: the
  predictor, the server (stdio and HTTP), the fleet CLI's workers, the
  predict CLI, the extractor CLI and the index builder CLI
  (``tools/ann_build.py``).
- The fleet router and the telemetry package import with ``torch``
  blocked: the router opens no CUDA context.
- The port's extractor builds from ``extractor/src`` alone and writes only
  under ``build/code2vec_tpu_torch/`` (never ``extractor/build``, which the
  JAX package's build uses, nor ``code2vec_tpu/_native``).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

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


TRAINING_MODULES = [
    "text.py", "data/vocab.py", "formats/corpus_io.py", "formats/params_io.py",
    "data/reader.py", "data/synth.py", "data/pipeline.py", "metrics.py", "train/config.py",
    "train/step.py", "checkpoint.py", "export.py", "predict.py", "train/loop.py", "cli.py",
    "__main__.py",
]


@pytest.mark.parametrize("name", TRAINING_MODULES)
def test_training_modules_are_in_the_scan(name):
    """The training path's modules exist in the port and are among the
    files the import scan above covers (neither jax nor code2vec_tpu)."""
    path = PORT / name
    assert path in FILES, path
    assert not imported_roots(path) & set(BANNED), path


def test_build_key_covers_every_source():
    from code2vec_tpu_torch.ops import _build

    names = {p.name for p in _build.CSRC.glob("*.cu*")}
    assert {"pool.cu", "pool.cuh", "fused_encode_pool.cu"} <= names
    assert _build.build_key() == _build.build_key()


def test_predict_cli_without_device_raises(no_gpu, tmp_path):
    from code2vec_tpu_torch.predict import main

    java = tmp_path / "A.java"
    java.write_text("class A { int f(int a) { return a; } }\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([str(java), "--model_path", str(tmp_path), "--terminal_idx_path", "t.txt",
              "--path_idx_path", "p.txt"])


def test_extractor_cli_without_device_raises(no_gpu, tmp_path):
    from code2vec_tpu_torch import extractor

    with pytest.raises(RuntimeError, match="no CUDA device"):
        extractor.main([str(tmp_path), str(tmp_path)])
    (tmp_path / "methods.txt").write_text("")
    assert extractor.main([str(tmp_path), str(tmp_path), "--no_cuda"]) == 0


def test_ann_build_cli_without_device_raises(no_gpu, tmp_path):
    """The index builder runs on the card unless ``--device cpu``; with no
    GPU visible it raises before it reads or writes anything."""
    from code2vec_tpu_torch.formats.vectors_io import append_code_vectors, write_code_vectors_header
    from code2vec_tpu_torch.tools import ann_build

    vec = tmp_path / "code.vec"
    write_code_vectors_header(vec, 4, 8)
    append_code_vectors(vec, ["a", "b", "c", "d"], torch.eye(4, 8).numpy())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ann_build.main(["--code_vec", str(vec), "--out", str(tmp_path / "ann.index")])
    assert not (tmp_path / "ann.index").exists()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ann_build.main(["--code_vec", str(vec), "--out", str(tmp_path / "ann.index"),
                        "--device", "cuda"])
    assert ann_build.main(["--code_vec", str(vec), "--out", str(tmp_path / "ann.index"),
                           "--n_list", "2", "--m", "2", "--device", "cpu"]) == 0
    assert (tmp_path / "ann.index").exists()


def test_extractor_reads_its_sources_and_writes_its_build_dir_only(monkeypatch, tmp_path):
    """A real build into a scratch build root, every compiler command
    recorded: sources from ``extractor/src`` only, outputs under the build
    root only, and nothing of the JAX package's extractor build."""
    import subprocess as sp

    from code2vec_tpu_torch import extractor

    text = (PORT / "extractor.py").read_text(encoding="utf-8")
    for banned in ("_native", "cmake", "extractor/build", '"extractor" / "build"'):
        assert banned not in text, banned
    calls = []

    def recorded(fn):
        def call(cmd, *a, **kw):
            calls.append(list(cmd))
            return fn(cmd, *a, **kw)
        return call

    monkeypatch.setattr(extractor, "subprocess", SimpleNamespace(
        Popen=recorded(sp.Popen), run=recorded(sp.run), PIPE=sp.PIPE))
    monkeypatch.setattr(extractor, "BUILD_ROOT", tmp_path / "build" / "code2vec_tpu_torch")
    out = extractor.build_extractor()
    assert out.parent == tmp_path / "build" / "code2vec_tpu_torch"
    src = REPO / "extractor" / "src"
    assert extractor.SOURCE_DIR == src
    assert len(calls) == 7  # five objects, then the program and the library
    for cmd in calls:
        written = Path(cmd[cmd.index("-o") + 1])
        assert written.is_relative_to(tmp_path / "build" / "code2vec_tpu_torch"), cmd
        for arg in cmd[1:]:
            if arg.endswith((".cc", ".h")):
                assert Path(arg).parent == src, cmd
        if "-I" in cmd:
            assert Path(cmd[cmd.index("-I") + 1]) == src
    assert sorted(p.name for p in (tmp_path / "build").rglob("*") if p.is_file()) == \
        ["c2v-extract", "libc2v.so"]


SERVE_CONTROL_MODULES = [
    "obs/__init__.py", "obs/sync.py", "obs/handles.py", "obs/runtime.py", "obs/events.py",
    "obs/trace.py", "obs/costs.py", "serve/swap.py", "serve/protocol.py", "serve/__main__.py",
    "serve/fleet/__init__.py", "serve/fleet/__main__.py", "serve/fleet/slo.py",
    "serve/fleet/cache.py", "serve/fleet/replica.py", "serve/fleet/router.py",
]


@pytest.mark.parametrize("name", SERVE_CONTROL_MODULES)
def test_serve_control_modules_are_in_the_scan(name):
    """The hot-swap, HTTP, telemetry and fleet modules exist in the port
    and are among the files the AST scan and the blocked-import check
    cover."""
    path = PORT / name
    assert path in FILES, path
    assert not imported_roots(path) & set(BANNED), path


def test_router_and_telemetry_import_without_torch():
    """The fleet router and the obs package never open a CUDA context:
    they import with ``torch`` (and jax) blocked, as JAX's router imports
    without jax; so do the transports they use (``serve/protocol.py``)."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for sub in ("obs", "serve/fleet") for p in (PORT / sub).rglob("*.py")
    ) + ["code2vec_tpu_torch.serve.protocol", "code2vec_tpu_torch.serve.swap"]
    script = (
        "import sys\n"
        f"for name in {BANNED + ('torch',)!r}: sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "print('ok', len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(modules) >= 13


def test_http_server_without_device_raises(no_gpu, tmp_path):
    from code2vec_tpu_torch.serve.__main__ import build_parser, build_server

    args = build_parser().parse_args([
        "--model_path", str(tmp_path), "--terminal_idx_path", "t.txt",
        "--path_idx_path", "p.txt", "--transport", "http", "--port", "0",
    ])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_server(args)


def test_fleet_workers_without_device_raise(no_gpu, tmp_path):
    """A fleet worker runs on the card unless the fleet CLI is given
    ``--device cpu``: without it, and with no GPU visible, the worker's
    command exits with the device error before it serves."""
    from code2vec_tpu_torch.serve.fleet.__main__ import build_parser, worker_argv

    base = ["--model_path", str(tmp_path), "--terminal_idx_path", str(tmp_path / "t.txt"),
            "--path_idx_path", str(tmp_path / "p.txt")]
    argv = worker_argv(build_parser().parse_args(base), 0)
    assert "--device" not in argv and argv[1:3] == ["-m", "code2vec_tpu_torch.serve"]
    cpu = worker_argv(build_parser().parse_args(base + ["--device", "cpu"]), 0)
    assert cpu[cpu.index("--device") + 1] == "cpu"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(argv, cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120, stdin=subprocess.DEVNULL)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr, proc.stderr[-2000:]
