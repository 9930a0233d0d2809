"""Build the hand-written CUDA kernels with ``nvcc`` and load them.

Every ``csrc/*.cu`` file becomes one shared library with a plain C
interface (``extern "C"`` launchers taking raw device pointers, sizes and
the CUDA stream), loaded through ``ctypes``. No PyTorch headers are
compiled, so a build takes seconds, not minutes.

Builds land in ``build/code2vec_tpu_torch/<key>/`` at the repo root, where
``<key>`` hashes the sources (``*.cu`` and ``*.cuh``) and the compiler
flags: an edit rebuilds, an unchanged tree reuses the libraries. Missing
libraries are built in parallel, one ``nvcc`` per source, and a failed
build raises with ``nvcc``'s stderr. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "code2vec_tpu_torch"
# --split-compile=0 runs the device compiler's passes on every core: on the
# H100 machine the slowest source builds in half the time, its SASS unchanged
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "--split-compile=0",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# ptxas' register / shared-memory report of the last build, per source
build_log: dict[str, str] = {}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "code2vec_tpu_torch are built from source at first use"
    )


def build_all() -> dict[str, Path]:
    """Build every missing library (in parallel); return name -> path."""
    with _lock:
        out_dir = BUILD_ROOT / build_key()
        targets = {src.stem: out_dir / f"lib{src.stem}.so" for src in sources()}
        todo = [s for s in sources() if not targets[s.stem].exists()]
        if todo:
            nvcc = _nvcc()
            out_dir.mkdir(parents=True, exist_ok=True)
            procs = []
            for src in todo:
                tmp = out_dir / f"lib{src.stem}.so.tmp{os.getpid()}"
                cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
                procs.append((src, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                )))
            failures = []
            for src, tmp, proc in procs:
                out, err = proc.communicate()
                build_log[src.stem] = (out + err).strip()
                if proc.returncode != 0:
                    failures.append(f"nvcc failed on {src.name}:\n{err}")
                    tmp.unlink(missing_ok=True)
                else:
                    os.replace(tmp, targets[src.stem])
            if failures:
                raise RuntimeError("\n".join(failures))
        return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built if needed)."""
    lib = _libs.get(name)
    if lib is None:
        path = build_all()[name]
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(path))
                lib.c2v_error_string.argtypes = [ctypes.c_int]
                lib.c2v_error_string.restype = ctypes.c_char_p
                _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error. A negative code is an
    error that was already pending before the launch (csrc/pool.cuh)."""
    if code < 0:
        msg = lib.c2v_error_string(-code).decode()
        raise RuntimeError(f"{what}: not launched, an earlier CUDA error was pending: "
                           f"{-code} ({msg})")
    if code != 0:
        msg = lib.c2v_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
