"""Java source -> path contexts, through the repo's C++ extractor.

Counterpart of ``code2vec_tpu/extractor.py`` for Java sources. The
extractor (``extractor/src``: lexer, Java parser, path enumerator) is
reached two ways:

- :func:`extract_source`: in process, through ``ctypes`` on ``libc2v.so``:
  a Java source string in, methods and run-local vocabs out, nothing on
  disk;
- :func:`extract_dataset`: the ``c2v-extract`` program over a dataset's
  ``methods.txt``, writing the five corpus artifacts (``corpus.txt``,
  ``terminal_idxs.txt``, ``path_idxs.txt``, ``params.txt``,
  ``actual_methods.txt``).

:func:`build_extractor` compiles both from ``extractor/src`` with ``g++``
at first use, with CMake's Release flags of ``extractor/CMakeLists.txt``,
into ``build/code2vec_tpu_torch/extractor-<digest>/`` (the digest covers
the sources and the flags, so an edit rebuilds). Each translation unit is
one ``g++`` process, all started together; the outputs appear in place
only once the whole build has succeeded, and a failed build raises with
the compiler's stderr.

Python sources go through ``pyextract.py`` (pure Python, no build). The
CLI sends a ``methods.txt`` with any ``.py`` row down the mixed route
(JAX ``extractor.py:351-436``): the Java rows through ``c2v-extract`` in a
temporary directory, whose artifacts are copied into the dataset, then the
Python rows appended in merge mode into the same vocab files, their ids
after the Java leg's ``method_count``; the Java leg's normalization flags
reach the Python leg.

    python -m code2vec_tpu_torch.extractor <dataset_dir> <source_dir> [--no_cuda]
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading
from dataclasses import dataclass, field
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[1]
SOURCE_DIR = REPO_ROOT / "extractor" / "src"
BUILD_ROOT = REPO_ROOT / "build" / "code2vec_tpu_torch"
# CMake's Release build of extractor/CMakeLists.txt: C++17, -O3 -DNDEBUG,
# -Wall -Wextra, position-independent objects; c2v-extract links pthreads
CXX_FLAGS = ("-std=c++17", "-O3", "-DNDEBUG", "-Wall", "-Wextra", "-fPIC")
CORE = ("lexer.cc", "parser.cc", "extract.cc")
BINARY = "c2v-extract"
LIBRARY = "libc2v.so"

_lock = threading.Lock()
_lib = None


def source_digest() -> str:
    """A digest of ``extractor/src`` (every file, by name and bytes) and
    the compiler flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for path in sorted(SOURCE_DIR.iterdir()):
        if path.is_file():
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / f"extractor-{source_digest()}"


def _compile(cxx: str, out_dir: Path) -> None:
    """Every object in parallel, then the program and the library."""
    objs = {name: out_dir / (name.removesuffix(".cc") + ".o")
            for name in (*CORE, "capi.cc", "main.cc")}
    procs = [(name, subprocess.Popen(
        [cxx, *CXX_FLAGS, *(("-pthread",) if name == "main.cc" else ()), "-I", str(SOURCE_DIR),
         "-c", str(SOURCE_DIR / name), "-o", str(obj)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)) for name, obj in objs.items()]
    failures = []
    for name, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"g++ failed on extractor/src/{name}:\n{err}")
    if failures:
        raise RuntimeError("\n".join(failures))
    core = [str(objs[name]) for name in CORE]
    links = [
        [cxx, *CXX_FLAGS, "-pthread", str(objs["main.cc"]), *core, "-o", str(out_dir / BINARY)],
        [cxx, *CXX_FLAGS, "-shared", str(objs["capi.cc"]), *core, "-o", str(out_dir / LIBRARY)],
    ]
    for cmd in links:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to link {Path(cmd[-1]).name}:\n{proc.stderr}")
    for obj in objs.values():
        obj.unlink()


def build_extractor() -> Path:
    """The build directory holding ``c2v-extract`` and ``libc2v.so``,
    compiled first if this digest has none. One build runs at a time
    (threads wait on a lock, processes on a ``flock`` of the build root);
    it compiles into a directory of its own and renames it into place."""
    out_dir = build_dir()
    if (out_dir / BINARY).exists() and (out_dir / LIBRARY).exists():
        return out_dir
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with _lock:
        root_fd = os.open(BUILD_ROOT, os.O_RDONLY)
        try:
            fcntl.flock(root_fd, fcntl.LOCK_EX)
            if (out_dir / BINARY).exists() and (out_dir / LIBRARY).exists():
                return out_dir  # built by another process while this one waited
            cxx = shutil.which("g++")
            if cxx is None:
                raise RuntimeError("g++ not found on PATH: the extractor of code2vec_tpu_torch "
                                   "is built from extractor/src at first use")
            from code2vec_tpu_torch.obs.trace import get_tracer

            tmp = Path(tempfile.mkdtemp(prefix=f"{out_dir.name}.tmp", dir=BUILD_ROOT))
            try:
                with get_tracer().span("extractor_build", category="extract"):
                    _compile(cxx, tmp)
                os.rename(tmp, out_dir)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            return out_dir
        finally:
            os.close(root_fd)  # releases the flock


@dataclass
class ExtractedMethod:
    label: str
    path_contexts: list[tuple[int, int, int]] = field(default_factory=list)
    aliases: list[tuple[str, str]] = field(default_factory=list)


@dataclass
class ExtractResult:
    methods: list[ExtractedMethod]
    terminal_vocab: dict[int, str]  # run-local indices from 1 (no PAD row)
    path_vocab: dict[int, str]


def load_library():
    """``libc2v.so`` loaded through ``ctypes``, built first if need be (a
    server calls this in its warmup, so no request waits for a build)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_extractor() / LIBRARY))
        lib.c2v_extract_source.restype = ctypes.c_void_p
        lib.c2v_extract_source.argtypes = [ctypes.c_char_p, ctypes.c_char_p] + [ctypes.c_int] * 6
        lib.c2v_free.argtypes = [ctypes.c_void_p]
        lib.c2v_last_error.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def extract_source(source: str, method_name: str = "*", max_length: int = 8,
                   max_width: int = 3, normalize_string: bool = True,
                   normalize_char: bool = True, normalize_int: bool = False,
                   normalize_double: bool = True) -> ExtractResult:
    """Path contexts of the methods named ``method_name`` (``*``: all) of
    a Java source string, in process."""
    lib = load_library()
    raw = lib.c2v_extract_source(
        source.encode("utf-8"), method_name.encode("utf-8"), max_length, max_width,
        int(normalize_string), int(normalize_char), int(normalize_int), int(normalize_double))
    if not raw:
        raise ValueError("extraction failed: " + lib.c2v_last_error().decode("utf-8"))
    try:
        text = ctypes.string_at(raw).decode("utf-8")
    finally:
        lib.c2v_free(raw)
    return _parse_blob(text)


def _parse_blob(text: str) -> ExtractResult:
    """``c2v_extract_source``'s text: per method a ``#`` line, ``label:``,
    ``paths:`` then tab-separated id triples, ``vars:`` then (original,
    alias) pairs; then the terminal and path vocabs after their markers."""
    body, _, tail = text.partition("===TERMINALS===\n")
    terminal_part, _, path_part = tail.partition("===PATHS===\n")

    def parse_vocab(chunk: str) -> dict[int, str]:
        out = {}
        for line in chunk.splitlines():
            if "\t" in line:
                index, name = line.split("\t", 1)
                out[int(index)] = name
        return out

    methods: list[ExtractedMethod] = []
    current: ExtractedMethod | None = None
    mode = 0
    for line in body.splitlines():
        if not line:
            current = None
            continue
        if line.startswith("#"):
            current = ExtractedMethod(label="")
            methods.append(current)
            mode = 0
        elif line.startswith("label:"):
            current.label = line[6:]
        elif line == "paths:":
            mode = 1
        elif line == "vars:":
            mode = 2
        elif mode == 1:
            start, path, end = line.split("\t")
            current.path_contexts.append((int(start), int(path), int(end)))
        elif mode == 2:
            original, alias = line.split("\t")
            current.aliases.append((original, alias))
    return ExtractResult(methods=methods, terminal_vocab=parse_vocab(terminal_part),
                         path_vocab=parse_vocab(path_part))


def read_method_rows(dataset_dir: str | os.PathLike) -> list[tuple[str, str]]:
    """``methods.txt``'s (source file, method name) rows."""
    rows = []
    with open(Path(dataset_dir) / "methods.txt", encoding="utf-8",
              errors="surrogateescape") as f:
        for line in f:
            line = line.strip()
            if line and "\t" in line:
                src, method = line.split("\t", 1)
                rows.append((src, method))
    return rows


def extract_dataset(dataset_dir: str | os.PathLike, source_dir: str | os.PathLike,
                    max_length: int = 8, max_width: int = 3,
                    method_declarations: str | None = None,
                    extra_args: list[str] | tuple[str, ...] = ()) -> subprocess.CompletedProcess:
    """``c2v-extract`` over ``<dataset_dir>/methods.txt``: writes the five
    artifacts into ``dataset_dir``. Every row goes to the program, a
    ``.py`` row too, as in JAX (the CLI routes those to :func:`_extract_mixed`).
    Raises ``CalledProcessError`` when the program fails."""
    cmd = [str(build_extractor() / BINARY), str(dataset_dir), str(source_dir),
           "--max-length", str(max_length), "--max-width", str(max_width)]
    if method_declarations:
        cmd += ["--method-declarations", method_declarations]
    cmd += list(extra_args)
    from code2vec_tpu_torch.obs.trace import get_tracer

    with get_tracer().span("extract_dataset", category="extract", dataset_dir=str(dataset_dir)):
        return subprocess.run(cmd, check=True, capture_output=True, text=True)


def _py_config_from_flags(args, extra):
    """The Java leg's pass-through normalization flags, applied to the
    Python leg too: both legs intern literals into one vocab, so they must
    agree on what a literal normalizes to."""
    from code2vec_tpu_torch.pyextract import PyExtractConfig

    config = PyExtractConfig(max_length=args.max_length, max_width=args.max_width)
    for flag in extra:
        if flag == "--no-normalize-string":
            config.normalize_string_literal = False
        elif flag == "--no-normalize-char":
            config.normalize_char_literal = False
        elif flag == "--normalize-int":
            config.normalize_int_literal = True
        elif flag == "--normalize-double":
            config.normalize_double_literal = True
        elif flag == "--no-normalize-double":
            config.normalize_double_literal = False
    return config


def _extract_mixed(args, extra, rows) -> None:
    """A Java + Python dataset: the ``.java`` rows through ``c2v-extract``
    in a temporary directory, its artifacts copied into the dataset, then
    the ``.py`` rows through ``pyextract`` in merge mode (the Java leg's
    vocab files preloaded, records appended, ids from its
    ``method_count``)."""
    from code2vec_tpu_torch.formats.params_io import read_params
    from code2vec_tpu_torch.pyextract import extract_python_dataset

    java_rows = [r for r in rows if not r[0].endswith(".py")]
    py_rows = [r for r in rows if r[0].endswith(".py")]
    start_id, merge = 0, False
    if java_rows:
        with tempfile.TemporaryDirectory() as tmp:
            with open(os.path.join(tmp, "methods.txt"), "w", encoding="utf-8",
                      errors="surrogateescape") as f:
                for src, method in java_rows:
                    f.write(f"{src}\t{method}\n")
            result = extract_dataset(tmp, args.source_dir, max_length=args.max_length,
                                     max_width=args.max_width,
                                     method_declarations=args.method_declarations,
                                     extra_args=extra)
            sys.stderr.write(result.stderr)
            names = ["corpus.txt", "actual_methods.txt", "terminal_idxs.txt", "path_idxs.txt",
                     "params.txt"]
            if args.method_declarations and os.path.exists(
                    os.path.join(tmp, args.method_declarations)):
                names.append(args.method_declarations)
            for name in names:
                shutil.copy2(os.path.join(tmp, name), os.path.join(args.dataset_dir, name))
            start_id = int(read_params(os.path.join(tmp, "params.txt"))["method_count"])
        merge = True
    n, vocabs = extract_python_dataset(
        args.dataset_dir, args.source_dir, py_rows, config=_py_config_from_flags(args, extra),
        merge=merge, start_id=start_id, method_declarations=args.method_declarations)
    print(f"extracted {n} methods ({start_id} java + {n - start_id} python), "
          f"{len(vocabs.terminals)} terminals, {len(vocabs.paths)} paths", file=sys.stderr)


def main(argv: list[str] | None = None) -> int:
    """``python -m code2vec_tpu_torch.extractor <dataset_dir> <source_dir>``:
    the rows of ``methods.txt`` -> the corpus artifacts (a ``.py`` row sends
    the whole dataset down the mixed route). The port's
    entry points run on the card unless asked for the CPU: extraction is
    host work, but without ``--no_cuda`` the command needs a visible GPU, like the trainer whose corpus it makes."""
    import argparse

    from code2vec_tpu_torch.ops.backend import resolve_device

    parser = argparse.ArgumentParser(
        prog="code2vec_tpu_torch.extractor",
        description="Java and/or Python sources -> path-context corpus artifacts (reads "
                    "<dataset_dir>/methods.txt, writes corpus.txt, terminal_idxs.txt, "
                    "path_idxs.txt, params.txt, actual_methods.txt)")
    parser.add_argument("dataset_dir")
    parser.add_argument("source_dir")
    parser.add_argument("--max-length", type=int, default=8)
    parser.add_argument("--max-width", type=int, default=3)
    parser.add_argument("--method-declarations", default=None)
    parser.add_argument("--no_cuda", action="store_true", default=False,
                        help="run without a GPU (the default needs one)")
    args, extra = parser.parse_known_args(argv)
    resolve_device("cpu" if args.no_cuda else None)
    try:
        rows = read_method_rows(args.dataset_dir)
        if any(src.endswith(".py") for src, _ in rows):
            _extract_mixed(args, extra, rows)
            return 0
        result = extract_dataset(args.dataset_dir, args.source_dir, max_length=args.max_length,
                                 max_width=args.max_width,
                                 method_declarations=args.method_declarations,
                                 extra_args=extra)
    except OSError as exc:
        print(f"ERROR: {exc}", file=sys.stderr)
        return 1
    except subprocess.CalledProcessError as exc:
        sys.stdout.write(exc.stdout or "")
        sys.stderr.write(exc.stderr or "")
        return exc.returncode
    sys.stdout.write(result.stdout)
    sys.stderr.write(result.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
