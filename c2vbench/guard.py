"""What a run may not load, and what the reference may not import.

Module names are compared by their top-level name, the part before the
first dot, whole: ``code2vec_tpu_torch`` (the program) is not
``code2vec_tpu`` (the JAX package it was ported from).
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
# never in the process that runs the card
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "code2vec_tpu"})
# nor in the yardstick, which must not lean on the program either
YARDSTICK_FORBIDDEN = FORBIDDEN | {"code2vec_tpu_torch"}
YARDSTICK = ("reference.py", "weights.py", "seeds.py", "corpus.py", "requests.py",
             "serve_kernels.py", "compare.py", "costs.py", "trace.py")


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules=None) -> list[str]:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in list(names) if top_level(n) in FORBIDDEN)


def imported_names(path: Path) -> set[str]:
    """Every module a file imports, at any depth of its code."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module)
    return out


def yardstick_violations() -> list[str]:
    """``file: module`` for each import of the yardstick's files that is
    forbidden to it."""
    bad = []
    for name in YARDSTICK:
        for mod in sorted(imported_names(HERE / name)):
            if top_level(mod) in YARDSTICK_FORBIDDEN:
                bad.append(f"{name}: {mod}")
    return bad
