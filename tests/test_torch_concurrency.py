"""The port's CX rule family (``code2vec_tpu_torch/analysis/concurrency.py``)
against the JAX package's (``code2vec_tpu/analysis/concurrency.py``).

Every fixture source of the JAX package's own CX tests
(``tests/test_concurrency.py``: each ``lint(<string literal>)`` call, read from
that file's syntax tree, so the two stay one list) goes through both
analyzers; they must report the same rule ids on the same lines with the
same suppression state (the JAX suppression marker ``# jaxlint:`` is
rewritten to the port's ``# torchlint:`` for the port). Then the port's
own additions: CX003's device syncs under a lock, and CX005 over the
port's fork-based feed pool.
"""

from __future__ import annotations

import ast
import textwrap
from pathlib import Path

import pytest

from code2vec_tpu.analysis import concurrency as jax_concurrency
from code2vec_tpu_torch.analysis import concurrency, torchlint

pytestmark = pytest.mark.sync

REPO = Path(__file__).resolve().parents[1]


def jax_fixtures(test_file: str, helper: str) -> list:
    """``(test name, source)`` of every ``helper(<string literal>)`` call in
    the JAX package's test file."""
    tree = ast.parse((REPO / "tests" / test_file).read_text())
    out = []
    for cls in tree.body:
        if not isinstance(cls, ast.ClassDef):
            continue
        for fn in cls.body:
            if not isinstance(fn, ast.FunctionDef):
                continue
            calls = [c for c in ast.walk(fn)
                     if isinstance(c, ast.Call) and isinstance(c.func, ast.Name)
                     and c.func.id == helper and c.args
                     and isinstance(c.args[0], ast.Constant)]
            for i, c in enumerate(calls):
                out.append(pytest.param(textwrap.dedent(c.args[0].value),
                                        id=f"{cls.name}.{fn.name}.{i}"))
    return out


def port_source(source: str) -> str:
    return source.replace("# jaxlint:", "# torchlint:")


def summary(findings) -> list:
    return sorted((f.rule, f.line, f.suppressed) for f in findings)


CX_FIXTURES = jax_fixtures("test_concurrency.py", "lint")


def test_every_jax_cx_fixture_is_read():
    assert len(CX_FIXTURES) >= 18


@pytest.mark.parametrize("source", CX_FIXTURES)
def test_cx_fixture_matches_jax(source):
    want = summary(jax_concurrency.lint_concurrency(source, "mod.py"))
    got = summary(concurrency.lint_concurrency(port_source(source), "mod.py"))
    assert got == want


@pytest.mark.parametrize("call,flags", [
    ("t.item()", True),
    ("torch.cuda.synchronize()", True),
    ("self._event.synchronize()", True),
    ("t.shape[0]", False),
])
def test_cx003_device_sync_under_lock(call, flags):
    """The port's CX003 gains the device syncs a torch program makes: each
    one under a lock holds it a full device round trip."""
    src = textwrap.dedent(f"""
        import threading
        import torch

        class Holder:
            def __init__(self):
                self._lock = threading.Lock()

            def read(self, t):
                with self._lock:
                    return {call}
        """)
    ids = {f.rule for f in concurrency.lint_concurrency(src) if not f.suppressed}
    assert ("CX003" in ids) is flags
    outside = src.replace("with self._lock:\n            return", "return")
    assert "CX003" not in {f.rule for f in concurrency.lint_concurrency(outside)}


def test_cx_rules_registered_and_fix_text_names_the_port():
    for rid in ("CX001", "CX002", "CX003", "CX004", "CX005"):
        assert rid in torchlint.RULES
    assert "code2vec_tpu_torch.obs.sync.guard_fork_safety" in torchlint.RULES["CX005"].hint


def test_port_parallel_feed_is_guarded():
    """The port's fork-based feed pool requests ``fork`` behind
    ``guard_fork_safety``: CX005 stays quiet on it."""
    path = REPO / "code2vec_tpu_torch" / "data" / "parallel_feed.py"
    findings = concurrency.lint_concurrency(path.read_text(), "parallel_feed.py")
    assert "CX005" not in {f.rule for f in findings if not f.suppressed}
