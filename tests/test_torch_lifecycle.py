"""The port's RS rule family (``code2vec_tpu_torch/analysis/lifecycle.py``)
against the JAX package's (``code2vec_tpu/analysis/lifecycle.py``).

Every fixture source of the JAX package's own RS tests
(``tests/test_lifecycle.py``: each ``_lint(<string literal>)`` call, and
each test's group of ``check_source`` files joined by ``finalize``, read
from that file's syntax tree) goes through both analyzers; they must
report the same rule ids on the same lines and paths with the same
suppression state (``# jaxlint:`` rewritten to ``# torchlint:`` for the
port).
"""

from __future__ import annotations

import ast
import textwrap
from pathlib import Path

import pytest
from test_torch_concurrency import jax_fixtures, port_source, summary

from code2vec_tpu.analysis import lifecycle as jax_lifecycle
from code2vec_tpu_torch.analysis import lifecycle, torchlint

pytestmark = pytest.mark.lifecycle

REPO = Path(__file__).resolve().parents[1]
RS_FIXTURES = jax_fixtures("test_lifecycle.py", "_lint")


def cross_file_fixtures() -> list:
    """Each JAX test's ``check_source(textwrap.dedent(<source>), <path>)``
    files, in order: one group a test, joined by ``finalize``."""
    tree = ast.parse((REPO / "tests" / "test_lifecycle.py").read_text())
    out = []
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        files = []
        for c in ast.walk(fn):
            if not (isinstance(c, ast.Call) and isinstance(c.func, ast.Name)
                    and c.func.id == "check_source" and len(c.args) == 2
                    and isinstance(c.args[1], ast.Constant)):
                continue
            src = c.args[0]
            if isinstance(src, ast.Call) and src.args:
                src = src.args[0]
            if isinstance(src, ast.Constant):
                files.append((c.lineno, textwrap.dedent(src.value), c.args[1].value))
        if files:
            out.append(pytest.param([f[1:] for f in sorted(files)], id=fn.name))
    return out


CROSS_FILE = cross_file_fixtures()


def test_every_jax_rs_fixture_is_read():
    assert len(RS_FIXTURES) >= 28 and len(CROSS_FILE) >= 3


@pytest.mark.parametrize("source", RS_FIXTURES)
def test_rs_fixture_matches_jax(source):
    want = summary(jax_lifecycle.lint_lifecycle(source))
    got = summary(lifecycle.lint_lifecycle(port_source(source)))
    assert got == want


@pytest.mark.parametrize("files", CROSS_FILE)
def test_rs_cross_file_finalize_matches_jax(files):
    def run(mod, rewrite):
        findings, fragments = [], []
        for source, path in files:
            f, frag = mod.check_source(rewrite(source), path)
            findings += f
            fragments.append(frag)
        findings += mod.finalize(fragments)
        return sorted((f.rule, f.path, f.line, f.suppressed) for f in findings)

    assert run(lifecycle, port_source) == run(jax_lifecycle, lambda s: s)


def test_rs_rules_registered_with_the_port_engine():
    for rid in ("RS001", "RS002", "RS003", "RS004", "RS005", "RS006"):
        assert torchlint.RULES[rid].severity == "warning"
