"""Sharding-contract checker: the port's specs vs the declared mesh.

Counterpart of ``code2vec_tpu/analysis/sharding_check.py``. An invalid
spec fails only at run time, on the cards, after staging. The port writes
a spec JAX's way but as a list (one entry a dim: None, an axis name, or a
tuple of names; ``[]`` for ``P()``, ``parallel/shardings.py``), and names
axes when it asks the mesh for a line (``mesh.group("data")``,
``mesh.shape["model"]``, ``mesh.coords["ctx"]``). This pass checks both,
statically, against the axis names the mesh module declares
(``parallel/mesh.py``'s ``AXIS_* = "..."`` constants; ``GROUP_*``
constants name groups that are not axes, such as the data x ctx plane):

- **SC001**: a spec, or a mesh access, names an axis the mesh does not
  declare (a typo'd ``"bath"``, a stale axis after a mesh refactor).
- **SC002**: the same axis appears twice in one spec — a mesh axis may
  shard at most one dimension of a tensor.
- **SC003**: the ``ctx`` axis appears in a spec built inside a function
  whose name marks it as a parameter/state sharding rule — the context
  axis shards the bag dimension of *batches*.

A spec is a list literal inside a *rule function*: one whose name holds
``spec`` or ``sharding`` (``spec_for_param``, ``batch_shardings``, ...).
Axis names are resolved through a small constant propagation: string
literals, ``None``, names assigned from either, ``AXIS_*`` names imported
from the mesh module, and ``a if cond else b`` over resolvable branches.
Anything else (helper-call results, arbitrary expressions) is UNKNOWN and
skipped — the checker never guesses.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Iterable

from code2vec_tpu_torch.analysis.torchlint import (
    Finding,
    _apply_suppressions,
    _collect_imports,
    iter_py_files,
    relative,
)

__all__ = [
    "declared_axes",
    "check_source",
    "check_paths",
    "validate_runtime_spec",
]

_UNKNOWN = object()
_RULE_FN = re.compile(r"spec|sharding", re.IGNORECASE)
_MESH_MAPS = {"shape", "coords"}  # mesh.<map>[axis]


def declared_axes(mesh_source: str) -> dict[str, str]:
    """Parse the mesh module for ``AXIS_<ROLE> = "<name>"`` declarations
    (and ``GROUP_<NAME> = "<name>"``, the groups that are not axes).
    Returns ``{"AXIS_DATA": "data", ...}`` — the var names matter too
    (SC003 keys off ``AXIS_CTX``'s value, mesh accesses accept groups)."""
    tree = ast.parse(mesh_source)
    out: dict[str, str] = {}
    for node in tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id.startswith(("AXIS_", "GROUP_"))
            and isinstance(node.value, ast.Constant)
            and isinstance(node.value.value, str)
        ):
            out[node.targets[0].id] = node.value.value
    return out


def _axis_env(tree: ast.Module, imports: dict[str, str],
              axis_decls: dict[str, str]) -> dict[str, object]:
    """Name -> possible axis values (strings / None), or UNKNOWN. One flat
    pass over every assignment in the file — scope-blind, which is safe: a
    name bound to two resolvable values yields the union."""
    env: dict[str, object] = {}
    for bound, target in imports.items():
        leaf = target.rsplit(".", 1)[-1]
        if leaf in axis_decls and ".mesh." in f".{target}":
            env[bound] = frozenset({axis_decls[leaf]})

    def resolve(node: ast.AST, depth: int = 0) -> object:
        if depth > 8:
            return _UNKNOWN
        if isinstance(node, ast.Constant) and (node.value is None or isinstance(node.value, str)):
            return frozenset({node.value})
        if isinstance(node, ast.Name):
            return env.get(node.id, _UNKNOWN)
        if isinstance(node, ast.IfExp):
            a = resolve(node.body, depth + 1)
            b = resolve(node.orelse, depth + 1)
            if a is _UNKNOWN or b is _UNKNOWN:
                return _UNKNOWN
            return a | b
        return _UNKNOWN

    pairs = [(node.targets[0].id, node.value) for node in ast.walk(tree)
             if isinstance(node, ast.Assign) and len(node.targets) == 1
             and isinstance(node.targets[0], ast.Name)]
    # iterate to a small fixed point so chained aliases resolve regardless
    # of their order in the file
    for _ in range(3):
        changed = False
        for name, value in pairs:
            val = resolve(value)
            prev = env.get(name)
            if val is _UNKNOWN:
                if name not in env:
                    env[name] = _UNKNOWN
                    changed = True
                continue
            merged = val if prev in (None, _UNKNOWN) else prev | val
            if merged != prev:
                env[name] = merged
                changed = True
        if not changed:
            break
    return env


def _slot_values(node: ast.AST, env: dict) -> list[object]:
    """Possible axis values of ONE spec entry: a list of frozensets (one
    per axis slot — a tuple entry shards one dim over several axes) or
    UNKNOWN entries."""
    if isinstance(node, ast.Tuple):
        out: list[object] = []
        for elt in node.elts:
            out.extend(_slot_values(elt, env))
        return out
    if isinstance(node, ast.Constant) and (node.value is None or isinstance(node.value, str)):
        return [frozenset({node.value})]
    if isinstance(node, ast.Name):
        return [env.get(node.id, _UNKNOWN)]
    if isinstance(node, ast.IfExp):
        a = _slot_values(node.body, env)
        b = _slot_values(node.orelse, env)
        if len(a) == len(b) == 1 and a[0] is not _UNKNOWN and b[0] is not _UNKNOWN:
            return [a[0] | b[0]]
        return [_UNKNOWN]
    return [_UNKNOWN]


def _is_mesh(node: ast.AST) -> bool:
    """``mesh`` or ``<anything>.mesh``: the receiver of a mesh access."""
    return (isinstance(node, ast.Name) and node.id == "mesh") or (
        isinstance(node, ast.Attribute) and node.attr == "mesh")


def _mesh_access(node: ast.AST) -> ast.AST | None:
    """The axis argument of ``mesh.group(x)`` / ``mesh.shape[x]`` /
    ``mesh.coords[x]``, else None."""
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "group" and _is_mesh(node.func.value) and node.args):
        return node.args[0]
    if (isinstance(node, ast.Subscript) and isinstance(node.value, ast.Attribute)
            and node.value.attr in _MESH_MAPS and _is_mesh(node.value.value)):
        return node.slice
    return None


def check_source(
    source: str,
    rel_path: str,
    axis_decls: dict[str, str],
    tree: ast.Module | None = None,
) -> list[Finding]:
    """Run SC001-SC003 over one file. ``axis_decls`` comes from
    :func:`declared_axes` (or a test-supplied mapping). Pass ``tree`` to
    reuse an already-parsed AST."""
    lines = source.splitlines()
    try:
        if tree is None:
            tree = ast.parse(source, filename=rel_path)
    except SyntaxError:
        return []  # torchlint already reports unparseable files
    imports = _collect_imports(tree)
    env = _axis_env(tree, imports, axis_decls)
    axes = {v for k, v in axis_decls.items() if k.startswith("AXIS_")}
    groups = axes | {v for k, v in axis_decls.items() if k.startswith("GROUP_")}
    ctx_axis = axis_decls.get("AXIS_CTX")
    findings: list[Finding] = []
    flagged: set[tuple[str, int, int]] = set()

    def emit(rule: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        # one spec repeating a bad axis is one defect, not one per slot
        if (rule, line, col) in flagged:
            return
        flagged.add((rule, line, col))
        snippet = lines[line - 1].strip() if 0 < line <= len(lines) else ""
        findings.append(Finding(rule=rule, path=rel_path, line=line, col=col,
                                message=message, snippet=snippet))

    def check_spec(node: ast.List, chain: str) -> None:
        slots = []
        for elt in node.elts:
            slots.extend(_slot_values(elt, env))
        definite: list[str] = []
        for values in slots:
            if values is _UNKNOWN:
                continue
            for v in values:
                if v is None:
                    continue
                if v not in axes:
                    emit("SC001", node, f"sharding spec names axis {v!r} but the mesh "
                                        f"declares only {sorted(axes)}")
                if len(values) == 1:
                    definite.append(v)
        for v in sorted({v for v in definite if definite.count(v) > 1}):
            emit("SC002", node, f"axis {v!r} appears {definite.count(v)} times in one "
                                "sharding spec — a mesh axis shards at most one dimension")
        if (ctx_axis is not None and ctx_axis in definite
                and any(k in chain.lower() for k in ("param", "state"))):
            emit("SC003", node, f"ctx axis {ctx_axis!r} in `{chain}` — parameter/state "
                                "sharding rules must not partition over the context axis")

    def visit(node: ast.AST, chain: str, in_rule: bool) -> None:
        for child in ast.iter_child_nodes(node):
            sub_chain, sub_rule = chain, in_rule
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                sub_chain = f"{chain}.{child.name}" if chain else child.name
                sub_rule = in_rule or bool(_RULE_FN.search(child.name))
            elif isinstance(child, ast.List) and in_rule:
                check_spec(child, chain)
            axis = _mesh_access(child)
            if axis is not None:
                for values in _slot_values(axis, env):
                    if values is _UNKNOWN:
                        continue
                    for v in values:
                        if v is not None and v not in groups:
                            emit("SC001", child, f"mesh access names axis {v!r} but the "
                                                 f"mesh declares only {sorted(groups)}")
            visit(child, sub_chain, sub_rule)

    visit(tree, "", False)
    _apply_suppressions(findings, lines)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def validate_runtime_spec(entries, declared: Iterable[str], context: str = "spec") -> list[str]:
    """SC001/SC002 semantics applied to one *live* spec at restore time.

    The static pass above validates spec literals in source; the
    mesh-reshape restore (``checkpoint.py``) reads specs from a checkpoint
    sidecar and re-slices onto a *new* mesh — axis names valid at save time
    may not exist anymore. ``entries`` is the sidecar form (one item per
    dim: None, an axis name, or a list of names); ``declared`` is the new
    mesh's axis-name set. Returns human-readable problems (empty = valid),
    so the caller can fail with guidance instead of a late shape error.
    """
    declared = set(declared)
    problems: list[str] = []
    flat: list[str] = []
    for entry in entries:
        if entry is None:
            continue
        flat.extend(entry if isinstance(entry, (list, tuple)) else [entry])
    for axis in dict.fromkeys(flat):  # stable de-dup
        if axis not in declared:
            problems.append(
                f"{context}: axis {axis!r} is not declared by the restore "
                f"mesh (axes: {sorted(declared)}) [SC001]"
            )
        if flat.count(axis) > 1:
            problems.append(
                f"{context}: axis {axis!r} appears {flat.count(axis)} times "
                "in one PartitionSpec — a mesh axis shards at most one "
                "dimension [SC002]"
            )
    return problems


def check_paths(
    paths: Iterable[Path],
    root: Path | None = None,
    axis_decls: dict[str, str] | None = None,
    mesh_file: Path | None = None,
) -> list[Finding]:
    """Check every ``.py`` under ``paths``. Axis declarations come from
    ``axis_decls``, else from ``mesh_file``, else from the first
    ``parallel/mesh.py`` found under the scanned paths; no mesh found →
    no findings (nothing to validate against)."""
    root = Path(root) if root is not None else Path.cwd()
    files = iter_py_files(paths)
    if axis_decls is None:
        if mesh_file is None:
            mesh_file = next(
                (f for f in files if f.as_posix().endswith("parallel/mesh.py")), None
            )
        if mesh_file is None:
            return []
        axis_decls = declared_axes(Path(mesh_file).read_text())
    findings: list[Finding] = []
    for file in files:
        findings.extend(check_source(file.read_text(), relative(file, root), axis_decls))
    return findings
