"""torchlint: a Python-AST static-analysis pass for PyTorch step footguns.

Counterpart of ``code2vec_tpu/analysis/jaxlint.py``. The defect classes it
catches never raise: a host sync inside a step that idles the card every
call, a dtype that drifts to int64 or the default float and gives the step
a new input signature, host-side randomness or clocks inside a body that a
CUDA graph would freeze, set-ordered collectives that hang across ranks.
Pure stdlib (``ast``): no torch import, so ``python -m
code2vec_tpu_torch.analysis`` costs parse time only.

A *device body* is a function whose calls run on the card in the step:
``forward``/``backward`` of an ``autograd.Function``, ``forward`` of an
``nn.Module``, and the port's step functions (:data:`STEP_FUNCTIONS`).
Nested functions inside one are device bodies too.

Rules (JAX's numbers under a ``TX`` prefix)
-------------------------------------------
- **TX000 parse-error** (error): the file does not parse.
- **TX001 dtype-less-literal** (warning): ``torch.tensor``/``as_tensor``/
  ``full``/``zeros``/``ones``/``arange`` of Python literals with no
  ``dtype=`` entering a batch dict (a display or item with a batch key) or
  a step call. The tensor gets int64 or the default float type instead of
  the pipeline's int32/float32: a new signature for ``RecompileDetector``.
- **TX002 host-sync-in-device-body** (error): ``.item()``/``.tolist()``/
  ``.cpu()``/``.numpy()``, ``float``/``int``/``bool`` of a tensor, or
  ``torch.cuda.synchronize()`` inside a device body: the host waits for the
  card every call.
- **TX003 tensor-branch** (error): Python ``if``/``while`` on a tensor's
  value inside a device body (``is None``, ``isinstance``, shapes, dtypes,
  devices and string comparisons are static): a hidden sync, and a branch
  a CUDA graph cannot capture.
- **TX004 impure-device-body** (error): ``time.*``/stdlib ``random``/
  ``uuid``/``secrets``/``np.random`` without a generator/``datetime.now``/
  ``os.urandom`` inside a device body: host state a captured graph would
  replay frozen, and steps that do not repeat.
- **TX005 missing-donate** (info): not applicable. JAX's JX005 asks for
  ``donate_argnums``; torch frees a buffer when its last reference dies and
  updates parameters in place, so there is nothing to donate. The id is
  kept so the table lines up with JAX's; it never fires.
- **TX006 set-iteration-order** (warning): iterating a ``set`` to build
  containers. Set order varies across processes (hash randomization), so a
  set-ordered sequence of ``torch.distributed`` calls can hang across
  ranks. Sort first.
- **TX007 host-sync-step-loop** (warning): ``float()``/``.item()`` inside a
  loop that also calls a step function: one device round trip a step.

Each finding carries a stable fingerprint (rule | file | source-line text)
so a checked-in baseline survives unrelated line shifts. Suppress a single
line with ``# torchlint: disable=TX001`` (or a bare ``disable`` for all
rules); suppress pre-existing debt with the baseline file
(``--write-baseline``).
"""

from __future__ import annotations

import ast
import dataclasses
import json
import re
from pathlib import Path
from typing import Iterable

__all__ = [
    "Finding",
    "Rule",
    "RULES",
    "RECOMPILE_HINT_RULES",
    "STEP_FUNCTIONS",
    "lint_source",
    "lint_paths",
    "fingerprint",
    "load_baseline",
    "write_baseline",
    "apply_baseline",
]

TOOL = "torchlint"

# the port's step functions: their bodies are device bodies (TX002-TX004)
# and a loop calling one is a step loop (TX007)
STEP_FUNCTIONS = frozenset(
    {"train_step", "eval_step", "forward_backward", "lazy_forward_backward", "train_chunk"}
)
# the keys of a step's batch dict (train/step.py BATCH_KEYS)
BATCH_KEYS = frozenset({"starts", "paths", "ends", "labels", "example_mask"})


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    name: str
    severity: str  # "error" | "warning" | "info"
    summary: str
    hint: str


RULES: dict[str, Rule] = {
    r.id: r
    for r in (
        Rule(
            "TX000",
            "parse-error",
            "error",
            "file does not parse — nothing in it can be checked",
            "fix the SyntaxError; the file is unanalyzed until it parses",
        ),
        Rule(
            "TX001",
            "dtype-less-literal",
            "warning",
            "dtype-less tensor of Python literals entering a batch or a step call",
            "give the constructor an explicit dtype (torch.tensor(x, dtype=torch.int32)) so "
            "the step sees the pipeline's int32/float32 and one input signature",
        ),
        Rule(
            "TX002",
            "host-sync-in-device-body",
            "error",
            "host sync (.item()/.tolist()/.cpu()/.numpy()/float()/synchronize) inside a "
            "device body",
            "keep the value on the card (torch.where, masked ops), or move the read out of "
            "the step and do it once an epoch",
        ),
        Rule(
            "TX003",
            "tensor-branch",
            "error",
            "Python control flow on a tensor's value inside a device body",
            "use torch.where / masked arithmetic, or branch on shapes, dtypes or config "
            "(static) instead of values",
        ),
        Rule(
            "TX004",
            "impure-device-body",
            "error",
            "impure host call (time/random/uuid) inside a device body",
            "draw randomness from a torch.Generator passed in, and take timestamps outside "
            "the step, so a captured CUDA graph replays the same work",
        ),
        Rule(
            "TX005",
            "missing-donate",
            "info",
            "not applicable: torch has no buffer donation (JAX JX005)",
            "nothing to do: torch frees a buffer when its last reference dies and "
            "optimizers update parameters in place; this rule never fires",
        ),
        Rule(
            "TX006",
            "set-iteration-order",
            "warning",
            "iteration over a set feeding container construction",
            "iterate sorted(...) — set order varies across processes, so collectives issued "
            "in that order can hang across ranks",
        ),
        Rule(
            "TX007",
            "host-sync-step-loop",
            "warning",
            "per-step host sync (float()/.item()) inside a step loop",
            "append the device scalar to a list and convert once after the loop — one sync "
            "per epoch instead of one per step",
        ),
        Rule(
            "SC001",
            "undeclared-mesh-axis",
            "error",
            "sharding spec or mesh access names an axis the mesh does not declare",
            "use one of the declared mesh axis names (parallel/mesh.py AXES) — an "
            "undeclared axis fails only at run time, on the cards",
        ),
        Rule(
            "SC002",
            "duplicate-spec-axis",
            "error",
            "the same mesh axis appears twice in one sharding spec",
            "a mesh axis may shard at most one dimension of a tensor; drop one of the "
            "duplicate references",
        ),
        Rule(
            "SC003",
            "ctx-axis-on-params",
            "warning",
            "context axis used in a parameter/state sharding rule",
            "the ctx axis shards the bag dimension of batches; vocab tables and encoder "
            "params must shard over model/data or replicate",
        ),
    )
}

# the lint rules whose defect class surfaces at run time as a new step input
# signature; obs.runtime.RecompileDetector stamps these ids into its
# `recompile` warning/event so the telemetry links back to the static pass
RECOMPILE_HINT_RULES: dict[str, str] = {
    "TX001": "dtype-less tensor of literals entering a batch or a step (dtype churn)",
    "TX006": "set-order-dependent container construction (structure churn)",
}

_SUPPRESS_RE = re.compile(r"#\s*torchlint:\s*disable(?:=(?P<ids>[A-Za-z0-9_,\s]+))?")

# --------------------------------------------------------------------------
# findings


@dataclasses.dataclass
class Finding:
    rule: str
    path: str  # repo-relative, posix
    line: int
    col: int
    message: str
    snippet: str  # stripped source line (fingerprint component)
    suppressed: bool = False
    baselined: bool = False

    @property
    def severity(self) -> str:
        return RULES[self.rule].severity

    @property
    def name(self) -> str:
        return RULES[self.rule].name

    @property
    def hint(self) -> str:
        return RULES[self.rule].hint

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "name": self.name,
            "severity": self.severity,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "hint": self.hint,
            "snippet": self.snippet,
            "fingerprint": fingerprint(self),
            "suppressed": self.suppressed,
            "baselined": self.baselined,
        }

    def text(self) -> str:
        return (
            f"{self.path}:{self.line}:{self.col}: {self.rule} "
            f"[{self.severity}] {self.message}\n    {self.snippet}\n"
            f"    fix: {self.hint}"
        )


def fingerprint(finding: Finding) -> str:
    """Line-shift-stable identity: rule + file + the flagged source line.
    Identical lines in one file share a fingerprint; the baseline stores a
    COUNT per fingerprint, so k pre-existing occurrences stay suppressed
    while a (k+1)-th new one fails."""
    return f"{finding.rule}|{finding.path}|{finding.snippet}"


# --------------------------------------------------------------------------
# import + name resolution helpers


_IMPORTS: dict[int, tuple[ast.Module, dict[str, str]]] = {}  # the last tree's table


def _collect_imports(tree: ast.Module) -> dict[str, str]:
    """Bound name -> dotted module/object path, for disambiguating
    ``torch.random`` from stdlib ``random`` and resolving aliases
    (``import torch.nn.functional as F``, ``from torch import nn``).
    Every layer asks for the same tree's table; the last one is kept."""
    hit = _IMPORTS.get(id(tree))
    if hit is not None and hit[0] is tree:
        return hit[1]
    table: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.asname:
                    table[alias.asname] = alias.name
                else:
                    table[alias.name.split(".")[0]] = alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            for alias in node.names:
                table[alias.asname or alias.name] = f"{node.module}.{alias.name}"
    _IMPORTS.clear()
    _IMPORTS[id(tree)] = (tree, table)
    return table


def _dotted(node: ast.AST, imports: dict[str, str]) -> str | None:
    """Resolve ``torch.tensor`` / ``np.random.rand`` / ``tensor`` to a dotted
    path through the import table; None when the root is not a plain name."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Call):  # f(...)(...) — resolve the inner target
        return _dotted(node.func, imports)
    if not isinstance(node, ast.Name):
        return None
    root = imports.get(node.id, node.id)
    return ".".join([root] + list(reversed(parts)))


def _tail(path: str | None) -> str:
    return path.rsplit(".", 1)[-1] if path else ""


def _base_tails(cls: ast.ClassDef, imports: dict[str, str]) -> set[str]:
    return {_tail(_dotted(b, imports)) for b in cls.bases}


# --------------------------------------------------------------------------
# the per-module linter


class _ModuleLint:
    def __init__(self, tree: ast.Module, rel_path: str, lines: list[str]):
        self.tree = tree
        self.path = rel_path
        self.lines = lines
        self.imports = _collect_imports(tree)
        self.findings: list[Finding] = []
        self._flagged: set[tuple[str, int, int]] = set()

    # -- plumbing --------------------------------------------------------

    def emit(self, rule: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        if (rule, line, col) in self._flagged:
            return
        self._flagged.add((rule, line, col))
        snippet = self.lines[line - 1].strip() if 0 < line <= len(self.lines) else ""
        self.findings.append(
            Finding(rule=rule, path=self.path, line=line, col=col, message=message,
                    snippet=snippet)
        )

    def run(self) -> list[Finding]:
        seen: set[int] = set()
        for root, reason, skip_first in self._device_bodies():
            if id(root) in seen:
                continue
            params = self._params_of(root, skip_first)
            self._walk_device(root, self._tainted(root, params), reason, seen)
        self._check_dtype_literals()
        self._check_set_iteration()
        self._check_step_loops()
        return self.findings

    # -- device-body discovery -------------------------------------------

    def _device_classes(self) -> dict[str, str]:
        """Class name -> "Function" | "Module" for the module's classes that
        derive (directly, or through a class of this module) from
        ``autograd.Function`` or ``nn.Module``."""
        classes = [n for n in ast.walk(self.tree) if isinstance(n, ast.ClassDef)]
        kinds: dict[str, str] = {}
        for _ in range(len(classes) + 1):
            changed = False
            for cls in classes:
                if cls.name in kinds:
                    continue
                for tail in _base_tails(cls, self.imports):
                    kind = ("Function" if tail == "Function" else
                            "Module" if tail == "Module" else kinds.get(tail))
                    if kind is not None:
                        kinds[cls.name] = kind
                        changed = True
                        break
            if not changed:
                break
        return kinds

    def _device_bodies(self) -> list[tuple[ast.AST, str, bool]]:
        """(function node, why it is a device body, whether its first
        parameter is a non-tensor ``ctx``/``self``)."""
        roots: list[tuple[ast.AST, str, bool]] = []
        kinds = self._device_classes()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ClassDef) and node.name in kinds:
                kind = kinds[node.name]
                wanted = {"forward", "backward"} if kind == "Function" else {"forward"}
                for fn in node.body:
                    if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                            and fn.name in wanted:
                        roots.append((fn, f"{kind}.{fn.name}", True))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name in STEP_FUNCTIONS:
                roots.append((node, node.name, False))
        return roots

    @staticmethod
    def _params_of(fn: ast.AST, skip_first: bool = False) -> set[str]:
        """The parameters that may hold tensors: all but ``self`` and an
        autograd Function's ``ctx`` (``skip_first``)."""
        args = fn.args
        positional = list(args.posonlyargs) + list(args.args)
        if skip_first:
            positional = positional[1:]
        names = {a.arg for a in positional + list(args.kwonlyargs)} - {"self"}
        for extra in (args.vararg, args.kwarg):
            if extra is not None:
                names.add(extra.arg)
        return names

    def _tainted(self, fn: ast.AST, params: set[str]) -> set[str]:
        """``params`` plus the locals assigned from an expression over them
        (flow-insensitive, to a fixed point; nested functions excluded)."""
        tainted = set(params)
        assigns = [n for n in self._body_nodes(fn)
                   if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign))]
        for _ in range(len(assigns) + 1):
            changed = False
            for node in assigns:
                value = node.value
                if value is None or not self._dynamic(value, tainted):
                    continue
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for tgt in targets:
                    for n in ast.walk(tgt):
                        if isinstance(n, ast.Name) and n.id not in tainted:
                            tainted.add(n.id)
                            changed = True
            if not changed:
                break
        return tainted

    def _walk_device(self, node: ast.AST, params: set[str], reason: str,
                     seen: set[int]) -> None:
        """Visit a device body; nested functions extend the live tensor
        set (their closures capture the enclosing tensors)."""
        seen.add(id(node))
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                inner = params | self._params_of(child)
                self._walk_device(child, self._tainted(child, inner), reason, seen)
                continue
            self._check_device_node(child, params, reason)
            self._walk_device(child, params, reason, seen)

    # -- dynamic-value analysis ------------------------------------------

    _STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "device", "is_cuda", "requires_grad",
                     "numel", "dim", "stride", "is_contiguous", "data_ptr", "is_floating_point"}
    _STATIC_FNS = {"len", "isinstance", "hasattr", "callable", "getattr", "type", "is_tensor",
                   "is_floating_point"}

    def _dynamic(self, node: ast.AST, params: set[str]) -> bool:
        """Could this expression hold a tensor's value rooted at a tensor
        parameter? Shape/dtype/device accesses, identity/isinstance tests and
        comparisons with strings are static."""
        if isinstance(node, ast.Name):
            return node.id in params
        if isinstance(node, ast.Attribute):
            if node.attr in self._STATIC_ATTRS:
                return False
            return self._dynamic(node.value, params)
        if isinstance(node, ast.Subscript):
            return self._dynamic(node.value, params)
        if isinstance(node, ast.Call):
            fn_path = _dotted(node.func, self.imports)
            if _tail(fn_path) in self._STATIC_FNS:
                return False
            children: list[ast.AST] = list(node.args) + [kw.value for kw in node.keywords]
            if not isinstance(node.func, ast.Name):
                children.append(node.func)
            return any(self._dynamic(c, params) for c in children)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False
            operands = [node.left] + list(node.comparators)
            if any(isinstance(c, ast.Constant) and isinstance(c.value, str) for c in operands):
                return False
            return any(self._dynamic(c, params) for c in operands)
        if isinstance(node, (ast.Constant, ast.Lambda)):
            return False
        return any(self._dynamic(c, params) for c in ast.iter_child_nodes(node))

    # -- rules inside device bodies --------------------------------------

    _SYNC_BUILTINS = {"float", "int", "bool", "complex"}
    _SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
    _NUMPY_ROOTS = {"numpy", "onp"}

    def _check_device_node(self, node: ast.AST, params: set[str], reason: str) -> None:
        if isinstance(node, ast.Call):
            self._check_host_sync(node, params, reason)
            self._check_impurity(node, reason)
        elif isinstance(node, (ast.If, ast.While)):
            if self._dynamic(node.test, params):
                kind = "while" if isinstance(node, ast.While) else "if"
                self.emit(
                    "TX003",
                    node,
                    f"`{kind}` branches on a tensor's value inside `{reason}` — the host "
                    "waits for the card, and a CUDA graph cannot capture the branch",
                )

    def _check_host_sync(self, node: ast.Call, params: set[str], reason: str) -> None:
        func = node.func
        path = _dotted(func, self.imports)
        if (
            isinstance(func, ast.Name)
            and func.id in self._SYNC_BUILTINS
            and node.args
            and self._dynamic(node.args[0], params)
        ):
            self.emit(
                "TX002",
                node,
                f"`{func.id}()` of a tensor inside `{reason}` copies it to the host and "
                "waits for the card",
            )
        elif isinstance(func, ast.Attribute) and func.attr in self._SYNC_METHODS:
            self.emit(
                "TX002",
                node,
                f"`.{func.attr}()` inside `{reason}` is a host sync",
            )
        elif path and (path == "torch.cuda.synchronize" or path.endswith("cuda.synchronize")):
            self.emit(
                "TX002",
                node,
                f"`torch.cuda.synchronize()` inside `{reason}` stalls the host on the card",
            )

    _IMPURE = {
        "time": {"time", "perf_counter", "monotonic", "time_ns", "perf_counter_ns",
                 "monotonic_ns"},
        "random": None,  # any attr of stdlib random
        "secrets": None,
        "uuid": None,
    }
    # np.random members that build or hold an explicit generator
    _NP_GENERATOR = {"default_rng", "Generator", "SeedSequence", "PCG64", "Philox", "MT19937",
                     "SFC64", "BitGenerator", "RandomState"}

    def _check_impurity(self, node: ast.Call, reason: str) -> None:
        path = _dotted(node.func, self.imports)
        if not path:
            return
        parts = path.split(".")
        root, tail = parts[0], parts[-1]
        impure = root in self._IMPURE and (self._IMPURE[root] is None
                                           or tail in self._IMPURE[root])
        # numpy's global RNG (np.random.rand, ...); a Generator's draws are explicit
        impure = impure or (
            root in self._NUMPY_ROOTS and len(parts) >= 3 and parts[1] == "random"
            and parts[2] not in self._NP_GENERATOR
        )
        impure = impure or path.endswith("datetime.now") or path == "os.urandom"
        if impure:
            self.emit(
                "TX004",
                node,
                f"`{path}` inside `{reason}` reads host state: a captured graph would "
                "replay it frozen, and the step does not repeat",
            )

    # -- TX001: dtype-less literal tensors into batches / step calls -----

    _LITERAL_CTORS = {"tensor", "as_tensor", "full", "zeros", "ones", "arange"}

    def _dtypeless_ctor(self, node: ast.AST) -> str | None:
        """The constructor's name when ``node`` is a dtype-less torch
        constructor of Python literals, else None."""
        if not isinstance(node, ast.Call):
            return None
        path = _dotted(node.func, self.imports)
        if not path or path.split(".")[0] != "torch" or _tail(path) not in self._LITERAL_CTORS:
            return None
        if any(k.arg == "dtype" for k in node.keywords):
            return None
        tail = _tail(path)
        if tail in ("tensor", "as_tensor"):
            if not node.args or not self._literal(node.args[0]):
                return None
        elif tail == "full":
            if len(node.args) < 2 or not self._literal(node.args[1]):
                return None
        return tail

    @classmethod
    def _literal(cls, node: ast.AST) -> bool:
        """A numeric Python literal, or a list/tuple of them."""
        if isinstance(node, ast.Constant):
            return isinstance(node.value, (int, float)) and not isinstance(node.value, bool)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, (ast.USub, ast.UAdd)):
            return cls._literal(node.operand)
        if isinstance(node, (ast.List, ast.Tuple)):
            return bool(node.elts) and all(cls._literal(e) for e in node.elts)
        return False

    def _check_dtype_literals(self) -> None:
        for node in ast.walk(self.tree):
            entering: list[tuple[ast.AST, str]] = []
            if isinstance(node, ast.Dict):
                keys = {k.value for k in node.keys
                        if isinstance(k, ast.Constant) and isinstance(k.value, str)}
                if keys & BATCH_KEYS:
                    entering += [(v, "a batch dict") for v in node.values]
            elif isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if (isinstance(tgt, ast.Subscript) and isinstance(tgt.slice, ast.Constant)
                            and tgt.slice.value in BATCH_KEYS):
                        entering.append((node.value, f"batch[{tgt.slice.value!r}]"))
            elif isinstance(node, ast.Call):
                if _tail(_dotted(node.func, self.imports)) in STEP_FUNCTIONS:
                    args = list(node.args) + [k.value for k in node.keywords]
                    for a in args:
                        entering.append((a, "a step call"))
                        if isinstance(a, ast.Dict):
                            entering += [(v, "a step call's batch") for v in a.values]
            for value, where in entering:
                tail = self._dtypeless_ctor(value)
                if tail is not None:
                    self.emit(
                        "TX001",
                        value,
                        f"`torch.{tail}` of Python literals without `dtype` entering {where} "
                        "makes int64 or the default float type, not the pipeline's "
                        "int32/float32 — a new input signature for the step",
                    )

    # -- TX006: set iteration feeding containers -------------------------

    def _is_set_expr(self, node: ast.AST) -> bool:
        if isinstance(node, (ast.Set, ast.SetComp)):
            return True
        if isinstance(node, ast.Call):
            return _tail(_dotted(node.func, self.imports)) in {"set", "frozenset"}
        return False

    def _check_set_iteration(self) -> None:
        for node in ast.walk(self.tree):
            iters: list[ast.AST] = []
            if isinstance(node, ast.For):
                iters.append(node.iter)
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)):
                iters.extend(gen.iter for gen in node.generators)
            for it in iters:
                if self._is_set_expr(it):
                    self.emit(
                        "TX006",
                        it,
                        "iterating a set: order varies across processes (hash "
                        "randomization) — containers or collectives built from it diverge "
                        "across ranks",
                    )

    # -- TX007: per-step host syncs in step loops ------------------------

    def _check_step_loops(self) -> None:
        for node in ast.walk(self.tree):
            if not isinstance(node, (ast.For, ast.While)):
                continue
            body = [n for stmt in node.body for n in self._body_nodes_of_stmts([stmt])]
            is_step_loop = any(
                isinstance(n, ast.Call)
                and _tail(_dotted(n.func, self.imports)) in STEP_FUNCTIONS
                for n in body
            )
            if not is_step_loop:
                continue
            for n in body:
                if not isinstance(n, ast.Call):
                    continue
                func = n.func
                if isinstance(func, ast.Name) and func.id == "float" and n.args:
                    self.emit(
                        "TX007",
                        n,
                        "`float()` in a step loop blocks the host on the card every "
                        "iteration",
                    )
                elif isinstance(func, ast.Attribute) and func.attr == "item":
                    self.emit(
                        "TX007",
                        n,
                        "`.item()` in a step loop blocks the host on the card every "
                        "iteration",
                    )

    @staticmethod
    def _body_nodes(fn: ast.AST) -> Iterable[ast.AST]:
        """Walk a function body without descending into nested functions."""
        return _ModuleLint._body_nodes_of_stmts(list(ast.iter_child_nodes(fn)))

    @staticmethod
    def _body_nodes_of_stmts(stmts: list[ast.AST]) -> Iterable[ast.AST]:
        stack = list(stmts)
        while stack:
            cur = stack.pop()
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            yield cur
            stack.extend(ast.iter_child_nodes(cur))


# --------------------------------------------------------------------------
# file-level driving


def _line_suppresses(line: str, rule: str) -> bool:
    m = _SUPPRESS_RE.search(line)
    if not m:
        return False
    ids = m.group("ids")
    return ids is None or rule in {s.strip().upper() for s in ids.split(",")}


def _apply_suppressions(findings: list[Finding], lines: list[str]) -> None:
    for f in findings:
        if 0 < f.line <= len(lines) and _line_suppresses(lines[f.line - 1], f.rule):
            f.suppressed = True


def lint_source(source: str, rel_path: str, tree: ast.Module | None = None) -> list[Finding]:
    """Lint one file's source; returns findings with inline suppressions
    applied (suppressed findings are kept, marked). Pass ``tree`` to reuse
    an already-parsed AST (the CLI parses each file once for every layer)."""
    lines = source.splitlines()
    try:
        if tree is None:
            tree = ast.parse(source, filename=rel_path)
    except SyntaxError as exc:
        # the message doubles as the snippet so each distinct syntax error
        # fingerprints separately (a baselined one can't mask the next)
        return [
            Finding(
                rule="TX000",
                path=rel_path,
                line=exc.lineno or 1,
                col=exc.offset or 0,
                message=f"file does not parse: {exc.msg}",
                snippet=str(exc.msg or ""),
            )
        ]
    findings = _ModuleLint(tree, rel_path, lines).run()
    _apply_suppressions(findings, lines)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def iter_py_files(paths: Iterable[Path]) -> list[Path]:
    out: list[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            out.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            out.append(p)
    seen: set[Path] = set()
    uniq = []
    for p in out:
        rp = p.resolve()
        if rp not in seen:
            seen.add(rp)
            uniq.append(p)
    return uniq


def relative(file: Path, root: Path) -> str:
    """``file`` relative to ``root`` (posix), or as given when outside it."""
    try:
        return file.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        return file.as_posix()


def lint_paths(paths: Iterable[Path], root: Path | None = None) -> list[Finding]:
    """Lint every ``.py`` under ``paths``; finding paths are relative to
    ``root`` (posix) so fingerprints are machine-independent."""
    root = Path(root) if root is not None else Path.cwd()
    findings: list[Finding] = []
    for file in iter_py_files(paths):
        findings.extend(lint_source(file.read_text(), relative(file, root)))
    return findings


# --------------------------------------------------------------------------
# baseline


def load_baseline(path: Path) -> dict[str, int]:
    """fingerprint -> allowed occurrence count; empty when absent."""
    path = Path(path)
    if not path.exists():
        return {}
    data = json.loads(path.read_text())
    return {str(k): int(v) for k, v in data.get("fingerprints", {}).items()}


def write_baseline(findings: list[Finding], path: Path) -> None:
    counts: dict[str, int] = {}
    for f in findings:
        if f.suppressed:
            continue
        fp = fingerprint(f)
        counts[fp] = counts.get(fp, 0) + 1
    Path(path).write_text(
        json.dumps({"version": 1, "tool": TOOL, "fingerprints": dict(sorted(counts.items()))},
                   indent=2)
        + "\n"
    )


def apply_baseline(findings: list[Finding], baseline: dict[str, int]) -> None:
    """Mark the first N occurrences of each baselined fingerprint; anything
    beyond the recorded count stays a NEW finding."""
    remaining = dict(baseline)
    for f in findings:
        if f.suppressed:
            continue
        fp = fingerprint(f)
        if remaining.get(fp, 0) > 0:
            remaining[fp] -= 1
            f.baselined = True
