"""Concurrency lint: the CX rule family on the torchlint engine.

Counterpart of ``code2vec_tpu/analysis/concurrency.py``, over the port's
paths. The serving and training stacks are lock-based concurrent code
(batcher, router, swap controller, result cache, replica pipes, checkpoint
writer, fork-based feed pool); this pass machine-checks the five shapes of
bug such code keeps growing, riding the same AST / fingerprint /
inline-suppression / baseline machinery as the TX/SC rules:

- **CX001 unguarded-shared-state** (warning): an attribute written from a
  thread-entry callable (``Thread(target=self.m)``, ``executor.submit(
  self.m)``) and also read/written in a public method outside any
  ``with self.<lock>`` region, in a class that owns locks. Attributes
  typed as thread-safe primitives (``Event``/``Queue``/``deque``/locks)
  are exempt.
- **CX002 lock-order-cycle** (error): the repo-wide lock acquisition
  graph — built from nested ``with``-lock regions plus cross-class edges
  through ``self.<attr>.<method>()`` calls whose target class acquires
  its own lock — contains a cycle: two code paths can acquire the same
  locks in opposite orders, i.e. a potential deadlock. Reentrant
  re-acquisition of an ``RLock`` is not an edge.
- **CX003 blocking-call-under-lock** (warning): ``time.sleep``, future
  ``.result()``, blocking ``queue.get/put``, pipe/socket I/O,
  ``subprocess`` waits, ``Thread.join``, and device syncs (``.item()``,
  ``torch.cuda.synchronize()``, an event's or stream's ``.synchronize()``)
  inside a held-lock region: every other thread waits a full device round
  trip.
- **CX004 condition-wait-no-predicate** (error): ``Condition.wait()``
  outside a ``while``-predicate loop and without a timeout — spurious
  wakeups and missed notifies make that a hang.
- **CX005 fork-after-threads** (error): requesting the ``fork``
  start-method (``multiprocessing.get_context("fork")`` /
  ``set_start_method("fork")``) without a ``guard_fork_safety`` call
  (``code2vec_tpu_torch/obs/sync.py``) in the same scope — a forked child
  inherits any lock a live thread holds, permanently frozen.

The per-file rules run in :func:`check_source`; CX002 is inherently
repo-wide, so each file contributes a :class:`ModuleFragment` (class lock
tables, per-method acquisition summaries, edge events) and
:func:`finalize` joins them, resolves cross-class calls, and reports
cycles. Findings carry the standard fingerprint and honor inline
``# torchlint: disable=CXnnn`` comments; a CX002 cycle is suppressed when
any edge line participating in the cycle carries one.

Everything here is heuristic over-approximation tuned to this codebase's
idioms (locks live in ``self.<attr>``; regions are ``with`` blocks);
manual ``.acquire()``/``.release()`` pairs and locks passed between
objects are out of scope by design — a lint pass earns its keep by being
quiet when it is unsure.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterable

from code2vec_tpu_torch.analysis import torchlint
from code2vec_tpu_torch.analysis.torchlint import (
    Finding,
    Rule,
    _collect_imports,
    _dotted,
    _line_suppresses,
    _tail,
)

__all__ = [
    "CX_RULES",
    "ModuleFragment",
    "check_source",
    "finalize",
    "lint_concurrency",
]

CX_RULES: tuple[Rule, ...] = (
    Rule(
        "CX001",
        "unguarded-shared-state",
        "warning",
        "attribute shared between a thread-entry method and a public "
        "method without the class's lock",
        "guard both sides with the owning lock (`with self._lock:`), or "
        "switch the attribute to a thread-safe primitive "
        "(Event/Queue/deque)",
    ),
    Rule(
        "CX002",
        "lock-order-cycle",
        "error",
        "two code paths acquire the same locks in opposite orders "
        "(potential deadlock)",
        "pick one global acquisition order and restructure the later "
        "acquisition out of the held region (snapshot under one lock, "
        "call out after releasing)",
    ),
    Rule(
        "CX003",
        "blocking-call-under-lock",
        "warning",
        "blocking call (sleep/result/queue/pipe/subprocess/device) "
        "inside a held-lock region",
        "move the blocking call outside the `with` block — snapshot the "
        "state you need under the lock, block after releasing it",
    ),
    Rule(
        "CX004",
        "condition-wait-no-predicate",
        "error",
        "Condition.wait() without a predicate loop or timeout",
        "wrap the wait in `while not <predicate>:` (spurious wakeups are "
        "allowed by the memory model) or pass a timeout",
    ),
    Rule(
        "CX005",
        "fork-after-threads",
        "error",
        "fork start-method requested without a fork-safety guard",
        "call code2vec_tpu_torch.obs.sync.guard_fork_safety(...) immediately "
        "before requesting the fork context — forked children inherit "
        "locks held by live threads, permanently frozen",
    ),
)

# register into the shared rule table so Finding.severity/.hint resolve and
# `--list-rules` shows the family
torchlint.RULES.update({r.id: r for r in CX_RULES})


# ---------------------------------------------------------------------------
# per-class model
# ---------------------------------------------------------------------------

# ctor tails -> internal type tags; anything tagged here is considered
# thread-safe enough to exempt from CX001 (and types CX003 receivers)
_CTOR_TYPES = {
    "Lock": "lock",
    "RLock": "rlock",
    "Condition": "condition",
    "make_lock": "lock",
    "make_rlock": "rlock",
    "make_condition": "condition",
    "Semaphore": "sync",
    "BoundedSemaphore": "sync",
    "Barrier": "sync",
    "Event": "event",
    "Queue": "queue",
    "LifoQueue": "queue",
    "PriorityQueue": "queue",
    "SimpleQueue": "queue",
    "deque": "deque",
    "defaultdict": "plain",
    "OrderedDict": "plain",
    "Thread": "thread",
    "Popen": "popen",
}

_LOCK_KINDS = {"lock", "rlock", "condition"}
_SAFE_TYPES = _LOCK_KINDS | {"sync", "event", "queue", "deque", "thread", "popen"}

_PIPE_ATTRS = {"stdin", "stdout", "stderr"}
_PIPE_METHODS = {"write", "flush", "read", "readline", "readlines"}
_SOCKET_METHODS = {"recv", "recv_into", "accept", "sendall", "connect"}
_SUBPROCESS_WAITS = {"run", "call", "check_call", "check_output"}


@dataclasses.dataclass
class EdgeEvent:
    """One potential acquisition-order edge source, recorded inside a
    held-lock region: either a directly nested ``with self.<lock>`` or a
    call that may acquire locks (resolved in :func:`finalize`)."""

    cls: str
    held: str  # own lock attr currently held (the edge source)
    kind: str  # "lock" | "selfcall" | "attrcall"
    target: str  # lock attr (kind=lock) or method name (calls)
    attr: str | None  # for attrcall: the self-attribute being called through
    path: str
    line: int
    snippet: str
    suppressed: bool


@dataclasses.dataclass
class ClassSummary:
    name: str
    path: str
    locks: dict[str, str]  # lock attr -> "lock" | "rlock" | "condition"
    attr_class: dict[str, str]  # attr -> candidate class name (ctor tail)
    method_acquires: dict[str, set[str]]  # method -> own lock attrs acquired
    method_calls: dict[str, set[tuple]]  # method -> {("self", m) | ("attr", a, m)}
    edge_events: list[EdgeEvent]


@dataclasses.dataclass
class ModuleFragment:
    """Everything CX002 needs from one file (the rest of the rules report
    inside :func:`check_source` directly)."""

    path: str
    classes: dict[str, ClassSummary]


# ---------------------------------------------------------------------------
# the per-class scanner
# ---------------------------------------------------------------------------


class _ClassScan:
    def __init__(self, mod: "_ModuleScan", node: ast.ClassDef) -> None:
        self.mod = mod
        self.node = node
        self.name = node.name
        self.methods: dict[str, ast.FunctionDef] = {
            n.name: n
            for n in node.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        self.locks: dict[str, str] = {}
        self.attr_types: dict[str, str] = {}
        self.attr_class: dict[str, str] = {}
        self.entry_methods: set[str] = set()
        self.method_acquires: dict[str, set[str]] = {}
        self.method_calls: dict[str, set[tuple]] = {}
        self.edge_events: list[EdgeEvent] = []
        # (method, attr, unguarded, is_write, node), in source order
        self.accesses: list[tuple[str, str, bool, bool, ast.AST]] = []

    # -- pass 1: attribute typing + thread entries -----------------------

    def collect_types(self) -> None:
        for fn in self.methods.values():
            ann = {
                a.arg: self._ann_tail(a.annotation)
                for a in (
                    list(fn.args.posonlyargs)
                    + list(fn.args.args)
                    + list(fn.args.kwonlyargs)
                )
                if a.annotation is not None
            }
            for sub in ast.walk(fn):
                if not isinstance(sub, ast.Assign):
                    continue
                for tgt in sub.targets:
                    if not (
                        isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"
                    ):
                        continue
                    self._type_attr(tgt.attr, sub.value, ann)
        for sub in ast.walk(self.node):
            if not isinstance(sub, ast.Call):
                continue
            entry = self._entry_target(sub)
            if entry is not None and entry in self.methods:
                self.entry_methods.add(entry)

    def _ann_tail(self, annotation: ast.AST) -> str:
        """Annotation -> class-name tail; quoted forward references
        (``b: "FleetRouter"``) arrive as string constants."""
        if isinstance(annotation, ast.Constant) and isinstance(
            annotation.value, str
        ):
            return annotation.value.strip("'\" ").rsplit(".", 1)[-1]
        return _tail(_dotted(annotation, self.mod.imports))

    def _type_attr(self, attr: str, value: ast.AST, ann: dict) -> None:
        if isinstance(value, ast.Call):
            tail = _tail(_dotted(value.func, self.mod.imports))
            tag = _CTOR_TYPES.get(tail)
            if tag in _LOCK_KINDS:
                self.locks[attr] = tag
                self.attr_types[attr] = tag
            elif tag is not None:
                self.attr_types.setdefault(attr, tag)
            elif tail and tail[:1].isupper():
                # candidate class instance — resolved against the global
                # class table in finalize() for cross-class lock edges
                self.attr_class.setdefault(attr, tail)
        elif isinstance(value, ast.Name) and value.id in ann:
            tail = ann[value.id]
            if tail and tail[:1].isupper():
                self.attr_class.setdefault(attr, tail)

    def _entry_target(self, call: ast.Call) -> str | None:
        """Method name when this call registers a thread entry:
        ``Thread(target=self.m)`` or ``<executor>.submit(self.m, ...)``."""
        tail = _tail(_dotted(call.func, self.mod.imports))
        if tail == "Thread":
            for kw in call.keywords:
                if (
                    kw.arg == "target"
                    and isinstance(kw.value, ast.Attribute)
                    and isinstance(kw.value.value, ast.Name)
                    and kw.value.value.id == "self"
                ):
                    return kw.value.attr
        if (
            isinstance(call.func, ast.Attribute)
            and call.func.attr == "submit"
            and call.args
            and isinstance(call.args[0], ast.Attribute)
            and isinstance(call.args[0].value, ast.Name)
            and call.args[0].value.id == "self"
        ):
            return call.args[0].attr
        return None

    # -- pass 2: held-region walk ----------------------------------------

    def scan_methods(self) -> None:
        for name, fn in self.methods.items():
            self.method_acquires[name] = set()
            self.method_calls[name] = set()
            for stmt in fn.body:
                self._walk(stmt, held=[], fn=name, in_while=False)

    def _self_lock_attr(self, expr: ast.AST) -> str | None:
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and expr.attr in self.locks
        ):
            return expr.attr
        return None

    def _edge(self, held: str, kind: str, target: str, attr, node) -> None:
        line = getattr(node, "lineno", 1)
        snippet = self.mod.line(line)
        self.edge_events.append(
            EdgeEvent(
                cls=self.name,
                held=held,
                kind=kind,
                target=target,
                attr=attr,
                path=self.mod.path,
                line=line,
                snippet=snippet,
                suppressed=_line_suppresses(snippet, "CX002"),
            )
        )

    def _walk(self, node: ast.AST, held: list, fn: str, in_while: bool) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return  # closures run on their own schedule; held doesn't transfer
        if isinstance(node, ast.With):
            acquired = []
            for item in node.items:
                attr = self._self_lock_attr(item.context_expr)
                if attr is not None:
                    self.method_acquires[fn].add(attr)
                    for h in held:
                        self._edge(h, "lock", attr, None, item.context_expr)
                    held.append(attr)
                    acquired.append(attr)
                else:
                    self._walk(item.context_expr, held, fn, in_while)
            for child in node.body:
                self._walk(child, held, fn, in_while)
            for _ in acquired:
                held.pop()
            return
        if isinstance(node, ast.While):
            self._walk(node.test, held, fn, True)
            for child in node.body + node.orelse:
                self._walk(child, held, fn, True)
            return
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            for tgt in targets:
                for sub in ast.walk(tgt):
                    if (
                        isinstance(sub, ast.Attribute)
                        and isinstance(sub.value, ast.Name)
                        and sub.value.id == "self"
                    ):
                        self.accesses.append(
                            (fn, sub.attr, not held, True, sub)
                        )
        if isinstance(node, ast.Call):
            self._check_call(node, held, fn, in_while)
        if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
            if node.value.id == "self" and isinstance(node.ctx, ast.Load):
                self.accesses.append((fn, node.attr, not held, False, node))
        for child in ast.iter_child_nodes(node):
            self._walk(child, held, fn, in_while)

    # -- call classification (CX002 events, CX003, CX004) ----------------

    def _check_call(
        self, node: ast.Call, held: list, fn: str, in_while: bool
    ) -> None:
        func = node.func
        # self.m(...)
        if (
            isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name)
            and func.value.id == "self"
        ):
            self.method_calls[fn].add(("self", func.attr))
            for h in held:
                self._edge(h, "selfcall", func.attr, None, node)
        # self.<attr>.m(...)
        elif (
            isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Attribute)
            and isinstance(func.value.value, ast.Name)
            and func.value.value.id == "self"
        ):
            attr, meth = func.value.attr, func.attr
            atype = self.attr_types.get(attr)
            if attr in self.attr_class:
                self.method_calls[fn].add(("attr", attr, meth))
                for h in held:
                    self._edge(h, "attrcall", meth, attr, node)
            if atype == "condition" and meth == "wait":
                self._check_condition_wait(node, in_while)
            elif held and atype == "queue" and meth in {"get", "put"}:
                self.mod.emit(
                    "CX003",
                    node,
                    f"blocking `{attr}.{meth}()` while holding "
                    f"`self.{held[-1]}` — the lock is held for the full "
                    "wait (use the _nowait variant or move it out)",
                )
            elif held and atype == "popen" and meth in {"wait", "communicate"}:
                self.mod.emit(
                    "CX003",
                    node,
                    f"subprocess `{meth}()` while holding `self.{held[-1]}` "
                    "waits on another process under the lock",
                )
            elif held and atype == "thread" and meth == "join":
                self.mod.emit(
                    "CX003",
                    node,
                    f"`{attr}.join()` while holding `self.{held[-1]}` — if "
                    "the joined thread needs the lock, this deadlocks",
                )
        if not isinstance(func, ast.Attribute) and not isinstance(
            func, ast.Name
        ):
            return
        if held:
            self._check_blocking(node, held)

    def _check_condition_wait(self, node: ast.Call, in_while: bool) -> None:
        has_timeout = bool(node.args) or any(
            kw.arg == "timeout" for kw in node.keywords
        )
        if in_while or has_timeout:
            return
        self.mod.emit(
            "CX004",
            node,
            "`Condition.wait()` outside a while-predicate loop and without "
            "a timeout — a spurious wakeup or missed notify hangs here",
        )

    def _check_blocking(self, node: ast.Call, held: list) -> None:
        func = node.func
        path = _dotted(func, self.mod.imports)
        tail = _tail(path)
        lock = held[-1]
        root = path.split(".")[0] if path else ""
        if path == "time.sleep":
            self.mod.emit(
                "CX003",
                node,
                f"`time.sleep` while holding `self.{lock}` stalls every "
                "other thread waiting on the lock",
            )
        elif root == "subprocess" and tail in _SUBPROCESS_WAITS:
            self.mod.emit(
                "CX003",
                node,
                f"`subprocess.{tail}` while holding `self.{lock}` waits on "
                "another process under the lock",
            )
        elif isinstance(func, ast.Attribute) and func.attr in {"item", "synchronize"}:
            self.mod.emit(
                "CX003",
                node,
                f"device sync `{tail}` while holding `self.{lock}` holds "
                "the lock for a full device round-trip",
            )
        elif isinstance(func, ast.Attribute) and func.attr == "result":
            self.mod.emit(
                "CX003",
                node,
                f"`.result()` while holding `self.{lock}` — if resolving "
                "the future needs the lock, this deadlocks",
            )
        elif isinstance(func, ast.Attribute) and (
            func.attr in _SOCKET_METHODS
            or (
                func.attr in _PIPE_METHODS
                and any(
                    isinstance(part, ast.Attribute) and part.attr in _PIPE_ATTRS
                    for part in ast.walk(func.value)
                )
            )
        ):
            self.mod.emit(
                "CX003",
                node,
                f"pipe/socket `{func.attr}` while holding `self.{lock}` can "
                "block on a slow/stalled peer with the lock held",
            )

    # -- CX001 ------------------------------------------------------------

    def report_unguarded(self) -> None:
        if not self.locks:
            return  # not a lock-owning class: no locking discipline to check
        reachable = self._entry_closure()
        written_by: dict[str, str] = {}
        for fn, attr, _unguarded, is_write, _node in self.accesses:
            if fn in reachable and fn != "__init__" and is_write:
                written_by.setdefault(attr, fn)
        if not written_by:
            return
        flagged: set[str] = set()
        for fn, attr, unguarded, _is_write, node in self.accesses:
            if (
                attr not in written_by
                or attr in flagged
                or not unguarded
                or fn in reachable
                or fn.startswith("_")
                or fn == written_by[attr]
                or attr in self.locks
                or self.attr_types.get(attr) in _SAFE_TYPES
                or attr in self.attr_class
                or attr in self.methods
            ):
                continue
            flagged.add(attr)
            self.mod.emit(
                "CX001",
                node,
                f"`self.{attr}` is written by thread-entry method "
                f"`{written_by[attr]}` but accessed in public `{fn}` "
                f"outside any `with self.<lock>` region of {self.name}",
            )

    def _entry_closure(self) -> set[str]:
        reach = set(self.entry_methods)
        frontier = list(reach)
        while frontier:
            m = frontier.pop()
            for call in self.method_calls.get(m, ()):
                if call[0] == "self" and call[1] in self.methods:
                    if call[1] not in reach:
                        reach.add(call[1])
                        frontier.append(call[1])
        return reach

    def summary(self) -> ClassSummary:
        return ClassSummary(
            name=self.name,
            path=self.mod.path,
            locks=dict(self.locks),
            attr_class=dict(self.attr_class),
            method_acquires={
                k: set(v) for k, v in self.method_acquires.items()
            },
            method_calls={k: set(v) for k, v in self.method_calls.items()},
            edge_events=list(self.edge_events),
        )


# ---------------------------------------------------------------------------
# the per-module scanner
# ---------------------------------------------------------------------------


class _ModuleScan:
    def __init__(self, tree: ast.Module, rel_path: str, lines: list[str]):
        self.tree = tree
        self.path = rel_path
        self.lines = lines
        self.imports = _collect_imports(tree)
        self.findings: list[Finding] = []
        self._flagged: set[tuple[str, int, int]] = set()

    def line(self, lineno: int) -> str:
        if 0 < lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def emit(self, rule: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        if (rule, line, col) in self._flagged:
            return
        self._flagged.add((rule, line, col))
        self.findings.append(
            Finding(
                rule=rule,
                path=self.path,
                line=line,
                col=col,
                message=message,
                snippet=self.line(line),
            )
        )

    def run(self) -> ModuleFragment:
        classes: dict[str, ClassSummary] = {}
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            scan = _ClassScan(self, node)
            scan.collect_types()
            scan.scan_methods()
            scan.report_unguarded()
            classes.setdefault(node.name, scan.summary())
        self._check_fork(self.tree)
        return ModuleFragment(path=self.path, classes=classes)

    # -- CX005 ------------------------------------------------------------

    def _check_fork(self, tree: ast.Module) -> None:
        # scope -> (fork-request nodes, has guard_fork_safety call)
        self._fork_scope(tree)

    def _fork_scope(self, scope: ast.AST) -> None:
        forks: list[ast.Call] = []
        guarded = False
        for node in self._scope_nodes(scope):
            if not isinstance(node, ast.Call):
                continue
            tail = _tail(_dotted(node.func, self.imports))
            if tail == "guard_fork_safety":
                guarded = True
            elif tail in {"get_context", "set_start_method"}:
                arg = node.args[0] if node.args else next(
                    (kw.value for kw in node.keywords if kw.arg == "method"),
                    None,
                )
                if isinstance(arg, ast.Constant) and arg.value == "fork":
                    forks.append(node)
        if not guarded:
            for node in forks:
                self.emit(
                    "CX005",
                    node,
                    "`fork` start-method requested without a "
                    "guard_fork_safety(...) call in the same scope — forked "
                    "children inherit locks held by live threads",
                )
        for node in ast.walk(scope):
            if node is not scope and isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                self._fork_scope(node)

    @staticmethod
    def _scope_nodes(scope: ast.AST) -> Iterable[ast.AST]:
        stack = list(ast.iter_child_nodes(scope))
        while stack:
            cur = stack.pop()
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # nested scopes get their own guard check
            yield cur
            stack.extend(ast.iter_child_nodes(cur))


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def check_source(
    source: str, rel_path: str, tree: ast.Module | None = None
) -> tuple[list[Finding], ModuleFragment]:
    """Run the per-file CX rules (CX001/CX003/CX004/CX005) on one module;
    returns (findings with inline suppressions applied, the module's CX002
    fragment for :func:`finalize`). Unparseable files yield nothing —
    torchlint's TX000 already reports those."""
    lines = source.splitlines()
    if tree is None:
        try:
            tree = ast.parse(source, filename=rel_path)
        except SyntaxError:
            return [], ModuleFragment(path=rel_path, classes={})
    scan = _ModuleScan(tree, rel_path, lines)
    fragment = scan.run()
    findings = scan.findings
    torchlint._apply_suppressions(findings, lines)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings, fragment


def _lock_reach(
    classes: dict[str, ClassSummary]
) -> dict[tuple[str, str], set[str]]:
    """Fixpoint of (class, method) -> qualified locks it may acquire,
    through self-calls and cross-class self-attribute calls."""
    reach: dict[tuple[str, str], set[str]] = {}
    for cls in classes.values():
        for method, acquires in cls.method_acquires.items():
            reach[(cls.name, method)] = {
                f"{cls.name}.{a}" for a in acquires
            }
    for _ in range(len(reach) + 1):
        changed = False
        for cls in classes.values():
            for method, calls in cls.method_calls.items():
                mine = reach.setdefault((cls.name, method), set())
                before = len(mine)
                for call in calls:
                    if call[0] == "self":
                        mine |= reach.get((cls.name, call[1]), set())
                    else:
                        target = cls.attr_class.get(call[1])
                        if target in classes:
                            mine |= reach.get((target, call[2]), set())
                changed = changed or len(mine) != before
        if not changed:
            break
    return reach


def finalize(fragments: Iterable[ModuleFragment]) -> list[Finding]:
    """Join every module's fragments into the repo-wide acquisition graph
    and report CX002 cycles. A cycle finding anchors at its first edge
    (path, line order) and is suppressed when ANY edge line in the cycle
    carries a CX002 suppression (one documented annotation per cycle)."""
    classes: dict[str, ClassSummary] = {}
    for frag in fragments:
        for name, summary in frag.classes.items():
            classes.setdefault(name, summary)
    reach = _lock_reach(classes)
    lock_kind = {
        f"{c.name}.{attr}": kind
        for c in classes.values()
        for attr, kind in c.locks.items()
    }
    # (src, dst) -> representative EdgeEvent (first seen in path/line order)
    edges: dict[tuple[str, str], EdgeEvent] = {}
    events = sorted(
        (ev for c in classes.values() for ev in c.edge_events),
        key=lambda e: (e.path, e.line),
    )
    for ev in events:
        src = f"{ev.cls}.{ev.held}"
        if ev.kind == "lock":
            dsts = {f"{ev.cls}.{ev.target}"}
        elif ev.kind == "selfcall":
            dsts = reach.get((ev.cls, ev.target), set())
        else:
            target = classes.get(ev.cls)
            tcls = target.attr_class.get(ev.attr) if target else None
            dsts = reach.get((tcls, ev.target), set()) if tcls else set()
        for dst in dsts:
            if dst == src and lock_kind.get(src) == "rlock":
                continue  # reentrant re-acquire: not an edge
            edges.setdefault((src, dst), ev)

    adjacency: dict[str, set[str]] = {}
    for src, dst in edges:
        adjacency.setdefault(src, set()).add(dst)
        adjacency.setdefault(dst, set())
    findings: list[Finding] = []
    for component in _sccs(adjacency):
        cyclic = len(component) > 1 or any(
            (n, n) in edges for n in component
        )
        if not cyclic:
            continue
        member_edges = sorted(
            (
                ev
                for (src, dst), ev in edges.items()
                if src in component and dst in component
            ),
            key=lambda e: (e.path, e.line),
        )
        if not member_edges:  # pragma: no cover - SCC implies edges
            continue
        anchor = member_edges[0]
        order = " -> ".join(sorted(component) + [sorted(component)[0]])
        finding = Finding(
            rule="CX002",
            path=anchor.path,
            line=anchor.line,
            col=0,
            message=(
                f"lock acquisition cycle {order}: two code paths can take "
                "these locks in opposite orders (potential deadlock); "
                "edges at "
                + ", ".join(f"{e.path}:{e.line}" for e in member_edges[:6])
            ),
            snippet=anchor.snippet,
            suppressed=any(e.suppressed for e in member_edges),
        )
        findings.append(finding)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def _sccs(adjacency: dict[str, set[str]]) -> list[set[str]]:
    """Tarjan's strongly-connected components, iterative."""
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    out: list[set[str]] = []
    counter = [0]

    for root in adjacency:
        if root in index:
            continue
        work: list[tuple[str, Iterable]] = [(root, iter(adjacency[root]))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for nxt in it:
                if nxt not in index:
                    index[nxt] = low[nxt] = counter[0]
                    counter[0] += 1
                    stack.append(nxt)
                    on_stack.add(nxt)
                    work.append((nxt, iter(adjacency[nxt])))
                    advanced = True
                    break
                if nxt in on_stack:
                    low[node] = min(low[node], index[nxt])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                component: set[str] = set()
                while True:
                    member = stack.pop()
                    on_stack.discard(member)
                    component.add(member)
                    if member == node:
                        break
                out.append(component)
    return out


def lint_concurrency(source: str, rel_path: str = "mod.py") -> list[Finding]:
    """Single-module convenience (fixture tests): per-file rules plus a
    one-module CX002 pass, suppressions applied, sorted."""
    findings, fragment = check_source(source, rel_path)
    findings = findings + finalize([fragment])
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings
