"""Resource-lifecycle lint: the RS rule family (static half of the analyzer).

Counterpart of ``code2vec_tpu/analysis/lifecycle.py``, over the port's
paths. Rides the torchlint engine exactly like the CX concurrency rules:
same :class:`~code2vec_tpu_torch.analysis.torchlint.Finding` shape, same
``# torchlint: disable=RSnnn`` inline suppressions, same fingerprint and
baseline semantics, shipped through ``python -m
code2vec_tpu_torch.analysis``. The runtime twin is the handle ledger in
:mod:`code2vec_tpu_torch.obs.handles` — the rules
catch leak *shapes* at lint time, the ledger catches leaked *instances* at
run time, and both speak the same vocabulary of lifecycle owners.

Rules:

- **RS001 unclosed-resource** — a file / mmap / socket / SharedMemory bound
  to a local that is neither a ``with`` target nor closed anywhere in its
  scope. Escapes (returned, yielded, passed to a call, stored into a
  container/attribute) transfer ownership and silence the rule.
- **RS002 unjoined-thread** — a non-daemon ``threading.Thread`` stored on
  ``self`` and ``start()``-ed, where no ``join()`` on that attribute is
  reachable from any close-like method (``close``/``shutdown``/``stop``/
  ``__exit__``/...) via the class's own self-call graph.
- **RS003 unreaped-subprocess** — a ``subprocess.Popen`` (local or
  attribute) with no ``wait``/``communicate``/``terminate``/``kill`` on any
  path that can see it — a zombie on every exit path.
- **RS004 unremoved-tempfile** — ``tempfile.mkdtemp`` /
  ``NamedTemporaryFile(delete=False)`` whose result neither reaches a
  recorded cleanup (``shutil.rmtree``/``os.unlink``/``atexit.register``/
  fixture finalizers) nor leaves the scope as an owned value.
- **RS005 leaky-owner-class** — a class that acquires closeable resources
  in ``__init__``/``__post_init__`` but defines no close-like method at
  all, or whose close closure provably never touches a tracked attribute.
  Resolved in a repo-wide :func:`finalize` pass joining per-file class
  fragments (same shape as CX002), so owning an instance of another
  closeable class counts as a tracked resource.
- **RS006 unshutdown-executor** — a ``ThreadPoolExecutor`` /
  ``ProcessPoolExecutor`` / ``multiprocessing.Pool`` / ``mp.Queue``
  created without a shutdown call.

All rules over-approximate toward *silence*: anything that escapes its
scope, is managed by ``with``/``contextlib.closing``/``enter_context``, or
is daemonized is assumed intentional. The point is catching the
unambiguous shapes cheaply, not proving lifetimes.
"""

from __future__ import annotations

import ast
import dataclasses

from code2vec_tpu_torch.analysis import torchlint
from code2vec_tpu_torch.analysis.torchlint import (
    Finding,
    Rule,
    _collect_imports,
    _dotted,
    _line_suppresses,
    _tail,
)

RS_RULES: tuple[Rule, ...] = (
    Rule(
        "RS001",
        "unclosed-resource",
        "warning",
        "file/mmap/socket/SharedMemory opened outside `with` and never closed",
        "wrap in `with` (or contextlib.closing) or close in try/finally",
    ),
    Rule(
        "RS002",
        "unjoined-thread",
        "warning",
        "non-daemon thread started with no join reachable from close()",
        "join the thread from close()/shutdown(), or make it a daemon",
    ),
    Rule(
        "RS003",
        "unreaped-subprocess",
        "warning",
        "subprocess.Popen never waited/terminated — a zombie on exit paths",
        "call wait()/communicate() (or terminate()+wait()) on every path",
    ),
    Rule(
        "RS004",
        "unremoved-tempfile",
        "warning",
        "mkdtemp/NamedTemporaryFile(delete=False) without recorded cleanup",
        "register shutil.rmtree/os.unlink via try/finally, atexit, or a "
        "fixture finalizer",
    ),
    Rule(
        "RS005",
        "leaky-owner-class",
        "warning",
        "class acquires closeable resources in __init__ but close() is "
        "missing or provably incomplete",
        "define close()/__exit__ releasing every tracked attribute",
    ),
    Rule(
        "RS006",
        "unshutdown-executor",
        "warning",
        "executor/pool/mp.Queue created without a shutdown call",
        "use `with`, or call shutdown()/close()+join_thread() when done",
    ),
)

torchlint.RULES.update({r.id: r for r in RS_RULES})


# ---------------------------------------------------------------------------
# resource classification
# ---------------------------------------------------------------------------

# explicit builtin/stdlib `open` spellings only — a bare tail match on
# "open" would hit every `x.open()` method in the repo
_OPEN_PATHS = {"open", "io.open", "gzip.open", "bz2.open", "lzma.open"}

_CLOSE_BY_KIND = {
    "file": {"close"},
    "mmap": {"close"},
    "socket": {"close", "shutdown", "detach"},
    "shm": {"close", "unlink"},
    "popen": {"wait", "communicate", "terminate", "kill"},
    "thread": {"join"},
    "executor": {"shutdown", "close", "terminate", "join"},
    "mpqueue": {"close", "join_thread", "shutdown"},
}

_RULE_BY_KIND = {
    "file": "RS001",
    "mmap": "RS001",
    "socket": "RS001",
    "shm": "RS001",
    "popen": "RS003",
    "thread": "RS002",
    "executor": "RS006",
    "mpqueue": "RS006",
}

# close-like entry points for the RS002/RS005 reachability closure
_CLOSE_ENTRY = {
    "close",
    "shutdown",
    "stop",
    "terminate",
    "join",
    "release",
    "kill",
    "aclose",
    "__exit__",
    "__del__",
}

# a call with one of these tails counts as "cleanup was recorded" for RS004
_CLEANUP_TAILS = {
    "rmtree",
    "rmdir",
    "remove",
    "unlink",
    "cleanup",
    "register",
    "addfinalizer",
    "addCleanup",
    "finalize",
}

# calls that adopt their Call arguments into managed lifetimes
_ADOPTING_TAILS = {"closing", "enter_context", "callback", "push"}


def _kw_const(call: ast.Call, name: str):
    for kw in call.keywords:
        if kw.arg == name and isinstance(kw.value, ast.Constant):
            return kw.value.value
    return None


def _resource_kind(call: ast.Call, imports: dict[str, str]) -> str | None:
    """Classify a Call as a resource acquisition, or None. Thread ctors
    with ``daemon=True`` and ``NamedTemporaryFile`` in its auto-delete
    default are deliberately NOT resources here (RS004 handles the
    ``delete=False`` form separately)."""
    path = _dotted(call.func, imports)
    if not path:
        return None
    tail = _tail(path)
    root = path.split(".", 1)[0]
    if path in _OPEN_PATHS:
        return "file"
    if tail == "open_memmap" or (tail == "memmap" and path != tail):
        return "mmap"
    if path == "mmap.mmap":
        return "mmap"
    if root == "socket" and tail in {
        "socket",
        "socketpair",
        "create_connection",
    }:
        return "socket"
    if tail == "SharedMemory":
        return "shm"
    if tail == "Popen":
        return "popen"
    if tail in {"ThreadPoolExecutor", "ProcessPoolExecutor"}:
        return "executor"
    if tail == "Pool" and path != tail:
        return "executor"
    if tail == "Queue" and root in {"multiprocessing", "mp"}:
        return "mpqueue"
    if tail in {"Thread", "Process"}:
        if _kw_const(call, "daemon") is True:
            return None
        return "thread"
    return None


def _is_tempdir_call(call: ast.Call, imports: dict[str, str]) -> str | None:
    """RS004 targets: 'tempdir' for mkdtemp, 'tempfile' for
    NamedTemporaryFile(delete=False); None otherwise."""
    tail = _tail(_dotted(call.func, imports))
    if tail == "mkdtemp":
        return "tempdir"
    if tail == "NamedTemporaryFile" and _kw_const(call, "delete") is False:
        return "tempfile"
    return None


def _iter_scope(body: list[ast.stmt]):
    """Walk a scope's nodes without descending into nested function/class
    bodies — those are scopes of their own."""
    stack: list[ast.AST] = list(body)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
            ):
                continue
            stack.append(child)


# ---------------------------------------------------------------------------
# repo-wide fragments (RS005 finalize input)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ResourceAttr:
    attr: str
    kind: str  # resource kind, or "closeable <ClassName>" for owned classes
    line: int
    col: int
    snippet: str
    suppressed: bool


@dataclasses.dataclass
class ClassSummary:
    name: str
    path: str
    line: int
    resources: list[ResourceAttr]
    # attr -> candidate owned-class ctor (resolved repo-wide in finalize)
    attr_class: dict[str, ResourceAttr]
    has_close: bool
    close_methods: list[str]
    closure_attrs: set[str]


@dataclasses.dataclass
class LifecycleFragment:
    path: str
    classes: dict[str, ClassSummary]


# ---------------------------------------------------------------------------
# per-file pass
# ---------------------------------------------------------------------------


class _ClassScan:
    """One class: collect __init__ resources + the close-reachability
    closure for RS005 fragments, and emit the class-local RS002/RS003/
    RS006 attribute findings."""

    def __init__(self, mod: "_ModuleScan", node: ast.ClassDef) -> None:
        self.mod = mod
        self.node = node
        self.methods: dict[str, ast.AST] = {}
        for stmt in node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.methods[stmt.name] = stmt
        # attr -> (ctor call, resource kind, assign node) from ANY method
        self.attr_resources: dict[str, tuple[ast.Call, str, ast.AST]] = {}
        self.attr_class: dict[str, ResourceAttr] = {}
        self.init_attrs: set[str] = set()
        self.self_calls: dict[str, set[str]] = {}
        self.attr_mentions: dict[str, set[str]] = {}
        self.attr_calls: dict[str, set[tuple[str, str]]] = {}
        self.daemonized: set[str] = set()

    def _self_name(self, method: ast.AST) -> str:
        args = method.args.posonlyargs + method.args.args
        return args[0].arg if args else "self"

    def run(self) -> ClassSummary:
        for name, method in self.methods.items():
            self._scan_method(name, method)
        self._emit_attr_findings()
        return self._summary()

    def _scan_method(self, name: str, method: ast.AST) -> None:
        self_name = self._self_name(method)
        calls = self.self_calls.setdefault(name, set())
        mentions = self.attr_mentions.setdefault(name, set())
        receiver = self.attr_calls.setdefault(name, set())
        in_init = name in {"__init__", "__post_init__"}
        for node in _iter_scope(method.body):
            if isinstance(node, ast.Attribute) and (
                isinstance(node.value, ast.Name)
                and node.value.id == self_name
            ):
                mentions.add(node.attr)
            if isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute
            ):
                base = node.func.value
                if isinstance(base, ast.Name) and base.id == self_name:
                    if node.func.attr in self.methods:
                        calls.add(node.func.attr)
                elif (
                    isinstance(base, ast.Attribute)
                    and isinstance(base.value, ast.Name)
                    and base.value.id == self_name
                ):
                    receiver.add((base.attr, node.func.attr))
            if isinstance(node, ast.Assign):
                self._scan_assign(node, self_name, in_init)

    def _scan_assign(
        self, node: ast.Assign, self_name: str, in_init: bool
    ) -> None:
        if len(node.targets) != 1:
            return
        target = node.targets[0]
        if not (
            isinstance(target, ast.Attribute)
            and isinstance(target.value, ast.Name)
            and target.value.id == self_name
        ):
            return
        attr = target.attr
        value = node.value
        if not isinstance(value, ast.Call):
            return
        kind = _resource_kind(value, self.mod.imports)
        if kind is not None:
            self.attr_resources.setdefault(attr, (value, kind, node))
            if in_init:
                self.init_attrs.add(attr)
            return
        tail = _tail(_dotted(value.func, self.mod.imports))
        if in_init and tail and tail[0].isupper():
            self.attr_class.setdefault(
                attr,
                ResourceAttr(
                    attr=attr,
                    kind=f"closeable {tail}",
                    line=node.lineno,
                    col=node.col_offset,
                    snippet=self.mod.line(node.lineno),
                    suppressed=_line_suppresses(
                        self.mod.line(node.lineno), "RS005"
                    ),
                ),
            )

    def _daemonized_attrs(self) -> set[str]:
        """Attrs daemonized *after* construction: `self._t.daemon = True`."""
        out: set[str] = set()
        for method in self.methods.values():
            self_name = self._self_name(method)
            for node in _iter_scope(method.body):
                if not isinstance(node, ast.Assign):
                    continue
                for target in node.targets:
                    if (
                        isinstance(target, ast.Attribute)
                        and target.attr == "daemon"
                        and isinstance(target.value, ast.Attribute)
                        and isinstance(target.value.value, ast.Name)
                        and target.value.value.id == self_name
                        and isinstance(node.value, ast.Constant)
                        and node.value.value is True
                    ):
                        out.add(target.value.attr)
        return out

    def _closure(self) -> tuple[list[str], set[str], set[tuple[str, str]]]:
        entries = sorted(set(self.methods) & _CLOSE_ENTRY)
        seen: set[str] = set()
        frontier = list(entries)
        while frontier:
            m = frontier.pop()
            if m in seen:
                continue
            seen.add(m)
            frontier.extend(self.self_calls.get(m, ()))
        attrs: set[str] = set()
        receiver: set[tuple[str, str]] = set()
        for m in seen:
            attrs |= self.attr_mentions.get(m, set())
            receiver |= self.attr_calls.get(m, set())
        return entries, attrs, receiver

    def _emit_attr_findings(self) -> None:
        entries, _closure_attrs, closure_recv = self._closure()
        all_recv: set[tuple[str, str]] = set()
        for recv in self.attr_calls.values():
            all_recv |= recv
        daemonized = self._daemonized_attrs()
        for attr, (call, kind, assign) in self.attr_resources.items():
            reaps = {m for (a, m) in all_recv if a == attr}
            if kind == "thread":
                if attr in daemonized or (attr, "start") not in all_recv:
                    continue
                if not entries:
                    continue  # no close path at all: that is RS005's call
                joined = {m for (a, m) in closure_recv if a == attr}
                if not joined & _CLOSE_BY_KIND["thread"]:
                    self.mod.emit(
                        "RS002",
                        assign,
                        f"non-daemon thread 'self.{attr}' of "
                        f"'{self.node.name}' is started but no join() is "
                        f"reachable from {'/'.join(entries)}",
                    )
            elif kind == "popen":
                if not reaps & _CLOSE_BY_KIND["popen"]:
                    self.mod.emit(
                        "RS003",
                        assign,
                        f"subprocess 'self.{attr}' of '{self.node.name}' "
                        "is never waited/terminated by any method",
                    )
            elif kind in {"executor", "mpqueue"}:
                if not reaps & _CLOSE_BY_KIND[kind]:
                    self.mod.emit(
                        "RS006",
                        assign,
                        f"executor 'self.{attr}' of '{self.node.name}' "
                        "is never shut down by any method",
                    )

    def _summary(self) -> ClassSummary:
        entries, closure_attrs, _ = self._closure()
        daemonized = self._daemonized_attrs()
        resources = []
        for attr in sorted(self.init_attrs):
            call, kind, assign = self.attr_resources[attr]
            if kind == "thread" and attr in daemonized:
                continue
            resources.append(
                ResourceAttr(
                    attr=attr,
                    kind=kind,
                    line=assign.lineno,
                    col=assign.col_offset,
                    snippet=self.mod.line(assign.lineno),
                    suppressed=_line_suppresses(
                        self.mod.line(assign.lineno), "RS005"
                    ),
                )
            )
        return ClassSummary(
            name=self.node.name,
            path=self.mod.rel_path,
            line=self.node.lineno,
            resources=resources,
            attr_class=dict(self.attr_class),
            has_close=bool(entries),
            close_methods=entries,
            closure_attrs=closure_attrs,
        )


class _ModuleScan:
    def __init__(
        self, tree: ast.Module, rel_path: str, lines: list[str]
    ) -> None:
        self.tree = tree
        self.rel_path = rel_path
        self.lines = lines
        self.imports = _collect_imports(tree)
        self.findings: list[Finding] = []
        self._emitted: set[tuple[str, int, int]] = set()

    def line(self, lineno: int) -> str:
        if 0 < lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def emit(self, rule: str, node: ast.AST, message: str) -> None:
        key = (rule, node.lineno, node.col_offset)
        if key in self._emitted:
            return
        self._emitted.add(key)
        self.findings.append(
            Finding(
                rule=rule,
                path=self.rel_path,
                line=node.lineno,
                col=node.col_offset,
                message=message,
                snippet=self.line(node.lineno),
            )
        )

    def run(self) -> LifecycleFragment:
        classes: dict[str, ClassSummary] = {}
        self._scan_scope(self.tree.body)
        for node in ast.walk(self.tree):
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                self._scan_scope(node.body)
            elif isinstance(node, ast.ClassDef):
                summary = _ClassScan(self, node).run()
                classes.setdefault(summary.name, summary)
        return LifecycleFragment(path=self.rel_path, classes=classes)

    # -- one local scope (module body or a function body) ------------------

    def _scan_scope(self, body: list[ast.stmt]) -> None:
        managed: set[int] = set()
        candidates: list[tuple[str, str, ast.Call, ast.AST]] = []
        temp_candidates: list[tuple[str, str, ast.AST]] = []
        attr_root_ids: set[int] = set()
        bare_names: set[str] = set()
        method_calls: dict[str, set[str]] = {}
        owned_escapes: set[str] = set()
        cleanup_seen = False
        store_targets: set[int] = set()

        nodes = list(_iter_scope(body))
        for node in nodes:
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    expr = item.context_expr
                    if isinstance(expr, ast.Call):
                        managed.add(id(expr))
                        for arg in expr.args:
                            if isinstance(arg, ast.Call):
                                managed.add(id(arg))
            elif isinstance(node, ast.Call):
                tail = _tail(_dotted(node.func, self.imports))
                if tail in _ADOPTING_TAILS:
                    for arg in node.args:
                        if isinstance(arg, ast.Call):
                            managed.add(id(arg))
                if tail in _CLEANUP_TAILS:
                    cleanup_seen = True

        for node in nodes:
            if isinstance(node, ast.Attribute) and isinstance(
                node.value, ast.Name
            ):
                attr_root_ids.add(id(node.value))
            if isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute
            ):
                base = node.func.value
                if isinstance(base, ast.Name):
                    method_calls.setdefault(base.id, set()).add(
                        node.func.attr
                    )
            if isinstance(node, (ast.Return, ast.Yield, ast.YieldFrom)):
                value = getattr(node, "value", None)
                if value is not None:
                    for sub in ast.walk(value):
                        if isinstance(sub, ast.Name):
                            owned_escapes.add(sub.id)
            if isinstance(node, ast.Assign):
                has_container_target = any(
                    isinstance(t, (ast.Attribute, ast.Subscript))
                    for t in node.targets
                )
                if has_container_target:
                    for sub in ast.walk(node.value):
                        if isinstance(sub, ast.Name):
                            owned_escapes.add(sub.id)
                target = node.targets[0]
                if (
                    len(node.targets) == 1
                    and isinstance(target, ast.Name)
                    and isinstance(node.value, ast.Call)
                    and id(node.value) not in managed
                ):
                    store_targets.add(id(target))
                    kind = _resource_kind(node.value, self.imports)
                    if kind is not None and kind != "thread":
                        candidates.append(
                            (target.id, kind, node.value, node)
                        )
                    temp = _is_tempdir_call(node.value, self.imports)
                    if temp is not None:
                        temp_candidates.append((target.id, temp, node))

        for node in nodes:
            if (
                isinstance(node, ast.Name)
                and isinstance(node.ctx, ast.Load)
                and id(node) not in attr_root_ids
            ):
                bare_names.add(node.id)

        for var, kind, call, assign in candidates:
            if var in bare_names:
                continue  # escapes: passed/returned/stored — ownership moved
            if method_calls.get(var, set()) & _CLOSE_BY_KIND[kind]:
                continue
            rule = _RULE_BY_KIND[kind]
            noun = {
                "popen": "subprocess",
                "executor": "executor",
                "mpqueue": "mp.Queue",
            }.get(kind, kind)
            if rule == "RS001":
                message = (
                    f"'{var}' holds an open {noun} but is neither a "
                    "`with` target nor closed on any path in this scope"
                )
            elif rule == "RS003":
                message = (
                    f"subprocess '{var}' is never waited/terminated in "
                    "this scope — a zombie on every exit path"
                )
            else:
                message = (
                    f"{noun} '{var}' is never shut down in this scope"
                )
            self.emit(rule, assign, message)

        for var, temp, assign in temp_candidates:
            if cleanup_seen or var in owned_escapes:
                continue
            if temp == "tempfile" and var in bare_names:
                # the NamedTemporaryFile object was handed off; its
                # delete=False file may be someone else's to remove
                continue
            what = (
                "temp dir from mkdtemp()"
                if temp == "tempdir"
                else "NamedTemporaryFile(delete=False)"
            )
            self.emit(
                "RS004",
                assign,
                f"'{var}' names a {what} with no recorded cleanup "
                "(rmtree/unlink/atexit/finalizer) in this scope",
            )


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def check_source(
    source: str, rel_path: str, tree: ast.Module | None = None
) -> tuple[list[Finding], LifecycleFragment]:
    """Per-file RS pass. Returns (findings, fragment); the fragment feeds
    the repo-wide :func:`finalize` join for RS005. Unparseable files
    contribute nothing (torchlint's TX000 already reports the SyntaxError).
    """
    lines = source.splitlines()
    if tree is None:
        try:
            tree = ast.parse(source, filename=rel_path)
        except SyntaxError:
            return [], LifecycleFragment(path=rel_path, classes={})
    scan = _ModuleScan(tree, rel_path, lines)
    fragment = scan.run()
    findings = scan.findings
    torchlint._apply_suppressions(findings, lines)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings, fragment


def finalize(fragments: list[LifecycleFragment]) -> list[Finding]:
    """Repo-wide RS005: join per-file class fragments, resolve owned-class
    attributes against every class seen anywhere (first definition wins on
    name collisions), then flag owners with tracked resources whose close
    path is missing or provably incomplete. Suppression state was captured
    at scan time from the resource's own source line."""
    has_close: dict[str, bool] = {}
    for fragment in fragments:
        for name, summary in fragment.classes.items():
            has_close.setdefault(name, summary.has_close)

    findings: list[Finding] = []
    for fragment in fragments:
        for summary in fragment.classes.values():
            tracked = list(summary.resources)
            for attr, res in sorted(summary.attr_class.items()):
                owned = res.kind.split(" ", 1)[1]
                if has_close.get(owned):
                    tracked.append(res)
            if not tracked:
                continue
            if not summary.has_close:
                anchor = min(tracked, key=lambda r: r.line)
                attrs = ", ".join(f"self.{r.attr}" for r in tracked)
                findings.append(
                    Finding(
                        rule="RS005",
                        path=summary.path,
                        line=anchor.line,
                        col=anchor.col,
                        message=(
                            f"class '{summary.name}' acquires "
                            f"{len(tracked)} closeable resource(s) in "
                            f"__init__ ({attrs}) but defines no "
                            "close()/__exit__"
                        ),
                        snippet=anchor.snippet,
                        suppressed=anchor.suppressed,
                    )
                )
                continue
            for res in tracked:
                if res.attr in summary.closure_attrs:
                    continue
                if res.kind in {"thread", "popen", "executor", "mpqueue"}:
                    # RS002/RS003/RS006 already judge these attrs against
                    # the close path; re-reporting them here double-counts
                    continue
                findings.append(
                    Finding(
                        rule="RS005",
                        path=summary.path,
                        line=res.line,
                        col=res.col,
                        message=(
                            f"'self.{res.attr}' ({res.kind}) of "
                            f"'{summary.name}' is acquired in __init__ "
                            "but never touched by "
                            f"{'/'.join(summary.close_methods)} — the "
                            "close path provably misses it"
                        ),
                        snippet=res.snippet,
                        suppressed=res.suppressed,
                    )
                )
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def lint_lifecycle(source: str, rel_path: str = "mod.py") -> list[Finding]:
    """Single-file convenience for tests/fixtures: per-file pass plus a
    finalize over just this file's fragment."""
    findings, fragment = check_source(source, rel_path)
    findings = findings + finalize([fragment])
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings
