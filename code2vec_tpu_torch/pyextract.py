"""Python source -> path contexts, in pure Python (``ast``).

Own copy of ``code2vec_tpu/pyextract.py`` (the port imports nothing from
the JAX package); its records and the five artifacts it writes are byte
for byte the JAX module's. The Java leg is the C++ extractor
(``extractor.py``); this leg walks the standard library's ``ast`` and
applies the same conventions, so both languages intern into one vocab:

- anonymization: parameters and locals become ``@var_k``, the function's
  own name (and nested defs) ``@method_k``, in encounter order;
- literals: str/bytes -> ``@string_literal``, float -> ``@double_literal``,
  int kept verbatim by default (``extractor/src/extract.h`` ExtractConfig);
- operator-suffixed node names (``BinOp:+`` like the Java ``BinaryExpr:+``);
- leaf-pair paths with the same length and width caps and the same
  ``↑``/``↓`` path strings (``extract.cc`` get_path);
- terminals lowercased at interning, vocabs 1-based in insertion order;
- the ignorable-method filter: bodyless defs, dunders, trivial
  getters and setters.

:func:`extract_python_dataset` writes or extends the artifacts in the text
formats of ``extractor/src/main.cc``; in merge mode it preloads the vocab
files a Java run wrote and appends its records (``extractor.main`` routes
``.py`` rows here). The records depend on the ``ast`` of the running
Python: both machines the port runs on have 3.12.
"""

from __future__ import annotations

import ast
import logging
import os
from dataclasses import dataclass, field

logger = logging.getLogger(__name__)

UP = "↑"  # ↑ — same arrows as extract.cc kUp/kDown
DOWN = "↓"

# the Object-method analogue of extract.cc kObjectMethods (toString/
# hashCode/equals/...): dunders carry no name signal to predict
_DUNDER_PREFIX = "__"

_BINOP_SYMBOL = {
    ast.Add: "+", ast.Sub: "-", ast.Mult: "*", ast.Div: "/",
    ast.FloorDiv: "//", ast.Mod: "%", ast.Pow: "**", ast.LShift: "<<",
    ast.RShift: ">>", ast.BitOr: "|", ast.BitXor: "^", ast.BitAnd: "&",
    ast.MatMult: "@",
}
_UNARYOP_SYMBOL = {
    ast.UAdd: "+", ast.USub: "-", ast.Not: "not", ast.Invert: "~",
}
_CMPOP_SYMBOL = {
    ast.Eq: "==", ast.NotEq: "!=", ast.Lt: "<", ast.LtE: "<=",
    ast.Gt: ">", ast.GtE: ">=", ast.Is: "is", ast.IsNot: "is not",
    ast.In: "in", ast.NotIn: "not in",
}
_BOOLOP_SYMBOL = {ast.And: "and", ast.Or: "or"}


@dataclass
class PyExtractConfig:
    """Mirrors extractor/src/extract.h ExtractConfig."""

    normalize_string_literal: bool = True
    normalize_char_literal: bool = True  # no-op for Python; params.txt parity
    normalize_int_literal: bool = False
    normalize_double_literal: bool = True
    max_length: int = 8
    max_width: int = 3


@dataclass
class _ENode:
    """Normalized AST node (extract.cc ENode)."""

    name: str
    terminal: str | None = None
    children: list["_ENode"] = field(default_factory=list)


@dataclass
class PyMethod:
    label: str  # original def name (the prediction target)
    contexts: list[tuple[str, str, str]]  # (start, path-string, end)
    variables: list[tuple[str, str]]  # (original, @var_k) encounter order
    methods: list[tuple[str, str]]  # (original, @method_k) encounter order
    source: str | None = None


class _Env:
    """Anonymization environment (extract.cc Env): encounter-ordered
    ``@<space>_k`` aliases."""

    def __init__(self, space: str):
        self.space = space
        self.order: list[tuple[str, str]] = []  # (original, alias)
        self.by_name: dict[str, str] = {}

    def fresh(self, original: str) -> str:
        alias = f"@{self.space}_{len(self.order)}"
        self.order.append((original, alias))
        self.by_name[original] = alias
        return alias

    def lookup(self, name: str) -> str | None:
        return self.by_name.get(name)


class _MethodExtractor(ast.NodeVisitor):
    """One FunctionDef -> normalized _ENode tree.

    Scoping follows the Java extractor's spirit: a name binds to a fresh
    ``@var_k`` at its first binding occurrence (params, assignment targets,
    for/with/except/comprehension targets), and every later reference
    resolves through the env; unbound names (globals, builtins, attribute
    roots of other objects) keep their original text, like Java field/type
    names do.
    """

    def __init__(self, config: PyExtractConfig, vars_env: _Env, methods_env: _Env):
        self.config = config
        self.vars = vars_env
        self.methods = methods_env

    # -- helpers ---------------------------------------------------------

    def node(self, name: str, *children) -> _ENode:
        out = _ENode(name)
        out.children = [c for c in children if c is not None]
        return out

    def term(self, name: str, terminal: str) -> _ENode:
        return _ENode(name, terminal=terminal)

    def walk(self, n) -> _ENode | None:
        if n is None:
            return None
        method = getattr(self, f"x_{type(n).__name__}", None)
        if method is not None:
            return method(n)
        return self.generic(n)

    def walk_all(self, nodes) -> list[_ENode]:
        return [e for e in (self.walk(c) for c in nodes) if e is not None]

    def generic(self, n) -> _ENode:
        out = _ENode(type(n).__name__)
        for child in ast.iter_child_nodes(n):
            e = self.walk(child)
            if e is not None:
                out.children.append(e)
        if not out.children and not isinstance(n, (ast.expr_context, ast.operator, ast.unaryop, ast.cmpop, ast.boolop)):
            # leaf statement/expr with no operands (pass, break, ...)
            out.terminal = type(n).__name__.lower()
        if isinstance(n, (ast.expr_context, ast.operator, ast.unaryop, ast.cmpop, ast.boolop)):
            return None  # operator tokens are folded into parent names
        return out

    # -- binding forms ---------------------------------------------------

    def bind_target(self, target) -> _ENode | None:
        """Anonymize a binding occurrence (Store context)."""
        if isinstance(target, ast.Name):
            alias = self.vars.lookup(target.id) or self.vars.fresh(target.id)
            return self.term("Name", alias)
        if isinstance(target, (ast.Tuple, ast.List)):
            out = _ENode(type(target).__name__)
            out.children = [
                e for e in (self.bind_target(t) for t in target.elts)
                if e is not None
            ]
            return out
        if isinstance(target, ast.Starred):
            out = _ENode("Starred")
            inner = self.bind_target(target.value)
            if inner is not None:
                out.children.append(inner)
            return out
        return self.walk(target)  # Attribute/Subscript targets: references

    # -- visitors --------------------------------------------------------

    def x_Name(self, n: ast.Name) -> _ENode:
        if isinstance(n.ctx, ast.Store):
            return self.bind_target(n)
        # vars first, then enclosing def names (so recursive calls resolve
        # to @method_k — the Java extractor's method-space lookup)
        alias = self.vars.lookup(n.id) or self.methods.lookup(n.id)
        return self.term("Name", alias if alias is not None else n.id)

    def x_arg(self, n: ast.arg) -> _ENode:
        alias = self.vars.fresh(n.arg)
        out = self.node("arg", self.term("Name", alias))
        if n.annotation is not None:
            out.children.append(self.walk(n.annotation))
        return out

    def x_Constant(self, n: ast.Constant) -> _ENode:
        v = n.value
        if isinstance(v, bool) or v is None or v is Ellipsis:
            return self.term("Constant", str(v))
        if isinstance(v, (str, bytes)):
            if self.config.normalize_string_literal:
                return self.term("Constant", "@string_literal")
            return self.term("Constant", str(v))
        if isinstance(v, int):
            if self.config.normalize_int_literal:
                return self.term("Constant", "@int_literal")
            return self.term("Constant", str(v))
        if isinstance(v, (float, complex)):
            if self.config.normalize_double_literal:
                return self.term("Constant", "@double_literal")
            return self.term("Constant", str(v))
        return self.term("Constant", str(v))

    def x_Attribute(self, n: ast.Attribute) -> _ENode:
        return self.node(
            "Attribute", self.walk(n.value), self.term("attr", n.attr)
        )

    def x_keyword(self, n: ast.keyword) -> _ENode:
        name = self.term("arg", n.arg) if n.arg else None
        return self.node("keyword", name, self.walk(n.value))

    def x_BinOp(self, n: ast.BinOp) -> _ENode:
        return self.node(
            f"BinOp:{_BINOP_SYMBOL.get(type(n.op), '?')}",
            self.walk(n.left), self.walk(n.right),
        )

    def x_UnaryOp(self, n: ast.UnaryOp) -> _ENode:
        return self.node(
            f"UnaryOp:{_UNARYOP_SYMBOL.get(type(n.op), '?')}",
            self.walk(n.operand),
        )

    def x_AugAssign(self, n: ast.AugAssign) -> _ENode:
        return self.node(
            f"AugAssign:{_BINOP_SYMBOL.get(type(n.op), '?')}=",
            self.bind_target(n.target), self.walk(n.value),
        )

    def x_BoolOp(self, n: ast.BoolOp) -> _ENode:
        out = _ENode(f"BoolOp:{_BOOLOP_SYMBOL.get(type(n.op), '?')}")
        out.children = self.walk_all(n.values)
        return out

    def x_Compare(self, n: ast.Compare) -> _ENode:
        # name carries the operator chain, like BinaryExpr:<op>
        ops = ",".join(_CMPOP_SYMBOL.get(type(o), "?") for o in n.ops)
        out = _ENode(f"Compare:{ops}")
        out.children = [self.walk(n.left)] + self.walk_all(n.comparators)
        return out

    def x_Assign(self, n: ast.Assign) -> _ENode:
        # value first (its references see pre-assignment bindings), then
        # targets bind — Python evaluation order
        value = self.walk(n.value)
        targets = [self.bind_target(t) for t in n.targets]
        out = _ENode("Assign")
        out.children = [t for t in targets if t is not None] + (
            [value] if value is not None else []
        )
        return out

    def x_AnnAssign(self, n: ast.AnnAssign) -> _ENode:
        value = self.walk(n.value) if n.value is not None else None
        return self.node(
            "AnnAssign", self.bind_target(n.target),
            self.walk(n.annotation), value,
        )

    def x_NamedExpr(self, n: ast.NamedExpr) -> _ENode:
        value = self.walk(n.value)
        return self.node("NamedExpr", self.bind_target(n.target), value)

    def x_For(self, n: ast.For) -> _ENode:
        return self._for(n, "For")

    def x_AsyncFor(self, n: ast.AsyncFor) -> _ENode:
        return self._for(n, "AsyncFor")

    def _for(self, n, name: str) -> _ENode:
        it = self.walk(n.iter)
        target = self.bind_target(n.target)
        out = _ENode(name)
        out.children = [target, it] + self.walk_all(n.body) + self.walk_all(
            n.orelse
        )
        out.children = [c for c in out.children if c is not None]
        return out

    def x_withitem(self, n: ast.withitem) -> _ENode:
        ctx = self.walk(n.context_expr)
        opt = (
            self.bind_target(n.optional_vars)
            if n.optional_vars is not None
            else None
        )
        return self.node("withitem", ctx, opt)

    def x_ExceptHandler(self, n: ast.ExceptHandler) -> _ENode:
        ty = self.walk(n.type) if n.type is not None else None
        name = self.term("Name", self.vars.fresh(n.name)) if n.name else None
        out = _ENode("ExceptHandler")
        out.children = [c for c in (ty, name) if c is not None]
        out.children += self.walk_all(n.body)
        return out

    def x_comprehension(self, n: ast.comprehension) -> _ENode:
        # target binds BEFORE iter/ifs are walked (they reference it)
        target = self.bind_target(n.target)
        out = _ENode("comprehension")
        out.children = [target, self.walk(n.iter)] + self.walk_all(n.ifs)
        out.children = [c for c in out.children if c is not None]
        return out

    def _comp(self, n, name: str) -> _ENode:
        out = _ENode(name)
        gens = self.walk_all(n.generators)
        if isinstance(n, ast.DictComp):
            elems = [self.walk(n.key), self.walk(n.value)]
        else:
            elems = [self.walk(n.elt)]
        out.children = gens + [e for e in elems if e is not None]
        return out

    def x_ListComp(self, n):
        return self._comp(n, "ListComp")

    def x_SetComp(self, n):
        return self._comp(n, "SetComp")

    def x_DictComp(self, n):
        return self._comp(n, "DictComp")

    def x_GeneratorExp(self, n):
        return self._comp(n, "GeneratorExp")

    def x_Lambda(self, n: ast.Lambda) -> _ENode:
        args = self.walk(n.args)
        return self.node("Lambda", args, self.walk(n.body))

    def x_Global(self, n: ast.Global) -> _ENode:
        out = _ENode("Global")
        out.children = [self.term("Name", name) for name in n.names]
        return out

    def x_Nonlocal(self, n: ast.Nonlocal) -> _ENode:
        out = _ENode("Nonlocal")
        out.children = [self.term("Name", name) for name in n.names]
        return out

    def x_FunctionDef(self, n) -> _ENode:
        alias = self.methods.fresh(n.name)
        out = _ENode(type(n).__name__)
        out.children.append(self.term("Name", alias))
        out.children.append(self.walk(n.args))
        out.children += self.walk_all(n.body)
        if n.returns is not None:
            out.children.append(self.walk(n.returns))
        for d in n.decorator_list:
            out.children.append(self.walk(d))
        return out

    x_AsyncFunctionDef = x_FunctionDef

    def x_alias(self, n: ast.alias) -> _ENode:
        shown = n.asname or n.name
        if n.asname:
            self.vars.fresh(n.asname)
            shown = self.vars.lookup(n.asname)
        return self.term("alias", shown)


def _is_ignorable(fn) -> bool:
    """extract.cc is_ignorable_method analogue for Python defs."""
    name = fn.name
    body = [
        s for s in fn.body
        if not (
            isinstance(s, ast.Expr)
            and isinstance(s.value, ast.Constant)
            and isinstance(s.value.value, str)
        )  # docstrings don't count as body
    ]
    if not body or all(isinstance(s, ast.Pass) for s in body):
        return True  # abstract/bodyless
    if name.startswith(_DUNDER_PREFIX) and name.endswith(_DUNDER_PREFIX):
        return True  # the Object-methods analogue
    if len(body) == 1:
        only = body[0]
        # trivial getter: get*/is* returning an attribute or name (the C++
        # filter's name-prefix condition applies here too — a one-line
        # return in an arbitrary def is NOT ignorable)
        if (
            (name.startswith("get") or name.startswith("is"))
            and isinstance(only, ast.Return)
            and isinstance(only.value, (ast.Attribute, ast.Name))
        ):
            return True
        # trivial setter: set* with a single self.<attr> = <param>
        if (
            name.startswith("set")
            and isinstance(only, ast.Assign)
            and len(only.targets) == 1
            and isinstance(only.targets[0], ast.Attribute)
            and isinstance(only.value, ast.Name)
        ):
            return True
    return False


def _find_terminals(root: _ENode):
    """(node, path-from-root as [(node, child_index), ...]) per terminal —
    extract.cc find_terminals."""
    out = []
    path = [(root, 0)]

    def rec(n: _ENode):
        if n.terminal is not None:
            out.append((n, list(path)))
            return
        for i, c in enumerate(n.children):
            path.append((c, i))
            rec(c)
            path.pop()

    rec(root)
    return out


def _get_path(a, b, max_length: int, max_width: int) -> str | None:
    """extract.cc get_path: shared-prefix strip, width/length caps, the
    ↑/↓ join. ``a``/``b`` are path-from-root lists."""
    i = 1
    hinge = a[0][0]
    while i < len(a) and i < len(b) and a[i][0] is b[i][0]:
        hinge = a[i][0]
        i += 1
    width = a[i][1] - b[i][1]
    if abs(width) > max_width:
        return None
    up_len = len(a) - i
    down_len = len(b) - i
    if up_len + down_len + 1 > max_length:
        return None
    parts = []
    for k in range(len(a) - 1, i - 1, -1):
        parts.append(a[k][0].name)
        parts.append(UP)
    parts.append(hinge.name)
    parts.append(DOWN)
    for k in range(i, len(b) - 1):
        parts.append(b[k][0].name)
        parts.append(DOWN)
    parts.append(b[-1][0].name)
    return "".join(parts)


def _collect_defs(tree):
    """All function defs, recursively (extract.cc collect_methods)."""
    out = []
    for n in ast.walk(tree):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append(n)
    return out


def extract_python_source(
    source: str,
    method_name: str = "*",
    config: PyExtractConfig | None = None,
) -> list[PyMethod]:
    """Parse Python source and extract path-contexts per function def."""
    config = config or PyExtractConfig()
    tree = ast.parse(source)
    methods: list[PyMethod] = []
    for fn in _collect_defs(tree):
        if method_name != "*" and fn.name != method_name:
            continue
        if _is_ignorable(fn):
            continue
        vars_env = _Env("var")
        methods_env = _Env("method")
        extractor = _MethodExtractor(config, vars_env, methods_env)
        enode = extractor.walk(fn)
        terminals = _find_terminals(enode)
        contexts: list[tuple[str, str, str]] = []
        for x in range(len(terminals)):
            for y in range(x + 1, len(terminals)):
                path = _get_path(
                    terminals[x][1], terminals[y][1],
                    config.max_length, config.max_width,
                )
                if path is not None:
                    contexts.append(
                        (terminals[x][0].terminal, path, terminals[y][0].terminal)
                    )
        if not contexts:
            continue
        methods.append(
            PyMethod(
                label=fn.name,
                contexts=contexts,
                variables=list(vars_env.order),
                methods=list(methods_env.order),
                source=ast.get_source_segment(source, fn),
            )
        )
    return methods


# ---------------------------------------------------------------------------
# dataset writing (main.cc artifact formats, with merge/append support)


class PyVocabs:
    """1-based insertion-ordered interner (extract.cc Vocabs), optionally
    preloaded from existing terminal_idxs.txt/path_idxs.txt so Python
    records extend a Java corpus's vocab space."""

    def __init__(self):
        self.terminals: dict[str, int] = {}
        self.paths: dict[str, int] = {}

    @staticmethod
    def _load(path: str) -> dict[str, int]:
        out: dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                idx, name = line.split("\t", 1)
                if name == "<PAD/>":
                    continue  # the writers re-emit row 0
                out[name] = int(idx)
        return out

    @classmethod
    def preloaded(cls, dataset_dir: str) -> "PyVocabs":
        v = cls()
        v.terminals = cls._load(os.path.join(dataset_dir, "terminal_idxs.txt"))
        v.paths = cls._load(os.path.join(dataset_dir, "path_idxs.txt"))
        return v

    def terminal_index(self, name: str) -> int:
        name = name.lower()  # vocab-size reduction (ipynb cell7)
        # unlike Java, Python string literals can contain raw newlines and
        # tabs (triple-quoted strings); with --no-normalize-string those
        # become terminal NAMES, which would corrupt the line/tab-delimited
        # terminal_idxs.txt — escape the delimiters before interning
        name = (
            name.replace("\\", "\\\\")
            .replace("\n", "\\n")
            .replace("\r", "\\r")
            .replace("\t", "\\t")
        )
        if name not in self.terminals:
            self.terminals[name] = len(self.terminals) + 1
        return self.terminals[name]

    def path_index(self, name: str) -> int:
        if name not in self.paths:
            self.paths[name] = len(self.paths) + 1
        return self.paths[name]


def _write_vocab(path: str, entries: dict[str, int]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write("0\t<PAD/>\n")
        for name, idx in sorted(entries.items(), key=lambda kv: kv[1]):
            f.write(f"{idx}\t{name}\n")


def extract_python_dataset(
    dataset_dir: str,
    source_dir: str,
    rows: list[tuple[str, str]],
    config: PyExtractConfig | None = None,
    merge: bool = False,
    start_id: int = 0,
    method_declarations: str | None = None,
) -> tuple[int, PyVocabs]:
    """Extract ``rows`` of (py_file, method_name) into the five artifacts.

    ``merge=True`` preloads the existing vocab files and APPENDS to
    corpus.txt/actual_methods.txt (the Java+Python merged-vocab flow);
    otherwise the artifacts are created fresh. Per-row failures (missing
    file, bad encoding, syntax error) warn and continue, like the C++ leg.
    Returns (next_id, vocabs).
    """
    config = config or PyExtractConfig()
    vocabs = PyVocabs.preloaded(dataset_dir) if merge else PyVocabs()
    mode = "a" if merge else "w"
    id_counter = start_id
    method_names: set[str] = set()
    if merge:
        # seed with the Java leg's names so method_name_vocab_count stays a
        # true distinct count across both languages (main.cc method_names)
        actual_path = os.path.join(dataset_dir, "actual_methods.txt")
        if os.path.exists(actual_path):
            with open(actual_path, encoding="utf-8") as f:
                for line in f:
                    parts = line.rstrip("\n").split("\t")
                    if len(parts) >= 2:
                        method_names.add(parts[1])

    corpus = open(os.path.join(dataset_dir, "corpus.txt"), mode, encoding="utf-8")
    actual = open(
        os.path.join(dataset_dir, "actual_methods.txt"), mode, encoding="utf-8"
    )
    declarations = None
    if method_declarations:
        declarations = open(
            os.path.join(dataset_dir, method_declarations), mode,
            encoding="utf-8",
        )
    try:
        last_file, methods_cache = None, []
        for py_file, method_name in rows:
            try:
                if py_file != last_file:
                    with open(
                        os.path.join(source_dir, py_file), encoding="utf-8"
                    ) as f:
                        methods_cache = extract_python_source(
                            f.read(), "*", config
                        )
                    last_file = py_file
                selected = [
                    m for m in methods_cache
                    if method_name == "*" or m.label == method_name
                ]
                if not selected and method_name != "*":
                    logger.warning("method not found: %s\t%s", py_file, method_name)
                for m in selected:
                    corpus_id = id_counter
                    id_counter += 1
                    corpus.write(f"#{corpus_id}\n")
                    corpus.write(f"label:{m.label}\n")
                    corpus.write(f"class:{py_file}\n")
                    corpus.write("paths:\n")
                    for start, path, end in m.contexts:
                        corpus.write(
                            f"{vocabs.terminal_index(start)}\t"
                            f"{vocabs.path_index(path)}\t"
                            f"{vocabs.terminal_index(end)}\n"
                        )
                    corpus.write("vars:\n")
                    for original, alias in m.variables:
                        corpus.write(f"{original}\t{alias}\n")
                    corpus.write("\n")
                    actual.write(
                        f"{py_file}\t{m.label}\t{corpus_id}\t{len(m.contexts)}\n"
                    )
                    if declarations is not None and m.source:
                        # main.cc method_declarations format
                        declarations.write(
                            f"#{corpus_id}\t{py_file}#{m.label}\n{m.source}\n\n"
                        )
                    method_names.add(m.label)
            except (SyntaxError, OSError, UnicodeDecodeError, ValueError) as e:
                # warn-and-continue, matching the C++ leg's per-row policy
                # (main.cc catch blocks): one bad file must not abort the
                # run mid-write and orphan already-appended records
                logger.error("parse error: %s (%s)", py_file, e)
                last_file, methods_cache = None, []
    finally:
        corpus.close()
        actual.close()
        if declarations is not None:
            declarations.close()

    _write_vocab(os.path.join(dataset_dir, "terminal_idxs.txt"), vocabs.terminals)
    _write_vocab(os.path.join(dataset_dir, "path_idxs.txt"), vocabs.paths)
    with open(os.path.join(dataset_dir, "params.txt"), "w", encoding="utf-8") as f:
        f.write(
            f"max_length:{config.max_length}\n"
            f"max_width:{config.max_width}\n"
            f"nomalize_string_literal:{'true' if config.normalize_string_literal else 'false'}\n"
            f"nomalize_char_literal:{'true' if config.normalize_char_literal else 'false'}\n"
            f"nomalize_int_literal:{'true' if config.normalize_int_literal else 'false'}\n"
            f"nomalize_double_literal:{'true' if config.normalize_double_literal else 'false'}\n"
            f"terminal_vocab_count:{len(vocabs.terminals)}\n"
            f"path_vocab_count:{len(vocabs.paths)}\n"
            f"method_count:{id_counter}\n"
            f"method_name_vocab_count:{len(method_names)}\n"
        )
    return id_counter, vocabs
