"""The port's Python extractor and mixed Java + Python datasets, against the
JAX package, on the CPU.

- Every case of ``tests/test_pyextract.py``, run on the port's
  ``pyextract`` with its own assertions, and each record (label, contexts,
  variables, method aliases, source segment) equal to JAX's for the same
  source and config.
- ``extract_python_source`` records and ``extract_python_dataset``
  artifacts byte for byte on ``examples/python`` and on files of the frozen
  ``code2vec_tpu/`` package (read as text), under several configs, fresh and
  in merge mode.
- The extractor CLI on ``examples/java`` + ``examples/python`` (one mixed
  ``methods.txt``) writes the five artifacts (and the method declarations)
  as JAX's CLI does, with the Java leg's normalization flags reaching the
  Python leg; ``extract_dataset`` with a ``.py`` row does what JAX's does.

Every comparison is exact: the extractors are host code with no floats.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest

from code2vec_tpu import extractor as jax_extractor
from code2vec_tpu import pyextract as jax_pyextract
from code2vec_tpu.data import reader as jax_reader
from code2vec_tpu_torch import extractor, pyextract
from code2vec_tpu_torch.data.reader import load_corpus
from code2vec_tpu_torch.pyextract import (
    DOWN,
    UP,
    PyExtractConfig,
    extract_python_dataset,
    extract_python_source,
)

REPO = Path(__file__).resolve().parent.parent
JAVA = REPO / "examples" / "java"
PYTHON = REPO / "examples" / "python"
ARTIFACTS = ("corpus.txt", "terminal_idxs.txt", "path_idxs.txt", "params.txt",
             "actual_methods.txt")
# files of the frozen JAX package, read as text (never imported through here)
PACKAGE_FILES = ("code2vec_tpu/text.py", "code2vec_tpu/metrics.py",
                 "code2vec_tpu/interop.py", "code2vec_tpu/models/hierarchical.py",
                 "code2vec_tpu/ops/attention.py")
CONFIGS = {
    "default": {},
    "narrow": dict(max_length=5, max_width=2),
    "literals": dict(normalize_string_literal=False, normalize_int_literal=True,
                     normalize_double_literal=False),
}


def records(methods):
    return [(m.label, m.contexts, m.variables, m.methods, m.source) for m in methods]


def both(src, method_name="*", **config):
    """The port's records of ``src``, after checking them equal to JAX's."""
    port = extract_python_source(src, method_name, PyExtractConfig(**config))
    ref = jax_pyextract.extract_python_source(src, method_name,
                                              jax_pyextract.PyExtractConfig(**config))
    assert records(port) == records(ref)
    return port


def contexts_of(src, name):
    for m in both(src):
        if m.label == name:
            return m
    raise AssertionError(f"{name} not extracted")


def terminals(m):
    return {t for s, _, e in m.contexts for t in (s, e)}


def assert_same_artifacts(port: Path, ref: Path, extra=()):
    for name in ARTIFACTS + tuple(extra):
        assert (port / name).read_bytes() == (ref / name).read_bytes(), name


# ---------------------------------------------------------------------------
# the cases of tests/test_pyextract.py, each against JAX
# ---------------------------------------------------------------------------


class TestAnonymization:
    def test_params_become_var_aliases(self):
        m = contexts_of("def add(a, b):\n    return a + b\n", "add")
        assert ("a", "@var_0") in m.variables and ("b", "@var_1") in m.variables
        assert {"@var_0", "@var_1"} <= terminals(m)
        assert not {"a", "b"} & terminals(m)

    def test_own_name_becomes_method_alias(self):
        m = contexts_of("def fib(n):\n    return fib(n - 1) + n\n", "fib")
        assert ("fib", "@method_0") in m.methods
        assert "@method_0" in terminals(m) and "fib" not in terminals(m)

    def test_locals_bind_at_first_store(self):
        src = ("def f(xs):\n    total = 0\n    for x in xs:\n        total += x\n"
               "    return total\n")
        assert [o for o, _ in contexts_of(src, "f").variables] == ["xs", "total", "x"]

    def test_unbound_names_keep_text(self):
        m = contexts_of("def f(x):\n    return len(x) + GLOBAL\n", "f")
        assert {"len", "GLOBAL"} <= terminals(m)


class TestLiterals:
    def test_string_and_float_normalized_int_kept(self):
        src = 'def f():\n    a = "hi"\n    b = 2.5\n    c = 7\n    return a\n'
        assert {"@string_literal", "@double_literal", "7"} <= terminals(contexts_of(src, "f"))

    def test_raw_multiline_strings_cannot_corrupt_vocab(self, tmp_path):
        for who in ("port", "jax"):
            (tmp_path / who / "src").mkdir(parents=True)
            (tmp_path / who / "src" / "m.py").write_text(
                'def banner(n):\n    text = """a\nb\tc"""\n    return text * n\n')
            (tmp_path / who / "dataset").mkdir()
        rows = [("src/m.py", "*")]
        extract_python_dataset(str(tmp_path / "port" / "dataset"), str(tmp_path / "port"), rows,
                               config=PyExtractConfig(normalize_string_literal=False))
        jax_pyextract.extract_python_dataset(
            str(tmp_path / "jax" / "dataset"), str(tmp_path / "jax"), rows,
            config=jax_pyextract.PyExtractConfig(normalize_string_literal=False))
        assert_same_artifacts(tmp_path / "port" / "dataset", tmp_path / "jax" / "dataset")
        ds = tmp_path / "port" / "dataset"
        data = load_corpus(ds / "corpus.txt", ds / "path_idxs.txt", ds / "terminal_idxs.txt")
        assert data.n_items == 1
        assert any("\\n" in name for name in data.terminal_vocab.stoi)

    def test_int_normalization_opt_in(self):
        methods = both("def f():\n    c = 7\n    return c\n", normalize_int_literal=True)
        assert "@int_literal" in terminals(methods[0])


class TestPaths:
    def test_path_format_uses_reference_arrows(self):
        m = contexts_of("def f(a):\n    return a\n", "f")
        assert all(UP in p or DOWN in p for _, p, _ in m.contexts)
        assert (UP, DOWN) == (jax_pyextract.UP, jax_pyextract.DOWN)
        for _, p, _ in m.contexts:
            assert p.index(DOWN) > -1

    def test_length_cap_prunes(self):
        src = "def f(a):\n    return ((((a + 1) + 2) + 3) + 4)\n"
        wide, tight = both(src, max_length=20), both(src, max_length=4)
        assert len(wide[0].contexts) > len(tight[0].contexts) > 0
        for _, p, _ in tight[0].contexts:
            assert p.count(UP) + p.count(DOWN) + 1 <= 4 + 1

    def test_operator_suffixed_nodes(self):
        assert any("BinOp:*" in p for _, p, _ in
                   contexts_of("def f(a, b):\n    return a * b\n", "f").contexts)
        assert any("Compare:<" in p for _, p, _ in
                   contexts_of("def f(a, b):\n    return a < b\n", "f").contexts)


class TestMethodFilter:
    def test_dunders_and_trivial_accessors_skipped(self):
        src = ("class A:\n    def __init__(self):\n        self.x = 1\n"
               "    def __repr__(self):\n        return str(self.x)\n"
               "    def get_x(self):\n        return self.x\n"
               "    def set_x(self, v):\n        self.x = v\n"
               "    def busy(self, v):\n        w = v * 2\n        return w + 1\n")
        assert [m.label for m in both(src)] == ["busy"]

    def test_docstring_only_skipped(self):
        assert both('def doc_only():\n    """just a doc"""\n') == []

    def test_nested_defs_extracted_separately(self):
        src = ("def outer(a):\n    def inner(b):\n        return b * 2\n"
               "    return inner(a) + a\n")
        assert sorted(m.label for m in both(src)) == ["inner", "outer"]


def write_sources(root: Path):
    (root / "src").mkdir()
    (root / "src" / "MathOps.java").write_text(
        "public class MathOps {\n    public static int add(int a, int b) { return a + b; }\n}\n")
    (root / "src" / "math_ops.py").write_text(
        "def add(a, b):\n    return a + b\n\ndef scale(v, k):\n    return v * k\n")
    (root / "src" / "nums.py").write_text("def pick(a):\n    return a + 42\n")
    (root / "dataset").mkdir()


def run_both_clis(tmp_path, methods_txt, args=()):
    """The port's and JAX's extractor CLIs over the same methods.txt and
    sources: the two dataset dirs."""
    out = {}
    for who in ("port", "jax"):
        root = tmp_path / who
        root.mkdir()
        write_sources(root)
        (root / "dataset" / "methods.txt").write_text(methods_txt)
        argv = [str(root / "dataset"), str(root), *args]
        if who == "port":
            assert extractor.main(argv + ["--no_cuda"]) == 0
        else:
            jax_extractor.main(argv)
        out[who] = root / "dataset"
    return out["port"], out["jax"]


class TestMergedDataset:
    def test_mixed_cli_merges_vocab_and_loads(self, tmp_path, capfd):
        port, ref = run_both_clis(tmp_path, "src/MathOps.java\t*\nsrc/math_ops.py\t*\n")
        err = capfd.readouterr().err
        assert err.count("(1 java + 2 python)") == 2  # the port's line, then JAX's
        assert_same_artifacts(port, ref)
        data = load_corpus(port / "corpus.txt", port / "path_idxs.txt",
                           port / "terminal_idxs.txt")
        assert data.n_items == 3
        np.testing.assert_array_equal(data.ids, [0, 1, 2])
        assert data.labels[0] == data.labels[1]
        java_terms = set(data.starts[: data.row_splits[1]])
        py_terms = set(data.starts[data.row_splits[1]: data.row_splits[2]])
        assert java_terms & py_terms

    def test_missing_file_warns_and_continues(self, tmp_path):
        rows = [("src/gone.py", "*"), ("src/math_ops.py", "*")]
        got = {}
        for who, mod in (("port", pyextract), ("jax", jax_pyextract)):
            (tmp_path / who).mkdir()
            write_sources(tmp_path / who)
            n, vocabs = mod.extract_python_dataset(str(tmp_path / who / "dataset"),
                                                   str(tmp_path / who), rows)
            got[who] = (n, vocabs.terminals, vocabs.paths)
        assert got["port"] == got["jax"] and got["port"][0] == 2
        assert_same_artifacts(tmp_path / "port" / "dataset", tmp_path / "jax" / "dataset")

    def test_normalization_flags_reach_python_leg(self, tmp_path):
        port, ref = run_both_clis(tmp_path, "src/nums.py\t*\n", ["--normalize-int"])
        assert_same_artifacts(port, ref)
        terms = (port / "terminal_idxs.txt").read_text()
        assert "@int_literal" in terms and "\t42\n" not in terms
        assert "nomalize_int_literal:true" in (port / "params.txt").read_text()

    def test_method_declarations_cover_python_leg(self, tmp_path):
        port, ref = run_both_clis(tmp_path, "src/MathOps.java\t*\nsrc/math_ops.py\t*\n",
                                  ["--method-declarations", "decls.txt"])
        assert_same_artifacts(port, ref, extra=("decls.txt",))
        decls = (port / "decls.txt").read_text()
        assert "src/MathOps.java#add" in decls and "src/math_ops.py#scale" in decls

    def test_python_only_dataset(self, tmp_path):
        rows = [("src/math_ops.py", "*")]
        for who, mod in (("port", pyextract), ("jax", jax_pyextract)):
            (tmp_path / who).mkdir()
            write_sources(tmp_path / who)
            n, _ = mod.extract_python_dataset(str(tmp_path / who / "dataset"),
                                              str(tmp_path / who), rows)
            assert n == 2
        assert_same_artifacts(tmp_path / "port" / "dataset", tmp_path / "jax" / "dataset")
        corpus = (tmp_path / "port" / "dataset" / "corpus.txt").read_text()
        assert corpus.startswith("#0\nlabel:add\n")


# ---------------------------------------------------------------------------
# real sources: examples/python and the frozen package's files
# ---------------------------------------------------------------------------


SOURCES = sorted((PYTHON / "src" / "util").glob("*.py")) + [REPO / p for p in PACKAGE_FILES]


@pytest.mark.parametrize("config", CONFIGS.values(), ids=CONFIGS.keys())
@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(REPO).as_posix())
def test_extract_python_source_matches_jax(path, config):
    methods = both(path.read_text(), **config)
    assert methods and all(m.contexts for m in methods)
    name = methods[-1].label
    assert [m.label for m in both(path.read_text(), name, **config)] == \
        [m.label for m in methods if m.label == name]


@pytest.mark.parametrize("config", CONFIGS.values(), ids=CONFIGS.keys())
@pytest.mark.parametrize("corpus", ["examples", "package"])
def test_extract_python_dataset_is_byte_identical_to_jax(tmp_path, corpus, config):
    if corpus == "examples":
        source_dir = PYTHON
        rows = [tuple(line.split("\t")) for line in
                (PYTHON / "dataset" / "methods.txt").read_text().splitlines() if line]
    else:
        source_dir = REPO
        rows = [(p, "*") for p in PACKAGE_FILES] + [("code2vec_tpu/metrics.py", "no_such_name")]
    for who, mod in (("port", pyextract), ("jax", jax_pyextract)):
        (tmp_path / who).mkdir()
        n, _ = mod.extract_python_dataset(str(tmp_path / who), str(source_dir), rows,
                                          config=mod.PyExtractConfig(**config),
                                          method_declarations="decls.txt")
        assert n > 10
    assert_same_artifacts(tmp_path / "port", tmp_path / "jax", extra=("decls.txt",))


def test_merge_mode_extends_a_java_corpus_as_jax_does(tmp_path):
    """The merge leg alone: a Java corpus's vocab files preloaded, Python
    records appended after its ids."""
    for who, mod in (("port", pyextract), ("jax", jax_pyextract)):
        ds = tmp_path / who
        ds.mkdir()
        shutil.copy(JAVA / "dataset" / "methods.txt", ds / "methods.txt")
        extractor.extract_dataset(ds, JAVA)
        start = int((ds / "params.txt").read_text().split("method_count:")[1].split()[0])
        rows = [(f"src/util/{p.name}", "*") for p in sorted((PYTHON / "src" / "util").glob("*.py"))]
        n, _ = mod.extract_python_dataset(str(ds), str(PYTHON), rows, merge=True, start_id=start)
        assert n > start == 24
    assert_same_artifacts(tmp_path / "port", tmp_path / "jax")


# ---------------------------------------------------------------------------
# the CLI on a mixed dataset, and extract_dataset with a .py row
# ---------------------------------------------------------------------------


def mixed_tree(root: Path) -> Path:
    """examples/java and examples/python under one source root, and a
    methods.txt with both examples' rows (Java first)."""
    lines = []
    for example in (JAVA, PYTHON):
        shutil.copytree(example / "src", root / example.name / "src")
        lines += [f"{example.name}/{line}\n" for line in
                  (example / "dataset" / "methods.txt").read_text().splitlines() if line.strip()]
    ds = root / "dataset"
    ds.mkdir()
    (ds / "methods.txt").write_text("".join(lines))
    return ds


@pytest.mark.parametrize("args", [
    [], ["--normalize-int", "--no-normalize-string"], ["--max-length", "6", "--max-width", "2"],
    ["--no-normalize-double", "--method-declarations", "decls.txt"],
], ids=["default", "literals", "narrow", "declarations"])
def test_mixed_cli_is_byte_identical_to_jax(tmp_path, args):
    dirs = {}
    for who in ("port", "jax"):
        ds = mixed_tree(tmp_path / who)
        argv = [str(ds), str(tmp_path / who), *args]
        if who == "port":
            assert extractor.main(argv + ["--no_cuda"]) == 0
        else:
            jax_extractor.main(argv)
        dirs[who] = ds
    extra = ("decls.txt",) if "--method-declarations" in args else ()
    assert_same_artifacts(dirs["port"], dirs["jax"], extra=extra)
    data = jax_reader.load_corpus(str(dirs["port"] / "corpus.txt"),
                                  str(dirs["port"] / "path_idxs.txt"),
                                  str(dirs["port"] / "terminal_idxs.txt"), cache=False,
                                  native=False)
    assert data.n_items == 40  # 24 Java methods, then 16 Python functions
    np.testing.assert_array_equal(data.ids, np.arange(40))
    params = (dirs["port"] / "params.txt").read_text()
    # the Java leg's normalization flags reach the Python leg's params
    assert ("nomalize_int_literal:true" in params) == ("--normalize-int" in args)
    assert ("nomalize_string_literal:false" in params) == ("--no-normalize-string" in args)
    if "--normalize-int" in args:
        assert (dirs["port"] / "terminal_idxs.txt").read_text().count("@int_literal") == 1


def test_extract_dataset_with_a_python_row_does_what_jax_does(tmp_path):
    """``extract_dataset`` hands every row, a ``.py`` one too, to
    ``c2v-extract``, as JAX's does (the CLI is what routes ``.py`` rows to
    the Python leg)."""
    for who, fn in (("port", extractor.extract_dataset), ("jax", jax_extractor.extract_dataset)):
        ds = tmp_path / who
        ds.mkdir()
        (ds / "methods.txt").write_text("src/util/MathUtils.java\t*\nsrc/util/math_utils.py\t*\n")
        root = tmp_path / f"{who}_src"
        shutil.copytree(JAVA / "src", root / "src")
        shutil.copy(PYTHON / "src" / "util" / "math_utils.py", root / "src" / "util")
        fn(str(ds), str(root))
    assert_same_artifacts(tmp_path / "port", tmp_path / "jax")
    assert "class:src/util/MathUtils.java" in (tmp_path / "port" / "corpus.txt").read_text()
