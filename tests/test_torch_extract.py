"""Java source extraction and prediction from source, the port against the
JAX package, on the CPU.

- ``extract_dataset`` over ``examples/java`` writes the five artifacts
  byte for byte as JAX ``extract_dataset`` writes them (default caps,
  narrower caps, literal flags); ``extract_source`` gives JAX's records.
- A method-task and a variable-task model trained by JAX ``train()`` on
  that corpus, the weights carried to the port (``interop``): the port's
  ``predict_source`` / ``predict_variables`` give JAX ``Predictor``'s
  names, ``target_variable``s, context and OOV counts and attention
  contexts, the probabilities within rtol 1e-5 / atol 1e-6; the predict
  CLI prints what JAX's prints.
- The port's server: a ``source`` request answers as the ``contexts``
  request of the same method (``predict``, ``embed``, ``neighbors``), a
  method whose every context is OOV gets an entry and no device work.
- The ``--task`` rules and the variable-only guard raise as in JAX; a
  Python source answers as JAX's ``Predictor`` answers it, a ``.py`` row
  of ``methods.txt`` is extracted as JAX extracts it.
"""

import io
import json
import shutil
from contextlib import redirect_stdout
from pathlib import Path

import jax
import numpy as np
import pytest

from code2vec_tpu import extractor as jax_extractor
from code2vec_tpu.data import reader as jax_reader
from code2vec_tpu.predict import Predictor as JaxPredictor
from code2vec_tpu.predict import main as jax_predict_main
from code2vec_tpu.train import loop as jax_loop
from code2vec_tpu.train.config import TrainConfig as JaxTrainConfig
from code2vec_tpu_torch import extractor, interop
from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig
from code2vec_tpu_torch.predict import Predictor, save_model_file
from code2vec_tpu_torch.predict import main as predict_main

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples" / "java"
SOURCES = sorted((EXAMPLES / "src" / "util").glob("*.java"))
ARTIFACTS = ("corpus.txt", "terminal_idxs.txt", "path_idxs.txt", "params.txt",
             "actual_methods.txt")
TRAIN_KW = dict(terminal_embed_size=8, path_embed_size=6, encode_size=12, batch_size=8,
                max_path_length=64, max_epoch=1, dropout_prob=0.0, random_seed=3,
                print_sample_cycle=0)


def dataset(tmp_path: Path, name: str) -> Path:
    out = tmp_path / name
    out.mkdir()
    shutil.copy(EXAMPLES / "dataset" / "methods.txt", out / "methods.txt")
    return out


@pytest.mark.parametrize("kw", [
    {}, {"max_length": 6, "max_width": 2},
    {"extra_args": ["--no-normalize-string", "--normalize-int"]},
], ids=["default", "narrow", "literals"])
def test_extract_dataset_is_byte_identical_to_jax(tmp_path, kw):
    port, ref = dataset(tmp_path, "port"), dataset(tmp_path, "jax")
    extractor.extract_dataset(port, EXAMPLES, **kw)
    jax_extractor.extract_dataset(str(ref), str(EXAMPLES), **kw)
    for name in ARTIFACTS:
        assert (port / name).read_bytes() == (ref / name).read_bytes(), name
    assert len((port / "corpus.txt").read_text().splitlines()) > 100


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.stem)
def test_extract_source_matches_jax(path):
    source = path.read_text()
    for kw in ({}, {"method_name": "gcd"}, {"max_length": 4, "normalize_int": True}):
        got = extractor.extract_source(source, **kw)
        want = jax_extractor.extract_source(source, **kw)
        assert got.terminal_vocab == want.terminal_vocab and got.path_vocab == want.path_vocab
        assert [(m.label, m.path_contexts, m.aliases) for m in got.methods] == \
            [(m.label, m.path_contexts, m.aliases) for m in want.methods]


def test_the_build_lands_in_the_port_build_dir():
    out = extractor.build_extractor()
    assert out.parent == REPO / "build" / "code2vec_tpu_torch"
    assert out.name == f"extractor-{extractor.source_digest()}"
    assert sorted(p.name for p in out.iterdir()) == ["c2v-extract", "libc2v.so"]
    assert extractor.build_extractor() == out


def test_a_failed_build_raises_with_the_compiler_stderr(monkeypatch, tmp_path):
    src = tmp_path / "src"
    shutil.copytree(extractor.SOURCE_DIR, src)
    (src / "lexer.cc").write_text("this is not C++\n")
    monkeypatch.setattr(extractor, "SOURCE_DIR", src)
    monkeypatch.setattr(extractor, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on extractor/src/lexer.cc"):
        extractor.build_extractor()
    assert not list((tmp_path / "build").iterdir())  # nothing half-built left in place


CONCURRENT_BUILD = """
import sys, time
from pathlib import Path
from code2vec_tpu_torch import extractor

root, log = Path(sys.argv[1]), Path(sys.argv[2])


def fake_compile(cxx, out_dir):
    with open(log, "a") as f:
        f.write("compile\\n")
    time.sleep(0.5)
    for name in (extractor.BINARY, extractor.LIBRARY):
        (out_dir / name).write_text("built")


extractor.BUILD_ROOT = root
extractor._compile = fake_compile
print(extractor.build_extractor())
"""


def test_concurrent_builds_compile_once(tmp_path):
    """Processes that ask for the extractor at once (test workers, a
    server beside a trainer) wait on the build root's lock: one compiles,
    the others find its build in place."""
    import os
    import subprocess
    import sys

    env = {**os.environ, "PYTHONPATH": str(REPO)}
    log = tmp_path / "compiles.log"
    procs = [subprocess.Popen([sys.executable, "-c", CONCURRENT_BUILD, str(tmp_path / "build"),
                               str(log)], stdout=subprocess.PIPE, text=True, env=env, cwd=REPO)
             for _ in range(3)]
    outs = [proc.communicate(timeout=120)[0].strip() for proc in procs]
    assert [proc.returncode for proc in procs] == [0, 0, 0]
    assert len(set(outs)) == 1 and Path(outs[0]).parent == tmp_path / "build"
    assert log.read_text().splitlines() == ["compile"]
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == [Path(outs[0]).name]


# ---------------------------------------------------------------------------
# models trained by JAX, served by the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The extracted corpus and two model dirs (method task, variable
    task), each trained by JAX and given the port's ``code2vec.model``
    from the weights JAX's ``Predictor`` restores."""
    root = tmp_path_factory.mktemp("extract_models")
    ds = dataset(root, "ds")
    extractor.extract_dataset(ds, EXAMPLES)
    vocab = (str(ds / "terminal_idxs.txt"), str(ds / "path_idxs.txt"))
    out = {"ds": ds, "vocab": vocab}
    for task, (im, iv) in {"method": (True, False), "variable": (False, True)}.items():
        model_dir = root / task
        data = jax_reader.load_corpus(str(ds / "corpus.txt"), vocab[1], vocab[0],
                                      infer_method=im, infer_variable=iv, cache=False,
                                      native=False)
        cfg = JaxTrainConfig(**TRAIN_KW, infer_method_name=im, infer_variable_name=iv)
        jax_loop.train(cfg, data, out_dir=str(model_dir),
                       vectors_path=str(model_dir / "code.vec"), sinks=())
        jax_pred = JaxPredictor(str(model_dir), *vocab)
        params = jax.tree.map(np.asarray, jax_pred.state.params)
        meta = json.loads((model_dir / "model_meta.json").read_text())
        port_cfg = Code2VecConfig(
            terminal_count=meta["terminal_count"], path_count=meta["path_count"],
            label_count=meta["label_count"], terminal_embed_size=8, path_embed_size=6,
            encode_size=12)
        model = Code2Vec(port_cfg)
        model.load_state_dict(interop.state_dict_from_jax_params(params, port_cfg))
        save_model_file(str(model_dir), model)
        out[task] = (model_dir, jax_pred, Predictor(str(model_dir), *vocab, device="cpu"))
    return out


def assert_predictions_match(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.method_name, g.n_contexts, g.n_oov, g.target_variable) == \
            (w.method_name, w.n_contexts, w.n_oov, w.target_variable)
        assert [p.name for p in g.predictions] == [p.name for p in w.predictions]
        np.testing.assert_allclose([p.prob for p in g.predictions],
                                   [p.prob for p in w.predictions], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g.code_vector, w.code_vector, rtol=1e-5, atol=1e-6)
        assert sorted(a[:3] for a in g.attention) == sorted(a[:3] for a in w.attention)
        np.testing.assert_allclose(sorted(a[3] for a in g.attention),
                                   sorted(a[3] for a in w.attention), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.stem)
def test_predict_source_matches_jax(models, path):
    _, jax_pred, pred = models["method"]
    source = path.read_text()
    assert_predictions_match(pred.predict_source(source, top_k=3),
                             jax_pred.predict_source(source, top_k=3))
    name = jax_extractor.extract_source(source).methods[-1].label
    assert_predictions_match(pred.predict_source(source, name, top_k=2),
                             jax_pred.predict_source(source, name, top_k=2))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.stem)
def test_predict_variables_matches_jax(models, path):
    _, jax_pred, pred = models["variable"]
    source = path.read_text()
    got = pred.predict_variables(source, top_k=3)
    assert_predictions_match(got, jax_pred.predict_variables(source, top_k=3))
    assert all(m.target_variable and m.method_name.endswith("." + m.target_variable)
               for m in got)


def test_extraction_caps_come_from_params_txt(models):
    _, jax_pred, pred = models["method"]
    assert pred.extract_params == jax_pred.extract_params
    assert pred.extract_params["max_length"] == 8


@pytest.mark.parametrize("task", ["method", "variable"])
def test_predict_cli_prints_what_jax_prints(models, task):
    model_dir, _, _ = models[task]
    args = [str(EXAMPLES / "src" / "util" / "MathUtils.java"), "--model_path", str(model_dir),
            "--terminal_idx_path", models["vocab"][0], "--path_idx_path", models["vocab"][1],
            "--top_k", "3", "--show_attention", "2", "--neighbors", "2"]
    outs = []
    for main in (predict_main, jax_predict_main):
        buf = io.StringIO()
        with redirect_stdout(buf):
            main(args + (["--no_cuda"] if main is predict_main else []))
        outs.append(buf.getvalue().splitlines())
    got, want = outs
    assert len(got) == len(want) > 0
    # the last word of each line (a count, a label, a terminal, a neighbour)
    # agrees; the printed numbers agree to rounding
    def last_words(lines):
        return [line.split()[-1] for line in lines]

    assert last_words(got) == last_words(want)


def test_task_rules_raise_as_in_jax(models):
    source = (EXAMPLES / "src" / "util" / "MathUtils.java").read_text()
    for task, call in (("variable", "predict_source"), ("method", "predict_variables")):
        _, jax_pred, pred = models[task]
        with pytest.raises(ValueError) as want:
            getattr(jax_pred, call)(source)
        with pytest.raises(ValueError) as got:
            getattr(pred, call)(source)
        assert str(got.value).split(";")[0] == str(want.value).split(";")[0]
    # --task auto follows the model: a variable-only model predicts variables
    model_dir, _, _ = models["variable"]
    buf = io.StringIO()
    with redirect_stdout(buf):
        predict_main([str(EXAMPLES / "src" / "util" / "MathUtils.java"), "--no_cuda",
                      "--model_path", str(model_dir), "--terminal_idx_path", models["vocab"][0],
                      "--path_idx_path", models["vocab"][1], "--method_name", "gcd"])
    assert buf.getvalue().startswith("gcd.")
    with pytest.raises(ValueError, match="variable-name task only"):
        predict_main([str(EXAMPLES / "src" / "util" / "MathUtils.java"), "--no_cuda",
                      "--task", "method", "--model_path", str(model_dir),
                      "--terminal_idx_path", models["vocab"][0],
                      "--path_idx_path", models["vocab"][1]])


def test_python_sources_are_not_ported(models, tmp_path):
    """Python sources are ported now: each place that raised answers as
    JAX does (a model trained on Java maps a Python method's contexts as
    JAX's Predictor maps them; the mixed datasets and whole files are held
    in tests/test_torch_pyextract.py and tests/test_torch_file_vectors.py)."""
    py_file = REPO / "examples" / "python" / "src" / "util" / "math_utils.py"
    py_source = py_file.read_text()
    _, jax_pred, pred = models["method"]
    assert_predictions_match(pred.predict_source(py_source, language="python", top_k=2),
                             jax_pred.predict_source(py_source, language="python", top_k=2))
    _, jax_pred, pred = models["variable"]
    assert_predictions_match(pred.predict_variables(py_source, language="python", top_k=2),
                             jax_pred.predict_variables(py_source, language="python", top_k=2))
    with pytest.raises(ValueError, match="unknown language"):
        pred.predict_variables(py_source, language="cobol")
    # a .py row: extract_dataset hands it to c2v-extract as JAX's does, the
    # CLI takes the mixed route as JAX's does
    for who in ("port", "jax"):
        for form in ("dataset", "cli"):
            ds = tmp_path / f"{who}_{form}"
            ds.mkdir()
            (ds / "methods.txt").write_text("examples/java/src/util/MathUtils.java\t*\n"
                                            "examples/python/src/util/math_utils.py\t*\n")
            if form == "dataset":
                (extractor if who == "port" else jax_extractor).extract_dataset(str(ds),
                                                                                str(REPO))
            elif who == "port":
                assert extractor.main([str(ds), str(REPO), "--no_cuda"]) == 0
            else:
                jax_extractor.main([str(ds), str(REPO)])
    for form in ("dataset", "cli"):
        for name in ARTIFACTS:
            assert (tmp_path / f"port_{form}" / name).read_bytes() == \
                (tmp_path / f"jax_{form}" / name).read_bytes(), (form, name)
    # the predict CLI on a .py file prints what JAX's prints
    model_dir, _, _ = models["method"]
    args = [str(py_file), "--model_path", str(model_dir),
            "--terminal_idx_path", models["vocab"][0], "--path_idx_path", models["vocab"][1]]
    outs = []
    for main in (predict_main, jax_predict_main):
        buf = io.StringIO()
        with redirect_stdout(buf):
            main(args + (["--no_cuda"] if main is predict_main else []))
        outs.append(buf.getvalue().splitlines())
    assert len(outs[0]) == len(outs[1]) > 0
    assert [line.split()[-1] for line in outs[0]] == [line.split()[-1] for line in outs[1]]


def test_extractor_cli_writes_the_dataset(tmp_path):
    ds = dataset(tmp_path, "cli")
    assert extractor.main([str(ds), str(EXAMPLES), "--no_cuda"]) == 0
    assert all((ds / name).exists() for name in ARTIFACTS)


# ---------------------------------------------------------------------------
# the server: source requests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def server(models):
    from code2vec_tpu_torch.serve.__main__ import build_parser, build_server

    model_dir, _, _ = models["method"]
    args = build_parser().parse_args([
        "--model_path", str(model_dir), "--terminal_idx_path", models["vocab"][0],
        "--path_idx_path", models["vocab"][1], "--device", "cpu", "--deadline_ms", "0.5",
        "--code_vec_path", str(model_dir / "code.vec")])
    srv = build_server(args)
    yield srv
    srv.close()


def test_the_server_loads_the_extractor_in_its_warmup(models, monkeypatch):
    """``build_server`` builds (if need be) and loads the extractor before
    the first request, and reports the time in ``health``: no ``source``
    request waits for ``g++``."""
    from code2vec_tpu_torch.serve.__main__ import build_parser, build_server

    model_dir, _, _ = models["method"]
    monkeypatch.setattr(extractor, "_lib", None)
    srv = build_server(build_parser().parse_args([
        "--model_path", str(model_dir), "--terminal_idx_path", models["vocab"][0],
        "--path_idx_path", models["vocab"][1], "--device", "cpu"]))
    try:
        assert extractor._lib is not None
        health = srv.handle({"op": "health"})
        assert health["ok"] and health["extractor_ms"] > 0

        def no_build():
            raise AssertionError("a request built the extractor")

        monkeypatch.setattr(extractor, "build_extractor", no_build)
        source = (EXAMPLES / "src" / "util" / "MathUtils.java").read_text()
        got = srv.handle({"op": "predict", "source": source, "method_name": "gcd"})
        assert got["ok"] and got["methods"][0]["method_name"] == "gcd"
    finally:
        srv.close()


@pytest.mark.parametrize("op", ["predict", "embed", "neighbors"])
@pytest.mark.parametrize("method", ["clamp", "gcd", "mean"])
def test_source_request_equals_contexts_request(server, op, method):
    pred = server.predictor
    source = (EXAMPLES / "src" / "util" / "MathUtils.java").read_text()
    (label, contexts, _), = pred._extract(source, method, "java")
    mapped, n_oov = pred._map_contexts(contexts)
    common = {"op": op, "top_k": 3, "include_vector": True}
    by_source = server.handle({**common, "source": source, "method_name": method})
    by_contexts = server.handle({**common, "contexts": [list(c) for c in mapped],
                                 "method_name": method})
    assert by_source["ok"] and by_contexts["ok"]
    assert by_source["extract_ms"] > 0 and "extract_ms" not in by_contexts
    (a,), (b,) = by_source["methods"], by_contexts["methods"]
    assert a["method_name"] == b["method_name"] == label == method
    # over-long bags (clamp and mean hold more than the bag of 64) take the
    # same seeded subsample in both forms
    assert (a["n_contexts"], a["n_oov"]) == (min(len(mapped), server.engine.max_width), n_oov)
    assert b["n_contexts"] == a["n_contexts"]
    for key in ("predictions", "neighbors"):
        assert a.get(key) == b.get(key), key
    np.testing.assert_array_equal(a["code_vector"], b["code_vector"])


def test_source_request_covers_every_method_and_oov(server):
    source = (EXAMPLES / "src" / "util" / "MathUtils.java").read_text()
    resp = server.handle({"op": "predict", "source": source, "top_k": 1})
    names = [m["method_name"] for m in resp["methods"]]
    assert names == [m.method_name for m in server.predictor.predict_source(source, top_k=1)]
    unseen = "class Q { void qq() { zzqqxx(yyqqww); } }"
    resp = server.handle({"op": "embed", "source": unseen})
    (entry,) = resp["methods"]
    assert resp["ok"] and entry["n_contexts"] == 0 and entry["n_oov"] > 0
    assert "error" in entry and "code_vector" not in entry and "timing" not in entry
    resp = server.handle({"op": "predict", "source": "   "})
    assert resp["error_kind"] == "bad_request"
