"""Whole-file vectors and Python sources end to end, the port against the
JAX package, on the CPU.

- ``models/hierarchical``: ``pool_vectors`` and ``pool_vectors_by_group``
  bitwise JAX's (both pool in float64 numpy); ``HierarchicalAttentionPool``
  against the flax module with the same ``file_attention`` (carried both
  ways by ``interop``): rtol 1e-5 / atol 1e-6, JAX's own bar
  (``tests/test_longbag.py:492-545``), an all-masked group uniform over M.
- ``export.export_file_vectors``: ``file.vec`` byte for byte JAX's, read
  back and retrieved (each file its own nearest row, similarity within
  1e-4 of 1).
- A method-task and a variable-task model trained by JAX ``train()`` on the
  mixed ``examples/java`` + ``examples/python`` corpus (the port's
  extractor CLI), the weights carried to the port: for Python sources the
  port's ``predict_source``, ``predict_variables``, ``embed_file`` and the
  predict CLI give JAX ``Predictor``'s names, counts and order, vectors and
  probabilities within rtol 1e-5 / atol 1e-6; the port's server answers
  ``embed_file`` and ``neighbors`` at ``granularity="file"`` as JAX's
  ``CodeServer`` does on the same ``file.vec`` (vectors within rtol 1e-5 /
  atol 1e-6, similarities within 1e-5), on the exact and the IVF-PQ backend.
- ``code2vec_tpu_torch/tools/ann_build.py`` against ``tools/ann_build.py``
  on the same ``file.vec``: on the CPU the containers are byte-identical
  (the port's k-means and PQ are bitwise JAX's there), the summary line
  the same but for ``out`` and ``build_seconds``.
"""

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from code2vec_tpu.data import reader as jax_reader
from code2vec_tpu.export import export_file_vectors as jax_export_file_vectors
from code2vec_tpu.models import hierarchical as jax_hier
from code2vec_tpu.predict import Predictor as JaxPredictor
from code2vec_tpu.predict import main as jax_predict_main
from code2vec_tpu.train import loop as jax_loop
from code2vec_tpu.train.config import TrainConfig as JaxTrainConfig
from code2vec_tpu_torch import extractor, interop
from code2vec_tpu_torch.export import export_file_vectors
from code2vec_tpu_torch.formats.vectors_io import read_code_vectors
from code2vec_tpu_torch.models import hierarchical
from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig
from code2vec_tpu_torch.models.hierarchical import (
    HierarchicalAttentionPool,
    pool_vectors,
    pool_vectors_by_group,
)
from code2vec_tpu_torch.predict import Predictor, save_model_file
from code2vec_tpu_torch.predict import main as predict_main
from code2vec_tpu_torch.serve.retrieval import RetrievalIndex
from code2vec_tpu_torch.tools import ann_build
from tests.test_torch_extract import TRAIN_KW, assert_predictions_match
from tests.test_torch_pyextract import mixed_tree

REPO = Path(__file__).resolve().parent.parent
PY_SOURCES = sorted((REPO / "examples" / "python" / "src" / "util").glob("*.py"))
JAVA_SOURCE = REPO / "examples" / "java" / "src" / "util" / "MathUtils.java"
RTOL, ATOL = 1e-5, 1e-6


# ---------------------------------------------------------------------------
# the pools
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("attn", [True, False], ids=["attention", "mean"])
@pytest.mark.parametrize("n,h,groups", [(6, 4, 3), (40, 12, 7), (1, 8, 1), (64, 100, 64)])
def test_pool_vectors_by_group_is_bitwise_jax(attn, n, h, groups):
    rng = np.random.default_rng(n * h)
    vectors = rng.normal(size=(n, h)).astype(np.float32) * 3.0
    param = rng.normal(size=h).astype(np.float32) if attn else None
    ids = [f"f{int(g)}.py" for g in rng.integers(0, groups, n)]
    keys, pooled = pool_vectors_by_group(vectors, ids, param)
    jkeys, jpooled = jax_hier.pool_vectors_by_group(vectors, ids, param)
    assert keys == jkeys == list(dict.fromkeys(ids))  # first appearance
    assert pooled.dtype == np.float32
    np.testing.assert_array_equal(pooled, jpooled)
    np.testing.assert_array_equal(pool_vectors(vectors, param),
                                  jax_hier.pool_vectors(vectors, param))


def test_group_pooling_matches_manual_softmax():
    """JAX's own case (tests/test_longbag.py:493-518) on the port."""
    rng = np.random.default_rng(0)
    vectors = rng.normal(size=(6, 4)).astype(np.float32)
    attn = rng.normal(size=4).astype(np.float32)
    groups = ["a.java", "b.java", "a.java", "c.java", "b.java", "a.java"]
    keys, pooled = pool_vectors_by_group(vectors, groups, attn)
    assert keys == ["a.java", "b.java", "c.java"]
    rows = vectors[[0, 2, 5]]
    s = rows @ attn
    w = np.exp(s - s.max())
    np.testing.assert_allclose(pooled[0], ((w / w.sum()) @ rows).astype(np.float32), rtol=1e-6)
    _, mean = pool_vectors_by_group(vectors, groups, None)
    np.testing.assert_allclose(mean[2], vectors[[3]].mean(axis=0), rtol=1e-6)
    for fn in (pool_vectors, jax_hier.pool_vectors):
        with pytest.raises(ValueError, match="non-empty"):
            fn(np.zeros((0, 4), np.float32), attn)
    for mod in (hierarchical, jax_hier):
        with pytest.raises(ValueError, match="group ids"):
            mod.pool_vectors_by_group(vectors, groups[:5], attn)
        keys, empty = mod.pool_vectors_by_group(np.zeros((0, 4), np.float32), [], attn)
        assert keys == [] and empty.shape == (0, 4) and empty.dtype == np.float32


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_module_matches_flax(direction):
    G, M, H = 4, 5, 8
    rng = np.random.default_rng(1)
    vectors = rng.normal(size=(G, M, H)).astype(np.float32)
    mask = np.ones((G, M), np.float32)
    mask[1, 3:] = 0.0  # a padded group
    mask[3] = 0.0  # an all-masked group
    flax_module = jax_hier.HierarchicalAttentionPool(encode_size=H)
    module = HierarchicalAttentionPool(H, generator=torch.Generator().manual_seed(5))
    if direction == "jax_to_port":
        params = jax.tree.map(np.asarray, flax_module.init(jax.random.PRNGKey(0), vectors,
                                                           mask)["params"])
        module.load_state_dict(interop.hierarchical_state_dict_from_jax_params(params))
    else:
        params = interop.jax_params_from_hierarchical_state_dict(module.state_dict())
    np.testing.assert_array_equal(
        interop.jax_params_from_hierarchical_state_dict(module.state_dict())["file_attention"],
        params["file_attention"])
    want_fv, want_w = flax_module.apply({"params": params}, vectors, mask)
    with torch.no_grad():
        fv, w = module(torch.from_numpy(vectors), torch.from_numpy(mask))
    assert fv.dtype == w.dtype == torch.float32
    np.testing.assert_allclose(fv.numpy(), np.asarray(want_fv), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(want_w), rtol=RTOL, atol=ATOL)
    for g in range(3):
        real = vectors[g][mask[g].astype(bool)]
        np.testing.assert_allclose(fv[g].numpy(), pool_vectors(real, params["file_attention"]),
                                   rtol=RTOL, atol=ATOL)
    assert w[1, 3:].max() < 1e-30
    np.testing.assert_allclose(w[3].numpy(), np.full(M, 1.0 / M), rtol=1e-6)


def test_module_init_is_seeded_with_the_reference_std():
    H = 4096
    a = HierarchicalAttentionPool(H, generator=torch.Generator().manual_seed(3))
    b = HierarchicalAttentionPool(H, generator=torch.Generator().manual_seed(3))
    c = HierarchicalAttentionPool(H, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a.file_attention, b.file_attention)
    assert not torch.equal(a.file_attention, c.file_attention)
    assert list(dict(a.named_parameters())) == ["file_attention"]
    std = float(a.file_attention.detach().std())
    assert abs(std / np.sqrt(2.0 / (H + 1)) - 1) < 0.05  # 4096 draws: ~1.1% sampling error


def test_export_file_vectors_matches_jax_and_retrieves(tmp_path):
    """JAX's case (tests/test_longbag.py:547-578) on the port, the file
    byte for byte JAX's."""
    rng = np.random.default_rng(2)
    method_vectors = rng.normal(size=(12, 8)).astype(np.float32)
    groups = [f"file_{i % 4}.java" for i in range(12)]
    attn = rng.normal(size=8).astype(np.float32)
    names = {g: f"src/{g}" for g in groups}
    for kw in ({}, {"group_names": names}, {"attn_param": None}):
        kw = {"attn_param": attn, **kw}
        path, ref = tmp_path / "file.vec", tmp_path / "jax.vec"
        keys, pooled = export_file_vectors(method_vectors, groups, str(path), **kw)
        jkeys, jpooled = jax_export_file_vectors(method_vectors, groups, str(ref), **kw)
        assert path.read_bytes() == ref.read_bytes()
        assert keys == jkeys and len(keys) == 4 and pooled.shape == (4, 8)
        np.testing.assert_array_equal(pooled, jpooled)
        labels, rows = read_code_vectors(path)
        want = [str(kw["group_names"][k]) if "group_names" in kw else str(k) for k in keys]
        assert labels == want
        np.testing.assert_array_equal(rows, pooled)
        index = RetrievalIndex.from_code_vec(str(path), device="cpu")
        for g, label in enumerate(labels):
            (name, sim), _ = index.top_k(pooled[g], 2)
            assert name == label and sim == pytest.approx(1.0, abs=1e-4)


# ---------------------------------------------------------------------------
# models trained by JAX on a mixed corpus, served by the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The mixed examples corpus (the port's extractor CLI) and two model
    dirs (method task, variable task) trained by JAX, each given the
    port's ``code2vec.model`` from the weights JAX's ``Predictor`` restores."""
    root = tmp_path_factory.mktemp("file_vectors")
    ds = mixed_tree(root / "corpus")
    assert extractor.main([str(ds), str(root / "corpus"), "--no_cuda"]) == 0
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


def test_the_corpus_holds_both_languages(models):
    actual = (models["ds"] / "actual_methods.txt").read_text().splitlines()
    files = [line.split("\t")[0] for line in actual]
    assert sum(f.endswith(".java") for f in files) == 24
    assert sum(f.endswith(".py") for f in files) == 16


@pytest.mark.parametrize("path", PY_SOURCES, ids=lambda p: p.stem)
def test_predict_source_python_matches_jax(models, path):
    _, jax_pred, pred = models["method"]
    source = path.read_text()
    want = jax_pred.predict_source(source, language="python", top_k=3)
    assert_predictions_match(pred.predict_source(source, language="python", top_k=3), want)
    name = want[-1].method_name
    assert_predictions_match(pred.predict_source(source, name, language="python", top_k=2),
                             jax_pred.predict_source(source, name, language="python", top_k=2))


@pytest.mark.parametrize("path", PY_SOURCES, ids=lambda p: p.stem)
def test_predict_variables_python_matches_jax(models, path):
    _, jax_pred, pred = models["variable"]
    source = path.read_text()
    got = pred.predict_variables(source, language="python", top_k=3)
    assert_predictions_match(got, jax_pred.predict_variables(source, language="python", top_k=3))
    assert all(m.method_name.endswith("." + m.target_variable) for m in got)


def test_python_extraction_follows_params_txt(models, tmp_path):
    """The corpus's caps reach the Python leg as JAX's Predictor passes
    them: a narrower params.txt gives JAX's (fewer) contexts."""
    model_dir, _, _ = models["method"]
    narrow = tmp_path / "vocab"
    narrow.mkdir()
    for name in ("terminal_idxs.txt", "path_idxs.txt"):
        (narrow / name).write_bytes((models["ds"] / name).read_bytes())
    params = (models["ds"] / "params.txt").read_text().replace("max_length:8", "max_length:5")
    (narrow / "params.txt").write_text(params)
    vocab = (str(narrow / "terminal_idxs.txt"), str(narrow / "path_idxs.txt"))
    pred, jax_pred = Predictor(str(model_dir), *vocab, device="cpu"), JaxPredictor(str(model_dir),
                                                                                  *vocab)
    assert pred.extract_params == jax_pred.extract_params and pred.extract_params["max_length"] == 5
    source = PY_SOURCES[0].read_text()
    assert pred._extract(source, "*", "python") == jax_pred._extract(source, "*", "python")
    assert_predictions_match(pred.predict_source(source, language="python"),
                             jax_pred.predict_source(source, language="python"))


@pytest.mark.parametrize("path", PY_SOURCES + [JAVA_SOURCE], ids=lambda p: p.name)
def test_embed_file_matches_jax(models, path):
    _, jax_pred, pred = models["method"]
    language = "python" if path.suffix == ".py" else "java"
    source = path.read_text()
    vec, names = pred.embed_file(source, language=language)
    want_vec, want_names = jax_pred.embed_file(source, language=language)
    assert names == want_names and len(names) > 1
    assert vec.shape == (12,) and vec.dtype == np.float32
    np.testing.assert_allclose(vec, want_vec, rtol=RTOL, atol=ATOL)
    # the pool of the source's own method vectors, with the checkpoint's attention
    vectors = [m.code_vector for m in pred.predict_source(source, language=language)]
    np.testing.assert_array_equal(vec, pool_vectors(np.stack(vectors), pred.attention_vector()))
    np.testing.assert_array_equal(pred.attention_vector(),
                                  np.asarray(jax_pred.state.params["attention"], np.float32))
    one, one_names = pred.embed_file(source, language=language, method_name=names[0])
    assert one_names == [names[0]]


def test_embed_file_with_nothing_to_embed_raises_as_jax(models):
    _, jax_pred, pred = models["method"]
    for source in ('def only_doc():\n    """nothing here"""\n', "def zzq():\n    return zzqqxx.yyqqww\n"):
        with pytest.raises(ValueError) as want:
            jax_pred.embed_file(source, language="python")
        with pytest.raises(ValueError) as got:
            pred.embed_file(source, language="python")
        assert str(got.value) == str(want.value)


def test_predict_cli_on_a_python_file_prints_what_jax_prints(models):
    model_dir, _, _ = models["method"]
    args = [str(PY_SOURCES[1]), "--model_path", str(model_dir),
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
    assert [line.split()[-1] for line in got] == [line.split()[-1] for line in want]


# ---------------------------------------------------------------------------
# the server: embed_file and file-granularity neighbors, beside JAX's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def file_vec(models, tmp_path_factory):
    """``file.vec`` of the examples' Python files: each file's method
    vectors (the port's ``predict_source``) pooled by ``export_file_vectors``."""
    _, _, pred = models["method"]
    vectors, groups = [], []
    for path in PY_SOURCES:
        for m in pred.predict_source(path.read_text(), language="python"):
            vectors.append(m.code_vector)
            groups.append(path.name)
    path = tmp_path_factory.mktemp("file_vec") / "file.vec"
    export_file_vectors(np.stack(vectors), groups, str(path), attn_param=pred.attention_vector())
    return path


@pytest.fixture(scope="module")
def servers(models, file_vec, tmp_path_factory):
    """The port's server and JAX's over the method model and ``file.vec``
    (exact), plus the port's on the IVF-PQ index ``ann_build`` makes of it."""
    from code2vec_tpu.obs.runtime import RuntimeHealth
    from code2vec_tpu.serve.batcher import MicroBatcher as JaxBatcher
    from code2vec_tpu.serve.engine import ServingEngine as JaxEngine
    from code2vec_tpu.serve.protocol import CodeServer as JaxCodeServer
    from code2vec_tpu.serve.retrieval import RetrievalIndex as JaxRetrievalIndex
    from code2vec_tpu_torch.serve.__main__ import build_parser, build_server

    model_dir, jax_pred, _ = models["method"]
    index = tmp_path_factory.mktemp("ann") / "ann.index"
    with redirect_stdout(io.StringIO()):
        assert ann_build.main(["--code_vec", str(file_vec), "--out", str(index), "--n_list", "2",
                               "--m", "4", "--device", "cpu"]) == 0
    common = ["--model_path", str(model_dir), "--terminal_idx_path", models["vocab"][0],
              "--path_idx_path", models["vocab"][1], "--device", "cpu", "--deadline_ms", "0.5"]
    port = build_server(build_parser().parse_args(common + ["--code_vec_path", str(file_vec)]))
    ann = build_server(build_parser().parse_args(
        common + ["--retrieval_backend", "ann", "--ann_index_path", str(index)]))
    engine = JaxEngine.from_predictor(jax_pred, health=RuntimeHealth())
    engine.prepare()
    ref = JaxCodeServer(jax_pred, engine, JaxBatcher(engine, deadline_ms=0.0,
                                                     health=RuntimeHealth()),
                        retrieval=JaxRetrievalIndex.from_code_vec(str(file_vec)))
    yield {"port": port, "ann": ann, "jax": ref}
    for srv in (port, ann, ref):
        srv.close()


@pytest.mark.parametrize("path", PY_SOURCES, ids=lambda p: p.stem)
def test_server_embed_file_matches_jax(servers, models, path):
    req = {"id": 4, "op": "embed_file", "source": path.read_text(), "language": "python"}
    got, want = servers["port"].handle(req), servers["jax"].handle(req)
    assert got["ok"] and want["ok"] and got["id"] == want["id"] == 4
    assert got["extract_ms"] > 0  # the port's addition, as on predict and embed
    assert set(got) - {"extract_ms"} == set(want)
    assert (got["n_methods"], got["method_names"]) == (want["n_methods"], want["method_names"])
    np.testing.assert_allclose(got["file_vector"], want["file_vector"], rtol=RTOL, atol=ATOL)
    vec, names = models["method"][2].embed_file(path.read_text(), language="python")
    assert names == got["method_names"]
    np.testing.assert_allclose(got["file_vector"], vec, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("backend", ["port", "ann"])
@pytest.mark.parametrize("path", PY_SOURCES, ids=lambda p: p.stem)
def test_file_neighbors_match_jax(servers, path, backend):
    for include_vector in (False, True):
        req = {"op": "neighbors", "source": path.read_text(), "language": "python",
               "granularity": "file", "top_k": 3, "include_vector": include_vector}
        got, want = servers[backend].handle(req), servers["jax"].handle(req)
        assert got["ok"] and want["ok"]
        assert set(got) - {"extract_ms"} == set(want)
        assert ("file_vector" in got) == include_vector
        assert got["n_methods"] == want["n_methods"]
        assert [n["name"] for n in got["neighbors"]] == [n["name"] for n in want["neighbors"]]
        np.testing.assert_allclose([n["similarity"] for n in got["neighbors"]],
                                   [n["similarity"] for n in want["neighbors"]], atol=1e-5)
        assert got["neighbors"][0]["name"] == path.name
        assert got["neighbors"][0]["similarity"] == pytest.approx(1.0, abs=1e-4)


@pytest.mark.parametrize("req,kind", [
    ({"op": "embed_file", "source": 'def only_doc():\n    """x"""\n', "language": "python"},
     "bad_request"),
    ({"op": "neighbors", "source": "def zzq():\n    return zzqqxx.yyqqww\n", "language": "python",
      "granularity": "file"}, "bad_request"),
    ({"op": "neighbors", "source": "def f(a):\n    return a\n", "language": "python",
      "granularity": "typo"}, "bad_request"),
    ({"op": "embed_file", "source": "def broken(:\n", "language": "python"}, "internal"),
    ({"op": "embed_file", "source": "   "}, "bad_request"),
])
def test_file_errors_match_jax(servers, req, kind):
    got, want = servers["port"].handle(req), servers["jax"].handle(req)
    assert got["error_kind"] == want["error_kind"] == kind
    assert got["error"].split(":")[0] == want["error"].split(":")[0]


def test_file_requests_by_contexts_match_jax(servers, models):
    """embed_file and file neighbors over a pre-mapped bag (one method)."""
    pred = models["method"][2]
    _, contexts, _ = pred._extract(PY_SOURCES[0].read_text(), "*", "python")[0]
    mapped, _ = pred._map_contexts(contexts)
    for op in ("embed_file", "neighbors"):
        req = {"op": op, "contexts": [list(c) for c in mapped], "granularity": "file",
               "include_vector": True, "top_k": 2}
        got, want = servers["port"].handle(req), servers["jax"].handle(req)
        assert got["ok"] and want["ok"] and set(got) == set(want)
        np.testing.assert_allclose(got["file_vector"], want["file_vector"], rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# ann_build: the port's CLI against tools/ann_build.py
# ---------------------------------------------------------------------------


def run_jax_tool(argv):
    proc = subprocess.run([sys.executable, str(REPO / "tools" / "ann_build.py"), *argv],
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "JAX_PLATFORMS": "cpu"})
    return proc.returncode, proc.stdout, proc.stderr


def run_port_tool(argv, capsys):
    rc = ann_build.main(argv + ["--device", "cpu"])
    captured = capsys.readouterr()
    return rc, captured.out, captured.err


@pytest.mark.parametrize("argv", [
    [], ["--n_list", "8", "--m", "4", "--kmeans_iters", "4", "--pq_iters", "3"],
    ["--m", "5", "--seed", "3", "--n_probe", "2", "--shortlist", "16", "--batch_size", "64"],
], ids=["defaults", "jax_smoke", "m_fallback"])
def test_ann_build_is_byte_identical_to_the_jax_tool(tmp_path, capsys, argv):
    rng = np.random.default_rng(0)
    rows = rng.normal(size=(400, 12)).astype(np.float32)
    code_vec = tmp_path / "file.vec"
    export_file_vectors(rows, [f"f{i}.py" for i in range(400)], str(code_vec))
    outs = {}
    for who, run in (("port", lambda a: run_port_tool(a, capsys)), ("jax", run_jax_tool)):
        out = tmp_path / f"{who}.index"
        rc, stdout, stderr = run(["--code_vec", str(code_vec), "--out", str(out), *argv])
        assert rc == 0, stderr
        summary = json.loads(stdout.strip().splitlines()[-1])
        outs[who] = (out.read_bytes(), summary, stderr.strip().splitlines()[-1:] if "m=" in
                     stderr else [])
    (port_bytes, port_sum, port_warn), (jax_bytes, jax_sum, jax_warn) = outs["port"], outs["jax"]
    assert port_bytes == jax_bytes
    for s in (port_sum, jax_sum):
        s.pop("out"), s.pop("build_seconds")
    assert port_sum == jax_sum and port_warn == jax_warn
    if argv == []:
        assert port_sum["n_list"] == 24  # ~sqrt(400) = 20, rounded up to a multiple of 8
        assert port_sum["m"] == 6 and "using m=6" in port_warn[0]  # 8 does not divide 12
    if "--m" in argv and argv[argv.index("--m") + 1] == "5":
        assert port_sum["m"] == 4


def test_ann_build_needs_two_vectors(tmp_path, capsys):
    code_vec = tmp_path / "one.vec"
    export_file_vectors(np.ones((1, 4), np.float32), ["a.py"], str(code_vec))
    rc, _, err = run_port_tool(["--code_vec", str(code_vec), "--out", str(tmp_path / "x")],
                               capsys)
    jrc, _, jerr = run_jax_tool(["--code_vec", str(code_vec), "--out", str(tmp_path / "y")])
    assert rc == jrc == 2 and "need >= 2" in err and "need >= 2" in jerr
