"""The port's out-of-core corpus path against the JAX package's, on the CPU.

- the CSR container (``formats/corpus_io.py``): the port writes JAX's
  bytes, record edge cases included, each package opens the other's
  container, and the footer histogram equals a scan of ``row_splits``;
- the readers: ``load_corpus_csr`` (mmap-backed), the native parser and
  the sidecar cache give JAX's arrays and the port's text path's; either
  package loads a cache the other wrote; a parser that cannot run falls
  back to the Python one (logged);
- the sources: ``StreamingSource`` (fixed and bucketed, both tasks) and
  ``MmapCorpusSource`` (fixed and bucketed) are bitwise JAX's, with the
  generator left in the same state; ``execute_plan(plan_batches(...))`` is
  bitwise the port's ``batches()`` and JAX's ``execute_plan``;
- ``train()`` over a streamed or an mmap-backed corpus: within the train
  differential's tolerance of JAX's ``train`` under the same flags;
  device-epoch staging from the container is bytewise staging from text;
- the two tools (``tools/corpus_convert.py``, ``tools/corpus_stats.py``)
  print what JAX's print, and the round trip is byte-identical; the CLI
  trains from a container and refuses a ``--corpus_format`` the file
  contradicts.
"""

import filecmp
import json
import logging
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from code2vec_tpu import extractor as jax_extractor
from code2vec_tpu.data import pipeline as jax_pipeline
from code2vec_tpu.data import reader as jax_reader
from code2vec_tpu.formats import corpus_io as jax_corpus_io
from code2vec_tpu.train import loop as jax_loop
from code2vec_tpu.train.config import TrainConfig as JaxTrainConfig
from code2vec_tpu.train.step import build_train_step_fn, create_train_state
from code2vec_tpu_torch import interop
from code2vec_tpu_torch.data import corpus_parser, pipeline, reader, synth
from code2vec_tpu_torch.formats import corpus_io
from code2vec_tpu_torch.tools import corpus_convert, corpus_stats
from code2vec_tpu_torch.train import loop
from code2vec_tpu_torch.train.config import TrainConfig
from code2vec_tpu_torch.train.device_epoch import stage_method_corpus

REPO = Path(__file__).resolve().parent.parent
BAG = 32
FIELDS = ("starts", "paths", "ends", "row_splits", "ids", "labels", "variable_indexes")


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The tiny corpus as text and as the port's container, each loaded by
    both packages (the text through the Python parser, no cache)."""
    out = tmp_path_factory.mktemp("ooc")
    paths = synth.generate_corpus_files(out, synth.SPECS["tiny"])
    csr = str(out / "corpus.csr")
    corpus_convert.text_to_csr(paths["corpus"], csr)
    vocabs = (paths["path_idx"], paths["terminal_idx"])
    return {
        "paths": paths, "csr": csr,
        "text": reader.load_corpus(paths["corpus"], *vocabs, cache=False, native=False),
        "mmap": reader.load_corpus(csr, *vocabs),
        "jax_text": jax_reader.load_corpus(paths["corpus"], *vocabs, cache=False, native=False),
        "jax_mmap": jax_reader.load_corpus(csr, *vocabs),
    }


def same_arrays(a, b, fields=FIELDS):
    for field in fields:
        x, y = np.asarray(getattr(a, field)), np.asarray(getattr(b, field))
        assert x.dtype == y.dtype and np.array_equal(x, y), field


def same_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) and a
    for k, (x, y) in enumerate(zip(a, b)):
        assert x.keys() == y.keys()
        for key in x:
            assert x[key].dtype == y[key].dtype and np.array_equal(x[key], y[key]), (k, key)


# ---------------------------------------------------------------------------
# the container
# ---------------------------------------------------------------------------

EDGE_RECORDS = [
    dict(id=7, label="getName", source="a/B.java", path_contexts=[(1, 2, 3), (4, 5, 6)],
         aliases=[("count", "@var_0"), ("n", "@var_1")]),
    dict(label="noId", source=None, path_contexts=[(9, 9, 9)]),  # no #id line
    dict(id=3, label="emptyPaths", source="c/D.java", path_contexts=[]),
    dict(id=4, label="withDoc", doc="returns the name", path_contexts=[(1, 1, 1)]),
    dict(id=5, label=None, path_contexts=[(2, 3, 4)], aliases=[("x", "@var_0")]),
    dict(id=6, label="ünïcode", source="é/F.java", path_contexts=[(5, 6, 7)]),
]


@pytest.mark.parametrize("shift", [0, 1])
def test_container_bytes_equal_jax_on_edge_records(tmp_path, shift):
    port, jax_file = tmp_path / "p.csr", tmp_path / "j.csr"
    corpus_io.write_corpus_csr(port, [corpus_io.CorpusRecord(**r) for r in EDGE_RECORDS], shift)
    jax_corpus_io.write_corpus_csr(jax_file, [jax_corpus_io.CorpusRecord(**r)
                                              for r in EDGE_RECORDS], shift)
    assert filecmp.cmp(port, jax_file, shallow=False)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_opens_the_others_container(tmp_path, writer):
    path = tmp_path / "c.csr"
    if writer == "port":
        corpus_io.write_corpus_csr(path, [corpus_io.CorpusRecord(**r) for r in EDGE_RECORDS], 1)
        opened = jax_corpus_io.open_corpus_csr(path)
    else:
        jax_corpus_io.write_corpus_csr(path, [jax_corpus_io.CorpusRecord(**r)
                                              for r in EDGE_RECORDS], 1)
        opened = corpus_io.open_corpus_csr(path)
    with opened:
        got = [vars(r) for r in opened.iter_records()]
    want = [vars(corpus_io.CorpusRecord(**r)) for r in EDGE_RECORDS]
    assert got == want


def test_container_of_the_corpus_equals_jax_and_round_trips(corpora, tmp_path):
    jax_csr = tmp_path / "j.csr"
    jax_corpus_io.write_corpus_csr(
        jax_csr, jax_corpus_io.iter_corpus_records(corpora["paths"]["corpus"]), 1)
    assert filecmp.cmp(corpora["csr"], jax_csr, shallow=False)
    back = tmp_path / "back.txt"
    corpus_convert.csr_to_text(corpora["csr"], str(back))
    assert filecmp.cmp(back, corpora["paths"]["corpus"], shallow=False)


def test_footer_histogram_equals_a_scan(corpora):
    lengths, counts = corpus_io.read_csr_histogram(corpora["csr"])
    want = np.unique(np.diff(corpora["text"].row_splits), return_counts=True)
    assert np.array_equal(lengths, want[0]) and np.array_equal(counts, want[1])
    jax_lengths, jax_counts = jax_corpus_io.read_csr_histogram(corpora["csr"])
    assert np.array_equal(lengths, jax_lengths) and np.array_equal(counts, jax_counts)


def test_magic_detection_and_lazy_views(corpora):
    assert corpus_io.is_csr_corpus(corpora["csr"])
    assert not corpus_io.is_csr_corpus(corpora["paths"]["corpus"])
    assert not corpus_io.is_csr_corpus("/nonexistent/corpus.csr")
    with corpus_io.open_corpus_csr(corpora["csr"]) as c:
        assert isinstance(c.starts.base, np.memmap) or isinstance(c.starts, np.memmap)
        assert not c.starts.flags.writeable


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------


def test_load_corpus_csr_equals_jax_and_the_text_path(corpora):
    mmap = corpora["mmap"]
    assert mmap.mmap_backed and not corpora["text"].mmap_backed
    assert not mmap.starts.flags.writeable  # views of the file
    same_arrays(mmap, corpora["jax_mmap"])
    same_arrays(mmap, corpora["text"])
    assert mmap.label_vocab.stoi == corpora["jax_text"].label_vocab.stoi
    assert mmap.normalized_labels == corpora["text"].normalized_labels
    assert mmap.sources == corpora["text"].sources and mmap.aliases == corpora["text"].aliases


def test_csr_with_another_shift_is_materialized(corpora, tmp_path):
    path = tmp_path / "s0.csr"
    corpus_convert.text_to_csr(corpora["paths"]["corpus"], str(path), shift=0)
    data = reader.load_corpus(path, corpora["paths"]["path_idx"], corpora["paths"]["terminal_idx"])
    assert not data.mmap_backed
    same_arrays(data, corpora["text"])


@pytest.mark.parametrize("infer", [(True, False), (False, True), (True, True)])
def test_native_parser_equals_jax_and_python(corpora, infer):
    p = corpora["paths"]
    args = (p["corpus"], p["path_idx"], p["terminal_idx"])
    kw = dict(infer_method=infer[0], infer_variable=infer[1], cache=False)
    native = reader.load_corpus(*args, native=True, **kw)
    python = reader.load_corpus(*args, native=False, **kw)
    want = jax_reader.load_corpus(*args, native=True, **kw)
    same_arrays(native, python)
    same_arrays(native, want)
    assert native.label_vocab.stoi == want.label_vocab.stoi
    assert native.aliases == want.aliases and native.sources == want.sources


def test_parse_corpus_native_equals_jax(corpora):
    got = corpus_parser.parse_corpus_native(corpora["paths"]["corpus"])
    want = jax_extractor.parse_corpus_native(corpora["paths"]["corpus"])
    for a, b in zip(got[:5], want[:5]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[5:] == want[5:]


def test_native_failure_falls_back_to_python(corpora, monkeypatch, caplog):
    def broken(path):
        raise RuntimeError("no compiler here")

    monkeypatch.setattr(corpus_parser, "parse_corpus_native", broken)
    p = corpora["paths"]
    with caplog.at_level(logging.WARNING):
        data = reader.load_corpus(p["corpus"], p["path_idx"], p["terminal_idx"], cache=False)
    assert "native corpus parser unavailable" in caplog.text
    same_arrays(data, corpora["text"])


def copy_corpus(corpora, tmp_path):
    """The tiny corpus in a directory of its own (the cache lands beside it)."""
    out = {}
    for key in ("corpus", "path_idx", "terminal_idx"):
        src = Path(corpora["paths"][key])
        out[key] = str(tmp_path / src.name)
        Path(out[key]).write_bytes(src.read_bytes())
    return out


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cache_is_read_by_either_package(corpora, tmp_path, writer):
    p = copy_corpus(corpora, tmp_path)
    args = (p["corpus"], p["path_idx"], p["terminal_idx"])
    kw = dict(infer_method=True, infer_variable=True)
    if writer == "port":
        reader.load_corpus(*args, **kw)
    else:
        jax_reader.load_corpus(*args, **kw)
    assert len(list(tmp_path.glob("corpus.txt.cache-*.npz"))) == 1
    port, want = reader.load_corpus(*args, **kw), jax_reader.load_corpus(*args, **kw)
    same_arrays(port, want)
    same_arrays(port, reader.load_corpus(*args, cache=False, native=False, **kw))
    assert port.label_vocab.stoi == want.label_vocab.stoi
    assert port.label_vocab.freq_list() == want.label_vocab.freq_list()
    assert port.aliases == want.aliases and port.normalized_labels == want.normalized_labels


def test_cache_hit_skips_the_parse_and_a_damaged_cache_reparses(corpora, tmp_path, monkeypatch,
                                                                caplog):
    p = copy_corpus(corpora, tmp_path)
    args = (p["corpus"], p["path_idx"], p["terminal_idx"])
    first = reader.load_corpus(*args)
    monkeypatch.setattr(reader, "_parse_native", lambda path: pytest.fail("parsed again"))
    monkeypatch.setattr(reader, "_parse_python", lambda path: pytest.fail("parsed again"))
    same_arrays(reader.load_corpus(*args), first)
    monkeypatch.undo()
    npz = next(tmp_path.glob("corpus.txt.cache-*.npz"))
    npz.write_bytes(b"not a zip")
    with caplog.at_level(logging.WARNING):
        same_arrays(reader.load_corpus(*args), first)
    assert "ignoring unreadable corpus cache" in caplog.text


# ---------------------------------------------------------------------------
# the sources and the plan/build split
# ---------------------------------------------------------------------------


def ladder_of(data):
    return pipeline.derive_bucket_ladder(np.diff(data.row_splits), BAG)


def sources(mod, text, mmap, ladder, order):
    idx = np.arange(text.n_items)
    kw = dict(context_order=order)
    return {
        "epoch-fixed": mod.EpochSource(text, idx, 8, BAG, **kw),
        "epoch-bucketed": mod.EpochSource(text, idx, 8, BAG, ladder=ladder, **kw),
        "stream-fixed": mod.StreamingSource(text, idx, 8, BAG, 48, **kw),
        "stream-bucketed": mod.StreamingSource(text, idx, 8, BAG, 48, ladder=ladder, **kw),
        "mmap-fixed": mod.MmapCorpusSource(mmap, idx, 8, BAG, **kw),
        "mmap-bucketed": mod.MmapCorpusSource(mmap, idx, 8, BAG, ladder=ladder, **kw),
    }


KINDS = ["epoch-fixed", "epoch-bucketed", "stream-fixed", "stream-bucketed", "mmap-fixed",
         "mmap-bucketed"]


@pytest.mark.parametrize("order", ["shuffled", "corpus"])
@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_source_streams_equal_jax(corpora, kind, shuffle, order):
    ladder = ladder_of(corpora["text"])
    port = sources(pipeline, corpora["text"], corpora["mmap"], ladder, order)[kind]
    want = sources(jax_pipeline, corpora["jax_text"], corpora["jax_mmap"], ladder, order)[kind]
    r1, r2 = np.random.default_rng(7), np.random.default_rng(7)
    same_batches(port.batches(r1, shuffle), want.batches(r2, shuffle))
    assert r1.bit_generator.state == r2.bit_generator.state
    assert port.pad_stats() == want.pad_stats()
    assert port.ladder == want.ladder


@pytest.mark.parametrize("order", ["shuffled", "corpus"])
@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_executed_plans_equal_the_stream_and_jax(corpora, kind, shuffle, order):
    ladder = ladder_of(corpora["text"])
    port = sources(pipeline, corpora["text"], corpora["mmap"], ladder, order)[kind]
    want = sources(jax_pipeline, corpora["jax_text"], corpora["jax_mmap"], ladder, order)[kind]
    backing = "mmap" if kind.startswith("mmap") else "text"
    data, jax_data = corpora[backing], corpora[f"jax_{backing}"]
    r_sync, r_plan, r_jax = (np.random.default_rng(11) for _ in range(3))
    sync = list(port.batches(r_sync, shuffle))
    plans = list(port.plan_batches(r_plan, shuffle))
    same_batches(sync, [pipeline.execute_plan(data, plan) for plan in plans])
    assert r_sync.bit_generator.state == r_plan.bit_generator.state
    jax_plans = list(want.plan_batches(r_jax, shuffle))
    same_batches(sync, [jax_pipeline.execute_plan(jax_data, plan) for plan in jax_plans])
    assert r_plan.bit_generator.state == r_jax.bit_generator.state
    for a, b in zip(plans, jax_plans):
        assert (a.width, a.valid) == (b.width, b.valid)
        assert np.array_equal(a.items, b.items) and np.array_equal(a.uniforms, b.uniforms)


@pytest.mark.parametrize("svi", [False, True])
@pytest.mark.parametrize("bucketed", [False, True])
@pytest.mark.parametrize("infer", [(False, True), (True, True)])
def test_streaming_variable_task_equals_jax(corpora, infer, bucketed, svi):
    p = corpora["paths"]
    args = (p["corpus"], p["path_idx"], p["terminal_idx"])
    kw = dict(infer_method=infer[0], infer_variable=infer[1], cache=False, native=False)
    port, want = reader.load_corpus(*args, **kw), jax_reader.load_corpus(*args, **kw)
    ladder = ladder_of(port) if bucketed else None
    idx = np.arange(port.n_items)
    src = pipeline.StreamingSource(port, idx, 8, BAG, 48, ladder=ladder,
                                   shuffle_variable_indexes=svi)
    jax_src = jax_pipeline.StreamingSource(want, idx, 8, BAG, 48, ladder=ladder,
                                           shuffle_variable_indexes=svi)
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    same_batches(src.batches(r1), jax_src.batches(r2))
    assert r1.bit_generator.state == r2.bit_generator.state
    assert src.pad_stats() == jax_src.pad_stats()
    with pytest.raises(ValueError, match="method task only"):
        src.plan_batches(np.random.default_rng(0))


def test_planned_draws_that_disagree_with_the_corpus_raise(corpora):
    plan = pipeline.BatchPlan(width=BAG, valid=1, items=np.asarray([0], np.int64),
                              uniforms=np.zeros(1, np.float64))
    with pytest.raises(ValueError, match="plan and the corpus disagree"):
        pipeline.execute_plan(corpora["text"], plan)


def test_make_batch_source_policy(corpora):
    idx = np.arange(10)
    assert type(pipeline.make_batch_source(corpora["text"], idx, 4, BAG)) is pipeline.EpochSource
    assert type(pipeline.make_batch_source(corpora["mmap"], idx, 4, BAG)) is \
        pipeline.MmapCorpusSource
    assert type(pipeline.make_batch_source(corpora["mmap"], idx, 4, BAG,
                                           stream_chunk_items=5)) is pipeline.StreamingSource
    with pytest.raises(NotImplementedError, match="plan split"):
        pipeline.BatchSource().plan_batches(np.random.default_rng(0))
    from dataclasses import replace

    variable = replace(corpora["mmap"], infer_variable=True)
    assert type(pipeline.make_batch_source(variable, idx, 4, BAG)) is pipeline.EpochSource
    with pytest.raises(ValueError, match="method task only"):
        pipeline.MmapCorpusSource(variable, idx, 4, BAG)


# ---------------------------------------------------------------------------
# training over the out-of-core sources
# ---------------------------------------------------------------------------

LOOP_KW = dict(terminal_embed_size=8, path_embed_size=6, encode_size=12, batch_size=32,
               max_path_length=BAG, max_epoch=2, dropout_prob=0.0, random_seed=11,
               print_sample_cycle=0)


def jax_and_port_train(port_data, jax_data, **flags):
    jcfg = JaxTrainConfig(**LOOP_KW, **flags)
    model_cfg = jax_loop.model_config_from(jcfg, jax_data)
    state = create_train_state(jcfg, model_cfg, jax.random.PRNGKey(11),
                               jax_loop.dummy_batch(jcfg))
    params0 = jax.tree.map(np.asarray, state.params)
    step = jax.jit(build_train_step_fn(model_cfg, jax_loop.class_weights_from(jcfg, jax_data)))
    want = jax_loop.train(jcfg, jax_data, sinks=(), initial_state=state, train_step=step)
    cfg = TrainConfig(**LOOP_KW, **flags)
    sd = interop.state_dict_from_jax_params(params0, loop.model_config_from(cfg, port_data))
    got = loop.train(cfg, port_data, device="cpu", initial_state_dict=sd)
    sync = loop.train(cfg.with_updates(feed_workers=0, prefetch_batches=0), port_data,
                      device="cpu", initial_state_dict=sd)
    return got, want, sync


@pytest.mark.parametrize("case", [
    ("mmap", dict(bucketed=True)),
    ("text", dict(stream_chunk_items=48)),
    ("mmap", dict(stream_chunk_items=48, bucketed=True, prefetch_batches=2)),
], ids=["mmap-bucketed", "stream-fixed", "stream-mmap-bucketed-prefetch"])
def test_train_tracks_jax_train(corpora, case):
    backing, flags = case
    got, want, sync = jax_and_port_train(corpora[backing], corpora[f"jax_{backing}"], **flags)
    assert len(got.history) == len(want.history) == 2
    for g, w, s in zip(got.history, want.history, sync.history):
        np.testing.assert_allclose(g["train_loss"], w["train_loss"], rtol=2e-5)
        np.testing.assert_allclose(g["test_loss"], w["test_loss"], rtol=2e-5)
        assert g["accuracy"] == w["accuracy"] and g["f1"] == w["f1"]
        assert g["pad_efficiency"] == w["pad_efficiency"]
        assert (g["train_loss"], g["test_loss"], g["f1"]) == \
            (s["train_loss"], s["test_loss"], s["f1"])


def test_device_epoch_staging_from_the_container_equals_text(corpora):
    idx = np.random.default_rng(0).permutation(corpora["text"].n_items)[:120]
    a = stage_method_corpus(corpora["text"], idx, np.random.default_rng(4))
    b = stage_method_corpus(corpora["mmap"], idx, np.random.default_rng(4))
    for field in ("contexts", "row_splits", "labels"):
        assert np.array_equal(getattr(a, field), getattr(b, field)), field
    cfg = TrainConfig(**{**LOOP_KW, "device_epoch": True, "max_epoch": 1})
    got = loop.train(cfg, corpora["mmap"], device="cpu")
    want = loop.train(cfg, corpora["text"], device="cpu")
    assert got.history[0]["train_loss"] == want.history[0]["train_loss"]


# ---------------------------------------------------------------------------
# the tools and the CLI
# ---------------------------------------------------------------------------


def run_tool(args):
    proc = subprocess.run([sys.executable, *args], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_convert_tool_output_and_round_trip_equal_jax(corpora, tmp_path):
    src = corpora["paths"]["corpus"]
    port_out = run_tool(["-m", "code2vec_tpu_torch.tools.corpus_convert", src,
                         str(tmp_path / "p.csr")])
    jax_out = run_tool(["tools/corpus_convert.py", src, str(tmp_path / "j.csr")])
    assert filecmp.cmp(tmp_path / "p.csr", tmp_path / "j.csr", shallow=False)
    assert port_out.split(" in ")[0] == jax_out.split(" in ")[0]  # all but the seconds
    run_tool(["-m", "code2vec_tpu_torch.tools.corpus_convert", "--to-text",
              str(tmp_path / "p.csr"), str(tmp_path / "back.txt")])
    assert filecmp.cmp(tmp_path / "back.txt", src, shallow=False)
    with pytest.raises(SystemExit, match="already a CSR"):
        corpus_convert.main([str(tmp_path / "p.csr"), str(tmp_path / "x.csr")])
    with pytest.raises(SystemExit, match="not a CSR"):
        corpus_convert.main(["--to-text", src, str(tmp_path / "x.txt")])


@pytest.mark.parametrize("which", ["text", "csr"])
def test_stats_tool_prints_what_jax_prints(corpora, which, capsys):
    path = corpora["paths"]["corpus"] if which == "text" else corpora["csr"]
    args = [path, "--max_contexts", str(BAG), "--batch_size", "16"]
    assert corpus_stats.main(args) == 0
    port_out = capsys.readouterr().out
    jax_out = run_tool(["tools/corpus_stats.py", *args])
    assert port_out == jax_out
    assert json.loads(port_out.splitlines()[-1])["n_methods"] == corpora["text"].n_items


def cli_args(corpora, corpus, out):
    p = corpora["paths"]
    return ["--corpus_path", corpus, "--path_idx_path", p["path_idx"], "--terminal_idx_path",
            p["terminal_idx"], "--model_path", str(out), "--vectors_path", str(out / "code.vec"),
            "--terminal_embed_size", "8", "--path_embed_size", "6", "--encode_size", "12",
            "--max_path_length", str(BAG), "--max_epoch", "2", "--no_cuda"]


def test_cli_trains_from_a_container_and_refuses_a_wrong_format(corpora, tmp_path, capsys):
    from code2vec_tpu_torch import cli

    runs = {}
    for name, extra in (("sync", []), ("fed", ["--feed_workers", "2", "--prefetch_batches", "2"])):
        assert cli.main(cli_args(corpora, corpora["csr"], tmp_path / name)
                        + ["--corpus_format", "csr", *extra]) == 0
        runs[name] = [json.loads(x) for x in capsys.readouterr().out.splitlines()
                      if x.startswith("{")]
    assert len(runs["sync"]) == 2
    for a, b in zip(runs["sync"], runs["fed"]):
        assert (a["train_loss"], a["test_loss"], a["f1"]) == (b["train_loss"], b["test_loss"],
                                                              b["f1"])
    with pytest.raises(SystemExit, match="is a csr corpus"):
        cli.main(cli_args(corpora, corpora["csr"], tmp_path / "x") + ["--corpus_format", "text"])
    with pytest.raises(SystemExit, match="is a text corpus"):
        cli.main(cli_args(corpora, corpora["paths"]["corpus"], tmp_path / "x")
                 + ["--corpus_format", "csr"])
