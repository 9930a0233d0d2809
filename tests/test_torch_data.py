"""The port's data layer and metrics against the JAX package's, on the CPU.

Synthetic corpora (``data/synth.py``, ``SPECS["tiny"]``) are written by
both packages and must be byte-identical; both readers must give equal
arrays and vocabs; the epoch build, the batcher and the split must give
equal arrays from the same ``numpy`` seed (the two trainers then see the
same batches); the three metrics must agree on random label ids (exact
to 1e-12; the port computes ``exact`` in numpy, the JAX package with
scikit-learn).
"""

import filecmp

import numpy as np
import pytest

from code2vec_tpu import metrics as jax_metrics
from code2vec_tpu import text as jax_text
from code2vec_tpu.data import pipeline as jax_pipeline
from code2vec_tpu.data import reader as jax_reader
from code2vec_tpu.data import synth as jax_synth
from code2vec_tpu_torch import metrics, text
from code2vec_tpu_torch.data import pipeline, reader, synth
from code2vec_tpu_torch.formats import corpus_io, params_io

FILES = ("corpus", "path_idx", "terminal_idx", "params")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny corpus written by both packages, loaded by both readers."""
    root = tmp_path_factory.mktemp("tiny")
    port_paths = synth.generate_corpus_files(root / "port", synth.SPECS["tiny"])
    jax_paths = jax_synth.generate_corpus_files(root / "jax", jax_synth.SPECS["tiny"])
    args = (port_paths["corpus"], port_paths["path_idx"], port_paths["terminal_idx"])
    return {
        "port_paths": port_paths,
        "jax_paths": jax_paths,
        "port": reader.load_corpus(*args),
        "jax": jax_reader.load_corpus(*args, cache=False, native=False),
    }


@pytest.mark.parametrize("name", FILES)
def test_synth_files_are_byte_identical(tiny, name):
    assert filecmp.cmp(tiny["port_paths"][name], tiny["jax_paths"][name], shallow=False)


@pytest.mark.parametrize("spec", ["tiny", "small", "parity10k", "top11"])
def test_specs_match(spec):
    assert vars(synth.SPECS[spec]) == vars(jax_synth.SPECS[spec])


@pytest.mark.parametrize("field", ["starts", "paths", "ends", "row_splits", "ids", "labels"])
def test_load_corpus_arrays(tiny, field):
    a, b = getattr(tiny["port"], field), getattr(tiny["jax"], field)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("vocab", ["terminal_vocab", "path_vocab", "label_vocab"])
def test_load_corpus_vocabs(tiny, vocab):
    a, b = getattr(tiny["port"], vocab), getattr(tiny["jax"], vocab)
    assert a.stoi == b.stoi and a.itos == b.itos
    assert a.itosubtokens == b.itosubtokens
    assert a.freq_list() == b.freq_list() and a.occurrence_list() == b.occurrence_list()


def test_load_corpus_per_item_fields(tiny):
    p, j = tiny["port"], tiny["jax"]
    assert p.normalized_labels == j.normalized_labels
    assert p.sources == j.sources and p.aliases == j.aliases
    assert p.method_token_index == j.method_token_index


def test_corpus_data_from_raw_matches():
    spec = synth.SynthSpec(n_methods=50, n_terminals=80, n_paths=60, n_labels=9, seed=4)
    p = synth.corpus_data_from_raw(synth.generate_corpus_data(spec))
    j = jax_synth.corpus_data_from_raw(jax_synth.generate_corpus_data(jax_synth.SynthSpec(
        **vars(spec))))
    for field in ("starts", "paths", "ends", "row_splits", "ids", "labels"):
        assert np.array_equal(getattr(p, field), getattr(j, field)), field
    assert p.label_vocab.stoi == j.label_vocab.stoi
    assert p.terminal_vocab.stoi == j.terminal_vocab.stoi


@pytest.mark.parametrize("ratio", [0.2, 0.5])
def test_split_items(ratio):
    a = pipeline.split_items(101, np.random.default_rng(3), ratio)
    b = jax_pipeline.split_items(101, np.random.default_rng(3), ratio)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("max_contexts", [5, 40, 200])
def test_build_method_epoch(tiny, max_contexts):
    items = np.random.default_rng(1).permutation(tiny["port"].n_items)[:77]
    rng_p, rng_j = np.random.default_rng(9), np.random.default_rng(9)
    a = pipeline.build_method_epoch(tiny["port"], items, max_contexts, rng_p)
    b = jax_pipeline.build_method_epoch(tiny["jax"], items, max_contexts, rng_j)
    for field in ("ids", "starts", "paths", "ends", "labels"):
        assert np.array_equal(getattr(a, field), getattr(b, field)), field
    # the @question substitution ran
    assert not (a.starts == tiny["port"].method_token_index).any()
    assert rng_p.random() == rng_j.random()  # both generators consumed alike


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("batch_size", [16, 33])
def test_epoch_and_batches(tiny, batch_size, shuffle):
    """build_epoch then iter_batches from one generator, as the trainers
    draw them: identical batches, masks and generator state."""
    items = np.arange(tiny["port"].n_items)
    out = []
    for data, mod in ((tiny["port"], pipeline), (tiny["jax"], jax_pipeline)):
        rng = np.random.default_rng(5)
        epoch = mod.build_epoch(data, items, 30, rng)
        out.append((list(mod.iter_batches(epoch, batch_size, rng=rng if shuffle else None)),
                    rng.random()))
    (bp, rp), (bj, rj) = out
    assert rp == rj and len(bp) == len(bj)
    for x, y in zip(bp, bj):
        assert x.keys() == y.keys()
        for k in x:
            assert np.array_equal(x[k], y[k]), k


def test_build_epoch_refuses_the_variable_task(tiny):
    """The variable task is ported (tests/test_torch_variable.py); what
    ``build_epoch`` refuses now is a corpus loaded with neither task."""
    from dataclasses import replace

    with pytest.raises(ValueError, match="neither task"):
        pipeline.build_epoch(replace(tiny["port"], infer_method=False, infer_variable=False),
                             np.arange(3), 10, np.random.default_rng(0))


@pytest.mark.parametrize("kw", [{"cache": True, "shard": (0, 2)},
                                {"native": True, "shard": (1, 2)}, {"shard": (0, 2)}])
def test_load_corpus_refuses_what_is_not_ported(tiny, kw):
    """Host sharding, on the cached, the native and the default route (the
    cache and the native parser are ported: tests/test_torch_ooc.py)."""
    p = tiny["port_paths"]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        reader.load_corpus(p["corpus"], p["path_idx"], p["terminal_idx"], **kw)


def test_load_corpus_refuses_a_csr_container(tiny, tmp_path):
    """A container that is the magic and no header is refused loudly (a
    valid one loads: tests/test_torch_ooc.py)."""
    p = tiny["port_paths"]
    csr = tmp_path / "corpus.csr"
    csr.write_bytes(corpus_io.CSR_MAGIC + b"\0" * 64)
    with pytest.raises(ValueError, match="CSR"):
        reader.load_corpus(csr, p["path_idx"], p["terminal_idx"])


def test_corpus_round_trip(tiny, tmp_path):
    records = list(corpus_io.iter_corpus_records(tiny["port_paths"]["corpus"]))
    corpus_io.write_corpus(tmp_path / "c.txt", records)
    assert filecmp.cmp(tmp_path / "c.txt", tiny["port_paths"]["corpus"], shallow=False)
    assert params_io.read_params(tiny["port_paths"]["params"])["method_count"] == "200"


@pytest.mark.parametrize("name", ["get_value_2", "toString", "HTMLParser", "md5Hash",
                                  "_private", "readAllBytesFromFile", "x", ""])
def test_text_rules(name):
    assert text.normalize_and_subtokenize(name) == jax_text.normalize_and_subtokenize(name)
    assert text.subtokenize(name) == jax_text.subtokenize(name)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("method", ["exact", "subtoken", "ave_subtoken"])
def test_metrics_match(tiny, method, seed):
    vocab = tiny["port"].label_vocab
    rng = np.random.default_rng(seed)
    expected = rng.integers(0, len(vocab), 60)
    actual = np.where(rng.random(60) < 0.4, expected, rng.integers(0, len(vocab), 60))
    a = metrics.evaluate(method, expected, actual, vocab)
    b = jax_metrics.evaluate(method, expected, actual, tiny["jax"].label_vocab)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def test_metrics_of_an_empty_split(tiny):
    empty = np.zeros(0, np.int64)
    assert metrics.evaluate("exact", empty, empty, tiny["port"].label_vocab) == (0, 0, 0, 0)
