"""The port's variable-name task against the JAX package's, on the CPU.

Two corpora: ``SPECS["tiny"]`` of ``data/synth.generate_corpus_files``
(0-3 ``@var_*`` aliases a method, one context each) and the corpus the
port's extractor makes from ``examples/java`` (real variables, 6-40
contexts each), also with an alias added that no context touches.

- Epochs: ``build_variable_epoch`` and ``build_epoch`` (variable-only and
  dual-task, ``shuffle_variable_indexes`` off and on) and the batch
  source over them are bit for bit JAX's, and leave the generator in
  JAX's state.
- Staging: ``stage_variable_corpus``, ``concat_staged`` (``device="host"``),
  the loop's staging order and the bucket partition are bit for bit JAX's.
- The sampler: with JAX's shifts and JAX's ``[B, V]`` uniform draw it
  equals JAX ``_sample_batch``; and its properties on the port's
  generator: the target is ``@question``, ids other than ``@var_*`` ids are
  untouched, each variable row gets a permutation, method rows never.
- Three variable-task train steps from JAX weights (``interop``), dropout
  0, on each route's plain version, host-fed and from the device sampler
  (shuffle off and on): losses rtol 2e-5, parameters atol 3e-5 / rtol
  1e-4 (``docs/PARITY.md:16``).
- A batch holding an all-PAD row and 1-context rows: each route's code
  vectors and gradients against JAX's (rtol 1e-5 / atol 1e-6).
- ``train()`` against JAX ``train()`` on both tasks, host-fed and device
  epochs; ``oov_rate``; the export; the CLI; the task-flag checks.

Dims are tiny (embed 8/6, encode 12).
"""

import contextlib
import json
import shutil
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu.data import pipeline as jax_pipeline
from code2vec_tpu.data import reader as jax_reader
from code2vec_tpu.models.code2vec import Code2VecConfig as JaxModelConfig
from code2vec_tpu.train import device_epoch as jax_de
from code2vec_tpu.train import loop as jax_loop
from code2vec_tpu.train.config import TrainConfig as JaxTrainConfig
from code2vec_tpu.train.step import build_train_step_fn, create_train_state
from code2vec_tpu.train.step import weighted_nll as jax_weighted_nll
from code2vec_tpu_torch import PAD_INDEX, QUESTION_TOKEN_INDEX, interop
from code2vec_tpu_torch.data import pipeline, reader, synth
from code2vec_tpu_torch.data.pipeline import split_items
from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig
from code2vec_tpu_torch.train import device_epoch as de
from code2vec_tpu_torch.train import loop
from code2vec_tpu_torch.train.config import TrainConfig
from code2vec_tpu_torch.train.step import forward_backward, make_optimizer, train_step

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples" / "java"
ROUTES = {"plain": {}, **{r: dict(use_pallas=True, pallas_impl=r)
                          for r in ("pool_only", "gather_split", "fused")}}
TASKS = {"variable": (False, True), "dual": (True, True)}
LOOP_KW = dict(terminal_embed_size=8, path_embed_size=6, encode_size=12, batch_size=8,
               max_epoch=2, dropout_prob=0.0, random_seed=11, print_sample_cycle=0)


@contextlib.contextmanager
def gspmd():
    """jax 0.9's Shardy partitioner rejects the JAX fused op (ROADMAP §C)."""
    previous = jax.config.jax_use_shardy_partitioner
    jax.config.update("jax_use_shardy_partitioner", False)
    try:
        yield
    finally:
        jax.config.update("jax_use_shardy_partitioner", previous)


@pytest.fixture(scope="module")
def corpus_files(tmp_path_factory):
    from code2vec_tpu_torch.extractor import extract_dataset

    tiny = synth.generate_corpus_files(tmp_path_factory.mktemp("tiny_var"), synth.SPECS["tiny"])
    java = tmp_path_factory.mktemp("java_var")
    shutil.copy(EXAMPLES / "dataset" / "methods.txt", java / "methods.txt")
    extract_dataset(java, EXAMPLES)
    return {"synth": (tiny["corpus"], tiny["path_idx"], tiny["terminal_idx"]),
            "java": tuple(str(java / n) for n in ("corpus.txt", "path_idxs.txt",
                                                  "terminal_idxs.txt"))}


@pytest.fixture(scope="module")
def corpora(corpus_files):
    """(corpus, tasks) -> (port CorpusData, JAX CorpusData)."""
    out = {}
    for name, args in corpus_files.items():
        for task, (im, iv) in TASKS.items():
            out[name, task] = (
                reader.load_corpus(*args, infer_method=im, infer_variable=iv),
                jax_reader.load_corpus(*args, infer_method=im, infer_variable=iv, cache=False,
                                       native=False))
    return out


def assert_epochs_equal(a, b):
    for key in ("ids", "starts", "paths", "ends", "labels"):
        x, y = getattr(a, key), getattr(b, key)
        assert x.dtype == y.dtype, key
        np.testing.assert_array_equal(x, y, err_msg=key)


# ---------------------------------------------------------------------------
# epochs and the batch source, bitwise
# ---------------------------------------------------------------------------

def test_the_java_corpus_has_what_the_variable_task_needs(corpora):
    data, _ = corpora["java", "variable"]
    assert len(data.variable_indexes) > 3
    assert (np.diff(data.variable_indexes) > 0).all()
    names = [data.terminal_vocab.itos[int(i)] for i in data.variable_indexes]
    assert all(n.startswith("@var_") for n in names)
    epoch = pipeline.build_variable_epoch(data, np.arange(data.n_items), 200,
                                          np.random.default_rng(0))
    counts = (epoch.paths != PAD_INDEX).sum(axis=1)
    assert counts.max() > 5 and len(epoch) > data.n_items


@pytest.mark.parametrize("shuffle", [False, True], ids=["plain_ids", "shuffled_ids"])
@pytest.mark.parametrize("bag", [5, 200])
@pytest.mark.parametrize("task", list(TASKS))
@pytest.mark.parametrize("corpus", ["synth", "java"])
def test_epochs_match_jax_bitwise(corpora, corpus, task, bag, shuffle):
    data, jax_data = corpora[corpus, task]
    train_idx, _ = split_items(data.n_items, np.random.default_rng(1))
    rng, jrng = np.random.default_rng(4), np.random.default_rng(4)
    got = pipeline.build_epoch(data, train_idx, bag, rng, shuffle)
    want = jax_pipeline.build_epoch(jax_data, train_idx, bag, jrng, shuffle)
    assert_epochs_equal(got, want)
    assert rng.bit_generator.state == jrng.bit_generator.state
    if task == "variable":
        rng, jrng = np.random.default_rng(5), np.random.default_rng(5)
        assert_epochs_equal(pipeline.build_variable_epoch(data, train_idx, bag, rng, shuffle),
                            jax_pipeline.build_variable_epoch(jax_data, train_idx, bag, jrng,
                                                              shuffle))


def test_rows_of_an_untouched_alias_are_all_pad(corpora):
    """Every alias gets its row before any context is looked at (JAX
    ``pipeline.py:286-299``, staging ``device_epoch.py:196-210``): an alias
    that no context of its method touches gives an all-PAD row on the host
    and a row of 0 contexts in the staging, which the sampler yields all PAD."""
    data, jax_data = corpora["java", "variable"]
    last = data.terminal_vocab.itos[int(data.variable_indexes[-1])]

    def widen(d):
        return replace(d, aliases=[{**a, last: "value"} if a and last not in a else a
                                   for a in d.aliases])

    data, jax_data = widen(data), widen(jax_data)
    idx = np.arange(data.n_items)
    epoch = pipeline.build_variable_epoch(data, idx, 50, np.random.default_rng(0), True)
    assert_epochs_equal(epoch, jax_pipeline.build_variable_epoch(
        jax_data, idx, 50, np.random.default_rng(0), True))
    empty = np.flatnonzero((epoch.paths != PAD_INDEX).sum(axis=1) == 0)
    assert len(empty) > 0
    assert len(epoch) == sum(sum(k.startswith("@var_") for k in a) for a in data.aliases)
    staged = de.stage_variable_corpus(data, idx, np.random.default_rng(1))
    assert_staged_equal(staged, jax_de.stage_variable_corpus(
        jax_data, idx, np.random.default_rng(1), device="host"))
    assert (staged.counts == 0).sum() == len(empty)
    placed = de.place_staged(staged, "cpu")
    rows = torch.from_numpy(np.flatnonzero(staged.counts == 0).astype(np.int32))
    batch = de.sample_batch(placed, rows, torch.ones(len(rows)), 8,
                            torch.Generator().manual_seed(0), shuffle_variable_ids=True)
    for k in ("starts", "paths", "ends"):
        assert (batch[k] == PAD_INDEX).all(), k


@pytest.mark.parametrize("bucketed", [False, True], ids=["fixed", "bucketed"])
@pytest.mark.parametrize("shuffle", [False, True], ids=["plain_ids", "shuffled_ids"])
def test_batch_source_matches_jax(corpora, shuffle, bucketed):
    data, jax_data = corpora["java", "dual"]
    ladder = (4, 8, 16) if bucketed else None
    items = np.arange(data.n_items)
    outs = []
    for mod, d in ((pipeline, data), (jax_pipeline, jax_data)):
        source = mod.make_batch_source(d, items, 8, 16, ladder=ladder,
                                       shuffle_variable_indexes=shuffle)
        rng = np.random.default_rng(3)
        epochs = [list(source.batches(rng, shuffle=True)) for _ in range(2)]
        outs.append((epochs, source.pad_stats(), rng.bit_generator.state))
    (got, got_pad, got_state), (want, want_pad, want_state) = outs
    assert got_pad == want_pad and got_state == want_state
    for ga, wa in zip(got, want):
        assert len(ga) == len(wa)
        for x, y in zip(ga, wa):
            for k in x:
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("task", list(TASKS))
@pytest.mark.parametrize("corpus", ["synth", "java"])
def test_oov_rate_matches_jax(corpora, corpus, task, exact):
    data, jax_data = corpora[corpus, task]
    train_idx, test_idx = split_items(data.n_items, np.random.default_rng(2))
    assert pipeline.oov_rate(data, train_idx, test_idx, exact) == \
        jax_pipeline.oov_rate(jax_data, train_idx, test_idx, exact)


# ---------------------------------------------------------------------------
# staging, bitwise
# ---------------------------------------------------------------------------

def jax_stage_host(jax_data, idx, rng):
    parts = []
    if jax_data.infer_method:
        parts.append(jax_de.stage_method_corpus(jax_data, idx, rng, device="host"))
    if jax_data.infer_variable:
        parts.append(jax_de.stage_variable_corpus(jax_data, idx, rng, device="host"))
    staged = parts[0]
    for p in parts[1:]:
        staged = jax_de.concat_staged(staged, p)
    return staged


def assert_staged_equal(got, want):
    for key in ("contexts", "row_splits", "labels", "remap_ids", "remap_flags"):
        a, b = getattr(got, key), getattr(want, key)
        if b is None:
            assert a is None, key
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    assert got.n_items == want.n_items
    np.testing.assert_array_equal(got.counts, np.diff(np.asarray(want.row_splits)))


@pytest.mark.parametrize("task", list(TASKS))
@pytest.mark.parametrize("corpus", ["synth", "java"])
def test_staging_matches_jax_bitwise(corpora, corpus, task):
    data, jax_data = corpora[corpus, task]
    train_idx, test_idx = split_items(data.n_items, np.random.default_rng(0))
    rng, jrng = np.random.default_rng(7), np.random.default_rng(7)
    for idx in (train_idx, test_idx):  # the loop's order: train, then test
        assert_staged_equal(loop.stage_host(data, idx, rng), jax_stage_host(jax_data, idx, jrng))
    assert rng.bit_generator.state == jrng.bit_generator.state
    rng, jrng = np.random.default_rng(8), np.random.default_rng(8)
    alone = de.stage_variable_corpus(data, train_idx, rng)
    assert_staged_equal(alone, jax_de.stage_variable_corpus(jax_data, train_idx, jrng,
                                                            device="host"))
    assert (alone.remap_flags == 1).all()
    placed = de.place_staged(loop.stage_host(data, train_idx, np.random.default_rng(0)), "cpu")
    assert placed.remap_ids.dtype == torch.int32 and placed.remap_flags.dtype == torch.int32
    np.testing.assert_array_equal(placed.remap_ids.numpy(), data.variable_indexes)


def test_concat_and_bucket_partition_match_jax(corpora):
    data, jax_data = corpora["java", "dual"]
    idx = np.arange(data.n_items)
    m = de.stage_method_corpus(data, idx, np.random.default_rng(1))
    v = de.stage_variable_corpus(data, idx, np.random.default_rng(2))
    jm = jax_de.stage_method_corpus(jax_data, idx, np.random.default_rng(1), device="host")
    jv = jax_de.stage_variable_corpus(jax_data, idx, np.random.default_rng(2), device="host")
    both = de.concat_staged(m, v)
    assert_staged_equal(both, jax_de.concat_staged(jm, jv))
    np.testing.assert_array_equal(both.remap_flags, [0] * m.n_items + [1] * v.n_items)
    ladder = (4, 8, 64)
    got = de.bucket_staged(both, ladder, "cpu")
    want = jax_de._bucket_host_partition(jax_de.concat_staged(jm, jv), ladder)
    assert [w for w, _ in got.buckets] == [w for w, _ in want]
    for (_, g), (_, w) in zip(got.buckets, want):  # placed: int32 splits
        assert_staged_equal(replace(g, **{k: getattr(g, k).numpy() for k in (
            "contexts", "row_splits", "labels", "remap_ids", "remap_flags")}),
            replace(w, row_splits=np.asarray(w.row_splits, np.int32)))


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dual_staged(corpora):
    data, _ = corpora["java", "dual"]
    host = loop.stage_host(data, np.arange(data.n_items), np.random.default_rng(0))
    return data, host, de.place_staged(host, "cpu")


def jax_draws(key, batch, n_var):
    """The shifts and the uniform draw JAX ``_sample_batch`` makes from ``key``."""
    shift = jax.random.randint(key, (batch, 1), 0, 1 << 30)
    u = jax.random.uniform(jax.random.fold_in(key, 1), (batch, n_var))
    return torch.from_numpy(np.array(shift)), torch.from_numpy(np.array(u))


@pytest.mark.parametrize("bag", [3, 16])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sampler_remap_matches_jax_bitwise(dual_staged, seed, bag):
    data, host, staged = dual_staged
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, staged.n_items, 12).astype(np.int32)
    rows[:3] = [0, data.n_items, staged.n_items - 1]  # method rows and variable rows
    valid = np.asarray([1.0] * 10 + [0.0] * 2, np.float32)
    key = jax.random.PRNGKey(seed)
    want = jax_de._sample_batch(*map(jnp.asarray, (host.contexts, host.row_splits.astype(np.int32),
                                                   host.labels, rows, valid)), bag, key,
                                jnp.asarray(host.remap_ids), jnp.asarray(host.remap_flags))
    shift, u = jax_draws(key, len(rows), len(host.remap_ids))
    got = de.sample_batch_from_shift(staged.contexts, staged.row_splits, staged.labels,
                                     torch.from_numpy(rows), torch.from_numpy(valid), bag, shift,
                                     staged.remap_ids, staged.remap_flags, u)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].numpy().dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_sampler_properties(dual_staged):
    data, host, staged = dual_staged
    var_ids = set(data.variable_indexes.tolist())
    rows = torch.arange(staged.n_items, dtype=torch.int32)
    valid = torch.ones(staged.n_items)
    g = torch.Generator().manual_seed(3)
    before = g.get_state()
    remapped = de.sample_batch(staged, rows, valid, 64, g, shuffle_variable_ids=True)
    g.set_state(before)
    plain = de.sample_batch(staged, rows, valid, 64, g)
    n_method = data.n_items
    # method rows are never remapped; paths and labels never
    for k in ("starts", "ends"):
        assert torch.equal(remapped[k][:n_method], plain[k][:n_method])
    assert torch.equal(remapped["paths"], plain["paths"])
    perms = set()
    for i in range(n_method, staged.n_items):
        real = plain["paths"][i] != PAD_INDEX
        before_ids = torch.cat([plain["starts"][i][real], plain["ends"][i][real]]).tolist()
        after_ids = torch.cat([remapped["starts"][i][real], remapped["ends"][i][real]]).tolist()
        if real.any():  # the target is @question, at the start or the end of every context
            assert ((plain["starts"][i][real] == QUESTION_TOKEN_INDEX)
                    | (plain["ends"][i][real] == QUESTION_TOKEN_INDEX)).all()
        mapping = {}
        for a, b in zip(before_ids, after_ids):
            if a not in var_ids:
                assert a == b  # ids other than @var_* ids are untouched
                continue
            assert b in var_ids and mapping.setdefault(a, b) == b
        # one permutation a row: injective on the ids it holds
        assert len(set(mapping.values())) == len(mapping)
        if mapping:
            perms.add(tuple(sorted(mapping.items())))
    assert len(perms) > 1  # rows draw their own permutations


def test_sampler_draws_shift_then_uniform(dual_staged):
    _, _, staged = dual_staged
    rows, valid = torch.arange(6, dtype=torch.int32), torch.ones(6)
    g = torch.Generator().manual_seed(9)
    got = de.sample_batch(staged, rows, valid, 8, g, shuffle_variable_ids=True)
    g2 = torch.Generator().manual_seed(9)
    shift = torch.randint(0, de.SHIFT_HIGH, (6, 1), generator=g2)
    u = torch.rand((6, len(staged.remap_ids)), generator=g2)
    want = de.sample_batch_from_shift(staged.contexts, staged.row_splits, staged.labels, rows,
                                      valid, 8, shift, staged.remap_ids, staged.remap_flags, u)
    assert all(torch.equal(got[k], want[k]) for k in got)
    assert torch.equal(g.get_state(), g2.get_state())
    # a method-only corpus (or shuffle off) draws the shifts alone
    assert not de.remaps(replace(staged, remap_ids=None), True)
    assert not de.remaps(staged, False) and de.remaps(staged, True)


# ---------------------------------------------------------------------------
# train steps and the all-PAD rows against JAX
# ---------------------------------------------------------------------------

def model_configs(data, route, dropout=0.0):
    kernel = route != "plain"
    dims = dict(terminal_count=len(data.terminal_vocab), path_count=len(data.path_vocab),
                label_count=len(data.label_vocab), terminal_embed_size=8, path_embed_size=6,
                encode_size=12)
    return (JaxModelConfig(**dims, dropout_prob=dropout, use_pallas=kernel,
                           pallas_impl=route if kernel else "pool_only", pallas_backend="cpu"),
            Code2VecConfig(**dims, dropout_prob=dropout, **ROUTES[route]))


def variable_batches(data, jax_data, feed, n=3, batch=6, bag=8):
    """``n`` variable-task batches: the host epoch's, or the device
    sampler's (with JAX's draws, checked equal to JAX ``_sample_batch``)."""
    if feed == "host":
        epoch = pipeline.build_epoch(data, np.arange(data.n_items), bag, np.random.default_rng(0))
        return list(pipeline.iter_batches(epoch, batch, rng=np.random.default_rng(1)))[:n]
    shuffle = feed == "device_shuffled"
    host = loop.stage_host(data, np.arange(data.n_items), np.random.default_rng(0))
    staged = de.place_staged(host, "cpu")
    order = np.random.default_rng(1).permutation(staged.n_items).astype(np.int32)
    out = []
    for i in range(n):
        rows, valid = order[i * batch:(i + 1) * batch], np.ones(batch, np.float32)
        key = jax.random.PRNGKey(i)
        remap = (jnp.asarray(host.remap_ids), jnp.asarray(host.remap_flags)) if shuffle else ()
        want = jax_de._sample_batch(*map(jnp.asarray, (host.contexts,
                                                       host.row_splits.astype(np.int32),
                                                       host.labels, rows, valid)), bag, key,
                                    *remap)
        shift, u = jax_draws(key, batch, len(host.remap_ids))
        got = de.sample_batch_from_shift(
            staged.contexts, staged.row_splits, staged.labels, torch.from_numpy(rows),
            torch.from_numpy(valid), bag, shift,
            *((staged.remap_ids, staged.remap_flags, u) if shuffle else ()))
        batch_np = {k: v.numpy() for k, v in got.items()}
        for k in batch_np:
            np.testing.assert_array_equal(batch_np[k], np.asarray(want[k]), err_msg=k)
        out.append(batch_np)
    return out


@pytest.mark.parametrize("feed", ["host", "device", "device_shuffled"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_variable_train_steps_match_jax(corpora, route, feed):
    data, jax_data = corpora["java", "variable"]
    batches = variable_batches(data, jax_data, feed)
    jax_cfg, cfg = model_configs(data, route)
    weights = np.ones(len(data.label_vocab), np.float32)
    train_cfg = JaxTrainConfig(lr=0.01, dropout_prob=0.0, batch_size=6, max_path_length=8)
    with gspmd():
        state = create_train_state(train_cfg, jax_cfg, jax.random.PRNGKey(7), batches[0])
        params0 = jax.tree.map(np.asarray, state.params)
        step = jax.jit(build_train_step_fn(jax_cfg, jnp.asarray(weights)))
        jax_losses = []
        for b in batches:
            state, loss = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            jax_losses.append(float(loss))
    model = Code2Vec(cfg)
    model.load_state_dict(interop.state_dict_from_jax_params(params0, cfg), strict=True)
    opt = make_optimizer(model, TrainConfig(lr=0.01))
    losses = [float(train_step(model, opt, {k: torch.from_numpy(v) for k, v in b.items()},
                               torch.from_numpy(weights))) for b in batches]
    np.testing.assert_allclose(losses, jax_losses, rtol=2e-5, atol=0)
    want = interop.state_dict_from_jax_params(jax.tree.map(np.asarray, state.params), cfg)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4, atol=3e-5, err_msg=k)


@pytest.mark.parametrize("route", list(ROUTES))
def test_all_pad_rows_match_jax(corpora, route):
    """A variable batch whose row 0 is an alias no context touches (all
    PAD, unmasked: the kernels give it uniform 1/L weights) and whose other
    rows hold one context: code vectors and gradients against JAX's."""
    data, jax_data = corpora["java", "variable"]
    epoch = pipeline.build_epoch(data, np.arange(data.n_items), 6, np.random.default_rng(0))
    counts = (epoch.paths != PAD_INDEX).sum(axis=1)
    one = np.flatnonzero(counts >= 1)[:5]
    idx = np.concatenate([[one[0]], one])
    batch = {k: getattr(epoch, k)[idx].copy() for k in ("starts", "paths", "ends", "labels")}
    for k in ("starts", "paths", "ends"):
        batch[k][0] = PAD_INDEX
        batch[k][1:, 1:] = PAD_INDEX  # one context a row
    batch["example_mask"] = np.ones(len(idx), np.float32)
    jax_cfg, cfg = model_configs(data, route)
    weights = np.ones(len(data.label_vocab), np.float32)
    train_cfg = JaxTrainConfig(dropout_prob=0.0, batch_size=len(idx), max_path_length=6)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with gspmd():
        state = create_train_state(train_cfg, jax_cfg, jax.random.PRNGKey(3), batch)

        def loss_fn(params):
            logits, cv, w = state.apply_fn({"params": params}, jb["starts"], jb["paths"],
                                           jb["ends"], deterministic=True)
            loss = jax_weighted_nll(logits, jb["labels"], jnp.asarray(weights),
                                    jb["example_mask"])
            return loss, (cv, w)

        (j_loss, (j_cv, j_w)), j_grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
    params0 = jax.tree.map(np.asarray, state.params)
    model = Code2Vec(cfg)
    model.load_state_dict(interop.state_dict_from_jax_params(params0, cfg), strict=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        _, cv, w = model.eval()(tb["starts"], tb["paths"], tb["ends"])
    np.testing.assert_allclose(cv.numpy(), np.asarray(j_cv), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(j_w), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(w[0].numpy(), np.full(6, 1 / 6, np.float32), rtol=1e-6)
    loss = forward_backward(model, tb, torch.from_numpy(weights))
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    want = interop.state_dict_from_jax_params(jax.tree.map(np.asarray, j_grads), cfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    # the all-PAD row's gradient reaches the PAD embedding rows
    assert model.terminal_embedding.weight.grad[PAD_INDEX].abs().sum() > 0


# ---------------------------------------------------------------------------
# train() against JAX train(), the export, the CLI and the task flags
# ---------------------------------------------------------------------------

def longest_variable_row(data) -> int:
    epoch = pipeline.build_epoch(data, np.arange(data.n_items), 400, np.random.default_rng(0))
    return int((epoch.paths != PAD_INDEX).sum(axis=1).max())


TRAIN_CASES = [("variable", False, True), ("dual", False, True), ("variable", True, False),
               ("dual", True, False)]


@pytest.mark.parametrize("task,device_epoch,shuffle", TRAIN_CASES,
                         ids=[f"{t}-{'device' if d else 'host'}" for t, d, _ in TRAIN_CASES])
def test_train_tracks_jax_train(corpora, task, device_epoch, shuffle):
    """Two epochs from one set of weights, dropout 0. Device epochs run
    with the shuffle off (the port's sampler draws its remap from a
    ``torch.Generator``, JAX from its keys) and a bag that holds every row
    whole."""
    data, jax_data = corpora["java", task]
    im, iv = TASKS[task]
    bag = max(longest_variable_row(data), int(np.diff(data.row_splits).max())) \
        if device_epoch else 16
    kw = dict(LOOP_KW, max_path_length=bag, infer_method_name=im, infer_variable_name=iv,
              shuffle_variable_indexes=shuffle, device_epoch=device_epoch)
    jcfg = JaxTrainConfig(**kw)
    state = create_train_state(jcfg, jax_loop.model_config_from(jcfg, jax_data),
                               jax.random.PRNGKey(11), jax_loop.dummy_batch(jcfg))
    params0 = jax.tree.map(np.asarray, state.params)
    want = jax_loop.train(jcfg, jax_data, sinks=(), initial_state=state)
    cfg = TrainConfig(**kw)
    sd = interop.state_dict_from_jax_params(params0, loop.model_config_from(cfg, data))
    got = loop.train(cfg, data, device="cpu", initial_state_dict=sd)
    assert len(got.history) == len(want.history) == 2
    for g, w in zip(got.history, want.history):
        np.testing.assert_allclose(g["train_loss"], w["train_loss"], rtol=1e-4)
        np.testing.assert_allclose(g["test_loss"], w["test_loss"], rtol=1e-4)
        for key in ("accuracy", "f1", "pad_efficiency"):
            assert g[key] == w[key], key
        assert ("truncated_context_fraction" in g) == (task == "dual")


def test_export_writes_the_variable_rows(corpora, tmp_path):
    from code2vec_tpu_torch.export import export_from_checkpoint
    from code2vec_tpu_torch.formats.vectors_io import read_code_vectors

    data, _ = corpora["java", "variable"]
    cfg = TrainConfig(**{**LOOP_KW, "max_epoch": 1}, max_path_length=16,
                      infer_method_name=False, infer_variable_name=True,
                      shuffle_variable_indexes=True)
    out = tmp_path / "m"
    loop.train(cfg, data, str(out), vectors_path=str(out / "code.vec"), device="cpu")
    labels, vectors = read_code_vectors(out / "code.vec")
    train_idx, test_idx = split_items(data.n_items, np.random.default_rng(cfg.random_seed))
    rows = [pipeline.build_epoch(data, idx, 16, np.random.default_rng(0), True)
            for idx in (train_idx, test_idx)]
    itos = data.label_vocab.itos
    assert labels == [itos[int(x)] for e in rows for x in e.labels]
    assert vectors.shape == (sum(len(e) for e in rows), 12)
    (out / "code.vec").unlink()
    export_from_checkpoint(cfg, data, str(out), str(out / "code.vec"), device="cpu")
    assert read_code_vectors(out / "code.vec")[0] == labels


@pytest.mark.parametrize("extra", [[], ["--device_epoch"], ["--bucketed"]],
                         ids=["host", "device_epoch", "bucketed"])
@pytest.mark.parametrize("tasks", [["--infer_method_name", "false"], []],
                         ids=["variable", "dual"])
def test_cli_trains_the_variable_task(tmp_path, capsys, tasks, extra):
    from code2vec_tpu_torch import cli
    from code2vec_tpu_torch.formats.vectors_io import read_code_vectors

    out = tmp_path / "cli"
    assert cli.main(["--no_cuda", "--synthetic", "small" if not extra and tasks else "tiny",
                     *tasks, "--infer_variable_name", "true", "--shuffle_variable_indexes",
                     "true", "--max_epoch", "2", "--model_path", str(out), "--vectors_path",
                     str(out / "code.vec"), "--terminal_embed_size", "8", "--path_embed_size",
                     "6", "--encode_size", "12", "--batch_size", "64", *extra]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert [x["epoch"] for x in lines] == [0, 1]
    assert all(np.isfinite(x["train_loss"]) and 0 < x["pad_efficiency"] <= 1 for x in lines)
    labels, vectors = read_code_vectors(out / "code.vec")
    assert len(labels) > 0 and np.isfinite(vectors).all()
    meta = json.loads((out / "model_meta.json").read_text())
    assert meta["infer_variable_name"] and meta["infer_method_name"] == (not tasks)


def test_cli_variable_task_without_a_device_raises_when_no_gpu(tmp_path):
    from code2vec_tpu_torch import cli

    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the no-fallback rule is checked where there is none")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--synthetic", "tiny", "--infer_method_name", "false",
                  "--infer_variable_name", "true", "--max_epoch", "1",
                  "--model_path", str(tmp_path / "m"), "--vectors_path", ""])


def test_task_flags(corpora):
    TrainConfig(infer_variable_name=True, shuffle_variable_indexes=True).validate()
    TrainConfig(infer_method_name=False, infer_variable_name=True).validate()
    with pytest.raises(ValueError, match="no task"):
        TrainConfig(infer_method_name=False).validate()
    data, _ = corpora["java", "variable"]
    with pytest.raises(ValueError, match="task flags disagree"):
        loop.train(TrainConfig(**LOOP_KW, max_path_length=8), data, device="cpu")
    with pytest.raises(ValueError, match="neither task"):
        pipeline.build_epoch(replace(data, infer_variable=False), np.arange(3), 8,
                             np.random.default_rng(0))
