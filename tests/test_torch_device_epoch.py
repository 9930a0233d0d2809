"""Device-resident epochs of the port (``train/device_epoch.py``) against the
JAX package's, on the CPU.

- Staging: ``stage_method_corpus`` gives JAX's contexts, row splits and
  labels bit for bit from the same numpy generator, which ends in the same
  state; the placed staging and the bucket partition likewise.
- The sampler: ``sample_batch_from_shift`` equals JAX ``_sample_batch``
  bit for bit on every output for the shift JAX's key draws (rows shorter
  than, equal to and longer than the bag, an empty row, a masked tail);
  and JAX ``TestSampling``'s properties on the port's generator.
- ``train(device_epoch=True)`` against JAX ``train(device_epoch=True)``
  from one set of weights, dropout 0, on a corpus whose longest row fits
  the bag (every row is taken whole, and the pool does not depend on the
  order): losses within rtol 1e-4, accuracy, F1 and ``pad_efficiency``
  equal, fixed and bucketed.
- The runner against the port's host step fed the same sampled batches,
  every route x f32/bf16 x dense/lazy; ``sample_prefetch``; the resume;
  the export's side generator; the CLI; the rejections.

Dims are tiny (embed 8/6, encode 12).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu.data import reader as jax_reader
from code2vec_tpu.train import device_epoch as jax_de
from code2vec_tpu.train import loop as jax_loop
from code2vec_tpu.train.config import TrainConfig as JaxTrainConfig
from code2vec_tpu.train.step import create_train_state
from code2vec_tpu_torch import PAD_INDEX, interop
from code2vec_tpu_torch.data import reader, synth
from code2vec_tpu_torch.data.pipeline import split_items
from code2vec_tpu_torch.models.code2vec import Code2Vec
from code2vec_tpu_torch.train import device_epoch as de
from code2vec_tpu_torch.train import loop
from code2vec_tpu_torch.train.config import TrainConfig
from code2vec_tpu_torch.train.step import StepTally, make_optimizer, to_device, train_step

LOOP_KW = dict(terminal_embed_size=8, path_embed_size=6, encode_size=12, batch_size=32,
               max_epoch=2, dropout_prob=0.0, random_seed=11, print_sample_cycle=0,
               device_epoch=True)
ROUTES = {"plain": {}, **{r: dict(use_pallas=True, pallas_impl=r)
                          for r in ("pool_only", "gather_split", "fused")}}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    paths = synth.generate_corpus_files(tmp_path_factory.mktemp("tiny_de"), synth.SPECS["tiny"])
    args = (paths["corpus"], paths["path_idx"], paths["terminal_idx"])
    data = reader.load_corpus(*args)
    return paths, data, jax_reader.load_corpus(*args, cache=False, native=False)


def longest(data) -> int:
    return int(np.diff(data.row_splits).max())


# ---------------------------------------------------------------------------
# (a) staging, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["train", "test", "subset", "empty"])
def test_staging_matches_jax_bitwise(tiny, which):
    _, data, jax_data = tiny
    train_idx, test_idx = split_items(data.n_items, np.random.default_rng(0))
    idx = {"train": train_idx, "test": test_idx, "subset": np.asarray([3, 0, 5]),
           "empty": np.zeros(0, np.int64)}[which]
    rng, jrng = np.random.default_rng(7), np.random.default_rng(7)
    got = de.stage_method_corpus(data, idx, rng)
    want = jax_de.stage_method_corpus(jax_data, idx, jrng, device="host")
    for key in ("contexts", "row_splits", "labels"):
        a, b = getattr(got, key), np.asarray(getattr(want, key))
        assert a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    assert got.n_items == want.n_items and got.n_contexts == want.n_contexts
    np.testing.assert_array_equal(got.counts, np.diff(want.row_splits))
    assert rng.bit_generator.state == jrng.bit_generator.state
    placed = de.place_staged(got, "cpu")
    assert placed.row_splits.dtype == torch.int32 and placed.contexts.dtype == torch.int32
    np.testing.assert_array_equal(placed.contexts.numpy(), got.contexts)
    np.testing.assert_array_equal(placed.row_splits.numpy(), got.row_splits)
    assert placed.nbytes == got.contexts.nbytes + 4 * len(got.row_splits) + got.labels.nbytes


def test_no_method_token_leaks(tiny):
    _, data, _ = tiny
    mid = data.method_token_index
    assert mid is not None
    ctx = de.stage_method_corpus(data, np.arange(data.n_items), np.random.default_rng(0)).contexts
    assert not (ctx[:, 0] == mid).any() and not (ctx[:, 2] == mid).any()


@pytest.mark.parametrize("ladder", [(10, 20, 40), (16, 64, 400)])
def test_bucket_partition_matches_jax(tiny, ladder):
    _, data, jax_data = tiny
    idx = np.arange(data.n_items)
    got = de.bucket_staged(de.stage_method_corpus(data, idx, np.random.default_rng(2)), ladder,
                           "cpu")
    want = jax_de._bucket_host_partition(
        jax_de.stage_method_corpus(jax_data, idx, np.random.default_rng(2), device="host"),
        ladder)
    assert [w for w, _ in got.buckets] == [w for w, _ in want]
    for (_, g), (_, w) in zip(got.buckets, want):
        np.testing.assert_array_equal(g.contexts.numpy(), np.asarray(w.contexts))
        np.testing.assert_array_equal(g.row_splits.numpy(), np.asarray(w.row_splits))
        np.testing.assert_array_equal(g.labels.numpy(), np.asarray(w.labels))
        np.testing.assert_array_equal(g.counts, np.diff(np.asarray(w.row_splits)))
    np.testing.assert_array_equal(got.host_labels(),
                                  np.concatenate([np.asarray(w.labels) for _, w in want]))
    assert got.n_items == data.n_items and got.n_contexts == data.n_contexts


# ---------------------------------------------------------------------------
# (b, c) the sampler
# ---------------------------------------------------------------------------

def csr(lens, seed=0):
    rng = np.random.default_rng(seed)
    splits = np.zeros(len(lens) + 1, np.int32)
    np.cumsum(lens, out=splits[1:])
    ctx = rng.integers(1, 1000, (int(splits[-1]), 3)).astype(np.int32)
    labels = rng.integers(0, 7, len(lens)).astype(np.int32)
    return ctx, splits, labels


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sampler_matches_jax_bitwise(seed):
    bag = 8
    # shorter than, equal to and longer than the bag, an empty row
    ctx, splits, labels = csr([5, 8, 1, 0, 13, 40], seed)
    rows = np.asarray([0, 1, 2, 3, 4, 5, 4, 0, 0, 0], np.int32)  # a masked tail of 3
    valid = np.asarray([1] * 7 + [0] * 3, np.float32)
    key = jax.random.PRNGKey(seed)
    want = jax_de._sample_batch(jnp.asarray(ctx), jnp.asarray(splits), jnp.asarray(labels),
                                jnp.asarray(rows), jnp.asarray(valid), bag, key)
    shift = jax.random.randint(key, (len(rows), 1), 0, 1 << 30)
    got = de.sample_batch_from_shift(*map(torch.from_numpy, (ctx, splits, labels, rows, valid)),
                                     bag, torch.from_numpy(np.array(shift)))
    assert got.keys() == want.keys()
    for k in got:
        w = np.asarray(want[k])
        assert got[k].numpy().dtype == w.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    # the keys and dtypes the step's host feed gives it
    host = to_device({k: v.numpy() for k, v in got.items()}, torch.device("cpu"))
    assert {k: v.dtype for k, v in host.items()} == {k: v.dtype for k, v in got.items()}


def staged_csr(lens, seed=0):
    ctx, splits, labels = csr(lens, seed)
    return de.StagedCorpus(torch.from_numpy(ctx), torch.from_numpy(splits),
                           torch.from_numpy(labels), len(lens), np.asarray(lens, np.int64))


def test_small_rows_take_everything_once():
    bag, lens = 8, [5, 8, 1, 0]
    corpus = staged_csr(lens)
    batch = de.sample_batch(corpus, torch.arange(4), torch.ones(4), bag,
                            torch.Generator().manual_seed(0))
    splits = corpus.row_splits.numpy()
    for i, n in enumerate(lens):
        row = batch["starts"][i].numpy()
        assert (row[n:] == PAD_INDEX).all()
        want = sorted(corpus.contexts[splits[i]:splits[i] + n, 0].tolist())
        assert sorted(row[:n].tolist()) == want


def test_large_rows_no_duplicates_and_fresh_windows():
    bag = 8
    corpus = staged_csr([40])
    g = torch.Generator().manual_seed(0)
    seen = set()
    for _ in range(6):
        batch = de.sample_batch(corpus, torch.zeros(1, dtype=torch.int32), torch.ones(1), bag, g)
        window = tuple(batch["paths"][0].tolist())
        assert len(set(window)) == bag
        seen.add(window)
    assert len(seen) > 1


def test_inclusion_marginals_uniform():
    bag, n, draws = 16, 64, 300
    corpus = staged_csr([n])
    corpus.contexts[:, 0] = torch.arange(1, n + 1, dtype=torch.int32)
    counts = np.zeros(n)
    g = torch.Generator().manual_seed(0)
    for _ in range(draws):
        batch = de.sample_batch(corpus, torch.zeros(1, dtype=torch.int32), torch.ones(1), bag, g)
        np.add.at(counts, batch["starts"][0].numpy() - 1, 1)
    expect = draws * bag / n
    assert counts.min() > 0.5 * expect and counts.max() < 1.7 * expect


# ---------------------------------------------------------------------------
# (d) train() against JAX train(), device epochs on both sides
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bucketed", [False, True], ids=["fixed", "bucketed"])
def test_device_epochs_track_jax_train(tiny, bucketed):
    _, data, jax_data = tiny
    kw = dict(LOOP_KW, max_path_length=longest(data), bucketed=bucketed,
              device_chunk_batches=16)
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
    first, second = got.history
    assert first["stage_seconds"] >= 0 and "stage_seconds" not in second
    if not bucketed:
        # contexts, int32 splits of both splits, labels
        assert first["staged_bytes"] == 12 * data.n_contexts + 4 * (data.n_items + 2) \
            + 4 * data.n_items
        assert first["train_steps"] == -(-(data.n_items - data.n_items // 5) // 32)


# ---------------------------------------------------------------------------
# (e, f) the runner against the host step over the same sampled batches
# ---------------------------------------------------------------------------

def runner_case(data, route, dtype, update, dropout=0.25, **kw):
    cfg = TrainConfig(**{**LOOP_KW, "max_path_length": 24, "batch_size": 16,
                         "dropout_prob": dropout, "compute_dtype": dtype,
                         "adam_mu_dtype": dtype, "table_update": update, **ROUTES[route], **kw})
    models = []
    for _ in range(2):
        model = Code2Vec(loop.model_config_from(cfg, data))
        model.reset_parameters(torch.Generator().manual_seed(3))
        model.seed_dropout(4)
        models.append((model, make_optimizer(model, cfg)))
    weights = loop.class_weights_from(cfg, data)
    corpus = de.stage_method_corpus(data, np.arange(data.n_items), np.random.default_rng(0),
                                    device="cpu")
    runner = de.EpochRunner(weights, cfg.batch_size, cfg.max_path_length, 3,
                            cfg.sample_prefetch)
    return cfg, models, weights, corpus, runner


@pytest.mark.parametrize("update", ["dense", "lazy"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_runner_matches_the_host_step(tiny, route, dtype, update):
    """One chunk of 3 device-epoch steps (dropout on, one keep-mask seed)
    against ``train_step`` fed the same batches through the host feed
    (``to_device`` of their numpy copies): the same losses and weights."""
    _, data, _ = tiny
    cfg, ((m_dev, o_dev), (m_host, o_host)), weights, corpus, runner = runner_case(
        data, route, dtype, update)
    order = np.random.default_rng(1).permutation(data.n_items)
    (row_lo, nb, n_valid), *_ = runner._chunk_plan(data.n_items)
    g = de.sampler_generator(5, "cpu")
    state = g.get_state()
    tally = StepTally(torch.device("cpu"))
    runner.train_chunk(m_dev, o_dev, corpus, order, row_lo, nb, n_valid, g, tally)
    dev_loss, speed = tally.result()
    assert speed["train_steps"] == nb == 3
    g.set_state(state)
    batches = list(runner._batches(corpus, order, row_lo, nb, n_valid, g))
    host = [train_step(m_host, o_host, to_device({k: v.numpy() for k, v in b.items()},
                                                 torch.device("cpu")), weights)
            for b in batches]
    assert dev_loss == float(torch.stack(host).double().sum())
    for (k, a), b in zip(m_dev.state_dict().items(), m_host.state_dict().values()):
        assert torch.equal(a, b), k
    # the speed counts the real contexts of the steps after the first
    real = [int((b["paths"] != PAD_INDEX).sum()) for b in batches]
    assert tally.contexts == sum(real[1:])


@pytest.mark.parametrize("route", ["plain", "fused"])
def test_sample_prefetch_gives_the_same_batches_and_losses(tiny, route):
    _, data, _ = tiny
    outs = []
    for prefetch in (False, True):
        cfg, ((model, opt), _), _, corpus, runner = runner_case(
            data, route, "float32", "dense", sample_prefetch=prefetch)
        assert runner.sample_prefetch is prefetch
        order = np.random.default_rng(1).permutation(data.n_items)
        g = de.sampler_generator(5, "cpu")
        batches = [b for lo, nb, nv in runner._chunk_plan(data.n_items)
                   for b in runner._batches(corpus, order, lo, nb, nv, g)]
        after = g.get_state()
        loss, _ = runner.run_train_epoch(model, opt, corpus, np.random.default_rng(1),
                                         de.sampler_generator(5, "cpu"))
        outs.append((batches, after, loss, model.state_dict()))
    (b0, s0, l0, p0), (b1, s1, l1, p1) = outs
    assert len(b0) == len(b1) == -(-data.n_items // 16)
    for x, y in zip(b0, b1):
        for k in x:
            assert torch.equal(x[k], y[k]), k
    assert torch.equal(s0, s1) and l0 == l1
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k


def test_bucketed_runner_draws_the_bucket_order_then_each_bucket(tiny):
    _, data, _ = tiny
    ladder = (16, 32, longest(data))
    weights = torch.ones(len(data.label_vocab))
    host = de.stage_method_corpus(data, np.arange(data.n_items), np.random.default_rng(0))
    corpus = de.bucket_staged(host, ladder, "cpu")
    runner = de.BucketedEpochRunner(weights, 16, ladder, 2)
    seen = []

    class Recorder(de.EpochRunner):
        def train_epoch(self, model, optimizer, staged, rng, generator, tally):
            seen.append((self.bag, rng.permutation(staged.n_items)))

    runner._runners = {w: Recorder(weights, 16, w, 2) for w in ladder}
    runner.run_train_epoch(None, None, corpus, np.random.default_rng(9), None)
    rng = np.random.default_rng(9)
    want = []
    for i in rng.permutation(len(corpus.buckets)):
        width, staged = corpus.buckets[int(i)]
        want.append((width, rng.permutation(staged.n_items)))
    assert len(corpus.buckets) > 1 and [w for w, _ in seen] == [w for w, _ in want]
    for (_, a), (_, b) in zip(seen, want):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# (g) resume, (h) the export's side generator
# ---------------------------------------------------------------------------

def history(result):
    skip = ("epoch_seconds", "stage_seconds", "staged_bytes", "steps_per_s", "contexts_per_s")
    return [{k: v for k, v in m.items() if k not in skip} for m in result.history]


def test_resume_reproduces_the_uninterrupted_epoch(tiny, tmp_path):
    """Dropout on, fused route: the restored numpy, dropout and sampler
    generators carry on the uninterrupted run's streams."""
    _, data, _ = tiny
    cfg = TrainConfig(**{**LOOP_KW, "max_path_length": 24, "dropout_prob": 0.25,
                         "use_pallas": True, "pallas_impl": "fused", "device_chunk_batches": 2})
    whole = loop.train(cfg, data, str(tmp_path / "a"), device="cpu")
    loop.train(cfg.with_updates(max_epoch=1), data, str(tmp_path / "b"), device="cpu")
    resumed = loop.train(cfg.with_updates(resume=True), data, str(tmp_path / "b"), device="cpu")
    assert resumed.epochs_run == 1
    assert history(resumed)[1] == history(whole)[1]
    state = torch.load(tmp_path / "b" / "checkpoint_best.pt", weights_only=False)
    assert state["sampler_rng_state"] is not None


def test_a_host_checkpoint_resumes_with_a_fresh_sampler_and_says_so(tiny, tmp_path, caplog):
    _, data, _ = tiny
    cfg = TrainConfig(**{**LOOP_KW, "max_path_length": 24, "max_epoch": 1})
    out = str(tmp_path / "m")
    loop.train(cfg.with_updates(device_epoch=False), data, out, device="cpu")
    assert torch.load(tmp_path / "m" / "checkpoint_best.pt",
                      weights_only=False)["sampler_rng_state"] is None
    with caplog.at_level("INFO", logger="code2vec_tpu_torch.checkpoint"):
        resumed = loop.train(cfg.with_updates(max_epoch=2, resume=True), data, out, device="cpu")
    assert resumed.epochs_run == 1
    assert "holds no device-epoch sampler state" in caplog.text


def test_export_and_print_sample_leave_the_history_alone(tiny, tmp_path):
    _, data, _ = tiny
    cfg = TrainConfig(**{**LOOP_KW, "max_path_length": 24, "max_epoch": 3})
    quiet = loop.train(cfg, data, device="cpu")
    loud = loop.train(cfg.with_updates(print_sample_cycle=2), data, device="cpu",
                      vectors_path=str(tmp_path / "code.vec"))
    assert history(loud) == history(quiet)
    from code2vec_tpu_torch.formats.vectors_io import read_code_vectors

    labels, vectors = read_code_vectors(tmp_path / "code.vec")
    assert len(labels) == data.n_items and vectors.shape == (data.n_items, 12)


# ---------------------------------------------------------------------------
# (i) the CLI, (j) the rejections
# ---------------------------------------------------------------------------

def test_cli_trains_device_epochs(tmp_path, capsys):
    from code2vec_tpu_torch import cli

    out = tmp_path / "cli"
    assert cli.main(["--synthetic", "tiny", "--device", "cpu", "--device_epoch",
                     "--device_chunk_batches", "2", "--sample_prefetch", "true",
                     "--max_epoch", "2", "--model_path", str(out),
                     "--vectors_path", str(out / "code.vec"), "--terminal_embed_size", "8",
                     "--path_embed_size", "6", "--encode_size", "12"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert [x["epoch"] for x in lines] == [0, 1]
    assert all(np.isfinite(x["train_loss"]) and x["train_steps"] == 5 for x in lines)
    assert "stage_seconds" in lines[0] and "stage_seconds" not in lines[1]
    assert (out / "code.vec").exists() and (out / "checkpoint_best.pt").exists()


@pytest.mark.parametrize("kw,match", [
    (dict(device_epoch=True, bucketed=True, max_contexts=0), "does not compose"),
    (dict(sample_prefetch=True), "requires --device_epoch"),
    (dict(device_epoch=True, device_chunk_batches=0), "device_chunk_batches"),
])
def test_rejections(kw, match):
    with pytest.raises(ValueError, match=match):
        TrainConfig(**kw).validate()


def test_device_epochs_without_a_device_raise_when_no_gpu(tiny):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the no-fallback rule is checked where there is none")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop.train(TrainConfig(**LOOP_KW, max_path_length=24), tiny[1])
