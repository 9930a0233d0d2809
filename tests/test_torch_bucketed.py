"""Bucketed and long-bag training of the port against the JAX package's, on the CPU.

- The bucketing functions of ``data/pipeline.py`` (``parse_bucket_ladder``,
  ``assign_buckets``, ``pad_stats``, ``bucket_batch_counts``,
  ``truncated_fraction(_of_counts)``, ``iter_bucketed_batches``) and the
  in-RAM ``EpochSource``: bitwise equal to JAX's, errors included, and the
  numpy generator in the same state afterwards;
- the fused op with a keep mask in ``two_pass`` (and ``online``) mode: the
  port's plain version against the JAX op's streamed kernel under the
  Pallas interpreter, values and VJP, rtol 2e-4 / atol 2e-5 (the masked
  fused-op test's tolerance);
- ``train()`` with ``bucketed=True`` (a derived and an explicit ladder) and
  with ``max_contexts=0`` (long bags) against JAX ``train()`` for 2 epochs
  from one set of weights, dropout 0: losses within rtol 1e-4, accuracy,
  F1, ``pad_efficiency`` and ``truncated_context_fraction`` equal, the
  recorded ladder equal, and the long-bag dir served by the ``Predictor``;
- the long-bag ``two_pass`` route's gradients against the plain route's
  with the keep mask on, and the rejections.

The corpus is skewed (lognormal sigma 1.2, bags up to 4x the training
bag). The JAX fused op runs under the GSPMD partitioner (ROADMAP §C).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu.data import pipeline as jax_pipeline
from code2vec_tpu.data import reader as jax_reader
from code2vec_tpu.ops.fused_encode_pool import fused_encode_attend_pool as jax_fused
from code2vec_tpu.train import loop as jax_loop
from code2vec_tpu.train.config import TrainConfig as JaxTrainConfig
from code2vec_tpu.train.step import create_train_state, make_eval_step, make_train_step
from code2vec_tpu_torch import interop
from code2vec_tpu_torch.data import pipeline, reader, synth
from code2vec_tpu_torch.models.code2vec import Code2Vec
from code2vec_tpu_torch.ops.fused_encode_pool import fused_encode_attend_pool
from code2vec_tpu_torch.train import loop
from code2vec_tpu_torch.train.config import TrainConfig
from code2vec_tpu_torch.train.step import forward_backward
from tests.test_torch_train import gspmd

BAG = 40
SKEWED = synth.SynthSpec(n_methods=160, n_terminals=200, n_paths=150, n_labels=10,
                         mean_contexts=12.0, length_sigma=1.2, max_contexts=4 * BAG,
                         signature_size=15, seed=3)
LOOP_KW = dict(terminal_embed_size=8, path_embed_size=6, encode_size=12, batch_size=16,
               max_path_length=BAG, max_epoch=2, dropout_prob=0.0, random_seed=11,
               print_sample_cycle=0)


@pytest.fixture(scope="module")
def skewed(tmp_path_factory):
    paths = synth.generate_corpus_files(tmp_path_factory.mktemp("skewed"), SKEWED)
    args = (paths["corpus"], paths["path_idx"], paths["terminal_idx"])
    return paths, reader.load_corpus(*args), jax_reader.load_corpus(*args, cache=False,
                                                                      native=False)


def same_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


# ---------------------------------------------------------------------------
# the bucketing functions, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec,top", [("25,50,100,200", 200), ("200,25, 100,50", 200),
                                      ("40", 40), ("8,8,16,40", 40), ("", 40), ("  ", 40)])
def test_parse_bucket_ladder_matches_jax(spec, top):
    got = pipeline.parse_bucket_ladder(spec, top)
    assert got == jax_pipeline.parse_bucket_ladder(spec, top)
    assert got is None or (got[-1] == top and list(got) == sorted(set(got)))


@pytest.mark.parametrize("spec", ["25,x,200", "0,40", "10,20", "-5,40", "25,50,100"])
def test_malformed_bucket_ladder_raises_as_jax(spec):
    with pytest.raises(ValueError) as port_err:
        pipeline.parse_bucket_ladder(spec, 40 if "100" not in spec else 200)
    with pytest.raises(ValueError) as jax_err:
        jax_pipeline.parse_bucket_ladder(spec, 40 if "100" not in spec else 200)
    assert str(port_err.value) == str(jax_err.value)


LADDERS = [(40,), (10, 20, 40), (5, 13, 40), (10, 20, 40, 128, 256)]


def counts_of(seed=0, n=300, top=256):
    rng = np.random.default_rng(seed)
    counts = np.clip(rng.lognormal(np.log(15), 1.2, n).astype(np.int64), 0, top)
    counts[:3] = (0, 1, top)
    return counts


@pytest.mark.parametrize("ladder", LADDERS)
def test_assign_buckets_matches_jax(ladder):
    counts = counts_of()
    got = pipeline.assign_buckets(counts, ladder)
    np.testing.assert_array_equal(got, jax_pipeline.assign_buckets(counts, ladder))
    assert got.max() < len(ladder)


@pytest.mark.parametrize("pad_final", [True, False])
@pytest.mark.parametrize("ladder", LADDERS)
def test_pad_stats_matches_jax(ladder, pad_final):
    counts = counts_of(1)
    got = pipeline.pad_stats(counts, ladder, 16, pad_final)
    assert got == jax_pipeline.pad_stats(counts, ladder, 16, pad_final)
    assert all(isinstance(x, int) for x in got)


@pytest.mark.parametrize("ladder", LADDERS)
def test_bucket_batch_counts_matches_jax(ladder):
    for counts in (counts_of(2), np.zeros(0, np.int64)):
        got = pipeline.bucket_batch_counts(counts, ladder, 16)
        want = jax_pipeline.bucket_batch_counts(counts, ladder, 16)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


@pytest.mark.parametrize("cap", [0, 1, 40, 256, 1000])
def test_truncated_fraction_matches_jax(cap):
    counts = counts_of(3)
    assert (pipeline.truncated_fraction_of_counts(counts, cap)
            == jax_pipeline.truncated_fraction_of_counts(counts, cap))
    lengths, weights = np.unique(counts, return_counts=True)
    assert (pipeline.truncated_fraction(lengths, weights, cap)
            == jax_pipeline.truncated_fraction(lengths, weights, cap))
    assert pipeline.truncated_fraction(np.zeros(0), np.zeros(0), cap) == 0.0


def skewed_epoch(data_pair, mod, cap, seed=5):
    _, data, jax_data = data_pair
    d = data if mod is pipeline else jax_data
    return mod.build_epoch(d, np.arange(d.n_items), cap, np.random.default_rng(seed))


@pytest.mark.parametrize("pad_final", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
def test_iter_bucketed_batches_match_jax(skewed, shuffle, pad_final):
    ladder = (10, 20, 40, 128, 256)
    out = []
    for mod in (pipeline, jax_pipeline):
        epoch = skewed_epoch(skewed, mod, 256)
        rng = np.random.default_rng(9)
        batches = list(mod.iter_bucketed_batches(epoch, ladder, 16,
                                                 rng=rng if shuffle else None,
                                                 pad_final=pad_final))
        out.append((batches, rng.bit_generator.state))
        np.testing.assert_array_equal(pipeline.epoch_context_counts(epoch),
                                      jax_pipeline.epoch_context_counts(epoch))
    same_batches(out[0][0], out[1][0])
    assert out[0][1] == out[1][1]
    widths = [b["starts"].shape[1] for b in out[0][0]]
    assert set(widths) <= set(ladder)
    if not shuffle:
        assert widths == sorted(widths)
    for b in out[0][0]:  # a partial batch repeats its own first row
        valid = int(b["example_mask"].sum())
        assert (b["ids"][valid:] == b["ids"][0]).all()


@pytest.mark.parametrize("ladder", [None, (10, 20, 40)])
@pytest.mark.parametrize("shuffle", [True, False])
def test_epoch_source_matches_jax(skewed, ladder, shuffle):
    _, data, jax_data = skewed
    items = np.random.default_rng(0).permutation(data.n_items)[:120]
    out = []
    for mod, d in ((pipeline, data), (jax_pipeline, jax_data)):
        source = mod.make_batch_source(d, items, 16, BAG, ladder=ladder)
        assert source.pad_stats() is None and source.last_epoch is None
        rng = np.random.default_rng(4)
        stream = source.batches(rng, shuffle=shuffle)
        assert source.last_epoch is None  # built at the first pull
        epochs = [list(stream), list(source.batches(rng, shuffle=shuffle))]
        out.append((epochs, source.pad_stats(), source.last_epoch, rng.bit_generator.state,
                    source.ladder))
    (p_epochs, p_pad, p_last, p_state, p_ladder), (j_epochs, j_pad, j_last, j_state,
                                                  j_ladder) = out
    for a, b in zip(p_epochs, j_epochs):
        same_batches(a, b)
    assert p_pad == j_pad and p_state == j_state and p_ladder == j_ladder
    for field in ("ids", "starts", "paths", "ends", "labels"):
        np.testing.assert_array_equal(getattr(p_last, field), getattr(j_last, field))


def test_make_batch_source_refuses_what_is_not_ported(skewed):
    """Bucketing with streaming is ported now: the policy hands back a
    bucketed ``StreamingSource`` whose stream is JAX's bit for bit."""
    _, data, jax_data = skewed
    idx = np.arange(8)
    src = pipeline.make_batch_source(data, idx, 4, BAG, ladder=(20, 40), stream_chunk_items=8)
    want = jax_pipeline.make_batch_source(jax_data, idx, 4, BAG, ladder=(20, 40),
                                          stream_chunk_items=8)
    assert type(src) is pipeline.StreamingSource and src.ladder == (20, 40)
    r1, r2 = np.random.default_rng(4), np.random.default_rng(4)
    same_batches(list(src.batches(r1)), list(want.batches(r2)))
    assert r1.bit_generator.state == r2.bit_generator.state


# ---------------------------------------------------------------------------
# the fused op with a keep mask, streamed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,L,chunk_l", [("two_pass", 11, 128), ("two_pass", 150, 64),
                                            ("two_pass", 300, 128), ("online", 150, 64)])
def test_masked_streamed_op_matches_jax(mode, L, chunk_l):
    """Values and VJP of the masked op in a streamed mode against the JAX
    op's streamed kernel (``interpret=True``: off the TPU its wrapper
    would rewrite the mode to materialize); both backwards recompute the
    plain formulation."""
    rng = np.random.default_rng(L + chunk_l)
    B, Et, Ep, H = 3, 6, 5, 12
    t = rng.normal(size=(30, Et)).astype(np.float32)
    p = rng.normal(size=(25, Ep)).astype(np.float32)
    ids = [rng.integers(1, n, (B, L)).astype(np.int32) for n in (30, 25, 30)]
    for i, n in enumerate((L, max(1, L // 3), 0)):  # a full bag, a PAD tail, an all-PAD row
        for x in ids:
            x[i, n:] = 0
    mask = (ids[0] > 0).astype(np.float32)
    dense = (rng.normal(size=(2 * Et + Ep, H)) / 4).astype(np.float32)
    lns = (1 + 0.1 * rng.normal(size=H)).astype(np.float32)
    lnb = (0.1 * rng.normal(size=H)).astype(np.float32)
    attn = rng.normal(size=H).astype(np.float32)
    drop = (rng.random((B, L, H)) < 0.75).astype(np.float32) / 0.75
    g_cv = rng.normal(size=(B, H)).astype(np.float32)
    g_w = rng.normal(size=(B, L)).astype(np.float32)
    diff = (t, p, dense, lns, lnb, attn)

    def jax_fn(t_, p_, d_, s_, b_, a_):
        return jax_fused(t_, p_, *map(jnp.asarray, ids), jnp.asarray(mask), d_, s_, b_, a_,
                         drop_mask=jnp.asarray(drop), impl="fused", softmax_mode=mode,
                         chunk_l=chunk_l, block_b=4, interpret=True)

    with gspmd():
        (j_cv, j_w), vjp = jax.vjp(jax_fn, *map(jnp.asarray, diff))
        j_grads = vjp((jnp.asarray(g_cv), jnp.asarray(g_w)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in diff]
    cv, w = fused_encode_attend_pool(
        leaves[0], leaves[1], *(torch.from_numpy(x) for x in ids), torch.from_numpy(mask),
        *leaves[2:], torch.from_numpy(drop), impl="fused", softmax_mode=mode, chunk_l=chunk_l)
    np.testing.assert_allclose(cv.detach().numpy(), np.asarray(j_cv), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(j_w), rtol=2e-4, atol=2e-5)
    grads = torch.autograd.grad((cv, w), leaves, (torch.from_numpy(g_cv), torch.from_numpy(g_w)))
    for name, a, b in zip(("t_table", "p_table", "dense", "ln_scale", "ln_bias", "attn"), grads,
                          j_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-5, err_msg=name)


# ---------------------------------------------------------------------------
# train() against JAX train()
# ---------------------------------------------------------------------------


def jax_and_port_train(skewed, tmp_path, with_dir=False, **kw):
    """2 epochs of JAX ``train()`` and of the port's from the JAX run's
    initial weights; the JAX steps run its kernels on the CPU strategy."""
    _, data, jax_data = skewed
    jcfg = JaxTrainConfig(**LOOP_KW, **kw)
    model_cfg = jax_loop.model_config_from(jcfg, jax_data)
    if jcfg.use_pallas:
        model_cfg = model_cfg.__class__(**{**vars(model_cfg), "pallas_backend": "cpu"})
    weights = jax_loop.class_weights_from(jcfg, jax_data)
    with gspmd():
        state = create_train_state(jcfg, model_cfg, jax.random.PRNGKey(11),
                                   jax_loop.dummy_batch(jcfg))
        params0 = jax.tree.map(np.asarray, state.params)
        want = jax_loop.train(jcfg, jax_data, str(tmp_path / "jax") if with_dir else None,
                              sinks=(), initial_state=state,
                              train_step=make_train_step(model_cfg, weights),
                              eval_step=make_eval_step(model_cfg, weights))
    cfg = TrainConfig(**LOOP_KW, **kw)
    sd = interop.state_dict_from_jax_params(params0, loop.model_config_from(cfg, data))
    got = loop.train(cfg, data, str(tmp_path / "port") if with_dir else None, device="cpu",
                     initial_state_dict=sd)
    assert len(got.history) == len(want.history) == 2
    for g, w in zip(got.history, want.history):
        np.testing.assert_allclose(g["train_loss"], w["train_loss"], rtol=1e-4)
        np.testing.assert_allclose(g["test_loss"], w["test_loss"], rtol=1e-4)
        for key in ("accuracy", "f1", "pad_efficiency", "truncated_context_fraction"):
            assert g[key] == w[key], key
    return got, want


ROUTES = {"plain": {}, "pool_only": dict(use_pallas=True, pallas_impl="pool_only")}


@pytest.mark.parametrize("ladder", ["", "10,20,40"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_bucketed_train_tracks_jax(skewed, tmp_path, route, ladder):
    got, _ = jax_and_port_train(skewed, tmp_path, bucketed=True, bucket_ladder=ladder,
                                **ROUTES[route])
    fixed = loop.train(TrainConfig(**LOOP_KW, **ROUTES[route]), skewed[1], device="cpu")
    for g, f in zip(got.history, fixed.history):
        # bucketing feeds fewer PAD slots; the cap is the same bag
        assert g["pad_efficiency"] > f["pad_efficiency"]
        assert g["truncated_context_fraction"] == f["truncated_context_fraction"] > 0


LONGBAG_ROUTES = {
    "plain": {},
    "pool_only": dict(use_pallas=True, pallas_impl="pool_only"),
    "fused_auto": dict(use_pallas=True, pallas_impl="fused"),
    "fused_two_pass": dict(use_pallas=True, pallas_impl="fused", pallas_softmax="two_pass"),
}


@pytest.mark.parametrize("route", list(LONGBAG_ROUTES))
def test_longbag_train_tracks_jax(skewed, tmp_path, route):
    paths, data, _ = skewed
    with_dir = route == "fused_auto"
    got, _ = jax_and_port_train(skewed, tmp_path, with_dir=with_dir, bucketed=True,
                                max_contexts=0, **LONGBAG_ROUTES[route])
    assert all(m["truncated_context_fraction"] == 0.0 for m in got.history)
    if not with_dir:
        return
    meta = json.loads((tmp_path / "port" / "model_meta.json").read_text())
    jax_meta = json.loads((tmp_path / "jax" / "model_meta.json").read_text())
    assert meta["bucket_ladder"] == jax_meta["bucket_ladder"]
    assert meta["bucket_ladder"][-1] >= int(np.diff(data.row_splits).max()) > BAG

    # the dir serves a bag longer than the training bag through the long rungs
    from code2vec_tpu_torch.predict import Predictor

    pred = Predictor(str(tmp_path / "port"), paths["terminal_idx"], paths["path_idx"],
                     device="cpu")
    assert pred.bag == meta["bucket_ladder"][-1] and pred.model.config.longbag_width == BAG
    ctx = [(int(s), int(p), int(e)) for s, p, e in zip(data.starts[:3 * BAG],
                                                       data.paths[:3 * BAG],
                                                       data.ends[:3 * BAG])]
    served = pred.predict_contexts(ctx, top_k=3)
    assert served.n_contexts == 3 * BAG
    width = pipeline.nearest_bucket_width(3 * BAG, tuple(meta["bucket_ladder"]))
    ids = np.zeros((3, 1, width), np.int64)
    ids[:, 0, :3 * BAG] = np.asarray(ctx).T
    plain = pred.model.__class__(pred.config.with_updates(use_pallas=False))
    plain.load_state_dict(pred.model.state_dict())
    with torch.no_grad():
        _, cv, _ = plain.eval()(*(torch.from_numpy(x) for x in ids))
    np.testing.assert_allclose(served.code_vector, cv[0].numpy(), rtol=1e-5, atol=1e-6)


def test_longbag_two_pass_gradients_match_the_plain_route(skewed):
    """A training forward at a long rung, keep mask on: the two_pass route
    (K4's plain version) and the plain route draw one mask from one
    generator seed and give the same gradients."""
    _, data, _ = skewed
    cfg = TrainConfig(**{**LOOP_KW, "dropout_prob": 0.25}, bucketed=True, max_contexts=0)
    ladder, bag_width = loop.resolve_ladder(cfg, data)
    assert bag_width == ladder[-1] > BAG
    epoch = pipeline.build_epoch(data, np.arange(data.n_items), bag_width,
                                 np.random.default_rng(0))
    batch = next(b for b in pipeline.iter_bucketed_batches(epoch, ladder, 16)
                 if b["starts"].shape[1] == ladder[-1])
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    weights = loop.class_weights_from(cfg, data)
    grads = {}
    for route, kw in (("plain", {}), ("two_pass", LONGBAG_ROUTES["fused_two_pass"])):
        model = Code2Vec(loop.model_config_from(cfg.with_updates(**kw), data))
        model.reset_parameters(torch.Generator().manual_seed(3))
        model.seed_dropout(7)
        model.train()
        assert model.resolve_kernel(cfg.batch_size, ladder[-1]) == (
            ("fused", "two_pass") if route == "two_pass" else (None, "materialize"))
        loss = forward_backward(model, batch, weights)
        grads[route] = (float(loss), {k: p.grad for k, p in model.named_parameters()})
    assert grads["two_pass"][0] == pytest.approx(grads["plain"][0], rel=1e-5)
    for k, g in grads["plain"][1].items():
        torch.testing.assert_close(grads["two_pass"][1][k], g, rtol=1e-4, atol=1e-6, msg=k)


# ---------------------------------------------------------------------------
# rejections and the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,match", [
    (dict(bucket_ladder="10,20,40"), "--bucketed is off"),
    (dict(max_contexts=0), "requires --bucketed"),
    (dict(max_contexts=100, bucketed=True), "max_path_length itself"),
    (dict(max_contexts=0, bucketed=True, device_epoch=True), "device_epoch"),
])
def test_jax_rules_are_value_errors(kw, match):
    with pytest.raises(ValueError, match=match):
        TrainConfig(**kw).validate()


def test_streaming_with_bucketing_is_not_ported():
    """Streaming with bucketing validates now; the host feed's workers
    still refuse device epochs, as JAX's do."""
    TrainConfig(bucketed=True, stream_chunk_items=8).validate()
    with pytest.raises(ValueError, match="--feed_workers"):
        TrainConfig(feed_workers=2, device_epoch=True).validate()


def test_ladder_must_end_at_the_bag(skewed):
    _, data, _ = skewed
    with pytest.raises(ValueError, match="must end at max_contexts"):
        loop.train(TrainConfig(**LOOP_KW, bucketed=True, bucket_ladder="10,20"), data,
                   device="cpu")


def test_cli_trains_long_bags(skewed, tmp_path, capsys):
    from code2vec_tpu_torch import cli

    paths, data, _ = skewed
    out = tmp_path / "cli"
    argv = ["--corpus_path", paths["corpus"], "--path_idx_path", paths["path_idx"],
            "--terminal_idx_path", paths["terminal_idx"], "--model_path", str(out),
            "--vectors_path", str(out / "code.vec"), "--terminal_embed_size", "8",
            "--path_embed_size", "6", "--encode_size", "12", "--max_path_length", str(BAG),
            "--batch_size", "16", "--max_epoch", "1", "--device", "cpu", "--bucketed",
            "--max_contexts", "0", "--use_pallas", "--pallas_impl", "fused"]
    assert cli.main(argv) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert len(lines) == 1 and lines[0]["truncated_context_fraction"] == 0.0
    assert 0 < lines[0]["pad_efficiency"] <= 1
    meta = json.loads((out / "model_meta.json").read_text())
    assert meta["bucket_ladder"][-1] > BAG
    vectors = (out / "code.vec").read_text().splitlines()
    assert vectors[0].split() == [str(data.n_items), "12"]
