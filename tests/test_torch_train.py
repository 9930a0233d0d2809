"""The port's training path against the JAX package's, on the CPU.

- K1's backward: ``pool_backward_reference`` (and the port's autograd
  ``Function`` over it) against ``jax.vjp`` of ``pallas_attention_pool``
  on the compiled CPU strategy, with and without a weights cotangent and
  an all-masked row (atol 1e-6), and against torch autograd of the plain
  pool;
- the fused op with a dropout keep mask: forward and the VJP of every
  differentiable input against the JAX op with ``drop_mask`` (rtol 2e-4 /
  atol 2e-5, the fused suite's tolerance), under the GSPMD partitioner;
- three train steps against JAX ``build_train_step_fn`` from identical
  weights through ``interop``, dropout 0, per kernel route, with and
  without weight decay and with the margin head: losses rtol 2e-5, every
  parameter atol 3e-5 / rtol 1e-4 (``docs/PARITY.md:16``);
- ``train()`` for two epochs on ``SPECS["tiny"]`` from the JAX run's
  initial weights: per-epoch train loss within rtol 1e-4 of JAX
  ``train()``, accuracy and F1 equal;
- resume at an epoch boundary, the model dir in the ``Predictor``, the
  CLI, and the rejections of what is not ported.

Dims are tiny (embed 8/6, encode 12-24) so the file runs in seconds.
"""

import contextlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu.data import reader as jax_reader
from code2vec_tpu.models.code2vec import Code2VecConfig as JaxModelConfig
from code2vec_tpu.ops.fused_encode_pool import fused_encode_attend_pool as jax_fused
from code2vec_tpu.ops.pallas_attention import pallas_attention_pool
from code2vec_tpu.train import loop as jax_loop
from code2vec_tpu.train.config import TrainConfig as JaxTrainConfig
from code2vec_tpu.train.step import build_train_step_fn, create_train_state
from code2vec_tpu_torch import interop
from code2vec_tpu_torch.data import reader, synth
from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig
from code2vec_tpu_torch.ops.attention import attention_pool, pool_backward_reference
from code2vec_tpu_torch.ops.fused_encode_pool import fused_encode_attend_pool
from code2vec_tpu_torch.ops.pool_kernel import attention_pool_kernel
from code2vec_tpu_torch.train import loop
from code2vec_tpu_torch.train.config import TrainConfig
from code2vec_tpu_torch.train.step import make_optimizer, train_step

DIMS = dict(terminal_count=50, path_count=40, label_count=9, terminal_embed_size=8,
            path_embed_size=6, encode_size=12)
ROUTES = ["plain", "pool_only", "gather_split", "fused"]


@contextlib.contextmanager
def gspmd():
    """jax 0.9's Shardy partitioner rejects the JAX fused op (ROADMAP §C)."""
    previous = jax.config.jax_use_shardy_partitioner
    jax.config.update("jax_use_shardy_partitioner", False)
    try:
        yield
    finally:
        jax.config.update("jax_use_shardy_partitioner", previous)


def pool_inputs(seed=0, B=4, L=9, H=7):
    rng = np.random.default_rng(seed)
    ctx = np.tanh(rng.normal(size=(B, L, H))).astype(np.float32)
    mask = (rng.random((B, L)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    mask[-1] = 0.0  # an all-masked row
    attn = rng.normal(size=H).astype(np.float32)
    g_cv = rng.normal(size=(B, H)).astype(np.float32)
    g_w = rng.normal(size=(B, L)).astype(np.float32)
    return ctx, mask, attn, g_cv, g_w


@pytest.mark.parametrize("with_gw", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_pool_backward_matches_jax_vjp(seed, with_gw):
    ctx, mask, attn, g_cv, g_w = pool_inputs(seed)
    (cv, w), vjp = jax.vjp(lambda c, a: pallas_attention_pool(c, jnp.asarray(mask), a,
                                                             backend="cpu"),
                           jnp.asarray(ctx), jnp.asarray(attn))
    gw = g_w if with_gw else np.zeros_like(g_w)
    j_ctx, j_attn = vjp((jnp.asarray(g_cv), jnp.asarray(gw)))
    t = [torch.from_numpy(x) for x in (ctx, mask, attn, g_cv, g_w)]
    p_ctx, p_attn = pool_backward_reference(t[0], t[1], t[2], torch.from_numpy(np.asarray(w)),
                                            t[3], t[4] if with_gw else None)
    np.testing.assert_allclose(p_ctx.numpy(), np.asarray(j_ctx), rtol=0, atol=1e-6)
    np.testing.assert_allclose(p_attn.numpy(), np.asarray(j_attn), rtol=0, atol=1e-6)
    # the all-masked row's contexts get w * g_cv only
    np.testing.assert_allclose(p_ctx[-1].numpy(), np.asarray(w)[-1][:, None] * g_cv[-1],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("with_gw", [False, True])
def test_pool_function_matches_autograd_of_the_plain_pool(with_gw):
    ctx, mask, attn, g_cv, g_w = (torch.from_numpy(x) for x in pool_inputs(2))
    c1, a1 = ctx.clone().requires_grad_(), attn.clone().requires_grad_()
    c2, a2 = ctx.clone().requires_grad_(), attn.clone().requires_grad_()
    out1 = attention_pool_kernel(c1, mask, a1)
    out2 = attention_pool(c2, mask, a2)
    assert type(out1[0].grad_fn).__name__ == "_AttentionPoolBackward"
    outs1, outs2 = (out1, out2) if with_gw else ((out1[0],), (out2[0],))
    grads = (g_cv, g_w) if with_gw else (g_cv,)
    g1 = torch.autograd.grad(outs1, (c1, a1), grads)
    g2 = torch.autograd.grad(outs2, (c2, a2), grads)
    for x, y in zip(g1, g2):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-6)


def test_pool_only_training_reaches_every_parameter():
    """The repaired fault: a pool_only training forward used to run K1
    with no backward, so on the card only the head got gradients. Through
    the autograd Function every parameter does."""
    cfg = Code2VecConfig(**DIMS, dropout_prob=0.25, use_pallas=True, pallas_impl="pool_only")
    model = Code2Vec(cfg).train()
    rng = np.random.default_rng(0)
    s = torch.from_numpy(rng.integers(1, 50, (3, 8)))
    p = torch.from_numpy(rng.integers(1, 40, (3, 8)))
    logits, cv, _ = model(s, p, s)
    assert type(cv.grad_fn).__name__ == "_AttentionPoolBackward"
    logits.sum().backward()
    for name in ("attention_parameter", "input_linear.weight", "terminal_embedding.weight",
                 "path_embedding.weight", "input_layer_norm.weight"):
        grad = dict(model.named_parameters())[name].grad
        assert grad is not None and grad.abs().sum() > 0, name


@pytest.mark.parametrize("impl", ["gather_split", "fused"])
def test_masked_fused_op_matches_jax(impl):
    """Forward and VJP of the fused op with a keep mask, against the JAX op."""
    rng = np.random.default_rng(1)
    B, L, Et, Ep, H = 3, 11, 6, 5, 12
    t = rng.normal(size=(30, Et)).astype(np.float32)
    p = rng.normal(size=(25, Ep)).astype(np.float32)
    ids = [rng.integers(0, n, (B, L)).astype(np.int32) for n in (30, 25, 30)]
    ids[0][:, :3] = rng.integers(1, 30, (B, 3))
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
                         drop_mask=jnp.asarray(drop), impl=impl, backend="cpu")

    with gspmd():
        (j_cv, j_w), vjp = jax.vjp(jax_fn, *map(jnp.asarray, diff))
        j_grads = vjp((jnp.asarray(g_cv), jnp.asarray(g_w)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in diff]
    cv, w = fused_encode_attend_pool(
        leaves[0], leaves[1], *(torch.from_numpy(x) for x in ids), torch.from_numpy(mask),
        *leaves[2:], torch.from_numpy(drop), impl=impl)
    np.testing.assert_allclose(cv.detach().numpy(), np.asarray(j_cv), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(j_w), rtol=2e-4, atol=2e-5)
    grads = torch.autograd.grad((cv, w), leaves, (torch.from_numpy(g_cv), torch.from_numpy(g_w)))
    for name, a, b in zip(("t_table", "p_table", "dense", "ln_scale", "ln_bias", "attn"), grads,
                          j_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-5, err_msg=name)


def train_batches(n=3, B=6, L=10, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        s = rng.integers(0, DIMS["terminal_count"], (B, L)).astype(np.int32)
        s[:, :2] = rng.integers(1, DIMS["terminal_count"], (B, 2))
        s[-1] = 0  # an all-PAD row under the example mask
        keep = s > 0
        out.append({
            "starts": s,
            "paths": (rng.integers(1, DIMS["path_count"], (B, L)) * keep).astype(np.int32),
            "ends": (rng.integers(1, DIMS["terminal_count"], (B, L)) * keep).astype(np.int32),
            "labels": rng.integers(0, DIMS["label_count"], B).astype(np.int32),
            "example_mask": np.array([1.0] * (B - 1) + [0.0], np.float32),
        })
    return out


STEP_CASES = [(r, wd, False) for r in ROUTES for wd in (0.0, 0.01)] + [
    ("plain", 0.01, True), ("fused", 0.0, True), ("pool_only", 0.0, True)]


@pytest.mark.parametrize("route,weight_decay,margin", STEP_CASES)
def test_three_train_steps_match_jax(route, weight_decay, margin):
    kernel = route != "plain"
    jax_cfg = JaxModelConfig(**DIMS, dropout_prob=0.0, angular_margin_loss=margin,
                             use_pallas=kernel, pallas_impl=route if kernel else "pool_only",
                             pallas_backend="cpu")
    train_cfg = JaxTrainConfig(lr=0.01, weight_decay=weight_decay, dropout_prob=0.0,
                               batch_size=6, max_path_length=10)
    batches = train_batches()
    weights = np.ones(DIMS["label_count"], np.float32)
    with gspmd():
        state = create_train_state(train_cfg, jax_cfg, jax.random.PRNGKey(7), batches[0])
        params0 = jax.tree.map(np.asarray, state.params)
        step = jax.jit(build_train_step_fn(jax_cfg, jnp.asarray(weights)))
        jax_losses = []
        for b in batches:
            state, loss = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            jax_losses.append(float(loss))
    cfg = Code2VecConfig(**DIMS, dropout_prob=0.0, angular_margin_loss=margin,
                         use_pallas=kernel, pallas_impl=route if kernel else "pool_only")
    model = Code2Vec(cfg)
    model.load_state_dict(interop.state_dict_from_jax_params(params0, cfg), strict=True)
    opt = make_optimizer(model, TrainConfig(lr=0.01, weight_decay=weight_decay))
    losses = [float(train_step(model, opt, {k: torch.from_numpy(v) for k, v in b.items()},
                               torch.from_numpy(weights))) for b in batches]
    np.testing.assert_allclose(losses, jax_losses, rtol=2e-5, atol=0)
    want = interop.state_dict_from_jax_params(jax.tree.map(np.asarray, state.params), cfg)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4, atol=3e-5, err_msg=k)


@pytest.fixture(scope="module")
def tiny_corpus(tmp_path_factory):
    paths = synth.generate_corpus_files(tmp_path_factory.mktemp("tiny"), synth.SPECS["tiny"])
    args = (paths["corpus"], paths["path_idx"], paths["terminal_idx"])
    return paths, reader.load_corpus(*args), jax_reader.load_corpus(*args, cache=False,
                                                                      native=False)


LOOP_KW = dict(terminal_embed_size=8, path_embed_size=6, encode_size=12, batch_size=32,
               max_path_length=40, max_epoch=2, dropout_prob=0.0, random_seed=11)


@pytest.mark.parametrize("route", ["plain", "pool_only"])
def test_two_epochs_track_jax_train(tiny_corpus, route):
    _, data, jax_data = tiny_corpus
    kernel = dict(use_pallas=True, pallas_impl=route) if route != "plain" else {}
    jcfg = JaxTrainConfig(**LOOP_KW, **kernel)
    model_cfg = jax_loop.model_config_from(jcfg, jax_data)
    if route != "plain":
        model_cfg = model_cfg.__class__(**{**vars(model_cfg), "pallas_backend": "cpu"})
    state = create_train_state(jcfg, model_cfg, jax.random.PRNGKey(11),
                               jax_loop.dummy_batch(jcfg))
    params0 = jax.tree.map(np.asarray, state.params)
    step = jax.jit(build_train_step_fn(model_cfg, jax_loop.class_weights_from(jcfg, jax_data)))
    want = jax_loop.train(jcfg, jax_data, sinks=(), initial_state=state, train_step=step)
    cfg = TrainConfig(**LOOP_KW, **kernel)
    sd = interop.state_dict_from_jax_params(params0, loop.model_config_from(cfg, data))
    got = loop.train(cfg, data, device="cpu", initial_state_dict=sd)
    assert len(got.history) == len(want.history) == 2
    for g, w in zip(got.history, want.history):
        np.testing.assert_allclose(g["train_loss"], w["train_loss"], rtol=1e-4)
        np.testing.assert_allclose(g["test_loss"], w["test_loss"], rtol=1e-4)
        assert g["accuracy"] == w["accuracy"] and g["f1"] == w["f1"]


def test_resume_reproduces_the_uninterrupted_epoch(tiny_corpus, tmp_path):
    """Dropout on: the restored numpy and dropout generators must both
    carry on the uninterrupted run's streams."""
    _, data, _ = tiny_corpus
    cfg = TrainConfig(**{**LOOP_KW, "dropout_prob": 0.25, "use_pallas": True,
                         "pallas_impl": "fused"})
    whole = loop.train(cfg, data, str(tmp_path / "a"), device="cpu")
    loop.train(cfg.with_updates(max_epoch=1), data, str(tmp_path / "b"), device="cpu")
    resumed = loop.train(cfg.with_updates(resume=True), data, str(tmp_path / "b"), device="cpu")
    assert resumed.epochs_run == 1 and len(resumed.history) == 2
    assert resumed.history[1]["train_loss"] == whole.history[1]["train_loss"]
    assert resumed.history[1]["f1"] == whole.history[1]["f1"]


def test_model_dir_is_served_by_the_predictor(tiny_corpus, tmp_path):
    from code2vec_tpu_torch.formats.vectors_io import read_code_vectors
    from code2vec_tpu_torch.predict import Predictor

    paths, data, _ = tiny_corpus
    cfg = TrainConfig(**{**LOOP_KW, "max_epoch": 1})
    out = tmp_path / "model"
    result = loop.train(cfg, data, str(out), vectors_path=str(out / "code.vec"),
                        test_result_path=str(out / "test.tsv"), device="cpu")
    pred = Predictor(str(out), paths["terminal_idx"], paths["path_idx"], device="cpu")
    ctx = [(int(s), int(p), int(e)) for s, p, e in zip(data.starts[:7], data.paths[:7],
                                                       data.ends[:7])]
    got = pred.predict_contexts(ctx, top_k=3)
    model = result.model.eval()
    ids = [torch.tensor([[c[i] for c in ctx]]) for i in range(3)]
    with torch.no_grad():
        _, cv, _ = model(*ids)
    np.testing.assert_allclose(got.code_vector, cv[0].numpy(), rtol=1e-6, atol=1e-6)
    labels, vectors = read_code_vectors(out / "code.vec")
    assert len(labels) == data.n_items and vectors.shape == (data.n_items, 12)
    assert len((out / "test.tsv").read_text().splitlines()) == data.n_items // 5
    meta = json.loads((out / "model_meta.json").read_text())
    assert meta["max_path_length"] == 40 and meta["bucket_ladder"][-1] == 40


def test_same_seed_same_keep_mask_on_every_route(tiny_corpus):
    """Dropout on: every route draws its keep mask from the module's
    generator at (B, L, H), so from one seed the losses agree."""
    rng = np.random.default_rng(0)
    s = torch.from_numpy(rng.integers(1, 50, (4, 8)))
    losses = []
    for route in ROUTES:
        kernel = dict(use_pallas=True, pallas_impl=route) if route != "plain" else {}
        torch.manual_seed(0)
        model = Code2Vec(Code2VecConfig(**DIMS, dropout_prob=0.25, **kernel)).train()
        model.reset_parameters(torch.Generator().manual_seed(1))
        model.seed_dropout(5)
        losses.append(float(model(s, s % 40, s)[0].logsumexp(-1).sum()))
    np.testing.assert_allclose(losses, losses[0], rtol=1e-5)
    model.eval()
    a = model(s, s % 40, s)[0]
    b = model(s, s % 40, s)[0]
    assert torch.equal(a, b)  # no mask in eval mode


def test_training_with_quantized_tables_raises():
    model = Code2Vec(Code2VecConfig(**DIMS, table_dtype="int8")).train()
    s = torch.ones(2, 3, dtype=torch.long)
    with pytest.raises(ValueError, match="not trainable"):
        model(s, s, s)


# the autotuner is ported (tests/test_torch_autotune.py)
AUTOTUNER = [{"data_axis": 2, "autotune_cache": "at.json"}, {"pallas_impl": "auto"}]
# lazy tables over a model axis are ported (tests/test_torch_mesh.py)
LAZY_MODEL_AXIS = {"model2": {"model_axis": 2, "table_update": "lazy"},
                   "data2_model2": {"data_axis": 2, "model_axis": 2, "table_update": "lazy"}}


@pytest.mark.parametrize("kw", AUTOTUNER, ids=lambda kw: next(iter(kw)))
def test_autotuner_settings_validate(kw):
    TrainConfig(**kw).validate()


@pytest.mark.parametrize("kw", list(LAZY_MODEL_AXIS.values()), ids=list(LAZY_MODEL_AXIS))
def test_lazy_tables_over_a_model_axis_validate(kw):
    TrainConfig(**kw).validate()


def test_device_epoch_validates():
    """``device_epoch`` is ported (tests/test_torch_device_epoch.py)."""
    TrainConfig(device_epoch=True).validate()
    TrainConfig(device_epoch=True, sample_prefetch=True, device_chunk_batches=4).validate()


def test_unknown_table_update_raises():
    """``lazy`` is ported (tests/test_torch_table_opt.py); another value is
    a ValueError, as in JAX ``create_train_state``."""
    TrainConfig(table_update="lazy").validate()
    with pytest.raises(ValueError, match="table_update must be one of"):
        TrainConfig(table_update="sparse").validate()


def test_train_rejects_a_quantized_table_dtype():
    with pytest.raises(ValueError, match="not trainable"):
        TrainConfig(table_dtype="int8").validate()
    TrainConfig(table_dtype="int8").validate(training=False)


def test_cli_trains_exports_and_honours_no_cuda(tiny_corpus, tmp_path, capsys):
    from code2vec_tpu_torch import cli

    paths, _, _ = tiny_corpus
    out = tmp_path / "cli"
    common = ["--corpus_path", paths["corpus"], "--path_idx_path", paths["path_idx"],
              "--terminal_idx_path", paths["terminal_idx"], "--model_path", str(out),
              "--vectors_path", str(out / "code.vec"), "--terminal_embed_size", "8",
              "--path_embed_size", "6", "--encode_size", "12", "--max_path_length", "30"]
    assert cli.main(common + ["--no_cuda", "--max_epoch", "1", "--use_pallas",
                              "--pallas_impl", "gather_split"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert [x["epoch"] for x in lines] == [0] and np.isfinite(lines[0]["train_loss"])
    assert (out / "code2vec.model").exists() and (out / "checkpoint_best.pt").exists()
    (out / "code.vec").unlink()
    assert cli.main(common + ["--device", "cpu", "--export_only", "--table_dtype", "int8"]) == 0
    assert (out / "code.vec").exists()
    # elastic training is ported (tests/test_torch_elastic.py): an async
    # save publishes its slot before the run returns
    (out / "checkpoint_best.pt").unlink()
    assert cli.main(common + ["--device", "cpu", "--max_epoch", "1", "--async_checkpoint"]) == 0
    assert (out / "checkpoint_best.pt").exists()
    assert not [p.name for p in out.iterdir() if ".tmp" in p.name]
    with pytest.raises(SystemExit):
        cli.main(common + ["--no_cuda", "--device", "cuda"])


def test_cli_without_a_device_raises_when_no_gpu(tiny_corpus, tmp_path):
    from code2vec_tpu_torch import cli

    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the no-fallback rule is checked where there is none")
    paths, _, _ = tiny_corpus
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--corpus_path", paths["corpus"], "--path_idx_path", paths["path_idx"],
                  "--terminal_idx_path", paths["terminal_idx"],
                  "--model_path", str(tmp_path / "m"), "--max_epoch", "1"])
