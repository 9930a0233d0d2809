"""The lazy table optimizer and the ``embed_grad`` formulations of the port
against the JAX package's, on the CPU.

- ``dedupe_sorted`` against JAX ``_dedupe_sorted`` (the JAX test's cases,
  all-distinct and all-same ids among them): ids equal, sums within 1e-6;
- ``LazyTableAdam``'s table rows against JAX ``mixed_table_adam`` and
  against ``torch.optim.SparseAdam``, 5 steps: f32 within 1e-6, bf16 first
  moments within 2e-3 (``tests/test_table_opt.py:77-130``); untouched rows
  and their moments bit for bit unchanged, PAD row and last row included;
- the model's zero offsets: their gradients scatter-added equal the dense
  tables' gradients on every route's plain version and on both encoder
  formulations (atol and rtol 1e-5), and zeros leave the forward bit for
  bit; the fused op with offsets against the JAX op (forward and VJP, the
  fused suite's rtol 2e-4 / atol 2e-5);
- three lazy train steps against the jitted JAX ``build_train_step_fn(...,
  table_update="lazy")`` from one set of weights, dropout 0, per route and
  weight decay: losses rtol 2e-5, parameters and the tables' moments atol
  3e-5 / rtol 1e-4 (``docs/PARITY.md:16``); bf16 first moments with f32
  compute: the stored moments equal but for at most 2% one-ulp boundary
  flips (``tests/test_torch_bf16.py``); bf16 compute + bf16 first moments,
  one step: the loss within one bf16 ulp (2^-8) relative, the moments
  within 2^-5 (mu) and 2^-4 (nu, a square) of their largest element, and
  every parameter whose JAX gradient is above that bound within the f32
  step tolerance (below it Adam's first step is ``-lr * sign(g)`` and a
  sign may differ, so within ``2 lr``);
- ``train()`` lazily: two bucketed epochs and one long-bag epoch against
  JAX ``train()`` (losses rtol 1e-4, accuracy and F1 equal), bucketed and
  long bags in bf16 (finite losses, F1 > 0); the
  checkpoint's round trip, its refusal under the other ``--table_update``
  and a lazy ``--resume`` that reproduces the uninterrupted epoch; the CLI;
- ``embed_grad``: the ``segment`` and ``segment_sorted`` table gradients
  (``F.embedding``'s backward, as ``dense``'s) against JAX
  ``embedding_lookup(grad_mode=...)`` within 1e-5, and the model's
  gradients under each mode bit for bit the ``dense`` ones.

Dims are tiny (embed 8/6, encode 12) so the file runs in seconds.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu.data import reader as jax_reader
from code2vec_tpu.models.code2vec import Code2VecConfig as JaxModelConfig
from code2vec_tpu.ops.embed import embedding_lookup as jax_lookup
from code2vec_tpu.ops.fused_encode_pool import fused_encode_attend_pool as jax_fused
from code2vec_tpu.train import loop as jax_loop
from code2vec_tpu.train.config import TrainConfig as JaxTrainConfig
from code2vec_tpu.train.step import (
    build_train_step_fn,
    create_train_state,
    make_eval_step,
    make_train_step,
)
from code2vec_tpu.train.table_opt import (
    SparseTableGrad,
    _dedupe_sorted,
    apply_updates_sparse,
    mixed_table_adam,
)
from code2vec_tpu_torch import interop
from code2vec_tpu_torch.checkpoint import slot_path
from code2vec_tpu_torch.data import reader, synth
from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig
from code2vec_tpu_torch.ops.embed import embedding_lookup
from code2vec_tpu_torch.ops.fused_encode_pool import fused_encode_attend_pool
from code2vec_tpu_torch.train import loop
from code2vec_tpu_torch.train.config import TrainConfig
from code2vec_tpu_torch.train.step import (
    TorchStyleAdam,
    adam_mu_dtype,
    forward_backward,
    lazy_forward_backward,
    make_optimizer,
    table_update,
    train_step,
)
from code2vec_tpu_torch.train.table_opt import LazyTableAdam, dedupe_sorted
from tests.test_torch_bf16 import bf16_ulp, close_to_scale, route_kw, to_np
from tests.test_torch_train import gspmd, train_batches

BF16 = torch.bfloat16
DIMS = dict(terminal_count=50, path_count=40, label_count=9, terminal_embed_size=8,
            path_embed_size=6, encode_size=12)
ROUTES = ["plain", "pool_only", "gather_split", "fused"]
TABLES = {"terminal_embedding": "terminal_embedding.weight",
          "path_embedding": "path_embedding.weight"}


def kernel_kw(route):
    return dict(use_pallas=True, pallas_impl=route) if route != "plain" else {}


def torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# dedupe and the row step
# ---------------------------------------------------------------------------

DEDUPE_CASES = {
    "duplicates": ([3, 1, 3, 7, 1, 3], [[1.0], [10.0], [2.0], [100.0], [20.0], [4.0]], 9),
    "all_distinct": ([4, 2, 8], [[1.0, 1.0]] * 3, 10),
    "all_same": ([5, 5, 5], [[1.0, 1.0]] * 3, 10),
    "random": (np.random.default_rng(0).integers(0, 13, 40).tolist(),
               np.random.default_rng(1).normal(size=(40, 3)).tolist(), 13),
}


@pytest.mark.parametrize("case", list(DEDUPE_CASES))
def test_dedupe_matches_jax(case):
    ids, slots, vocab = DEDUPE_CASES[case]
    ids, slots = np.asarray(ids, np.int32), np.asarray(slots, np.float32)
    j_uids, j_gsum = _dedupe_sorted(jnp.asarray(ids), jnp.asarray(slots), vocab)
    uids, gsum = dedupe_sorted(torch.from_numpy(ids), torch.from_numpy(slots), vocab)
    np.testing.assert_array_equal(uids.numpy(), np.asarray(j_uids))
    np.testing.assert_allclose(gsum.numpy(), np.asarray(j_gsum), rtol=1e-6, atol=1e-6)
    k = len(set(ids.tolist()))
    assert (uids[k:] == vocab).all() and (gsum[k:] == 0).all()


def sparse_step_inputs(seed, vocab, dim, n_slots, steps):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, n_slots).astype(np.int32),
             rng.standard_normal((n_slots, dim)).astype(np.float32)) for _ in range(steps)]


def lazy_optimizer(tables, mu_dtype=torch.float32, lr=0.01):
    dummy = torch.zeros(3, requires_grad=True)
    return LazyTableAdam(tables, torch.optim.Adam([dummy], lr=lr), lr=lr,
                         betas=(0.9, 0.999), mu_dtype=mu_dtype)


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_table_rows_match_jax_mixed_table_adam(mu_dtype):
    """Both tables, 5 steps of random ids (repeats, PAD) against JAX
    ``mixed_table_adam`` + ``apply_updates_sparse``: parameters and both
    moments."""
    dim, lr = 4, 0.01
    rng = np.random.default_rng(7)
    init = {"terminal_embedding": rng.standard_normal((23, dim)).astype(np.float32),
            "path_embedding": rng.standard_normal((17, dim)).astype(np.float32)}
    params = {k: {"embedding": jnp.asarray(v)} for k, v in init.items()}
    params["other"] = jnp.zeros((3,))
    tx = mixed_table_adam(lr, 0.9, 0.999, 0.0, mu_dtype=mu_dtype)
    state = tx.init(params)
    tables = [torch.tensor(init[k]) for k in TABLES]
    opt = lazy_optimizer(tables, {"float32": torch.float32, "bfloat16": BF16}[mu_dtype], lr)
    steps = [(a, b) for a, b in zip(sparse_step_inputs(1, 23, dim, 40, 5),
                                    sparse_step_inputs(2, 17, dim, 30, 5))]
    tol = 2e-3 if mu_dtype == "bfloat16" else 1e-6
    for step, grads in enumerate(steps):
        jgrads = {k: {"embedding": SparseTableGrad(ids=jnp.asarray(i), slots=jnp.asarray(s))}
                  for k, (i, s) in zip(TABLES, grads)}
        jgrads["other"] = jnp.zeros((3,))
        updates, state = tx.update(jgrads, state, params)
        params = apply_updates_sparse(params, updates)
        opt.step([(torch.from_numpy(i), torch.from_numpy(s)) for i, s in grads])
        for key, p in zip(TABLES, tables):
            np.testing.assert_allclose(p.numpy(), np.asarray(params[key]["embedding"]),
                                       rtol=tol, atol=tol, err_msg=f"{key} step {step}")
            st = opt.state[p]
            np.testing.assert_allclose(to_np(st["exp_avg"]),
                                       to_np(state.lazy.mu[key]["embedding"]), rtol=tol, atol=tol)
            np.testing.assert_allclose(st["exp_avg_sq"].numpy(),
                                       np.asarray(state.lazy.nu[key]["embedding"]),
                                       rtol=tol, atol=tol)
    assert opt.param_groups[0]["step"] == int(state.lazy.count) == 5


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_table_rows_match_torch_sparse_adam(mu_dtype):
    vocab, dim, lr = 23, 4, 0.01
    init = np.random.default_rng(7).standard_normal((vocab, dim)).astype(np.float32)
    ours = torch.tensor(init)
    opt = lazy_optimizer([ours, torch.zeros(5, dim)],
                         {"float32": torch.float32, "bfloat16": BF16}[mu_dtype], lr)
    theirs = torch.tensor(init, requires_grad=True)
    sparse = torch.optim.SparseAdam([theirs], lr=lr, betas=(0.9, 0.999))
    tol = 2e-3 if mu_dtype == "bfloat16" else 1e-6
    for step, (ids, slots) in enumerate(sparse_step_inputs(3, vocab, dim, 40, 5)):
        opt.step([(torch.from_numpy(ids), torch.from_numpy(slots)),
                  (torch.zeros(4, dtype=torch.int32), torch.zeros(4, dim))])
        theirs.grad = torch.sparse_coo_tensor(torch.from_numpy(ids[None].astype(np.int64)),
                                              torch.from_numpy(slots), (vocab, dim))
        sparse.step()
        np.testing.assert_allclose(ours.numpy(), theirs.detach().numpy(), rtol=tol, atol=tol,
                                   err_msg=f"step {step}")


@pytest.mark.parametrize("last_touched", [False, True], ids=["last_untouched", "last_touched"])
def test_untouched_rows_and_moments_stay_bitwise(last_touched):
    """Rows a step does not touch keep their parameters and both moments bit
    for bit (moments nonzero from earlier steps); the capacity padding
    never reaches a row, PAD (0) and the last row among them."""
    vocab, dim = 11, 3
    table = torch.randn(vocab, dim, generator=torch.Generator().manual_seed(0))
    opt = lazy_optimizer([table, torch.zeros(4, dim)])
    for ids in ([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10], [2, 0, 0, 2]):
        p0 = table.clone()
        m0, v0 = (opt.state[table][k].clone() for k in ("exp_avg", "exp_avg_sq"))
        ids = ids + ([vocab - 1] if last_touched and len(ids) < vocab else [])
        opt.step([(torch.tensor(ids), torch.ones(len(ids), dim)),
                  (torch.tensor([1]), torch.ones(1, dim))])
        untouched = [i for i in range(vocab) if i not in ids]
        for now, before in ((table, p0), (opt.state[table]["exp_avg"], m0),
                            (opt.state[table]["exp_avg_sq"], v0)):
            assert torch.equal(now[untouched], before[untouched])
            assert not torch.equal(now[sorted(set(ids))], before[sorted(set(ids))])
    assert opt.state[table]["exp_avg"][untouched].abs().sum() > 0


def test_step_refuses_missing_table_gradients():
    opt = lazy_optimizer([torch.zeros(3, 2), torch.zeros(3, 2)])
    with pytest.raises(ValueError, match="per-slot"):
        opt.step()
    with pytest.raises(ValueError, match="2 tables, 1 gradients"):
        opt.step([(torch.tensor([0]), torch.zeros(1, 2))])


def test_lazy_optimizer_state_round_trips():
    """``load_state_dict`` restores the shared count, both moments (mu stays
    bf16) and the dense side's state."""
    cfg = TrainConfig(table_update="lazy", adam_mu_dtype="bfloat16")
    model = Code2Vec(Code2VecConfig(**DIMS))
    opt = make_optimizer(model, cfg)
    assert isinstance(opt.dense, TorchStyleAdam) and adam_mu_dtype(opt) == "bfloat16"
    assert table_update(opt) == "lazy"
    for b in train_batches(2):
        train_step(model, opt, torch_batch(b), torch.ones(DIMS["label_count"]))
    fresh = make_optimizer(model, cfg)
    fresh.load_state_dict(opt.state_dict())
    assert fresh.param_groups[0]["step"] == 2
    for prm in (model.terminal_embedding.weight, model.path_embedding.weight):
        a, b = opt.state[prm], fresh.state[prm]
        assert b["exp_avg"].dtype == BF16 and torch.equal(a["exp_avg"], b["exp_avg"])
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])
    for prm in model.input_linear.parameters():
        assert torch.equal(opt.dense.state[prm]["exp_avg"], fresh.dense.state[prm]["exp_avg"])


def test_unknown_table_update_raises_in_make_optimizer():
    with pytest.raises(ValueError, match="table_update must be"):
        make_optimizer(Code2Vec(Code2VecConfig(**DIMS)), TrainConfig(table_update="sparse"))


# ---------------------------------------------------------------------------
# the zero offsets
# ---------------------------------------------------------------------------

OFFSET_CASES = [(r, "concat") for r in ROUTES] + [("plain", "split"), ("pool_only", "split")]


@pytest.mark.parametrize("route,encoder_impl", OFFSET_CASES)
def test_slot_grads_scatter_to_the_dense_table_grads(route, encoder_impl):
    """The offsets' gradients, scatter-added by id, are the dense tables'
    gradients; under offsets the tables get no ``.grad``."""
    cfg = Code2VecConfig(**DIMS, dropout_prob=0.0, encoder_impl=encoder_impl,
                         **kernel_kw(route))
    model = Code2Vec(cfg)
    batch = torch_batch(train_batches(1)[0])
    weights = torch.ones(DIMS["label_count"])
    loss_dense = forward_backward(model, batch, weights)
    dense = [model.terminal_embedding.weight.grad.clone(), model.path_embedding.weight.grad]
    model.zero_grad(set_to_none=True)
    loss_lazy, grads = lazy_forward_backward(model, batch, weights)
    assert model.terminal_embedding.weight.grad is None
    assert model.path_embedding.weight.grad is None
    assert model.input_linear.weight.grad is not None
    assert torch.equal(loss_dense, loss_lazy)
    for (ids, slots), want in zip(grads, dense):
        got = torch.zeros_like(want).index_add_(0, ids.long(), slots)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ROUTES)
def test_zero_offsets_leave_the_forward_bitwise(route, dtype):
    """Training mode with dropout on: one keep mask from one seed, with and
    without the offsets."""
    from code2vec_tpu_torch.train.step import zero_offsets

    cfg = Code2VecConfig(**DIMS, dropout_prob=0.25, dtype=getattr(torch, dtype),
                         **kernel_kw(route))
    model = Code2Vec(cfg).train()
    s, p, e = (torch.from_numpy(train_batches(1)[0][k]) for k in ("starts", "paths", "ends"))
    model.seed_dropout(3)
    want = model(s, p, e)
    model.seed_dropout(3)
    got = model(s, p, e, embed_offsets=zero_offsets(cfg, s.shape, s.device))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def fused_inputs(seed=1, B=3, L=11, Et=6, Ep=5, H=12):
    rng = np.random.default_rng(seed)
    ids = [rng.integers(0, n, (B, L)).astype(np.int32) for n in (30, 25, 30)]
    ids[0][:, :3] = rng.integers(1, 30, (B, 3))
    return dict(
        t=rng.normal(size=(30, Et)).astype(np.float32),
        p=rng.normal(size=(25, Ep)).astype(np.float32), ids=ids,
        mask=(ids[0] > 0).astype(np.float32),
        dense=(rng.normal(size=(2 * Et + Ep, H)) / 4).astype(np.float32),
        lns=(1 + 0.1 * rng.normal(size=H)).astype(np.float32),
        lnb=(0.1 * rng.normal(size=H)).astype(np.float32),
        attn=rng.normal(size=H).astype(np.float32),
        drop=(rng.random((B, L, H)) < 0.75).astype(np.float32) / 0.75,
        off_se=(0.1 * rng.normal(size=(B, 2 * L, Et))).astype(np.float32),
        off_p=(0.1 * rng.normal(size=(B, L, Ep))).astype(np.float32),
        g_cv=rng.normal(size=(B, H)).astype(np.float32),
        g_w=rng.normal(size=(B, L)).astype(np.float32),
    )


@pytest.mark.parametrize("impl", ["gather_split", "fused"])
def test_fused_op_with_offsets_matches_jax(impl):
    """Forward and VJP with the tables as constants and the offsets
    differentiated, against the JAX op (``fused`` gathers without them in
    both forwards; ``gather_split`` adds them, here nonzero)."""
    x = fused_inputs()
    if impl == "fused":  # zero by contract on the in-kernel gather
        x["off_se"], x["off_p"] = np.zeros_like(x["off_se"]), np.zeros_like(x["off_p"])
    diff = (x["dense"], x["lns"], x["lnb"], x["attn"], x["off_se"], x["off_p"])

    def jax_fn(d_, s_, b_, a_, ose, op):
        return jax_fused(jnp.asarray(x["t"]), jnp.asarray(x["p"]), *map(jnp.asarray, x["ids"]),
                         jnp.asarray(x["mask"]), d_, s_, b_, a_, drop_mask=jnp.asarray(x["drop"]),
                         off_se=ose, off_p=op, impl=impl, backend="cpu")

    with gspmd():
        (j_cv, j_w), vjp = jax.vjp(jax_fn, *map(jnp.asarray, diff))
        j_grads = vjp((jnp.asarray(x["g_cv"]), jnp.asarray(x["g_w"])))
    leaves = [torch.from_numpy(a).requires_grad_() for a in diff]
    cv, w = fused_encode_attend_pool(
        torch.from_numpy(x["t"]), torch.from_numpy(x["p"]), *map(torch.from_numpy, x["ids"]),
        torch.from_numpy(x["mask"]), *leaves[:4], torch.from_numpy(x["drop"]), *leaves[4:],
        impl=impl)
    np.testing.assert_allclose(cv.detach().numpy(), np.asarray(j_cv), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(j_w), rtol=2e-4, atol=2e-5)
    grads = torch.autograd.grad((cv, w), leaves, (torch.from_numpy(x["g_cv"]),
                                                  torch.from_numpy(x["g_w"])))
    for name, a, b in zip(("dense", "ln_scale", "ln_bias", "attn", "off_se", "off_p"), grads,
                          j_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-5, err_msg=name)


def test_fused_op_takes_both_offsets_or_neither():
    x = fused_inputs()
    args = [torch.from_numpy(a) for a in (x["t"], x["p"], *x["ids"], x["mask"], x["dense"],
                                          x["lns"], x["lnb"], x["attn"])]
    with pytest.raises(ValueError, match="come together"):
        fused_encode_attend_pool(*args, None, torch.from_numpy(x["off_se"]), None)


# ---------------------------------------------------------------------------
# lazy train steps against the jitted JAX step
# ---------------------------------------------------------------------------


def jax_lazy_steps(route, batches, weights, model_kw=None, **train_kw):
    """The jitted JAX lazy step from a seeded state: ``(params0, state,
    losses)``."""
    kernel = route != "plain"
    jax_cfg = JaxModelConfig(**DIMS, dropout_prob=0.0, **(model_kw or {}),
                             **(route_kw(route, True) if "dtype" in (model_kw or {}) else
                                dict(use_pallas=kernel, pallas_impl=route if kernel else
                                     "pool_only", pallas_backend="cpu")))
    train_cfg = JaxTrainConfig(lr=0.01, dropout_prob=0.0, batch_size=6, max_path_length=10,
                               table_update="lazy", **train_kw)
    with gspmd():
        state = create_train_state(train_cfg, jax_cfg, jax.random.PRNGKey(7), batches[0])
        params0 = jax.tree.map(np.asarray, state.params)
        step = jax.jit(build_train_step_fn(jax_cfg, jnp.asarray(weights), table_update="lazy"))
        losses = []
        for b in batches:
            state, loss = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(loss))
    return params0, state, losses


def port_lazy_steps(route, params0, batches, weights, model_kw=None, **train_kw):
    cfg = Code2VecConfig(**DIMS, dropout_prob=0.0, **(model_kw or {}), **kernel_kw(route))
    model = Code2Vec(cfg)
    model.load_state_dict(interop.state_dict_from_jax_params(params0, cfg), strict=True)
    opt = make_optimizer(model, TrainConfig(lr=0.01, table_update="lazy", **train_kw))
    losses = [float(train_step(model, opt, torch_batch(b), torch.from_numpy(weights)))
              for b in batches]
    return cfg, model, opt, losses


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("route", ROUTES)
def test_three_lazy_steps_match_jax(route, weight_decay):
    batches = train_batches()
    weights = np.ones(DIMS["label_count"], np.float32)
    params0, state, jax_losses = jax_lazy_steps(route, batches, weights,
                                                weight_decay=weight_decay)
    cfg, model, opt, losses = port_lazy_steps(route, params0, batches, weights,
                                              weight_decay=weight_decay)
    np.testing.assert_allclose(losses, jax_losses, rtol=2e-5, atol=0)
    want = interop.state_dict_from_jax_params(jax.tree.map(np.asarray, state.params), cfg)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4, atol=3e-5, err_msg=k)
    assert model.terminal_embedding.weight.grad is None
    lazy = state.opt_state.lazy
    assert opt.param_groups[0]["step"] == int(lazy.count) == 3
    for key, name in TABLES.items():
        st = opt.state[dict(model.named_parameters())[name]]
        for mine, theirs in (("exp_avg", lazy.mu), ("exp_avg_sq", lazy.nu)):
            np.testing.assert_allclose(st[mine].numpy(), np.asarray(theirs[key]["embedding"]),
                                       rtol=1e-4, atol=3e-5, err_msg=f"{name} {mine}")


def test_lazy_steps_with_the_margin_head_match_jax():
    batches = train_batches()
    weights = np.ones(DIMS["label_count"], np.float32)
    kw = dict(angular_margin_loss=True)
    params0, state, jax_losses = jax_lazy_steps("fused", batches, weights, model_kw=kw)
    cfg, model, _, losses = port_lazy_steps("fused", params0, batches, weights, model_kw=kw)
    np.testing.assert_allclose(losses, jax_losses, rtol=2e-5, atol=0)
    want = interop.state_dict_from_jax_params(jax.tree.map(np.asarray, state.params), cfg)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4, atol=3e-5, err_msg=k)


@pytest.mark.parametrize("route", ["plain", "fused"])
def test_three_lazy_steps_with_bf16_first_moments_match_jax(route):
    """f32 compute: the table rows' mu stored in bf16 from the unrounded
    f32 ``b1`` (JAX ``_lazy_rows``), the dense side ``TorchStyleAdam``."""
    batches = train_batches()
    weights = np.ones(DIMS["label_count"], np.float32)
    params0, state, jax_losses = jax_lazy_steps(route, batches, weights,
                                                adam_mu_dtype="bfloat16")
    cfg, model, opt, losses = port_lazy_steps(route, params0, batches, weights,
                                              adam_mu_dtype="bfloat16")
    np.testing.assert_allclose(losses, jax_losses, rtol=2e-5, atol=0)
    want = interop.state_dict_from_jax_params(jax.tree.map(np.asarray, state.params), cfg)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4, atol=3e-5, err_msg=k)
    for key, name in TABLES.items():
        mu = opt.state[dict(model.named_parameters())[name]]["exp_avg"]
        mu_j = to_np(state.opt_state.lazy.mu[key]["embedding"])
        assert mu.dtype == BF16
        differ = (mu.float().numpy() != mu_j).mean()
        assert differ <= 0.02, f"{name}: {differ:.2%} of the stored mu differ"
        assert (np.abs(mu.float().numpy() - mu_j) <= bf16_ulp(mu_j)).all()


@pytest.mark.parametrize("route", ["plain", "gather_split", "fused"])
def test_one_lazy_step_in_bf16_matches_jax(route):
    """bf16 compute + bf16 first moments, one step from one set of weights
    (a second step would carry each side's bf16 rounding into the next
    gradients); tolerances in the module docstring."""
    batches = train_batches(1)
    weights = np.ones(DIMS["label_count"], np.float32)
    params0, state, jax_losses = jax_lazy_steps(
        route, batches, weights, model_kw=dict(dtype=jnp.bfloat16), adam_mu_dtype="bfloat16",
        compute_dtype="bfloat16")
    cfg, model, opt, losses = port_lazy_steps(route, params0, batches, weights,
                                              model_kw=dict(dtype=BF16), adam_mu_dtype="bfloat16")
    np.testing.assert_allclose(losses, jax_losses, rtol=2.0**-8, atol=0)
    lazy = state.opt_state.lazy
    named = dict(model.named_parameters())
    grad_bound = {}
    for key, name in TABLES.items():
        st = opt.state[named[name]]
        mu_j = to_np(lazy.mu[key]["embedding"])
        close_to_scale(st["exp_avg"], mu_j, 2.0**-5, f"{name} mu")
        close_to_scale(st["exp_avg_sq"], to_np(lazy.nu[key]["embedding"]), 2.0**-4, f"{name} nu")
        grad_bound[name] = (mu_j, 2.0**-5 * np.abs(mu_j).max())
    tables_j = {k: {"embedding": np.zeros(named[n].shape, np.float32)} for k, n in TABLES.items()}
    dense_mu = interop.state_dict_from_jax_params(
        {**jax.tree.map(to_np, state.opt_state.dense[0].mu), **tables_j}, cfg)
    for name, prm in named.items():
        if name not in grad_bound:
            mu_j = dense_mu[name].numpy()
            close_to_scale(opt.dense.state[prm]["exp_avg"], mu_j, 2.0**-5, f"{name} mu")
            grad_bound[name] = (mu_j, 2.0**-5 * np.abs(mu_j).max())
    want = interop.state_dict_from_jax_params(jax.tree.map(np.asarray, state.params), cfg)
    for name, prm in named.items():
        got, ref = prm.detach().numpy(), want[name].numpy()
        mu_j, bound = grad_bound[name]
        clear = np.abs(mu_j) > bound
        np.testing.assert_allclose(got[clear], ref[clear], rtol=1e-4, atol=3e-5, err_msg=name)
        assert (np.abs(got - ref) <= 2 * 0.01 + 3e-5).all(), name


# ---------------------------------------------------------------------------
# train(), checkpoints, the CLI
# ---------------------------------------------------------------------------

BAG = 40
SKEWED = synth.SynthSpec(n_methods=160, n_terminals=200, n_paths=150, n_labels=10,
                         mean_contexts=12.0, length_sigma=1.2, max_contexts=4 * BAG,
                         signature_size=15, seed=3)
LOOP_KW = dict(terminal_embed_size=8, path_embed_size=6, encode_size=12, batch_size=16,
               max_path_length=BAG, max_epoch=2, dropout_prob=0.0, random_seed=11,
               print_sample_cycle=0, table_update="lazy")


@pytest.fixture(scope="module")
def skewed(tmp_path_factory):
    paths = synth.generate_corpus_files(tmp_path_factory.mktemp("skewed"), SKEWED)
    args = (paths["corpus"], paths["path_idx"], paths["terminal_idx"])
    return paths, reader.load_corpus(*args), jax_reader.load_corpus(*args, cache=False,
                                                                      native=False)


TRAIN_CASES = {
    "bucketed-plain": dict(bucketed=True),
    "bucketed-pool_only": dict(bucketed=True, use_pallas=True, pallas_impl="pool_only"),
    "longbag-fused": dict(bucketed=True, max_contexts=0, max_epoch=1, use_pallas=True,
                          pallas_impl="fused"),
}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_lazy_train_tracks_jax_train(skewed, case):
    """JAX ``train()`` with ``table_update="lazy"`` and the port's from the
    JAX run's initial weights: the epochs' losses, accuracy and F1."""
    _, data, jax_data = skewed
    kw = {**LOOP_KW, **TRAIN_CASES[case]}
    jcfg = JaxTrainConfig(**kw)
    model_cfg = jax_loop.model_config_from(jcfg, jax_data)
    if jcfg.use_pallas:
        model_cfg = model_cfg.__class__(**{**vars(model_cfg), "pallas_backend": "cpu"})
    weights = jax_loop.class_weights_from(jcfg, jax_data)
    with gspmd():
        state = create_train_state(jcfg, model_cfg, jax.random.PRNGKey(11),
                                   jax_loop.dummy_batch(jcfg))
        params0 = jax.tree.map(np.asarray, state.params)
        want = jax_loop.train(jcfg, jax_data, None, sinks=(), initial_state=state,
                              train_step=make_train_step(model_cfg, weights, "lazy"),
                              eval_step=make_eval_step(model_cfg, weights))
    cfg = TrainConfig(**kw)
    sd = interop.state_dict_from_jax_params(params0, loop.model_config_from(cfg, data))
    got = loop.train(cfg, data, device="cpu", initial_state_dict=sd)
    assert len(got.history) == len(want.history) == kw["max_epoch"]
    for g, w in zip(got.history, want.history):
        np.testing.assert_allclose(g["train_loss"], w["train_loss"], rtol=1e-4)
        np.testing.assert_allclose(g["test_loss"], w["test_loss"], rtol=1e-4)
        for key in ("accuracy", "f1", "pad_efficiency", "truncated_context_fraction"):
            assert g[key] == w[key], key


@pytest.mark.parametrize("kw", [
    dict(use_pallas=True, pallas_impl="gather_split"),
    dict(use_pallas=True, pallas_impl="fused", pallas_softmax="two_pass", max_contexts=0),
], ids=["bucketed-gather_split", "longbag-two_pass"])
def test_lazy_bucketed_and_long_bag_train_in_bf16(skewed, kw):
    """bf16 compute + bf16 first moments, lazily: finite losses, F1 > 0,
    nothing truncated on the long-bag run, bf16 moments in the optimizer."""
    _, data, _ = skewed
    cfg = TrainConfig(**{**LOOP_KW, "dropout_prob": 0.25}, bucketed=True,
                      compute_dtype="bfloat16", adam_mu_dtype="bfloat16", **kw)
    res = loop.train(cfg, data, device="cpu")
    assert all(np.isfinite(m["train_loss"]) for m in res.history) and res.best_f1 > 0.0
    if kw.get("max_contexts") == 0:
        assert all(m["truncated_context_fraction"] == 0.0 for m in res.history)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    paths = synth.generate_corpus_files(tmp_path_factory.mktemp("tiny"), synth.SPECS["tiny"])
    return paths, reader.load_corpus(paths["corpus"], paths["path_idx"], paths["terminal_idx"])


TINY_KW = dict(terminal_embed_size=8, path_embed_size=6, encode_size=12, batch_size=32,
               max_path_length=40, max_epoch=2, random_seed=11, print_sample_cycle=0,
               table_update="lazy")


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_lazy_resume_reproduces_the_uninterrupted_epoch(tiny, tmp_path, mu_dtype):
    """Dropout on, the fused route: the restored tables' moments, shared
    count and dense state carry on the uninterrupted run exactly."""
    _, data = tiny
    cfg = TrainConfig(**TINY_KW, dropout_prob=0.25, use_pallas=True, pallas_impl="fused",
                      adam_mu_dtype=mu_dtype)
    whole = loop.train(cfg, data, str(tmp_path / "a"), device="cpu")
    loop.train(cfg.with_updates(max_epoch=1), data, str(tmp_path / "b"), device="cpu")
    saved = torch.load(slot_path(str(tmp_path / "b"), "best"), weights_only=False)
    assert saved["meta"]["table_update"] == "lazy" and "dense" in saved["optimizer"]
    resumed = loop.train(cfg.with_updates(resume=True), data, str(tmp_path / "b"), device="cpu")
    assert resumed.epochs_run == 1 and len(resumed.history) == 2
    assert resumed.history[1]["train_loss"] == whole.history[1]["train_loss"]
    assert resumed.history[1]["f1"] == whole.history[1]["f1"]
    for a, b in zip(resumed.model.state_dict().values(), whole.model.state_dict().values()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("saved,other", [("lazy", "dense"), ("dense", "lazy")])
def test_resume_refuses_the_other_table_update(tiny, tmp_path, saved, other):
    _, data = tiny
    cfg = TrainConfig(**{**TINY_KW, "max_epoch": 1, "table_update": saved})
    out = str(tmp_path / "m")
    loop.train(cfg, data, out, device="cpu")
    with pytest.raises(ValueError, match=f"pass --table_update {saved} to resume it"):
        loop.train(cfg.with_updates(resume=True, max_epoch=2, table_update=other), data, out,
                   device="cpu")
    resumed = loop.train(cfg.with_updates(resume=True, max_epoch=2), data, out, device="cpu")
    assert resumed.epochs_run == 1


def test_checkpoint_from_before_the_field_reads_as_dense(tiny, tmp_path):
    _, data = tiny
    cfg = TrainConfig(**{**TINY_KW, "max_epoch": 1, "table_update": "dense"})
    out = str(tmp_path / "m")
    loop.train(cfg, data, out, device="cpu")
    path = slot_path(out, "best")
    state = torch.load(path, weights_only=False)
    del state["meta"]["table_update"]
    torch.save(state, path)
    with pytest.raises(ValueError, match="saved with --table_update dense"):
        loop.train(cfg.with_updates(resume=True, max_epoch=2, table_update="lazy"), data, out,
                   device="cpu")


@pytest.mark.parametrize("route", ["pool_only", "gather_split"])
def test_cli_trains_lazily_and_exports(tiny, tmp_path, capsys, route):
    from code2vec_tpu_torch import cli

    paths, _ = tiny
    out = tmp_path / "cli"
    assert cli.main([
        "--corpus_path", paths["corpus"], "--path_idx_path", paths["path_idx"],
        "--terminal_idx_path", paths["terminal_idx"], "--model_path", str(out),
        "--vectors_path", str(out / "code.vec"), "--terminal_embed_size", "8",
        "--path_embed_size", "6", "--encode_size", "12", "--max_path_length", "30",
        "--device", "cpu", "--max_epoch", "2", "--table_update", "lazy",
        "--use_pallas", "--pallas_impl", route,
    ]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert [x["epoch"] for x in lines] == [0, 1] and np.isfinite(lines[-1]["train_loss"])
    assert json.loads((out / "model_meta.json").read_text())["table_update"] == "lazy"
    assert (out / "code2vec.model").exists() and (out / "code.vec").exists()
    (out / "code.vec").unlink()
    assert cli.main(["--corpus_path", paths["corpus"], "--path_idx_path", paths["path_idx"],
                     "--terminal_idx_path", paths["terminal_idx"], "--model_path", str(out),
                     "--vectors_path", str(out / "code.vec"), "--terminal_embed_size", "8",
                     "--path_embed_size", "6", "--encode_size", "12", "--max_path_length",
                     "30", "--device", "cpu", "--export_only"]) == 0
    assert (out / "code.vec").exists()


# ---------------------------------------------------------------------------
# embed_grad
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["segment", "segment_sorted"])
def test_segment_table_grads_match_jax_and_dense(mode, dtype):
    """The table's gradient through a cast to the compute dtype, against
    JAX ``embedding_lookup(grad_mode=mode)`` and the port's ``dense``."""
    rng = np.random.default_rng(4)
    table = rng.normal(size=(17, 5)).astype(np.float32)
    ids = rng.integers(0, 17, (6, 9)).astype(np.int32)
    ids[:, -3:] = 0  # PAD slots repeat id 0
    g = rng.normal(size=(6, 9, 5)).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    _, vjp = jax.vjp(lambda t: jax_lookup(t, jnp.asarray(ids), jdt, mode), jnp.asarray(table))
    (want,) = vjp(jnp.asarray(g).astype(jdt))
    grads = {}
    for m in (mode, "dense"):
        t = torch.from_numpy(table).requires_grad_()
        rows = embedding_lookup(t, torch.from_numpy(ids), m).to(getattr(torch, dtype))
        (grads[m],) = torch.autograd.grad(rows, t, torch.from_numpy(g).to(rows.dtype))
        assert torch.equal(rows.float(), torch.from_numpy(table)[ids].to(rows.dtype).float())
    np.testing.assert_allclose(grads[mode].numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grads[mode].numpy(), grads["dense"].numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["segment", "segment_sorted"])
@pytest.mark.parametrize("route", ["plain", "pool_only"])
def test_model_embed_grad_matches_dense(route, mode):
    """Every mode runs ``F.embedding``'s backward: the model's gradients
    under ``mode`` are the ``dense`` ones bit for bit."""
    batch = torch_batch(train_batches(1)[0])
    weights = torch.ones(DIMS["label_count"])
    grads = {}
    for m in ("dense", mode):
        model = Code2Vec(Code2VecConfig(**DIMS, dropout_prob=0.0, embed_grad=m,
                                        **kernel_kw(route)))
        model.reset_parameters(torch.Generator().manual_seed(2))
        forward_backward(model, batch, weights)
        grads[m] = {k: p.grad for k, p in model.named_parameters()}
    for k, g in grads["dense"].items():
        assert torch.equal(grads[mode][k], g), k


def test_embed_grad_flows_from_the_config_and_is_validated(tiny):
    _, data = tiny
    cfg = TrainConfig(embed_grad="segment_sorted").validate()
    assert loop.model_config_from(cfg, data).embed_grad == "segment_sorted"
    with pytest.raises(ValueError, match="embed_grad must be one of"):
        TrainConfig(embed_grad="sorted").validate()
    with pytest.raises(ValueError, match="unknown embed_grad"):
        Code2Vec(Code2VecConfig(**DIMS, embed_grad="sorted"))
    with pytest.raises(ValueError, match="grad_mode must be one of"):
        embedding_lookup(torch.zeros(3, 2), torch.zeros(2, dtype=torch.long), "sorted")


def test_lazy_train_with_embed_grad_runs(tiny):
    """Under lazy the tables are constants, so ``embed_grad`` has nothing to
    form: a run with both trains as the lazy run alone does."""
    _, data = tiny
    cfg = TrainConfig(**{**TINY_KW, "max_epoch": 1, "dropout_prob": 0.0})
    a = loop.train(cfg, data, device="cpu")
    b = loop.train(cfg.with_updates(embed_grad="segment"), data, device="cpu")
    assert a.history[0]["train_loss"] == b.history[0]["train_loss"]
