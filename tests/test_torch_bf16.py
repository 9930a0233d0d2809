"""bf16 training in the port against the JAX package's, on the CPU.

``compute_dtype="bfloat16"`` / ``adam_mu_dtype="bfloat16"``: every piece
is held against its JAX counterpart on the same numpy inputs (made from a
seed; bf16 values by round-to-nearest-even on both sides, so both start
from the same bits):

- K1's plain version over bf16 contexts against ``pallas_attention_pool``
  (``backend="cpu"``, the TPU kernel's tile arithmetic on the widened
  contexts), and K1b's gradients against ``jax.vjp`` of it;
- the fused op under bf16 compute: ``gather_split`` against the JAX op on
  ``backend="cpu"`` (rows rounded to bf16, an f32 encode), ``fused``
  against the TPU formulation under the Pallas interpreter (f32 rows, as
  the TPU kernel and K3/K4 gather them), forward and the bf16 recompute
  backward;
- the model per route at dropout 0 against the JAX model under
  ``dtype=bfloat16``, weights carried across by ``interop``;
- three f32-compute train steps with bf16 first moments against the JAX
  step with ``torch_style_adam(mu_dtype="bfloat16")``;
- ``train()`` under bf16 compute (fixed bag per route, bucketed, and long
  bags through the streamed softmax), the CLI, the checkpoint's mu dtype
  and the refusal to resume it under the other one.

Tolerances, and why:

- f32 arithmetic on the same widened bf16 values (K1's outputs, K1b's
  ``d_attn``, the kernel forwards): atol 1e-6 for the pool, the fused
  suite's rtol 2e-4 / atol 2e-5 for the encode;
- a value rounded to bf16 at the end of f32 arithmetic (K1b's
  ``d_contexts``, and ``d_attn`` through the attention vector's cast): the
  f32 tolerance (1e-6) plus one bf16 ulp of the element, since two f32
  values that differ by rounding can round across a bf16 boundary (and
  ``w g + ds a`` may cancel, so the f32 difference is the terms' rounding,
  not the result's);
- the model's bf16 forward (logits, code vector, weights, loss): one bf16
  ulp (2^-8) of the tensor's largest element: XLA's and PyTorch's CPU bf16
  ops may round an element one ulp apart;
- bf16 gradients: 2^-5 of the tensor's largest element. A bf16 backward
  chains about six rounded ops (the matmuls, tanh, the pool's einsums,
  the casts); one element rounded one ulp apart moves its gradients by a
  few ulps of their scale;
- the train-step tolerance (``docs/PARITY.md:16``) for the f32-compute
  bf16-mu steps: losses rtol 2e-5, parameters atol 3e-5 / rtol 1e-4; the
  stored first moments equal except where the two f32 values of ``mu``
  straddle a bf16 rounding boundary, at most 2% of the elements.

Dims are tiny (embed 8/6, encode 12) so the file runs in seconds.
"""

import contextlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu.data import reader as jax_reader
from code2vec_tpu.models.code2vec import Code2Vec as JaxCode2Vec
from code2vec_tpu.models.code2vec import Code2VecConfig as JaxModelConfig
from code2vec_tpu.ops.fused_encode_pool import fused_encode_attend_pool as jax_fused
from code2vec_tpu.ops.pallas_attention import pallas_attention_pool
from code2vec_tpu.train.config import TrainConfig as JaxTrainConfig
from code2vec_tpu.train.step import build_train_step_fn, create_train_state
from code2vec_tpu_torch import interop
from code2vec_tpu_torch.checkpoint import slot_path
from code2vec_tpu_torch.data import reader, synth
from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig
from code2vec_tpu_torch.ops.attention import pool_backward_reference
from code2vec_tpu_torch.ops.fused_encode_pool import (
    encode_pool_reference,
    fused_encode_attend_pool,
    kernel_name,
    split_reference_forward,
)
from code2vec_tpu_torch.ops.pool_kernel import attention_pool_kernel
from code2vec_tpu_torch.train import loop
from code2vec_tpu_torch.train.config import TrainConfig
from code2vec_tpu_torch.train.step import (
    TorchStyleAdam,
    adam_mu_dtype,
    make_optimizer,
    train_step,
)

BF16 = torch.bfloat16
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


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each element's magnitude (8 significant bits)."""
    mag = np.maximum(np.abs(np.asarray(x, np.float64)), 2.0**-126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def to_np(x) -> np.ndarray:
    """An f32 numpy copy of a torch or JAX array of any float dtype."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def within_ulp(a, b, atol=0.0):
    """|a - b| <= atol + one bf16 ulp of b, elementwise."""
    a, b = to_np(a), to_np(b)
    assert a.shape == b.shape
    bad = np.abs(a - b) > atol + bf16_ulp(b)
    assert not bad.any(), f"{bad.sum()} elements over one bf16 ulp: max {np.abs(a - b).max()}"


def close_to_scale(a, b, frac, name=""):
    """|a - b| <= frac * max|b|: a bound relative to the tensor's scale."""
    a, b = to_np(a), to_np(b)
    np.testing.assert_allclose(a, b, rtol=0, atol=frac * max(np.abs(b).max(), 1e-30),
                               err_msg=name)


# ---------------------------------------------------------------------------
# K1 / K1b over bf16 contexts
# ---------------------------------------------------------------------------


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


def jax_pool_vjp(ctx, mask, attn, g_cv, g_w):
    """JAX K1 (compiled CPU strategy) over bf16 contexts and a bf16
    attention vector, and its VJP (``_pool_bwd``)."""
    (cv, w), vjp = jax.vjp(
        lambda c, a: pallas_attention_pool(c, jnp.asarray(mask), a, backend="cpu"),
        jnp.asarray(ctx).astype(jnp.bfloat16), jnp.asarray(attn).astype(jnp.bfloat16))
    d_ctx, d_attn = vjp((jnp.asarray(g_cv), jnp.asarray(g_w)))
    return cv, w, d_ctx, d_attn


@pytest.mark.parametrize("shape", [(4, 9, 7), (3, 33, 12), (2, 1, 16)])
@pytest.mark.parametrize("seed", [0, 1])
def test_k1_plain_over_bf16_contexts_matches_jax(seed, shape):
    B, L, H = shape
    ctx, mask, attn, g_cv, g_w = pool_inputs(seed, B, L, H)
    cv_j, w_j, _, _ = jax_pool_vjp(ctx, mask, attn, g_cv, g_w)
    c = torch.from_numpy(ctx).to(BF16)
    cv, w = attention_pool_kernel(c, torch.from_numpy(mask), torch.from_numpy(attn).to(BF16))
    assert cv.dtype == w.dtype == torch.float32
    np.testing.assert_allclose(cv.numpy(), to_np(cv_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(w.numpy(), to_np(w_j), rtol=0, atol=1e-6)


@pytest.mark.parametrize("with_gw", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k1b_over_bf16_contexts_matches_jax_vjp(seed, with_gw):
    """Through the port's autograd Function: d_contexts in bf16, and d_attn
    (bf16, through the attention vector's cast), within 1e-6 plus one ulp."""
    ctx, mask, attn, g_cv, g_w = pool_inputs(seed)
    gw = g_w if with_gw else np.zeros_like(g_w)
    _, _, d_ctx_j, d_attn_j = jax_pool_vjp(ctx, mask, attn, g_cv, gw)
    c = torch.from_numpy(ctx).to(BF16).requires_grad_()
    a = torch.from_numpy(attn).to(BF16).requires_grad_()
    cv, w = attention_pool_kernel(c, torch.from_numpy(mask), a)
    outs, grads = ((cv, w), (torch.from_numpy(g_cv), torch.from_numpy(g_w))) if with_gw else \
        ((cv,), (torch.from_numpy(g_cv),))
    d_ctx, d_attn = torch.autograd.grad(outs, (c, a), grads)
    assert d_ctx.dtype == d_attn.dtype == BF16
    within_ulp(d_ctx, d_ctx_j, atol=1e-6)
    within_ulp(d_attn, d_attn_j, atol=1e-6)


def test_k1b_plain_version_rounds_only_d_contexts():
    """pool_backward_reference on bf16 contexts: the f32 VJP of the widened
    contexts, d_contexts rounded to bf16 (nearest even), d_attn f32."""
    ctx, mask, attn, g_cv, g_w = (torch.from_numpy(x) for x in pool_inputs(3))
    c16 = ctx.to(BF16)
    _, w = attention_pool_kernel(c16, mask, attn)
    d16, a16 = pool_backward_reference(c16, mask, attn, w, g_cv, g_w)
    d32, a32 = pool_backward_reference(c16.float(), mask, attn, w, g_cv, g_w)
    assert d16.dtype == BF16 and a16.dtype == torch.float32
    assert torch.equal(d16, d32.to(BF16)) and torch.equal(a16, a32)


# ---------------------------------------------------------------------------
# the fused op (K2 over bf16 rows; K3/K4 unchanged) under bf16 compute
# ---------------------------------------------------------------------------


def fused_inputs(seed=1, B=3, L=11, Et=6, Ep=5, H=12, vt=30, vp=25):
    rng = np.random.default_rng(seed)
    t = rng.normal(size=(vt, Et)).astype(np.float32)
    p = rng.normal(size=(vp, Ep)).astype(np.float32)
    ids = [rng.integers(0, n, (B, L)).astype(np.int32) for n in (vt, vp, vt)]
    ids[0][:, :3] = rng.integers(1, vt, (B, 3))
    ids[0][-1] = 0  # an all-masked row
    mask = (ids[0] > 0).astype(np.float32)
    dense = (rng.normal(size=(2 * Et + Ep, H)) / 4).astype(np.float32)
    lns = (1 + 0.1 * rng.normal(size=H)).astype(np.float32)
    lnb = (0.1 * rng.normal(size=H)).astype(np.float32)
    attn = rng.normal(size=H).astype(np.float32)
    drop = (rng.random((B, L, H)) < 0.75).astype(np.float32) / 0.75
    g_cv = rng.normal(size=(B, H)).astype(np.float32)
    g_w = rng.normal(size=(B, L)).astype(np.float32)
    return (t, p, dense, lns, lnb, attn), ids, mask, drop, g_cv, g_w


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("impl", ["gather_split", "fused"])
def test_fused_op_under_bf16_compute_matches_jax(impl, masked):
    """``gather_split`` against the JAX op on the compiled CPU strategy
    (bf16 rows, f32 encode); ``fused`` against the TPU kernel under the
    interpreter (f32 rows): forward, then the bf16 recompute VJP of every
    differentiable input."""
    diff, ids, mask, drop, g_cv, g_w = fused_inputs()
    drop = drop if masked else None
    backend = "cpu" if impl == "gather_split" else "interpret"

    def jax_fn(t_, p_, d_, s_, b_, a_):
        return jax_fused(t_, p_, *map(jnp.asarray, ids), jnp.asarray(mask), d_, s_, b_, a_,
                         drop_mask=None if drop is None else jnp.asarray(drop), impl=impl,
                         compute_dtype=jnp.bfloat16, backend=backend)

    with gspmd():
        (j_cv, j_w), vjp = jax.vjp(jax_fn, *map(jnp.asarray, diff))
        j_grads = vjp((jnp.asarray(g_cv), jnp.asarray(g_w)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in diff]
    cv, w = fused_encode_attend_pool(
        leaves[0], leaves[1], *(torch.from_numpy(x) for x in ids), torch.from_numpy(mask),
        *leaves[2:], None if drop is None else torch.from_numpy(drop), impl=impl,
        compute_dtype=BF16)
    np.testing.assert_allclose(cv.detach().numpy(), to_np(j_cv), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(w.detach().numpy(), to_np(j_w), rtol=2e-4, atol=2e-5)
    grads = torch.autograd.grad((cv, w), leaves, (torch.from_numpy(g_cv), torch.from_numpy(g_w)))
    for name, a, b in zip(("t_table", "p_table", "dense", "ln_scale", "ln_bias", "attn"), grads,
                          j_grads):
        close_to_scale(a, b, 2.0**-5, name)


def test_k2_plain_version_is_the_f32_encode_of_bf16_rows():
    """K2's plain version under bf16 compute: rows rounded to bf16, then
    the f32 encode and pool on them widened; for f32 it is the f32 op."""
    diff, ids, mask, drop, _, _ = fused_inputs(seed=4)
    t, p, dense, lns, lnb, attn = (torch.from_numpy(x) for x in diff)
    s, pa, e = (torch.from_numpy(x) for x in ids)
    m, d = torch.from_numpy(mask), torch.from_numpy(drop)
    args = (t, p, s, pa, e, m, dense, lns, lnb, attn, d)
    got = split_reference_forward(*args, compute_dtype=BF16)
    rows = [t[s].to(BF16).float(), p[pa].to(BF16).float(), t[e].to(BF16).float()]
    want = encode_pool_reference(*rows, m, dense, lns, lnb, attn, d)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    op = fused_encode_attend_pool(*args, impl="gather_split", compute_dtype=BF16)
    assert all(torch.equal(x, y) for x, y in zip(op, want))
    assert kernel_name("gather_split", "f32", masked=True, compute_dtype=BF16) == \
        "gather_split_bf16_masked"


def test_fused_op_rejects_another_compute_dtype():
    diff, ids, mask, _, _, _ = fused_inputs()
    t = [torch.from_numpy(x) for x in diff]
    with pytest.raises(ValueError, match="compute_dtype"):
        fused_encode_attend_pool(t[0], t[1], *(torch.from_numpy(x) for x in ids),
                                 torch.from_numpy(mask), *t[2:], impl="gather_split",
                                 compute_dtype=torch.float16)


# ---------------------------------------------------------------------------
# the model under bf16 compute
# ---------------------------------------------------------------------------


def model_batch(B=5, L=14, seed=0):
    rng = np.random.default_rng(seed)
    s = rng.integers(1, DIMS["terminal_count"], (B, L)).astype(np.int32)
    p = rng.integers(1, DIMS["path_count"], (B, L)).astype(np.int32)
    e = rng.integers(0, DIMS["terminal_count"], (B, L)).astype(np.int32)
    for i, n in enumerate(rng.integers(1, L + 1, B)):
        s[i, n:] = p[i, n:] = e[i, n:] = 0
    s[-1] = p[-1] = e[-1] = 0
    return s, p, e, rng.integers(0, DIMS["label_count"], B).astype(np.int32)


def route_kw(route, jax_side):
    if route == "plain":
        return {}
    kw = dict(use_pallas=True, pallas_impl=route)
    if jax_side:  # fused: the TPU formulation (f32 rows) under the interpreter
        kw["pallas_backend"] = "interpret" if route == "fused" else "cpu"
    return kw


@pytest.mark.parametrize("encoder_impl", ["concat", "split"])
@pytest.mark.parametrize("route", ROUTES)
def test_model_forward_and_gradients_match_jax_bf16(route, encoder_impl):
    """Dropout 0: logits, code vector, weights, the loss and every
    parameter's gradient against the JAX model under dtype=bfloat16."""
    s, p, e, labels = model_batch()
    kw = dict(DIMS, dropout_prob=0.0, encoder_impl=encoder_impl)
    jm = JaxCode2Vec(JaxModelConfig(**kw, dtype=jnp.bfloat16, **route_kw(route, True)))
    ids_j = [jnp.asarray(x) for x in (s, p, e)]

    def loss_fn(params):
        logits, cv, w = jm.apply({"params": params}, *ids_j)
        nll = jax.nn.logsumexp(logits, -1) - logits[jnp.arange(len(labels)), labels]
        return nll.sum(), (logits, cv, w)

    with gspmd():
        params = jm.init(jax.random.PRNGKey(3), *ids_j)["params"]
        (loss_j, outs_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(params)
    cfg = Code2VecConfig(**kw, dtype=BF16, **route_kw(route, False))
    model = Code2Vec(cfg)
    model.load_state_dict(interop.state_dict_from_jax_params(
        jax.tree.map(np.asarray, params), cfg), strict=True)
    model.train()
    logits, cv, w = model(*(torch.from_numpy(x) for x in (s, p, e)))
    assert logits.dtype == cv.dtype == w.dtype == torch.float32
    nll = torch.logsumexp(logits, -1) - logits[torch.arange(len(labels)),
                                               torch.from_numpy(labels).long()]
    loss = nll.sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=2.0**-8)
    for name, a, b in zip(("logits", "code_vector", "attention"), (logits, cv, w), outs_j):
        close_to_scale(a, b, 2.0**-8, name)
    want = interop.state_dict_from_jax_params(jax.tree.map(to_np, grads_j), cfg)
    for name, prm in model.named_parameters():
        close_to_scale(prm.grad, want[name], 2.0**-5, name)


@pytest.mark.parametrize("route", ["plain", "fused"])
def test_margin_head_and_vocab_padding_in_bf16(route):
    """The margin head (with labels: the training margin) and padded vocab
    tables under bf16 compute: logits and code vector against JAX's, one
    bf16 ulp of their scale."""
    s, p, e, labels = model_batch(seed=2)
    kw = dict(DIMS, dropout_prob=0.0, angular_margin_loss=True, vocab_pad_multiple=4)
    jm = JaxCode2Vec(JaxModelConfig(**kw, dtype=jnp.bfloat16, **route_kw(route, True)))
    ids_j = [jnp.asarray(x) for x in (s, p, e)]
    with gspmd():
        params = jm.init(jax.random.PRNGKey(4), *ids_j)["params"]
        outs_j = jm.apply({"params": params}, *ids_j, labels=jnp.asarray(labels))
    cfg = Code2VecConfig(**kw, dtype=BF16, **route_kw(route, False))
    model = Code2Vec(cfg)
    model.load_state_dict(interop.state_dict_from_jax_params(
        jax.tree.map(np.asarray, params), cfg), strict=True)
    with torch.no_grad():
        outs = model.eval()(*(torch.from_numpy(x) for x in (s, p, e)),
                            labels=torch.from_numpy(labels))
    for name, a, b in zip(("logits", "code_vector"), outs, outs_j):
        close_to_scale(a, b, 2.0**-8, name)


def test_model_rejects_another_compute_dtype():
    with pytest.raises(ValueError, match="compute dtype"):
        Code2Vec(Code2VecConfig(**DIMS, dtype=torch.float16))


def test_bf16_keep_mask_is_one_draw_on_every_route():
    """Dropout on, bf16 compute: every route draws the same (B, L, H) mask
    from the module's generator, so from one seed the losses agree to the
    routes' bf16 differences (the plain pool rounds its code vector to bf16,
    the kernels' forwards keep f32): within one bf16 ulp (2^-8) relative,
    while another seed's mask moves the loss by more than 2^-7."""
    rng = np.random.default_rng(0)
    s = torch.from_numpy(rng.integers(1, 50, (4, 8)))
    losses = []
    for route in ROUTES:
        model = Code2Vec(Code2VecConfig(**DIMS, dropout_prob=0.25, dtype=BF16,
                                        **route_kw(route, False))).train()
        model.reset_parameters(torch.Generator().manual_seed(1))
        model.seed_dropout(5)
        losses.append(float(model(s, s % 40, s)[0].logsumexp(-1).sum()))
        model.seed_dropout(6)
        other = float(model(s, s % 40, s)[0].logsumexp(-1).sum())
        assert abs(other - losses[-1]) > 2.0**-7 * abs(losses[-1])  # the mask was applied
    np.testing.assert_allclose(losses, losses[0], rtol=2.0**-8)


# ---------------------------------------------------------------------------
# Adam with bf16 first moments
# ---------------------------------------------------------------------------


def train_batches(n=3, B=6, L=10, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        s = rng.integers(0, DIMS["terminal_count"], (B, L)).astype(np.int32)
        s[:, :2] = rng.integers(1, DIMS["terminal_count"], (B, 2))
        s[-1] = 0
        keep = s > 0
        out.append({
            "starts": s,
            "paths": (rng.integers(1, DIMS["path_count"], (B, L)) * keep).astype(np.int32),
            "ends": (rng.integers(1, DIMS["terminal_count"], (B, L)) * keep).astype(np.int32),
            "labels": rng.integers(0, DIMS["label_count"], B).astype(np.int32),
            "example_mask": np.array([1.0] * (B - 1) + [0.0], np.float32),
        })
    return out


def jax_first_moments(opt_state):
    for leaf in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(leaf, "mu"):
            return leaf.mu
    raise AssertionError("no Adam state")


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("route", ROUTES)
def test_three_steps_with_bf16_first_moments_match_jax(route, weight_decay):
    """f32 compute, dropout 0, the JAX jitted step with
    ``torch_style_adam(mu_dtype="bfloat16")`` from the same weights."""
    kernel = route != "plain"
    jax_cfg = JaxModelConfig(**DIMS, dropout_prob=0.0, use_pallas=kernel,
                             pallas_impl=route if kernel else "pool_only", pallas_backend="cpu")
    train_cfg = JaxTrainConfig(lr=0.01, weight_decay=weight_decay, dropout_prob=0.0,
                               batch_size=6, max_path_length=10, adam_mu_dtype="bfloat16")
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
    cfg = Code2VecConfig(**DIMS, dropout_prob=0.0, use_pallas=kernel,
                         pallas_impl=route if kernel else "pool_only")
    model = Code2Vec(cfg)
    model.load_state_dict(interop.state_dict_from_jax_params(params0, cfg), strict=True)
    opt = make_optimizer(model, TrainConfig(lr=0.01, weight_decay=weight_decay,
                                            adam_mu_dtype="bfloat16"))
    assert isinstance(opt, TorchStyleAdam) and adam_mu_dtype(opt) == "bfloat16"
    losses = [float(train_step(model, opt, {k: torch.from_numpy(v) for k, v in b.items()},
                               torch.from_numpy(weights))) for b in batches]
    np.testing.assert_allclose(losses, jax_losses, rtol=2e-5, atol=0)
    want = interop.state_dict_from_jax_params(jax.tree.map(np.asarray, state.params), cfg)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4, atol=3e-5, err_msg=k)
    mu_j = interop.state_dict_from_jax_params(
        jax.tree.map(to_np, jax_first_moments(state.opt_state)), cfg)
    for name, prm in model.named_parameters():
        mu = opt.state[prm]["exp_avg"]
        assert mu.dtype == BF16 and opt.state[prm]["exp_avg_sq"].dtype == torch.float32
        differ = (mu.float() != mu_j[name]).float().mean().item()
        assert differ <= 0.02, f"{name}: {differ:.2%} of the stored mu differ"
        within_ulp(mu, mu_j[name])


def test_f32_moments_keep_torch_adam():
    model = Code2Vec(Code2VecConfig(**DIMS))
    opt = make_optimizer(model, TrainConfig())
    assert type(opt) is torch.optim.Adam and adam_mu_dtype(opt) == "float32"


def test_bf16_mu_optimizer_state_round_trips():
    """load_state_dict keeps mu in bf16 (the base class would widen it)."""
    model = Code2Vec(Code2VecConfig(**DIMS))
    opt = make_optimizer(model, TrainConfig(adam_mu_dtype="bfloat16"))
    batch = {k: torch.from_numpy(v) for k, v in train_batches(1)[0].items()}
    train_step(model, opt, batch, torch.ones(DIMS["label_count"]))
    saved = opt.state_dict()
    fresh = make_optimizer(model, TrainConfig(adam_mu_dtype="bfloat16"))
    fresh.load_state_dict(saved)
    for prm in model.parameters():
        a, b = opt.state[prm], fresh.state[prm]
        assert b["exp_avg"].dtype == BF16 and torch.equal(a["exp_avg"], b["exp_avg"])
        assert a["step"] == b["step"] == 1


# ---------------------------------------------------------------------------
# train(), the CLI, checkpoints
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_corpus(tmp_path_factory):
    paths = synth.generate_corpus_files(tmp_path_factory.mktemp("tiny"), synth.SPECS["tiny"])
    args = (paths["corpus"], paths["path_idx"], paths["terminal_idx"])
    return paths, reader.load_corpus(*args), jax_reader.load_corpus(*args, cache=False,
                                                                      native=False)


LOOP_KW = dict(terminal_embed_size=8, path_embed_size=6, encode_size=12, batch_size=32,
               max_path_length=40, max_epoch=2, random_seed=11, compute_dtype="bfloat16",
               adam_mu_dtype="bfloat16")


@pytest.mark.parametrize("route", ROUTES)
def test_train_two_epochs_in_bf16(tiny_corpus, route, tmp_path):
    """As the JAX package's own bf16 test (tests/test_train.py:427-435):
    two epochs under bf16 compute, a finite loss and F1 > 0; the code.vec
    export runs on the same bf16 model and the meta records the run."""
    _, data, _ = tiny_corpus
    kernel = dict(use_pallas=True, pallas_impl=route) if route != "plain" else {}
    cfg = TrainConfig(**LOOP_KW, **kernel)
    out = tmp_path / "m"
    res = loop.train(cfg, data, str(out), vectors_path=str(out / "code.vec"), device="cpu")
    assert res.model.config.dtype == BF16
    assert np.isfinite(res.history[-1]["train_loss"]) and res.final_f1 > 0.0
    assert (out / "code.vec").exists()
    meta = json.loads((out / "model_meta.json").read_text())
    assert meta["adam_mu_dtype"] == "bfloat16" and meta["table_update"] == "dense"
    saved = torch.load(slot_path(str(out), "best"), weights_only=False)
    assert saved["meta"]["adam_mu_dtype"] == "bfloat16"
    assert all(s["exp_avg"].dtype == BF16 for s in saved["optimizer"]["state"].values())


SKEWED = synth.SynthSpec(n_methods=160, n_terminals=200, n_paths=150, n_labels=10,
                         mean_contexts=12.0, length_sigma=1.2, max_contexts=160,
                         signature_size=15, seed=3)


@pytest.mark.parametrize("kw", [
    dict(use_pallas=True, pallas_impl="gather_split"),
    dict(use_pallas=True, pallas_impl="pool_only", max_contexts=0),
    dict(use_pallas=True, pallas_impl="fused", max_contexts=0),
    dict(use_pallas=True, pallas_impl="fused", pallas_softmax="two_pass", max_contexts=0),
], ids=["bucketed-gather_split", "longbag-pool_only", "longbag-fused", "longbag-two_pass"])
def test_bucketed_and_long_bag_train_in_bf16(tmp_path, kw):
    """Bucketed (``--bucketed``) and long-bag (``--max_contexts 0``: the
    long rungs stream through the fused op's online / two_pass softmax)
    training under bf16 compute and bf16 first moments: finite losses,
    F1 > 0, nothing truncated on the long-bag runs."""
    paths = synth.generate_corpus_files(tmp_path / "skewed", SKEWED)
    data = reader.load_corpus(paths["corpus"], paths["path_idx"], paths["terminal_idx"])
    cfg = TrainConfig(**{**LOOP_KW, "batch_size": 16, "max_path_length": 40}, bucketed=True,
                      print_sample_cycle=0, **kw)
    res = loop.train(cfg, data, device="cpu")
    assert all(np.isfinite(m["train_loss"]) for m in res.history) and res.best_f1 > 0.0
    if kw.get("max_contexts") == 0:
        assert max(loop.resolve_ladder(cfg, data)[0]) > 40
        assert all(m["truncated_context_fraction"] == 0.0 for m in res.history)


def test_resume_refuses_another_mu_dtype(tiny_corpus, tmp_path):
    _, data, _ = tiny_corpus
    cfg = TrainConfig(**{**LOOP_KW, "max_epoch": 1})
    out = str(tmp_path / "m")
    loop.train(cfg, data, out, device="cpu")
    with pytest.raises(ValueError, match="pass --adam_mu_dtype bfloat16 to resume it"):
        loop.train(cfg.with_updates(resume=True, max_epoch=2, adam_mu_dtype="float32"), data,
                   out, device="cpu")
    resumed = loop.train(cfg.with_updates(resume=True, max_epoch=2), data, out, device="cpu")
    assert resumed.epochs_run == 1 and len(resumed.history) == 2


def test_checkpoint_from_before_the_field_reads_as_float32(tiny_corpus, tmp_path):
    _, data, _ = tiny_corpus
    cfg = TrainConfig(**{**LOOP_KW, "max_epoch": 1, "adam_mu_dtype": "float32"})
    out = str(tmp_path / "m")
    loop.train(cfg, data, out, device="cpu")
    path = slot_path(out, "best")
    state = torch.load(path, weights_only=False)
    del state["meta"]["adam_mu_dtype"]
    torch.save(state, path)
    with pytest.raises(ValueError, match="stores Adam first moments as float32"):
        loop.train(cfg.with_updates(resume=True, max_epoch=2, adam_mu_dtype="bfloat16"), data,
                   out, device="cpu")
    resumed = loop.train(cfg.with_updates(resume=True, max_epoch=2), data, out, device="cpu")
    assert resumed.epochs_run == 1


def test_cli_trains_in_bf16(tiny_corpus, tmp_path, capsys):
    from code2vec_tpu_torch import cli

    paths, _, _ = tiny_corpus
    out = tmp_path / "cli"
    assert cli.main([
        "--corpus_path", paths["corpus"], "--path_idx_path", paths["path_idx"],
        "--terminal_idx_path", paths["terminal_idx"], "--model_path", str(out),
        "--vectors_path", str(out / "code.vec"), "--terminal_embed_size", "8",
        "--path_embed_size", "6", "--encode_size", "12", "--max_path_length", "30",
        "--device", "cpu", "--max_epoch", "2", "--compute_dtype", "bfloat16",
        "--adam_mu_dtype", "bfloat16", "--use_pallas", "--pallas_impl", "gather_split",
    ]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert [x["epoch"] for x in lines] == [0, 1]
    assert np.isfinite(lines[-1]["train_loss"]) and lines[-1]["f1"] > 0.0


@pytest.mark.parametrize("kw", [{"compute_dtype": "bfloat16"}, {"adam_mu_dtype": "bfloat16"},
                                {"compute_dtype": "bfloat16", "adam_mu_dtype": "bfloat16"}],
                         ids=["compute", "mu", "both"])
def test_config_accepts_bf16(kw):
    TrainConfig(**kw).validate()


@pytest.mark.parametrize("kw", [{"compute_dtype": "float16"}, {"adam_mu_dtype": "float16"}],
                         ids=["compute", "mu"])
def test_config_rejects_other_dtypes(kw):
    with pytest.raises(ValueError, match="must be one of"):
        TrainConfig(**kw).validate()
