"""The port's ``analysis/`` package against the JAX package's.

- The call-time contracts at every counterpart of a JAX contract site
  (the plain, streaming and K1 pools, the softmax weights, the embedding
  gather, the K2-K4 op, K5, the train and eval steps): the same seeded
  numpy inputs, healthy and malformed, go through JAX's function and the
  port's. Both raise their ``ContractError`` on the same malformed cases,
  with messages one pattern matches; on healthy inputs the port's output
  equals its ``__wrapped__`` function's bit for bit (and JAX's within
  float tolerance). The three inputs the port's step used to train on
  (an ``example_mask`` of shape (B, 1) or (1,), float labels) at 30/20/5
  vocabs, embeds 8/6, encode 16, B=4, L=6.
- ``@shape_contract`` itself: spec forms, weak values (Python and numpy
  scalars), attribute specs, no value read (meta tensors), the wrapper.
- torchlint: a positive and a negative fixture for every TX and SC rule
  (TX005 is not applicable and never fires), suppressions, the baseline.
- The CLI: the port scans clean (``main([]) == 0``), the flags, and a run
  with ``torch`` and ``numpy`` blocked.
- ``RecompileDetector``'s ``recompile`` event names TX001 and TX006.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu.analysis.contracts import ContractError as JaxContractError
from code2vec_tpu.ann import lut_kernel as jax_lut
from code2vec_tpu.models.code2vec import Code2VecConfig as JaxModelConfig
from code2vec_tpu.ops import attention as jax_attention
from code2vec_tpu.ops import embed as jax_embed
from code2vec_tpu.ops import fused_encode_pool as jax_fused
from code2vec_tpu.ops import pallas_attention as jax_pallas
from code2vec_tpu.train.config import TrainConfig as JaxTrainConfig
from code2vec_tpu.train.step import create_train_state, make_eval_step, make_train_step
from code2vec_tpu_torch import interop
from code2vec_tpu_torch.analysis import sharding_check, torchlint
from code2vec_tpu_torch.analysis.__main__ import main
from code2vec_tpu_torch.analysis.contracts import ArgSpec, ContractError, shape_contract, spec
from code2vec_tpu_torch.ann import lut_kernel
from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig
from code2vec_tpu_torch.obs.runtime import RecompileDetector
from code2vec_tpu_torch.ops import attention, embed, fused_encode_pool, pool_kernel
from code2vec_tpu_torch.train import device_epoch
from code2vec_tpu_torch.train.config import TrainConfig
from code2vec_tpu_torch.train.step import StepTally, eval_step, make_optimizer, train_step

REPO = Path(__file__).resolve().parents[1]
AXES = {"AXIS_DATA": "data", "AXIS_MODEL": "model", "AXIS_CTX": "ctx", "GROUP_DC": "dc"}

# one pattern per malformation, matching both packages' messages
RANK = r"has rank \d+ \(shape \([0-9, ]*\)\), contract expects rank \d+"
BOUND = r"was bound by an earlier argument"
DTYPE = r"has dtype \w+, contract expects (category '\w+'|\w+)"
WEAK = r"WEAK-typed"

# the probe's sizes: vocabs 30/20/5, embeds 8/6, encode 16, B=4, L=6
DIMS = dict(terminal_count=30, path_count=20, label_count=5, terminal_embed_size=8,
            path_embed_size=6, encode_size=16)
B, L = 4, 6


@contextlib.contextmanager
def gspmd():
    """jax 0.9's Shardy partitioner rejects the JAX fused op (ROADMAP §C)."""
    previous = jax.config.jax_use_shardy_partitioner
    jax.config.update("jax_use_shardy_partitioner", False)
    try:
        yield
    finally:
        jax.config.update("jax_use_shardy_partitioner", previous)


# ---------------------------------------------------------------------------
# the contract sites


def pool_inputs(seed=0):
    rng = np.random.default_rng(seed)
    mask = (rng.random((B, L)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    return {"contexts": np.tanh(rng.normal(size=(B, L, 8))).astype(np.float32),
            "mask": mask, "attn_param": rng.normal(size=8).astype(np.float32)}


def weights_inputs(seed=0):
    rng = np.random.default_rng(seed)
    return {"scores": rng.normal(size=(B, L)).astype(np.float32),
            "mask": (rng.random((B, L)) > 0.3).astype(np.float32)}


def embed_inputs(seed=0):
    rng = np.random.default_rng(seed)
    return {"table": rng.normal(size=(30, 8)).astype(np.float32),
            "ids": rng.integers(0, 30, (B, L)).astype(np.int32)}


def fused_inputs(seed=0):
    rng = np.random.default_rng(seed)
    starts = rng.integers(1, 30, (B, L)).astype(np.int32)
    mask = (rng.random((B, L)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    return {
        "t_table": (rng.normal(size=(30, 8)) * 0.5).astype(np.float32),
        "p_table": (rng.normal(size=(20, 6)) * 0.5).astype(np.float32),
        "starts": starts, "paths": rng.integers(1, 20, (B, L)).astype(np.int32),
        "ends": rng.integers(1, 30, (B, L)).astype(np.int32), "mask": mask,
        "dense_kernel": (rng.normal(size=(22, 16)) * 0.3).astype(np.float32),
        "ln_scale": (1 + 0.1 * rng.normal(size=16)).astype(np.float32),
        "ln_bias": (0.1 * rng.normal(size=16)).astype(np.float32),
        "attn_param": rng.normal(size=16).astype(np.float32),
    }


def lut_inputs(seed=0):
    rng = np.random.default_rng(seed)
    bias = np.zeros((10, 32), np.float32)
    bias[:, 28:] = -np.inf
    scales = rng.random((10, 32)).astype(np.float32)
    scales[:, 28:] = 0.0
    return {"lut": rng.normal(size=(2, 4, 256)).astype(np.float32),
            "probed": rng.integers(0, 10, (2, 3)).astype(np.int32),
            "codes": rng.integers(0, 256, (10, 32, 4)).astype(np.uint8),
            "scales": scales, "bias": bias}


def step_batch(seed=0):
    rng = np.random.default_rng(seed)
    starts = rng.integers(1, 30, (B, L)).astype(np.int32)
    starts[:, -2:] = 0
    keep = starts > 0
    return {"starts": starts,
            "paths": (rng.integers(1, 20, (B, L)) * keep).astype(np.int32),
            "ends": (rng.integers(1, 30, (B, L)) * keep).astype(np.int32),
            "labels": rng.integers(0, 5, B).astype(np.int32),
            "example_mask": np.array([1.0, 1.0, 1.0, 0.0], np.float32)}


def to_torch(v):
    return torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray) else v


def to_jax(v):
    return jnp.asarray(v) if isinstance(v, np.ndarray) else v


FUSED_MODES = {"gather_split": ("gather_split", "materialize"),
               "fused": ("fused", "materialize"), "online": ("fused", "online")}


class Site:
    """One contract site: its seeded inputs, the JAX call and the port's
    (decorated) function, called with the inputs by name."""

    def __init__(self, name, inputs, jax_call, port_fn, port_kw=None, cases=()):
        self.name, self.inputs, self.jax_call = name, inputs, jax_call
        self.port_fn, self.port_kw, self.cases = port_fn, port_kw or {}, dict(cases)

    def port_call(self, fn, args):
        return fn(**{k: to_torch(v) for k, v in args.items()}, **self.port_kw)


def _jax_kw(fn, **extra):
    return lambda args: fn(**{k: to_jax(v) for k, v in args.items()}, **extra)


def _rank_up(x):
    return x[..., None]


def _cut(x):
    return x[..., :-1]


POOL_CASES = {"rank": ("contexts", lambda x: x[:, :, 0], RANK),
              "symbol": ("attn_param", _cut, BOUND),
              "dtype": ("contexts", lambda x: x.astype(np.int32), DTYPE),
              "scalar": ("attn_param", lambda x: 1.0, RANK)}

SITES = {
    "masked_attention_weights": Site(
        "masked_attention_weights", weights_inputs,
        _jax_kw(jax_attention.masked_attention_weights), attention.masked_attention_weights,
        cases={"rank": ("mask", _rank_up, RANK), "symbol": ("mask", _cut, BOUND),
               "scalar": ("mask", lambda x: 1.0, RANK)}),
    "attention_pool": Site("attention_pool", pool_inputs, _jax_kw(jax_attention.attention_pool),
                           attention.attention_pool, cases=POOL_CASES),
    "streaming_attention_pool": Site(
        "streaming_attention_pool", pool_inputs,
        _jax_kw(jax_attention.streaming_attention_pool), attention.streaming_attention_pool,
        cases=POOL_CASES),
    "embedding_lookup": Site(
        "embedding_lookup", embed_inputs, _jax_kw(jax_embed.embedding_lookup),
        embed.embedding_lookup,
        cases={"rank": ("table", lambda x: x[:, 0], RANK),
               "dtype": ("ids", lambda x: x.astype(np.float32), DTYPE),
               "scalar": ("ids", lambda x: 3, WEAK)}),
    "K1": Site("K1", pool_inputs, _jax_kw(jax_pallas.pallas_attention_pool, backend="cpu"),
               pool_kernel.attention_pool_kernel, cases=POOL_CASES),
    "K5": Site("K5", lut_inputs, _jax_kw(jax_lut.lut_score_cells, backend="cpu"),
               lut_kernel.lut_score_cells,
               cases={"rank": ("probed", lambda x: x[:, 0], RANK),
                      "symbol": ("codes", lambda x: x[..., :3], BOUND),
                      "dtype": ("probed", lambda x: x.astype(np.float32), DTYPE),
                      "scalar": ("scales", lambda x: 1.0, RANK)}),
}
for _mode, (_impl, _softmax) in FUSED_MODES.items():
    SITES[f"K2-K4 {_mode}"] = Site(
        f"K2-K4 {_mode}", fused_inputs,
        _jax_kw(jax_fused.fused_encode_attend_pool, impl=_impl, softmax_mode=_softmax,
                backend="cpu"),
        fused_encode_pool.fused_encode_attend_pool,
        port_kw={"impl": _impl, "softmax_mode": _softmax},
        cases={"rank": ("mask", _rank_up, RANK), "symbol": ("ends", _cut, BOUND),
               "dtype": ("paths", lambda x: x.astype(np.float32), DTYPE),
               "scalar": ("ln_bias", lambda x: 0.0, RANK)})

SITE_CASES = [(name, case) for name, site in SITES.items()
              for case in ("healthy", *site.cases)]


def flat(out):
    return out if isinstance(out, (tuple, list)) else (out,)


@pytest.mark.parametrize("name,case", SITE_CASES, ids=[f"{n}-{c}" for n, c in SITE_CASES])
def test_contract_site_matches_jax(name, case):
    site = SITES[name]
    args = site.inputs()
    if case == "healthy":
        with gspmd():
            want = [np.asarray(x) for x in flat(site.jax_call(args))]
        got = flat(site.port_call(site.port_fn, args))
        bare = flat(site.port_call(site.port_fn.__wrapped__, args))
        for g, b, w in zip(got, bare, want):
            assert torch.equal(g, b)
            np.testing.assert_allclose(g.float().numpy(), w, rtol=2e-5, atol=2e-6)
        return
    key, bad, pattern = site.cases[case]
    args[key] = bad(args[key])
    with gspmd(), pytest.raises(JaxContractError, match=pattern):
        site.jax_call(args)
    with pytest.raises(ContractError, match=pattern):
        site.port_call(site.port_fn, args)


# ---------------------------------------------------------------------------
# the steps


@pytest.fixture(scope="module")
def jax_state():
    cfg = JaxModelConfig(**DIMS, dropout_prob=0.0)
    train_cfg = JaxTrainConfig(lr=0.01, dropout_prob=0.0, batch_size=B, max_path_length=L)
    state = create_train_state(train_cfg, cfg, jax.random.PRNGKey(3), step_batch())
    weights = jnp.ones(DIMS["label_count"], jnp.float32)
    return state, make_train_step(cfg, weights), make_eval_step(cfg, weights)


def port_model(jax_state):
    cfg = Code2VecConfig(**DIMS, dropout_prob=0.0)
    model = Code2Vec(cfg)
    params = jax.tree.map(np.asarray, jax_state[0].params)
    model.load_state_dict(interop.state_dict_from_jax_params(params, cfg), strict=True)
    return model, make_optimizer(model, TrainConfig(lr=0.01))


def jax_step(jax_state, kind, batch, state=None):
    state = jax.tree.map(jnp.array, jax_state[0] if state is None else state)  # donated
    out = (jax_state[1] if kind == "train" else jax_state[2])(
        state, {k: to_jax(v) for k, v in batch.items()})
    return float(out[1]) if kind == "train" else float(out["loss"])


def port_step(fn, kind, model, opt, batch):
    batch = {k: to_torch(v) for k, v in batch.items()}
    weights = torch.ones(DIMS["label_count"])
    if kind == "train":
        return fn(model, opt, batch, weights)
    return fn(model, batch, weights)["loss"]


STEP_CASES = {
    # the three inputs the port's step used to accept (Motivation)
    "mask_b1": ("example_mask", lambda x: x[:, None], RANK),
    "mask_1": ("example_mask", lambda x: x[:1], BOUND),
    "float_labels": ("labels", lambda x: x.astype(np.float32), DTYPE),
    # a Python scalar where a tensor goes
    "scalar_labels": ("labels", lambda x: 3, RANK),
}


@pytest.mark.parametrize("kind", ["train", "eval"])
@pytest.mark.parametrize("case", ["healthy", *STEP_CASES, "bf16_tables"])
def test_step_contract_matches_jax(jax_state, kind, case):
    batch = step_batch()
    fn = train_step if kind == "train" else eval_step
    model, opt = port_model(jax_state)
    if case == "healthy":
        want = jax_step(jax_state, kind, batch)
        twin, twin_opt = copy.deepcopy(model), None
        twin_opt = make_optimizer(twin, TrainConfig(lr=0.01))
        got = port_step(fn, kind, model, opt, batch)
        bare = port_step(fn.__wrapped__, kind, twin, twin_opt, batch)
        assert torch.equal(got, bare)
        for (k, a), b in zip(model.state_dict().items(), twin.state_dict().values()):
            assert torch.equal(a, b), k
        np.testing.assert_allclose(float(got), want, rtol=2e-5)
        return
    state = None
    if case == "bf16_tables":  # the master tables are f32 on every step path
        pattern = r"has dtype bfloat16, contract expects float32"
        params = jax.tree.map(lambda x: x, jax_state[0].params)
        params["terminal_embedding"]["embedding"] = \
            params["terminal_embedding"]["embedding"].astype(jnp.bfloat16)
        state = jax_state[0].replace(params=params)
        model.terminal_embedding.to(torch.bfloat16)
    else:
        key, bad, pattern = STEP_CASES[case]
        batch[key] = bad(batch[key])
    with pytest.raises(JaxContractError, match=pattern):
        jax_step(jax_state, kind, batch, state)
    before = copy.deepcopy(model.state_dict())
    with pytest.raises(ContractError, match=pattern):
        port_step(fn, kind, model, opt, batch)
    for k, v in model.state_dict().items():  # raised before the step
        assert torch.equal(v, before[k]), k


def test_device_epoch_chunks_go_through_the_contract(jax_state, monkeypatch):
    """``EpochRunner.train_chunk`` steps its sampled batches through the
    contract-checked ``train_step``: a sampler that handed out float labels
    raises before any step."""
    model, opt = port_model(jax_state)
    bad = {k: to_torch(v) for k, v in step_batch().items()}
    bad["labels"] = bad["labels"].float()
    runner = device_epoch.EpochRunner(torch.ones(DIMS["label_count"]), B, L)
    monkeypatch.setattr(runner, "_batches", lambda *a: iter([bad]))
    corpus = SimpleNamespace(counts=np.full(B, L))
    with pytest.raises(ContractError, match=DTYPE):
        runner.train_chunk(model, opt, corpus, np.arange(B), 0, 1, B, None,
                           StepTally(torch.device("cpu")))


# ---------------------------------------------------------------------------
# @shape_contract itself


def T(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


def test_spec_parsing():
    s = spec("B,L", "int")
    assert s.dims == ("B", "L") and s.dtypes == "int"
    assert spec("").dims == () and spec("4,?").dims == (4, "?")
    assert spec(None, torch.int32).dtypes == (torch.int32,)
    assert spec(dtype=(torch.int32, torch.int64)).dtypes == (torch.int32, torch.int64)
    assert isinstance(spec(), ArgSpec)
    with pytest.raises(ValueError):
        spec("B", "complex")
    with pytest.raises(TypeError):
        spec("B", np.int32)


@pytest.mark.parametrize("value,pattern", [
    (T(2, 3), None),
    (T(2), RANK),
    (T(2, 3, dtype=torch.int32), DTYPE),
    (T(2, 3, dtype=torch.bfloat16), None),
    (1.5, RANK),
])
def test_rank_and_category(value, pattern):
    @shape_contract(x=spec("B,L", "float"))
    def f(x):
        return "ran"

    if pattern is None:
        assert f(value) == "ran"
    else:
        with pytest.raises(ContractError, match=pattern):
            f(value)


def test_exact_dtypes_symbols_and_pins():
    @shape_contract(spec("B,4", torch.int32), y=spec("B", (torch.float32, torch.float64)))
    def f(x, y):
        return x.shape[0]

    assert f(T(3, 4, dtype=torch.int32), T(3)) == 3
    assert f(T(5, 4, dtype=torch.int32), y=T(5, dtype=torch.float64)) == 5  # B rebinds per call
    with pytest.raises(ContractError, match="contract pins it to 4"):
        f(T(3, 5, dtype=torch.int32), T(3))
    with pytest.raises(ContractError, match=BOUND):
        f(T(3, 4, dtype=torch.int32), T(2))
    with pytest.raises(ContractError, match="contract expects int32"):
        f(T(3, 4, dtype=torch.int64), T(3))
    with pytest.raises(ContractError, match="float32/float64"):
        f(T(3, 4, dtype=torch.int32), T(3, dtype=torch.float16))


@pytest.mark.parametrize("value", [3, 2.5, True, np.float32(1.0), np.int32(7)])
def test_python_and_numpy_scalars_are_weak(value):
    @shape_contract(x=spec(None))
    def f(x):
        return x

    @shape_contract(x=spec(None, allow_weak=True))
    def g(x):
        return x

    with pytest.raises(ContractError, match=r"WEAK-typed.*TX001"):
        f(value)
    assert g(value) is value
    assert f(torch.tensor(value)).shape == ()  # a 0-d tensor is strong


@pytest.mark.parametrize("value", [[1, 2], np.zeros((2, 2), np.float32), "ids"])
def test_non_tensors_are_rejected(value):
    @shape_contract(x=spec(None))
    def f(x):
        return x

    with pytest.raises(ContractError, match="contract expects a torch.Tensor"):
        f(value)


def test_dict_and_attribute_specs():
    contract = {"table": {"weight": spec("V,E", torch.float32)}}

    @shape_contract(model=contract, batch={"ids": spec("B", "int")})
    def step(model, batch):
        return "ok"

    good = SimpleNamespace(table=SimpleNamespace(weight=T(7, 3)))
    assert step(good, {"ids": T(2, dtype=torch.int64), "extra": 1}) == "ok"
    with pytest.raises(ContractError, match="missing required key 'ids'"):
        step(good, {})
    with pytest.raises(ContractError, match="has no attribute 'table'"):
        step(SimpleNamespace(), {"ids": T(2, dtype=torch.int64)})
    with pytest.raises(ContractError, match=r"model\['table'\]\['weight'\] has dtype bfloat16"):
        step(SimpleNamespace(table=SimpleNamespace(weight=T(7, 3, dtype=torch.bfloat16))),
             {"ids": T(2, dtype=torch.int64)})


def test_a_check_reads_no_value():
    """Meta tensors carry shape and dtype but no data: a check that read a
    value would raise. So a check on the card never syncs it."""
    @shape_contract(a=spec("B,L", "int"), b=spec("B", "float"))
    def f(a, b):
        return None

    f.check(torch.empty(4, 6, dtype=torch.int32, device="meta"),
            torch.empty(4, device="meta"))
    with pytest.raises(ContractError, match=BOUND):
        f.check(torch.empty(4, 6, dtype=torch.int32, device="meta"),
                torch.empty(5, device="meta"))


def test_wrapper_keeps_signature_and_counts():
    import inspect

    calls = []

    @shape_contract(x=spec("N"))
    def f(x, scale: float = 2.0):
        """Doc."""
        calls.append(x)
        return x * scale

    assert f.__name__ == "f" and f.__doc__ == "Doc." and f.__wrapped__ is not f
    assert list(inspect.signature(f).parameters) == ["x", "scale"]
    f.check(T(3))  # the check alone does not run the body
    assert calls == [] and f.contract_checks == 1
    f(T(3))
    assert len(calls) == 1 and f.contract_checks == 2
    for fn in (pool_kernel.attention_pool_kernel, fused_encode_pool.fused_encode_attend_pool,
               lut_kernel.lut_score_cells, train_step, eval_step, embed.embedding_lookup):
        assert inspect.signature(fn) == inspect.signature(fn.__wrapped__)
        assert fn.__contract__


def test_contracts_import_without_torch():
    """The module imports torch on the first check, so spec objects (and
    the lint layers beside it) build with torch blocked."""
    script = ("import sys\nsys.modules['torch'] = None\n"
              "from code2vec_tpu_torch.analysis.contracts import spec, shape_contract\n"
              "s = spec('B,L', 'int')\nshape_contract(x=s)(lambda x: x)\nprint('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


# ---------------------------------------------------------------------------
# torchlint rules: one positive and one negative fixture each


def lint(src: str):
    return torchlint.lint_source(textwrap.dedent(src), "mod.py")


def rule_ids(findings, include_suppressed=False):
    return {f.rule for f in findings if include_suppressed or not f.suppressed}


def shard(src: str):
    return sharding_check.check_source(textwrap.dedent(src), "mod.py", AXES)


RULE_FIXTURES = {
    "TX000": ("def broken(:\n    pass\n", "def fine():\n    pass\n"),
    "TX001": (
        """
        import torch
        def feed(model, opt, w, s):
            batch = {"starts": s, "labels": torch.tensor([1, 2])}
            train_step(model, opt, batch, w)
            eval_step(model, {"starts": s}, torch.ones(9))
        """,
        """
        import torch
        def feed(model, opt, w, s):
            batch = {"starts": s, "labels": torch.tensor([1, 2], dtype=torch.int32)}
            train_step(model, opt, batch, w)
            scale = torch.tensor(2.0)  # not a batch, not a step's input
        """),
    "TX002": (
        """
        import torch
        from torch import nn
        class Head(nn.Module):
            def forward(self, x):
                n = x.sum()
                return x / n.item()
        class Op(torch.autograd.Function):
            @staticmethod
            def backward(ctx, g):
                return g * float(g.max())
        def train_step(model, optimizer, batch, class_weights):
            torch.cuda.synchronize()
        """,
        """
        import torch
        from torch import nn
        class Head(nn.Module):
            def forward(self, x):
                n = int(x.size(0)) + int(x.shape[1]) + float(self.scale)
                return x / n
        def report(t):
            return t.item()  # not a device body
        """),
    "TX003": (
        """
        import torch
        class Head(torch.nn.Module):
            def forward(self, x, mask):
                if mask.any():
                    x = x * mask
                while (x > 1).all():
                    x = x / 2
                total = x.sum()  # a local computed from a tensor is a tensor
                if total > 0:
                    x = x / total
                return x
        """,
        """
        import torch
        class Op(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, mask, impl: str = "fused", backend=None):
                if mask is None or x.dim() != 3 or x.device.type == "cpu":
                    return x
                if impl == "fused" and x.dtype == torch.bfloat16 and ctx.needs_input_grad[0]:
                    return x
                return x
        """),
    "TX004": (
        """
        import random
        import time
        import numpy as np
        def train_step(model, optimizer, batch, class_weights):
            t0 = time.perf_counter()
            keep = np.random.rand(4) > random.random()
        """,
        """
        import time
        import numpy as np
        import torch
        def train_step(model, optimizer, batch, class_weights, generator=None):
            rng = np.random.default_rng(0)
            return torch.rand(4, generator=generator)
        def timed():
            return time.perf_counter()
        """),
    "TX006": (
        """
        def build(names):
            out = [n for n in set(names)]
            for n in {1, 2}:
                out.append(n)
        """,
        """
        def build(names):
            return [n for n in sorted(set(names))]
        """),
    "TX007": (
        """
        def epoch(model, opt, batches, w):
            total = 0.0
            for b in batches:
                loss = train_step(model, opt, b, w)
                total += float(loss)
                seen = loss.item()
        """,
        """
        import torch
        def epoch(model, opt, batches, w, record_steps):
            losses = [train_step(model, opt, b, w) for b in batches]
            total = float(torch.stack(losses).sum())
            for b in batches:
                record_steps(b, w)
                total += float(b)
        """),
}

SHARD_FIXTURES = {
    "SC001": (
        """
        def batch_shardings(mesh):
            return {"ids": ["bath"]}
        def lines(mesh):
            return mesh.group("modle"), mesh.shape["dta"], self.mesh.coords["x"]
        """,
        """
        from code2vec_tpu_torch.parallel.mesh import AXIS_DATA, GROUP_DC
        def batch_shardings(mesh):
            data = AXIS_DATA if mesh.shape[AXIS_DATA] > 1 else None
            return {"ids": [data], "starts": [data, "ctx"], "query": []}
        def lines(mesh, m):
            keys = ["not", "a", "spec"]  # outside a rule function
            return mesh.group(GROUP_DC), mesh.group("dc"), m.group("value")
        """),
    "SC002": (
        """
        def retrieval_shardings(mesh):
            return {"rows": ["model", "model"], "cells": [("data", "model"), "model"]}
        """,
        """
        def retrieval_shardings(mesh):
            return {"rows": ["model", None], "cells": [("data", "ctx"), "model"]}
        """),
    "SC003": (
        """
        def spec_for_param(name, mesh_shape, shape=None):
            return ["ctx", None]
        """,
        """
        def spec_for_param(name, mesh_shape, shape=None):
            return ["model", None]
        def batch_shardings(mesh):
            return {"starts": ["data", "ctx"]}
        """),
}


@pytest.mark.parametrize("rule,positive", [(r, p) for r in RULE_FIXTURES for p in (True, False)])
def test_tx_rule_fixture(rule, positive):
    findings = lint(RULE_FIXTURES[rule][0 if positive else 1])
    assert (rule in rule_ids(findings)) is positive, [f.text() for f in findings]
    if not positive:
        assert rule_ids(findings) == set(), [f.text() for f in findings]


@pytest.mark.parametrize("rule,positive", [(r, p) for r in SHARD_FIXTURES for p in (True, False)])
def test_sc_rule_fixture(rule, positive):
    findings = shard(SHARD_FIXTURES[rule][0 if positive else 1])
    assert (rule in rule_ids(findings)) is positive, [f.text() for f in findings]
    if not positive:
        assert rule_ids(findings) == set(), [f.text() for f in findings]


def test_positive_fixtures_flag_every_site():
    assert len([f for f in lint(RULE_FIXTURES["TX002"][0]) if f.rule == "TX002"]) == 3
    assert len([f for f in lint(RULE_FIXTURES["TX003"][0]) if f.rule == "TX003"]) == 3
    assert len([f for f in lint(RULE_FIXTURES["TX004"][0]) if f.rule == "TX004"]) == 3
    assert len([f for f in shard(SHARD_FIXTURES["SC001"][0]) if f.rule == "SC001"]) == 4


def test_tx005_is_not_applicable():
    """JX005's fixture (a jitted update without donation) gives nothing:
    torch has no donation; the rule stays in the table as info."""
    src = """
        import jax

        @jax.jit
        def step(state, batch):
            state = state.apply_gradients(grads=batch)
            return state
        """
    assert rule_ids(lint(src)) == set()
    assert torchlint.RULES["TX005"].severity == "info"
    assert "not applicable" in torchlint.RULES["TX005"].summary


def test_real_mesh_module_declares_axes_and_groups():
    decls = sharding_check.declared_axes(
        (REPO / "code2vec_tpu_torch" / "parallel" / "mesh.py").read_text())
    assert decls == AXES


@pytest.mark.parametrize("entries,problems", [
    (["data", None], 0), (["bath"], 1), ([["data", "model"], "model"], 1), (["x", "x"], 2)])
def test_validate_runtime_spec_is_jaxs(entries, problems):
    from code2vec_tpu.analysis.sharding_check import validate_runtime_spec as jax_validate

    got = sharding_check.validate_runtime_spec(entries, ["data", "model", "ctx"], "k")
    assert got == jax_validate(entries, ["data", "model", "ctx"], "k") and len(got) == problems


# ---------------------------------------------------------------------------
# suppression and baseline


SET_LOOP = "def f(xs):\n    return [x for x in set(xs)]{}\n"


@pytest.mark.parametrize("comment,suppressed", [
    ("  # torchlint: disable=TX006", True),
    ("  # torchlint: disable", True),
    ("  # torchlint: disable=TX001, tx006", True),
    ("  # torchlint: disable=TX001", False),
    ("  # jaxlint: disable=TX006", False),  # the JAX package's marker is not the port's
])
def test_inline_suppression(comment, suppressed):
    findings = torchlint.lint_source(SET_LOOP.format(comment), "mod.py")
    assert rule_ids(findings, include_suppressed=True) == {"TX006"}
    assert (rule_ids(findings) == set()) is suppressed


def test_baseline_round_trip_counts_and_line_shift(tmp_path):
    src = "def f(xs):\n    a = [x for x in set(xs)]\n    b = [x for x in set(xs)]\n"
    findings = torchlint.lint_source(src, "mod.py")
    assert len(findings) == 2
    path = tmp_path / "baseline.json"
    torchlint.write_baseline(findings[:1], path)
    doc = json.loads(path.read_text())
    assert doc["tool"] == "torchlint" and doc["version"] == 1
    assert torchlint.load_baseline(path) == {torchlint.fingerprint(findings[0]): 1}
    shifted = torchlint.lint_source("import os\n\n" + src.replace("b =", "a ="), "mod.py")
    torchlint.apply_baseline(shifted, torchlint.load_baseline(path))
    assert [f.baselined for f in shifted] == [True, False]  # one recorded, one new
    assert torchlint.load_baseline(tmp_path / "missing.json") == {}


# ---------------------------------------------------------------------------
# the CLI


def run_cli(tmp_path, *extra):
    return main([str(tmp_path), "--root", str(tmp_path),
                 "--baseline", str(tmp_path / "baseline.json"), *extra])


BAD = "import torch\nfrom torch import nn\nclass M(nn.Module):\n" \
      "    def forward(self, x):\n        return x.item()\n"


def test_cli_clean_then_finding_then_baseline(tmp_path, capsys):
    (tmp_path / "ok.py").write_text("x = 1\n")
    assert run_cli(tmp_path) == 0
    assert "0 new finding(s)" in capsys.readouterr().out
    (tmp_path / "snippet.py").write_text(BAD)
    assert run_cli(tmp_path) == 1
    out = capsys.readouterr().out
    assert "TX002" in out and "fix:" in out and "snippet.py:5" in out
    assert run_cli(tmp_path, "--write-baseline") == 0
    capsys.readouterr()
    assert run_cli(tmp_path) == 0
    assert "1 baselined" in capsys.readouterr().out


def test_cli_json_schema(tmp_path, capsys):
    (tmp_path / "snippet.py").write_text(BAD)
    assert run_cli(tmp_path, "--json") == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["version"] == 1 and doc["tool"] == "torchlint"
    assert set(doc["summary"]) == {"total", "new", "baselined", "suppressed", "by_severity"}
    (finding,) = [f for f in doc["findings"] if f["rule"] == "TX002"]
    assert set(finding) == {"rule", "name", "severity", "path", "line", "col", "message",
                            "hint", "snippet", "fingerprint", "suppressed", "baselined"}
    assert finding["severity"] == "error" and finding["path"] == "snippet.py"


def test_cli_list_rules(tmp_path, capsys):
    assert run_cli(tmp_path, "--list-rules") == 0
    out = capsys.readouterr().out
    want = ([f"TX00{i}" for i in range(8)] + ["SC001", "SC002", "SC003"]
            + [f"CX00{i}" for i in range(1, 6)] + [f"RS00{i}" for i in range(1, 7)])
    for rid in want:
        assert rid in out
    assert set(want) == set(torchlint.RULES)


def test_cli_diff_only(tmp_path, capsys):
    (tmp_path / "snippet.py").write_text(BAD)
    assert run_cli(tmp_path, "--diff-only", "HEAD") == 1  # no git: the full scan
    assert "full scan" in capsys.readouterr().err
    with pytest.raises(SystemExit) as exc:
        run_cli(tmp_path, "--diff-only", "HEAD", "--write-baseline")
    assert exc.value.code == 2


def test_the_port_scans_clean(capsys):
    """``python -m code2vec_tpu_torch.analysis`` over the port and
    ``chip_smoke.py`` has zero unsuppressed, unbaselined findings."""
    assert main([]) == 0, capsys.readouterr().out


def test_cli_runs_with_torch_and_numpy_blocked():
    script = ("import sys\n"
              "for name in ('torch', 'numpy', 'jax', 'code2vec_tpu'): sys.modules[name] = None\n"
              "from code2vec_tpu_torch.analysis.__main__ import main\n"
              "sys.exit(main(['--json']))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    doc = json.loads(proc.stdout)
    assert doc["summary"]["new"] == 0 and doc["summary"]["baselined"] == 0
    paths = {f["path"] for f in doc["findings"]}
    assert {"chip_smoke.py", "code2vec_tpu_torch/serve/fleet/replica.py"} <= paths


# ---------------------------------------------------------------------------
# the recompile event's hints


def test_recompile_event_names_the_lint_rules():
    events = []
    log = SimpleNamespace(emit=lambda kind, **fields: events.append((kind, fields)))
    det = RecompileDetector(events=log)
    det.track("train_step")
    det.observe("train_step", (4, 6, "int32"))
    assert det.check(epoch=1) == 0  # the warmup
    det.observe("train_step", (4, 6, "int64"))
    assert det.check(epoch=2) == 1
    (kind, fields), = events
    assert kind == "recompile" and fields["lint_hints"] == ["TX001", "TX006"]
    assert set(torchlint.RECOMPILE_HINT_RULES) <= set(torchlint.RULES)
