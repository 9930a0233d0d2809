"""Live hot-swap on the port (``code2vec_tpu_torch/serve/swap.py``) against JAX's.

The same scenario runs on JAX's ``CodeServer`` (engines built from a JAX
train state, its batcher and swap controller) and on the port's, built by
its own CLI path (``build_server``, ``--device cpu``), from the same
weights: generation A from one JAX init, B from another (JAX params
crossing to the port through ``interop.state_dict_from_jax_params``), and
a copy of B whose encoder weight holds a NaN. Held equal: the sequence of
``swap_status`` states and outcomes, the error kinds (a NaN checkpoint, a
concurrent reload, a rollback mid-swap or with nothing resident, a
reload without a factory, a recall floor the backend misses). After a
commit the port's code vectors match JAX's at rtol 2e-4 / atol 2e-5; a
rollback gives the port's earlier answers bitwise.
"""

from __future__ import annotations

import json
import shutil
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from code2vec_tpu.models.code2vec import Code2Vec as JaxCode2Vec
from code2vec_tpu.models.code2vec import Code2VecConfig as JaxConfig
from code2vec_tpu.obs.runtime import RuntimeHealth as JaxHealth
from code2vec_tpu.serve.batcher import MicroBatcher as JaxBatcher
from code2vec_tpu.serve.engine import ServingEngine as JaxEngine
from code2vec_tpu.serve.protocol import CodeServer as JaxCodeServer
from code2vec_tpu.serve.retrieval import RetrievalIndex as JaxRetrievalIndex
from code2vec_tpu.serve.swap import Generation as JaxGeneration
from code2vec_tpu.serve.swap import GoldenSet as JaxGoldenSet
from code2vec_tpu_torch import interop
from code2vec_tpu_torch.formats.vectors_io import append_code_vectors, write_code_vectors_header
from code2vec_tpu_torch.models.code2vec import Code2VecConfig
from code2vec_tpu_torch.serve.__main__ import build_parser, build_server
from code2vec_tpu_torch.serve.protocol import CodeServer
from code2vec_tpu_torch.serve.swap import Generation, GoldenSet, validate_generation
from test_torch_serve import BAG, DIMS, LADDER, bag, make_model_dir

RTOL, ATOL = 2e-4, 2e-5
BATCH_SIZES = (1, 8)


def jax_params(seed: int, nan: bool = False) -> dict:
    jm = JaxCode2Vec(JaxConfig(**DIMS, dropout_prob=0.0))
    ids = jnp.ones((1, BAG), jnp.int32)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed), ids, ids, ids)["params"])
    if nan:
        params["input_dense"]["kernel"] = params["input_dense"]["kernel"].copy()
        params["input_dense"]["kernel"][0, 0] = np.nan
    return params


def write_other_weights(a_dir, out_dir, seed: int, nan: bool = False) -> dict:
    """A model dir beside ``a_dir``'s with the JAX init of ``seed`` (the
    vocab files stay ``a_dir``'s); returns the JAX params."""
    params = jax_params(seed, nan)
    out_dir.mkdir(parents=True, exist_ok=True)
    cfg = Code2VecConfig(**DIMS)
    interop.save_state_dict(interop.state_dict_from_jax_params(params, cfg), str(out_dir), cfg)
    for name in ("model_meta.json", "label_vocab.txt"):
        shutil.copy(a_dir / name, out_dir / name)
    return params


def write_code_vec(path, seed: int = 3, rows: int = 60) -> None:
    vecs = np.random.default_rng(seed).normal(size=(rows, DIMS["encode_size"]))
    write_code_vectors_header(path, rows, DIMS["encode_size"])
    append_code_vectors(path, [f"m{i}" for i in range(rows)], vecs.astype(np.float32))


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("swap")
    (root / "a").mkdir()
    a, _, params_a = make_model_dir(root / "a")
    out = {"A": a, "params": {"A": params_a}}
    for name, seed, nan in (("B", 11, False), ("NaN", 11, True)):
        out[name] = root / name.lower()
        out["params"][name] = write_other_weights(a, out[name], seed, nan)
    return out


class Gate:
    """Holds a factory's builds until released (a swap caught mid-build)."""

    def __init__(self, build):
        self.build, self.open = build, threading.Event()
        self.open.set()

    def __call__(self, target):
        assert self.open.wait(60)
        return self.build(target)


def jax_server(dirs, min_recall=0.9, code_vec=None):
    """JAX's CodeServer over engines from a JAX train state, its factory
    building generation ``target`` ("B", "NaN") from the same params."""
    from code2vec_tpu.train.config import TrainConfig
    from code2vec_tpu.train.step import create_train_state

    health = JaxHealth()
    mc = JaxConfig(**DIMS, dropout_prob=0.0)
    example = {k: np.zeros((1, BAG), np.int32) for k in ("starts", "paths", "ends")}
    example.update(labels=np.zeros(1, np.int32), example_mask=np.ones(1, np.float32))
    base = create_train_state(TrainConfig(batch_size=4, max_path_length=BAG), mc,
                              jax.random.PRNGKey(0), example)
    meta = json.loads((dirs["A"] / "model_meta.json").read_text())
    predictor = SimpleNamespace(meta=meta, label_vocab=None)

    from code2vec_tpu.obs.runtime import FlightRecorder

    flight = FlightRecorder(health=health)

    def generation(name, version):
        state = base.replace(params=jax.tree.map(jnp.asarray, dirs["params"][name]))
        engine = JaxEngine(state, max_width=BAG, ladder=LADDER, batch_sizes=BATCH_SIZES,
                           model_dims=(DIMS["terminal_embed_size"], DIMS["path_embed_size"],
                                       DIMS["encode_size"]), health=health, version=version)
        engine.prepare()
        retrieval = JaxRetrievalIndex.from_code_vec(str(code_vec)) if code_vec else None
        return JaxGeneration(version=version, engine=engine, predictor=predictor,
                             batcher=JaxBatcher(engine, deadline_ms=1.0, health=health,
                                                flight=flight),
                             retrieval=retrieval)

    gen0 = generation("A", "A#g0")
    counter = iter(range(1, 100))
    factory = Gate(lambda target: generation(target, f"{target}#g{next(counter)}"))
    golden = JaxGoldenSet(n_terminals=DIMS["terminal_count"], n_paths=DIMS["path_count"],
                          min_recall=min_recall)
    server = JaxCodeServer(predictor, gen0.engine, gen0.batcher, retrieval=gen0.retrieval,
                           health=health, version=gen0.version, factory=factory, golden=golden,
                           flight=flight, generation=gen0)
    return server, factory, {"B": "B", "NaN": "NaN"}


def port_server(dirs, min_recall=0.9, code_vec=None):
    a = dirs["A"]
    argv = ["--model_path", str(a), "--terminal_idx_path", str(a / "terminal_idxs.txt"),
            "--path_idx_path", str(a / "path_idxs.txt"), "--device", "cpu",
            "--batch_sizes", "1,8", "--deadline_ms", "1", "--golden_min_recall", str(min_recall)]
    if code_vec:
        argv += ["--code_vec_path", str(code_vec)]
    server = build_server(build_parser().parse_args(argv))
    factory = Gate(server.swap._build)
    server.swap._build = factory
    return server, factory, {"B": str(dirs["B"]), "NaN": str(dirs["NaN"])}


def state_of(status: dict) -> tuple:
    last = status.get("last_swap") or {}
    return status["state"], last.get("outcome"), status["previous_version"] is not None


def embed(server, probes) -> np.ndarray:
    out = []
    for p in probes:
        resp = server.handle({"op": "embed", "contexts": p.tolist()})
        assert resp.get("ok"), resp
        out.append(resp["methods"][0]["code_vector"])
    return np.asarray(out, np.float32)


PROBES = [bag(n, 900 + n) for n in (1, 5, 8, 9, 16, 30)]


def scenario(server, gate, targets) -> dict:
    """The swap scenario; returns what it saw (states, error kinds, the
    probes' vectors at each step)."""
    seen = {"states": [state_of(server.handle({"op": "swap_status"})["swap"])], "kinds": []}
    kind = lambda resp: resp.get("error_kind")  # noqa: E731
    seen["kinds"].append(kind(server.handle({"op": "rollback"})))  # nothing resident
    seen["before"] = embed(server, PROBES)
    resp = server.handle({"op": "reload", "model_path": targets["B"], "wait": True})
    seen["kinds"].append(kind(resp))
    seen["states"].append(state_of(resp["swap"]))
    seen["after"] = embed(server, PROBES)
    resp = server.handle({"op": "rollback"})
    seen["kinds"].append(kind(resp))
    seen["states"].append(state_of(resp["swap"]))
    seen["rolled_back"] = embed(server, PROBES)
    active = server.handle({"op": "swap_status"})["swap"]["active_version"]
    resp = server.handle({"op": "reload", "model_path": targets["NaN"], "wait": True})
    seen["kinds"].append(kind(resp))
    seen["states"].append(state_of(resp["swap"]))
    seen["nan_kept_active"] = resp["swap"]["active_version"] == active
    seen["nan_error"] = "non-finite" in resp["error"]
    # a reload caught mid-build: a second reload and a rollback are refused
    gate.open.clear()
    resp = server.handle({"op": "reload", "model_path": targets["B"], "wait": False})
    seen["kinds"].append(kind(resp))
    seen["states"].append(state_of(resp["swap"]))
    seen["kinds"].append(kind(server.handle({"op": "reload", "model_path": targets["B"]})))
    seen["kinds"].append(kind(server.handle({"op": "rollback"})))
    gate.open.set()
    server.swap.wait(120)
    seen["states"].append(state_of(server.handle({"op": "swap_status"})["swap"]))
    seen["final"] = embed(server, PROBES)
    return seen


@pytest.fixture(scope="module")
def scenarios(dirs):
    out = {}
    for name, make in (("jax", jax_server), ("port", port_server)):
        server, gate, targets = make(dirs)
        try:
            out[name] = scenario(server, gate, targets)
        finally:
            server.close()
    return out


def test_states_and_error_kinds_equal_jax(scenarios):
    jax_seen, port_seen = scenarios["jax"], scenarios["port"]
    assert port_seen["states"] == jax_seen["states"]
    assert port_seen["kinds"] == jax_seen["kinds"] == [
        "bad_request", None, None, "swap_failed", None, "bad_request", "bad_request"]
    assert port_seen["states"] == [
        ("idle", None, False), ("idle", "committed", True), ("idle", "rolled_back", True),
        ("idle", "failed", True), ("building", "failed", True), ("idle", "committed", True)]


@pytest.mark.parametrize("step", ["before", "after", "final"])
def test_vectors_match_jax_at_each_step(scenarios, step):
    np.testing.assert_allclose(scenarios["port"][step], scenarios["jax"][step],
                               rtol=RTOL, atol=ATOL)


def test_commit_serves_the_new_weights(scenarios):
    port = scenarios["port"]
    assert not np.allclose(port["after"], port["before"])
    np.testing.assert_array_equal(port["final"], port["after"])


def test_rollback_is_bitwise(scenarios):
    np.testing.assert_array_equal(scenarios["port"]["rolled_back"], scenarios["port"]["before"])


def test_nan_checkpoint_keeps_the_active_generation(scenarios):
    for name in ("jax", "port"):
        assert scenarios[name]["nan_kept_active"] and scenarios[name]["nan_error"], name


def test_recall_floor_miss_fails_alike(dirs, tmp_path):
    code_vec = tmp_path / "code.vec"
    write_code_vec(code_vec)
    kinds = {}
    for name, make in (("jax", jax_server), ("port", port_server)):
        server, _, targets = make(dirs, min_recall=1.01, code_vec=code_vec)
        try:
            version = server.handle({"op": "swap_status"})["swap"]["active_version"]
            resp = server.handle({"op": "reload", "model_path": targets["B"], "wait": True})
            assert "recall@10" in resp["error"], resp
            assert resp["swap"]["active_version"] == version
            kinds[name] = resp["error_kind"]
        finally:
            server.close()
    assert kinds["port"] == kinds["jax"] == "swap_failed"


def test_exact_backend_recall_commits_at_one(dirs, tmp_path):
    code_vec = tmp_path / "code.vec"
    write_code_vec(code_vec)
    server, _, targets = port_server(dirs, code_vec=code_vec)
    try:
        resp = server.handle({"op": "reload", "model_path": targets["B"], "wait": True})
        assert resp["ok"] and resp["swap"]["last_swap"]["recall"] == 1.0
        assert server.retrieval.host_rows().shape == (60, DIMS["encode_size"])
    finally:
        server.close()


def test_reload_without_a_factory_is_refused_alike():
    stub = dict(predictor=SimpleNamespace(meta={}), engine=SimpleNamespace(max_width=16),
                batcher=SimpleNamespace(close=lambda: None))
    got = CodeServer(**stub).handle({"op": "reload", "model_path": "x"})
    want = JaxCodeServer(**stub).handle({"op": "reload", "model_path": "x"})
    assert got["error_kind"] == want["error_kind"] == "bad_request"
    assert "factory" in got["error"] and "factory" in want["error"]


def test_golden_requests_equal_jax(dirs):
    """The golden set sweeps the same requests over the same ladder."""
    server, _, _ = port_server(dirs)
    try:
        gen = server.swap.active
        got = GoldenSet().requests_for(gen)
        want = JaxGoldenSet(n_terminals=DIMS["terminal_count"],
                            n_paths=DIMS["path_count"]).requests_for(
            SimpleNamespace(engine=SimpleNamespace(active_ladder=LADDER), predictor=None))
        assert len(got) == len(want) == 2 * len(LADDER)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        report = validate_generation(gen, GoldenSet())
        assert report["golden_requests"] == len(got)
    finally:
        server.close()


def test_retired_generation_is_closed(dirs):
    """After a third generation commits, the first one's batcher is
    closed and it has left the controller; two stay resident."""
    server, _, targets = port_server(dirs)
    try:
        first = server.swap.active
        for target in (targets["B"], str(dirs["A"])):
            assert server.handle({"op": "reload", "model_path": target, "wait": True})["ok"]
        assert first not in (server.swap.active, server.swap.previous)
        with pytest.raises(Exception):
            first.batcher.submit(bag(3, 1))
        assert isinstance(server.swap.previous, Generation)
    finally:
        server.close()
