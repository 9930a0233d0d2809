"""A resume, and a fine-tune from a checkpoint, train at the resuming
run's optimizer settings, against the JAX package's resume, on the CPU.

JAX builds its optax chain from the run's config and restores only the
arrays (``code2vec_tpu/checkpoint.py:616-760``), so a resume at another
``--lr``, ``--beta_min/--beta_max`` or non-zero ``--weight_decay`` trains
at the new values from the saved moments and step counts. Each route here
saves after a few steps at lr 0.01 (weight decay 0.01), on both sides from
one set of weights (``interop``), dropout 0; then both resume at one
changed setting:

- routes: dense f32 (``torch.optim.Adam``), ``--adam_mu_dtype bfloat16``
  (``TorchStyleAdam``), ``--table_update lazy``, a mid-epoch cursor save
  (``--checkpoint_every_steps``), ``--device_epoch`` at a boundary save on
  a bag every row fits (the port's sampler draws from a ``torch.Generator``;
  with whole rows the batches are JAX's) and one JAX dispatch a step;
- per-step losses rtol 2e-5 and final parameters atol 3e-5 / rtol 1e-4
  (``docs/PARITY.md:16``); under bf16 moments also the stored first moments
  within one bf16 ulp (``tests/test_torch_bf16.py``);
- at ``--lr 0`` every parameter stays bitwise the checkpoint's, on every
  route, on a ``data=2`` gloo mesh and through the CLI;
- a ``data=2`` mesh resume (``tests/test_torch_mesh.py``'s harness) at each
  changed setting against the port's world-1 resume of the same checkpoint:
  losses rtol 2e-5 a step, parameters at the train-step bar;
- a weight decay switched on or off changes the optimizer's structure: JAX's
  restore raises (orbax's tree check), and so does the port's, naming
  ``--weight_decay``, before it loads anything;
- a restore keeps every step count (``LazyTableAdam``'s group ``step`` and
  each parameter's) and the moments in the run's dtype, and takes the run's
  rate, betas, eps and weight decay.

Dims are tiny (embed 8/6, encode 12, 5 steps an epoch).
"""

import shutil

import jax
import numpy as np
import pytest
import torch

import test_torch_mesh as harness
from code2vec_tpu import faultinject as jax_faultinject
from code2vec_tpu.data import reader as jax_reader
from code2vec_tpu.train import device_epoch as jax_de
from code2vec_tpu.train import loop as jax_loop
from code2vec_tpu.train.config import TrainConfig as JaxTrainConfig
from code2vec_tpu.train.step import create_train_state, make_train_step
from code2vec_tpu_torch import faultinject, interop
from code2vec_tpu_torch.checkpoint import (
    TrainMeta,
    restore_checkpoint,
    save_checkpoint,
    slot_path,
)
from code2vec_tpu_torch.data import reader, synth
from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig
from code2vec_tpu_torch.train import device_epoch as port_de
from code2vec_tpu_torch.train import loop
from code2vec_tpu_torch.train.config import TrainConfig
from code2vec_tpu_torch.train.step import TorchStyleAdam, make_optimizer, to_device, train_step

# the run that saves: lr 0.01 and a non-zero weight decay, so that a changed
# weight decay keeps the optimizer's structure
SAVE = dict(terminal_embed_size=8, path_embed_size=6, encode_size=12, batch_size=32,
            dropout_prob=0.0, random_seed=11, print_sample_cycle=0, checkpoint_cycle=1,
            lr=0.01, weight_decay=0.01, max_epoch=1)
ROUTES = {
    "dense": {},
    "bf16": dict(adam_mu_dtype="bfloat16"),
    "lazy": dict(table_update="lazy"),
    "cursor": dict(checkpoint_every_steps=2),
    "device_epoch": dict(device_epoch=True, device_chunk_batches=1),
}
# the cursor route's first run stops at its 3rd step, after the save at step 2
CURSOR_FAULT = "train_step@3:raise"
CHANGES = {
    "lr": dict(lr=0.003),
    "betas": dict(beta_min=0.8, beta_max=0.99),
    "weight_decay": dict(weight_decay=0.05),
}


@pytest.fixture(autouse=True)
def _no_fault_plan():
    faultinject.install_plan(None)
    jax_faultinject.install_plan(None)
    yield
    faultinject.install_plan(None)
    jax_faultinject.install_plan(None)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    paths = synth.generate_corpus_files(tmp_path_factory.mktemp("resume_hp"),
                                        synth.SPECS["tiny"])
    args = (paths["corpus"], paths["path_idx"], paths["terminal_idx"])
    data = reader.load_corpus(*args)
    # every row fits the bag: the device epochs' batches are JAX's
    bag = int(np.diff(data.row_splits).max())
    return {"paths": {k: str(v) for k, v in paths.items()}, "data": data, "bag": bag,
            "jax": jax_reader.load_corpus(*args, cache=False, native=False)}


def route_kw(tiny, route, **updates) -> dict:
    return {**SAVE, "max_path_length": tiny["bag"], **ROUTES[route], **updates}


class _Recorder:
    """Per-step losses of a JAX run: a wrapped ``train_step``, or (device
    epochs, one batch a dispatch) each chunk's loss."""

    def __init__(self, monkeypatch):
        self.losses = []
        original = jax_de.EpochRunner._train_chunk
        losses = self.losses

        def chunk(runner, n_batches):
            fn = original(runner, n_batches)

            def recorded(*args):
                state, loss = fn(*args)
                losses.append(float(loss))
                return state, loss

            return recorded

        monkeypatch.setattr(jax_de.EpochRunner, "_train_chunk", chunk)

    def step(self, step):
        def recorded(state, batch):
            state, loss = step(state, batch)
            self.losses.append(float(loss))
            return state, loss

        return recorded


def jax_state(tiny, kw: dict):
    """The JAX state of the seed, its optimizer built from ``kw``."""
    jcfg = JaxTrainConfig(**kw)
    return create_train_state(jcfg, jax_loop.model_config_from(jcfg, tiny["jax"]),
                              jax.random.PRNGKey(11), jax_loop.dummy_batch(jcfg))


def jax_run(tiny, kw: dict, out_dir: str, monkeypatch):
    """JAX ``train()`` of ``kw`` in ``out_dir`` from :func:`jax_state` (which
    a resume's restore overwrites): ``(result, per-step losses)``."""
    jcfg = JaxTrainConfig(**kw)
    jdata = tiny["jax"]
    rec = _Recorder(monkeypatch)
    step = None
    if not jcfg.device_epoch:
        model_cfg = jax_loop.model_config_from(jcfg, jdata)
        step = rec.step(make_train_step(model_cfg, jax_loop.class_weights_from(jcfg, jdata),
                                        table_update=jcfg.table_update))
    result = jax_loop.train(jcfg, jdata, out_dir=out_dir, sinks=(),
                            initial_state=jax_state(tiny, kw), train_step=step)
    return result, rec.losses


def port_run(tiny, kw: dict, out_dir: str, monkeypatch, initial_state_dict=None):
    """The port's ``train()`` of ``kw``: ``(result, per-step losses)``."""
    losses = []
    cfg = TrainConfig(**kw)
    target = port_de if cfg.device_epoch else loop
    original = target.train_step

    def recorded(*args):
        loss = original(*args)
        losses.append(float(loss))
        return loss

    monkeypatch.setattr(target, "train_step", recorded)
    result = loop.train(cfg, tiny["data"], out_dir, device="cpu", sinks=(),
                        initial_state_dict=initial_state_dict)
    monkeypatch.setattr(target, "train_step", original)
    return result, losses


def newest_checkpoint(out_dir) -> dict:
    states = [torch.load(slot_path(str(out_dir), slot), weights_only=False)
              for slot in ("best", "last") if (out_dir / f"checkpoint_{slot}.pt").exists()]
    return max(states, key=lambda s: (s["meta"]["epoch"], s["meta"].get("step", 0)))


def assert_params_close(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k].float().numpy(), want[k].float().numpy(), rtol=1e-4,
                                   atol=3e-5, err_msg=k)


def jax_weights(result, cfg_kw, tiny) -> dict:
    cfg = loop.model_config_from(TrainConfig(**cfg_kw), tiny["data"])
    return interop.state_dict_from_jax_params(jax.tree.map(np.asarray, result.state.params),
                                              cfg)


@pytest.fixture(scope="module")
def saved(tiny, tmp_path_factory):
    """Per route, the first run (lr 0.01) on both sides from one set of
    weights: ``{route: (jax_dir, port_dir)}``, made on first use."""
    cache = {}

    def get(route):
        if route not in cache:
            root = tmp_path_factory.mktemp(f"saved_{route}")
            kw = route_kw(tiny, route)
            sd = interop.state_dict_from_jax_params(
                jax.tree.map(np.asarray, jax_state(tiny, kw).params),
                loop.model_config_from(TrainConfig(**kw), tiny["data"]))
            with pytest.MonkeyPatch.context() as mp:
                if route == "cursor":
                    kw = dict(kw, fault_plan=CURSOR_FAULT)
                    with pytest.raises(jax_faultinject.FaultInjected):
                        jax_run(tiny, kw, str(root / "jax"), mp)
                    with pytest.raises(faultinject.FaultInjected):
                        port_run(tiny, kw, str(root / "port"), mp, sd)
                else:
                    jax_run(tiny, kw, str(root / "jax"), mp)
                    port_run(tiny, kw, str(root / "port"), mp, sd)
            faultinject.install_plan(None)
            jax_faultinject.install_plan(None)
            cache[route] = (root / "jax", root / "port")
        return cache[route]

    return get


def copy_dir(src, dst):
    shutil.copytree(src, dst)
    return dst


@pytest.mark.parametrize("change", CHANGES)
@pytest.mark.parametrize("route", ROUTES)
def test_resume_at_changed_settings_tracks_jax(tiny, saved, route, change, tmp_path,
                                               monkeypatch):
    jax_dir, port_dir = saved(route)
    if route == "cursor":
        cursor = torch.load(slot_path(str(port_dir), "last"), weights_only=False)["meta"]
        assert (cursor["cursor"]["epoch"], cursor["cursor"]["step"]) == (0, 2)
    kw = route_kw(tiny, route, max_epoch=2, resume=True, **CHANGES[change])
    want, want_losses = jax_run(tiny, kw, str(copy_dir(jax_dir, tmp_path / "jax")),
                                monkeypatch)
    got, got_losses = port_run(tiny, kw, str(copy_dir(port_dir, tmp_path / "port")),
                               monkeypatch)
    steps = 3 + 5 if route == "cursor" else 5
    assert len(got_losses) == len(want_losses) == steps
    np.testing.assert_allclose(got_losses, want_losses, rtol=2e-5, atol=0)
    assert_params_close(got.model.state_dict(), jax_weights(want, kw, tiny))
    for g, w in zip(got.history, want.history):
        np.testing.assert_allclose(g["train_loss"], w["train_loss"], rtol=2e-5)
    ckpt = newest_checkpoint(tmp_path / "port")
    groups = ckpt["optimizer"].get("dense", ckpt["optimizer"])["param_groups"]
    assert groups[0]["lr"] == kw["lr"] and groups[0]["weight_decay"] == kw["weight_decay"]
    assert tuple(groups[0]["betas"]) == (kw.get("beta_min", 0.9), kw.get("beta_max", 0.999))
    if route == "bf16":
        import test_torch_bf16 as bf16

        cfg = loop.model_config_from(TrainConfig(**kw), tiny["data"])
        mu_j = interop.state_dict_from_jax_params(
            jax.tree.map(bf16.to_np, bf16.jax_first_moments(want.state.opt_state)), cfg)
        names = [n for n, _ in got.model.named_parameters()]
        for i, state in ckpt["optimizer"]["state"].items():
            assert state["exp_avg"].dtype == torch.bfloat16
            bf16.within_ulp(state["exp_avg"], mu_j[names[i]])


@pytest.mark.parametrize("route", ROUTES)
def test_resume_at_lr_zero_keeps_every_weight(tiny, saved, route, tmp_path, monkeypatch):
    _, port_dir = saved(route)
    out = copy_dir(port_dir, tmp_path / "port")
    before = restored_weights(out)
    got, losses = port_run(tiny, route_kw(tiny, route, max_epoch=2, resume=True, lr=0.0),
                           str(out), monkeypatch)
    assert len(losses) == (8 if route == "cursor" else 5)
    after = got.model.state_dict()
    for k, v in before.items():
        assert torch.equal(after[k], v), k


def restored_weights(out_dir) -> dict:
    """The weights a resume from ``out_dir`` starts from."""
    return {k: v.clone() for k, v in newest_checkpoint(out_dir)["model"].items()}


def test_cli_resume_at_lr_zero_keeps_the_checkpoint(tmp_path):
    """``--resume --lr 0`` after a run at ``--lr 0.01``, through the CLI:
    every weight of the resumed run's save is bitwise the first run's, and
    the save records lr 0."""
    from code2vec_tpu_torch import cli

    out = tmp_path / "m"
    argv = ["--no_cuda", "--synthetic", "tiny", "--batch_size", "64", "--model_path", str(out),
            "--print_sample_cycle", "0", "--checkpoint_cycle", "1"]
    assert cli.main(argv + ["--max_epoch", "1", "--lr", "0.01"]) == 0
    first = newest_checkpoint(out)
    assert cli.main(argv + ["--max_epoch", "2", "--lr", "0", "--resume"]) == 0
    second = newest_checkpoint(out)
    assert (first["meta"]["epoch"], second["meta"]["epoch"]) == (1, 2)
    assert second["optimizer"]["param_groups"][0]["lr"] == 0.0
    for k, v in first["model"].items():
        assert torch.equal(second["model"][k], v), k


# ---------------------------------------------------------------------------
# a data=2 mesh resume against the port's world-1 resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("change", [*CHANGES, "lr0"])
def test_mesh_resume_tracks_the_world_one_resume(tiny, saved, change, tmp_path, monkeypatch):
    """The dense route's checkpoint resumed at ``data=2`` (each rank a gloo
    subprocess) and on one device, at the same changed setting; the world-1
    resume is the one ``test_resume_at_changed_settings_tracks_jax`` holds
    against JAX."""
    _, port_dir = saved("dense")
    updates = dict(lr=0.0) if change == "lr0" else CHANGES[change]
    kw = route_kw(tiny, "dense", max_epoch=2, resume=True, **updates)
    want, want_losses = port_run(tiny, kw, str(copy_dir(port_dir, tmp_path / "one")),
                                 monkeypatch)
    mesh_dir = copy_dir(port_dir, tmp_path / "mesh")
    before = restored_weights(mesh_dir)
    results = harness.spawn(tmp_path, "train", 2, corpus=tiny["paths"], out_dir=str(mesh_dir),
                            config=dict(kw, data_axis=2))
    assert results[0]["losses"] == results[1]["losses"]
    np.testing.assert_allclose(results[0]["losses"], want_losses, rtol=2e-5, atol=0)
    got = newest_checkpoint(mesh_dir)
    assert got["meta"]["epoch"] == 2 and got["shardings"]["mesh_shape"]["data"] == 2
    assert_params_close(got["model"], want.model.state_dict())
    if change == "lr0":
        for k, v in before.items():
            assert torch.equal(got["model"][k], v), k


# ---------------------------------------------------------------------------
# a weight decay switched on or off: JAX's outcome
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("saved_wd,resumed_wd", [(0.0, 0.01), (0.01, 0.0)])
@pytest.mark.parametrize("update", ["dense", "lazy"])
def test_weight_decay_switched_on_or_off_raises_as_jax_does(tiny, update, saved_wd, resumed_wd,
                                                           tmp_path, monkeypatch):
    kw = route_kw(tiny, "dense", table_update=update, weight_decay=saved_wd)
    jax_run(tiny, kw, str(tmp_path / "jax"), monkeypatch)
    resume = dict(kw, max_epoch=2, resume=True, weight_decay=resumed_wd)
    with pytest.raises(ValueError, match="tree structures do not match"):
        jax_run(tiny, resume, str(tmp_path / "jax"), monkeypatch)
    port_run(tiny, kw, str(tmp_path / "port"), monkeypatch)
    want = "pass a non-zero --weight_decay" if saved_wd else "pass --weight_decay 0"
    with pytest.raises(ValueError, match=want):
        port_run(tiny, resume, str(tmp_path / "port"), monkeypatch)
    # nothing is loaded before the check
    cfg = TrainConfig(**resume)
    model = Code2Vec(loop.model_config_from(cfg, tiny["data"]))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    opt = make_optimizer(model, cfg)
    with pytest.raises(ValueError, match="--weight_decay"):
        restore_checkpoint(str(tmp_path / "port"), model, opt, np.random.default_rng(0),
                           model.config.vocab_pad_multiple)
    for k, v in model.state_dict().items():
        assert torch.equal(v, init[k]), k
    assert not getattr(opt, "dense", opt).state


# ---------------------------------------------------------------------------
# what a restore keeps and what it takes from the run
# ---------------------------------------------------------------------------

DIMS = dict(terminal_count=30, path_count=25, label_count=7, terminal_embed_size=8,
            path_embed_size=6, encode_size=12, dropout_prob=0.0)


def batch(seed):
    rng = np.random.default_rng(seed)
    s = rng.integers(1, DIMS["terminal_count"], (6, 9))
    return to_device({"starts": s.astype(np.int32),
                      "paths": rng.integers(1, DIMS["path_count"], (6, 9)).astype(np.int32),
                      "ends": rng.integers(1, DIMS["terminal_count"], (6, 9)).astype(np.int32),
                      "labels": rng.integers(0, DIMS["label_count"], 6).astype(np.int32),
                      "example_mask": np.ones(6, np.float32)}, torch.device("cpu"))


@pytest.mark.parametrize("mu,update", [("float32", "dense"), ("bfloat16", "dense"),
                                       ("float32", "lazy"), ("bfloat16", "lazy")])
def test_restore_keeps_the_step_counts_and_takes_the_run_settings(mu, update, tmp_path):
    saved_cfg = TrainConfig(lr=0.01, weight_decay=0.01, adam_mu_dtype=mu, table_update=update)
    model = Code2Vec(Code2VecConfig(**DIMS))
    opt = make_optimizer(model, saved_cfg)
    weights = torch.ones(DIMS["label_count"])
    for seed in range(3):
        train_step(model, opt, batch(seed), weights)
    save_checkpoint(str(tmp_path), "last", model, opt, TrainMeta(epoch=1, step=3),
                    np.random.default_rng(0))
    run_cfg = TrainConfig(lr=0.002, beta_min=0.85, beta_max=0.95, weight_decay=0.04,
                          adam_mu_dtype=mu, table_update=update)
    fresh = Code2Vec(Code2VecConfig(**DIMS))
    new = make_optimizer(fresh, run_cfg)
    restore_checkpoint(str(tmp_path), fresh, new, np.random.default_rng(1), 1)
    dense = new.dense if update == "lazy" else new
    assert isinstance(dense, TorchStyleAdam) == (mu == "bfloat16")
    for group in dense.param_groups:
        assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == (
            0.002, (0.85, 0.95), 1e-8, 0.04)
    if update == "lazy":
        (group,) = new.param_groups
        assert (group["lr"], group["betas"], group["step"]) == (0.002, (0.85, 0.95), 3)
    mu_dtype = torch.bfloat16 if mu == "bfloat16" else torch.float32
    names = dict(zip(map(id, model.parameters()), (n for n, _ in model.named_parameters())))
    old_by_name = {names[id(p)]: s for p, s in opt.state.items()}
    old_by_name.update({names[id(p)]: s for p, s in getattr(opt, "dense", opt).state.items()})
    fresh_names = dict(zip(map(id, fresh.parameters()), (n for n, _ in fresh.named_parameters())))
    seen = 0
    for part in ([new, new.dense] if update == "lazy" else [new]):
        for p, state in part.state.items():
            old = old_by_name[fresh_names[id(p)]]
            assert state["exp_avg"].dtype == mu_dtype
            assert torch.equal(state["exp_avg"], old["exp_avg"])
            assert torch.equal(state["exp_avg_sq"], old["exp_avg_sq"])
            if "step" in state:
                assert float(state["step"]) == 3.0
            seen += 1
    assert seen == len(list(fresh.parameters()))
    # the next step's bias correction goes on from step 3
    train_step(fresh, new, batch(3), weights)
    if update == "lazy":
        assert new.param_groups[0]["step"] == 4
    steps = {float(s["step"]) for s in dense.state.values()}
    assert steps == {4.0}
