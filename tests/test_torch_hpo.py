"""The port's hyperparameter search against the JAX package's, on the CPU.

- ``Study`` with ``TPESampler`` and with ``RandomSampler`` on a scripted
  objective (reports and prunes), seeds {0, 1, 7}: the same params, states,
  values and best trial, bit for bit (both are numpy);
- ``MedianPruner`` decides as JAX's on every case of JAX's
  ``TestMedianPruner``;
- ``sample_train_config`` gives the same config fields;
- ``find_optimal_hyperparams`` with ``train`` replaced in both packages by
  the same scripted per-epoch F1s: the same trial records and the same
  ``trial`` / ``trial_result`` events;
- a real three-trial CPU search on ``SPECS["tiny"]`` prunes at least once,
  writes no checkpoint and no vectors and leaves no thread, handler or
  fault plan behind;
- a trial's config with odd searched values (encode 37, a batch that
  leaves a short last batch, dropout 0) trains through the port's
  ``train()`` within rtol 2e-5 of JAX ``train()`` (``docs/PARITY.md:16``)
  from the bridged weights.
"""

import dataclasses
import signal
import threading
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from code2vec_tpu import hpo as jax_hpo
from code2vec_tpu.data import reader as jax_reader
from code2vec_tpu.obs.events import EventLog as JaxEventLog
from code2vec_tpu.train import loop as jax_loop
from code2vec_tpu.train.config import TrainConfig as JaxTrainConfig
from code2vec_tpu.train.step import build_train_step_fn, create_train_state
from code2vec_tpu_torch import faultinject, hpo, interop
from code2vec_tpu_torch.data import reader, synth
from code2vec_tpu_torch.obs.events import EventLog
from code2vec_tpu_torch.train import loop
from code2vec_tpu_torch.train.config import TrainConfig

PACKAGES = {"jax": (jax_hpo, JaxTrainConfig), "port": (hpo, TrainConfig)}


@pytest.fixture(scope="module")
def tiny_corpus(tmp_path_factory):
    paths = synth.generate_corpus_files(tmp_path_factory.mktemp("tiny"), synth.SPECS["tiny"])
    args = (paths["corpus"], paths["path_idx"], paths["terminal_idx"])
    return reader.load_corpus(*args), jax_reader.load_corpus(*args, cache=False, native=False)


def scripted_objective(mod, config_cls):
    """A deterministic objective over the reference's space: a bowl in the
    sampled config, reported over three steps, pruned when the pruner asks."""
    base = config_cls()

    def objective(trial):
        c = mod.sample_train_config(trial, base)
        value = ((np.log(c.encode_size) - np.log(170.0)) ** 2 + (c.dropout_prob - 0.6) ** 2
                 + (np.log10(c.lr) + 2.5) ** 2 / 10.0 + (np.log2(c.batch_size) - 9.0) ** 2 / 20.0)
        for step in range(3):
            trial.report(float(value * (1.0 + 0.5 / (step + 1))), step)
            if trial.should_prune():
                raise mod.TrialPruned
        return float(value)

    return objective


def records(study):
    return [(t.number, t.params, t.state, t.value, t.intermediates) for t in study.trials]


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("sampler", ["tpe", "random"])
def test_study_draws_what_jax_draws(sampler, seed):
    out = {}
    for name, (mod, config_cls) in PACKAGES.items():
        chosen = (mod.TPESampler(n_startup_trials=4, seed=seed) if sampler == "tpe"
                  else mod.RandomSampler(seed=seed))
        study = mod.Study(pruner=mod.MedianPruner(n_startup_trials=2), seed=seed,
                          sampler=chosen)
        study.optimize(scripted_objective(mod, config_cls), n_trials=14)
        out[name] = study
    assert records(out["port"]) == records(out["jax"])
    assert out["port"].best_trial.number == out["jax"].best_trial.number
    assert out["port"].best_params == out["jax"].best_params
    # the scripted search reaches both trial states
    assert {t.state for t in out["port"].trials} == {"complete", "pruned"}


def _finished(mod, number, values, state="complete"):
    return mod.FrozenTrial(number=number, params={}, intermediates=dict(enumerate(values)),
                           value=values[-1], state=state)


def _new_trial(mod, study):
    record = mod.FrozenTrial(number=len(study.trials), params={})
    study.trials.append(record)
    return mod.Trial(study, record)


def _case(mod, startup, warmup, finished, reports):
    """JAX ``TestMedianPruner``'s shape: finished trials, then one trial's
    reports, then its decision."""
    study = mod.Study(pruner=mod.MedianPruner(n_startup_trials=startup, n_warmup_steps=warmup))
    for i, (values, state) in enumerate(finished):
        study.trials.append(_finished(mod, i, values, state))
    trial = _new_trial(mod, study)
    for step, value in reports:
        trial.report(value, step)
    return trial.should_prune()


PRUNER_CASES = {  # name -> (startup, warmup, finished trials, reports, JAX's decision)
    "no_prune_during_startup_trials": (5, 0, [([0.1], "complete")] * 4, [(0, 9.9)], False),
    "prunes_below_median": (2, 0, [([v, v], "complete") for v in (0.1, 0.2, 0.3)],
                            [(0, 0.9)], True),
    "keeps_above_median": (2, 0, [([v, v], "complete") for v in (0.1, 0.2, 0.3)],
                           [(0, 0.05)], False),
    "uses_best_intermediate_so_far": (1, 0, [([0.5, 0.5], "complete")],
                                      [(0, 0.1), (1, 0.9)], False),
    "median_pool_uses_prior_trials_best_up_to_step": (1, 0, [([0.1, 0.9], "complete")],
                                                      [(1, 0.5)], True),
    "pruned_trials_excluded_from_median_pool": (
        1, 0, [([0.2, 0.2], "complete"), ([0.9, 0.9], "pruned")], [(1, 0.5)], True),
    "warmup_steps_block_pruning": (1, 3, [([0.1, 0.1], "complete")], [(1, 0.9)], False),
}


@pytest.mark.parametrize("case", sorted(PRUNER_CASES))
def test_median_pruner_decides_as_jax(case):
    startup, warmup, finished, reports, want = PRUNER_CASES[case]
    got = {name: _case(mod, startup, warmup, finished, reports)
           for name, (mod, _) in PACKAGES.items()}
    assert got == {"jax": want, "port": want}


def test_sample_train_config_gives_the_same_fields():
    studies = {name: mod.Study(seed=5) for name, (mod, _) in PACKAGES.items()}
    for _ in range(20):
        configs = {name: dataclasses.asdict(mod.sample_train_config(
                       _new_trial(mod, studies[name]), config_cls()))
                   for name, (mod, config_cls) in PACKAGES.items()}
        port, jax_ = configs["port"], configs["jax"]
        assert {k: port[k] for k in jax_} == jax_
        # the port's own settings (code2seq's) stay at their defaults
        assert {k: v for k, v in port.items() if k not in jax_} == {
            k: v for k, v in dataclasses.asdict(TrainConfig()).items() if k not in jax_}


def scripted_train(stop_cls):
    """``train`` replaced: per-epoch F1s that are a function of the
    trial's config, reported as the loop reports them."""
    def fake(config, data, report_fn=None, events=None, **kw):
        best = 0.0
        for epoch in range(3):
            f1 = float(1.0 / (1.0 + abs(np.log(config.encode_size / 150.0)))
                       * (epoch + 1) / 3.0 * (1.0 - abs(config.dropout_prob - 0.7)))
            best = max(best, f1)
            try:
                report_fn(epoch, f1)
            except stop_cls:
                break
        return SimpleNamespace(best_f1=best)

    return fake


def test_search_with_scripted_training_matches_jax(monkeypatch):
    monkeypatch.setattr(jax_loop, "train", scripted_train(jax_loop.StopTraining))
    monkeypatch.setattr(loop, "train", scripted_train(loop.StopTraining))
    got = {}
    for name, (mod, config_cls), log_cls in (("jax", PACKAGES["jax"], JaxEventLog),
                                             ("port", PACKAGES["port"], EventLog)):
        events, seen = log_cls(), []
        events.subscribe(seen.append)
        study = mod.find_optimal_hyperparams(
            None, config_cls(), n_trials=8, seed=3,
            pruner=mod.MedianPruner(n_startup_trials=1),
            sampler=mod.TPESampler(n_startup_trials=3, seed=3), events=events)
        trial_events = [{k: v for k, v in e.items() if k not in ("seq", "t_ms", "unix_time")}
                        for e in seen if e["event"] in ("trial", "trial_result")]
        got[name] = (records(study), trial_events, seen[0]["search"])
    assert got["port"] == got["jax"]
    assert {r[2] for r in got["port"][0]} == {"complete", "pruned"}


def test_a_real_search_prunes_and_leaves_nothing_behind(tiny_corpus, tmp_path, monkeypatch):
    """Three trials of two epochs on the tiny corpus (prefetched, so a
    producer thread runs in each): at least one is pruned, nothing is
    written into the working directory, and no producer thread, SIGTERM
    handler or fault plan outlives the search."""
    data, _ = tiny_corpus
    monkeypatch.chdir(tmp_path)
    before = signal.getsignal(signal.SIGTERM)
    base = TrainConfig(terminal_embed_size=8, path_embed_size=6, max_path_length=20,
                       max_epoch=2, prefetch_batches=2, print_sample_cycle=0)
    events, seen = EventLog(), []
    events.subscribe(seen.append)
    study = hpo.find_optimal_hyperparams(
        data, base, n_trials=3, seed=0, pruner=hpo.MedianPruner(n_startup_trials=1),
        sampler="random", events=events, device="cpu")
    states = [t.state for t in study.trials]
    assert len(states) == 3 and "pruned" in states, states
    assert [e["event"] for e in seen].count("trial_result") == 3
    assert not any(e["event"] == "checkpoint_saved" for e in seen)
    assert list(tmp_path.iterdir()) == []
    assert not [t for t in threading.enumerate() if t.name == "c2v-host-prefetch"]
    assert signal.getsignal(signal.SIGTERM) == before
    assert faultinject.active_plan() is None


@pytest.mark.parametrize("route", ["plain", "pool_only"])
def test_an_odd_trial_config_trains_as_jax(tiny_corpus, route):
    """encode 37 and batch 48 (the tiny train split leaves a short last
    batch), the trial's lr and weight decay, dropout 0: each epoch's train
    and test loss within rtol 2e-5 of JAX ``train()``, accuracy and F1 equal."""
    data, jax_data = tiny_corpus
    trial = _new_trial(hpo, hpo.Study(seed=2))
    drawn = hpo.sample_train_config(trial, TrainConfig())
    searched = dict(encode_size=37, batch_size=48, dropout_prob=0.0, lr=drawn.lr,
                    weight_decay=drawn.weight_decay)
    common = dict(terminal_embed_size=8, path_embed_size=6, max_path_length=40, max_epoch=2,
                  random_seed=11, print_sample_cycle=0, **searched)
    kernel = dict(use_pallas=True, pallas_impl=route) if route != "plain" else {}
    n_train = len(loop.split_items(data.n_items, np.random.default_rng(11))[0])
    assert n_train % 48, "the batch must leave a short last batch"
    jcfg = JaxTrainConfig(**common, **kernel)
    model_cfg = jax_loop.model_config_from(jcfg, jax_data)
    if route != "plain":
        model_cfg = model_cfg.__class__(**{**vars(model_cfg), "pallas_backend": "cpu"})
    state = create_train_state(jcfg, model_cfg, jax.random.PRNGKey(11),
                               jax_loop.dummy_batch(jcfg))
    params0 = jax.tree.map(np.asarray, state.params)
    step = jax.jit(build_train_step_fn(model_cfg, jax_loop.class_weights_from(jcfg, jax_data)))
    want = jax_loop.train(jcfg, jax_data, sinks=(), initial_state=state, train_step=step)
    cfg = TrainConfig(**common, **kernel)
    sd = interop.state_dict_from_jax_params(params0, loop.model_config_from(cfg, data))
    got = loop.train(cfg, data, device="cpu", initial_state_dict=sd, sinks=())
    assert len(got.history) == len(want.history) == 2
    for g, w in zip(got.history, want.history):
        np.testing.assert_allclose(g["train_loss"], w["train_loss"], rtol=2e-5)
        np.testing.assert_allclose(g["test_loss"], w["test_loss"], rtol=2e-5)
        assert g["accuracy"] == w["accuracy"] and g["f1"] == w["f1"]
