"""Hyperparameter search: the reference's Optuna study, self-contained.

Own copy of ``code2vec_tpu/hpo.py`` (numpy and the standard library; the
samplers draw bit for bit what JAX's draw from the same seed). The
reference drives ``optuna.create_study(MedianPruner()).optimize``
(main.py:429-488) with a per-epoch ``trial.report(1 - f1)`` and pruning
(main.py:207-211). Here:

- a :class:`Study` over the reference's search space (main.py:447-449,
  477-483): ``encode_size`` log-int 100..300, ``dropout_prob`` 0.5..0.9,
  ``batch_size`` log-int 256..2048, Adam ``lr`` log 1e-5..1e-1 and
  ``weight_decay`` log 1e-10..1e-3;
- a :class:`TPESampler`, optuna's default (Bergstra et al., NeurIPS 2011:
  Parzen estimators over the best/rest split, the candidate of the best
  l(x)/g(x)), and a :class:`RandomSampler` (``sampler="random"``);
- a :class:`MedianPruner` with optuna's semantics;
- :func:`find_optimal_hyperparams`, the ``--find_hyperparams`` entry:
  the objective is ``1 - best_f1`` (minimized), the pruning rides the
  train loop's ``report_fn``, which raises
  :class:`~code2vec_tpu_torch.train.loop.StopTraining`.

The corpus is loaded once and shared by the trials (main.py:431-441).
Each trial builds its own model, optimizer and kernel launches at its
sampled widths; they are released before the next trial starts.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

logger = logging.getLogger(__name__)


class TrialPruned(Exception):
    """Raised inside an objective to mark the running trial pruned."""


@dataclass
class FrozenTrial:
    """Completed/pruned trial record (optuna's FrozenTrial analogue)."""

    number: int
    params: dict[str, float | int]
    intermediates: dict[int, float] = field(default_factory=dict)
    value: float | None = None
    state: str = "running"  # running | complete | pruned | failed


class MedianPruner:
    """Prune when the trial's best intermediate so far is worse (for
    minimization: greater) than the median of previous finished trials'
    intermediate values at the same step.

    ``n_startup_trials`` trials run unpruned first; steps below
    ``n_warmup_steps`` never prune. Matches optuna's defaults (5 / 0).
    """

    def __init__(self, n_startup_trials: int = 5, n_warmup_steps: int = 0):
        self.n_startup_trials = n_startup_trials
        self.n_warmup_steps = n_warmup_steps

    def should_prune(self, study: "Study", trial: FrozenTrial) -> bool:
        if not trial.intermediates:
            return False
        step = max(trial.intermediates)
        if step < self.n_warmup_steps:
            return False
        # optuna parity: only COMPLETE trials gate startup and feed the
        # median (pruned trials' bad tails would skew it), and each prior
        # trial contributes its BEST intermediate up to this step, not the
        # raw value at the step (a trial that regressed late still counts
        # by its early best)
        finished = [
            t for t in study.trials
            if t.number != trial.number and t.state == "complete"
        ]
        if len(finished) < self.n_startup_trials:
            return False
        at_step = [
            min(v for s, v in t.intermediates.items() if s <= step)
            for t in finished
            if step in t.intermediates
        ]
        if not at_step:
            return False
        best_so_far = min(trial.intermediates.values())
        return best_so_far > float(np.median(at_step))


@dataclass(frozen=True)
class _Distribution:
    """Search-space descriptor for one parameter."""

    low: float
    high: float
    log: bool = False
    is_int: bool = False

    def to_internal(self, value: float) -> float:
        return math.log(value) if self.log else float(value)

    def from_internal(self, x: float) -> float | int:
        value = math.exp(x) if self.log else x
        if self.is_int:
            value = min(max(int(round(value)), int(self.low)), int(self.high))
        return value

    @property
    def internal_low(self) -> float:
        return math.log(self.low) if self.log else self.low

    @property
    def internal_high(self) -> float:
        return math.log(self.high) if self.log else self.high


class RandomSampler:
    """Independent uniform (or log-uniform) draws — the pre-TPE behavior."""

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)

    def suggest(self, study: "Study", trial: FrozenTrial, name: str,
                dist: _Distribution) -> float | int:
        x = self._rng.uniform(dist.internal_low, dist.internal_high)
        return dist.from_internal(x)


class _ParzenEstimator:
    """1-D mixture of truncated Gaussians over the internal domain
    (Bergstra et al. 2011 §4: per-point bandwidths from neighbor spacing,
    plus a wide uniform-ish prior component at the domain midpoint)."""

    def __init__(self, xs: np.ndarray, low: float, high: float):
        span = max(high - low, 1e-12)
        mid = 0.5 * (low + high)
        mus = np.sort(np.append(xs, mid))
        if len(mus) > 1:
            neighbor = np.empty_like(mus)
            gaps = np.diff(mus)
            neighbor[0] = gaps[0]
            neighbor[-1] = gaps[-1]
            if len(mus) > 2:
                neighbor[1:-1] = np.maximum(gaps[:-1], gaps[1:])
            sigmas = np.clip(neighbor, span / min(100.0, len(mus) + 1.0), span)
        else:
            sigmas = np.full_like(mus, span)
        # the prior component (at mid) always keeps full-range bandwidth
        sigmas[np.argmin(np.abs(mus - mid))] = span
        self.mus, self.sigmas = mus, sigmas
        self.low, self.high = low, high
        # truncation mass of each component on [low, high]
        self._z = self._cdf((high - mus) / sigmas) - self._cdf((low - mus) / sigmas)
        self._z = np.maximum(self._z, 1e-12)

    @staticmethod
    def _cdf(z: np.ndarray) -> np.ndarray:
        # vectorized standard-normal CDF via erf (math.erf is scalar-only)
        return 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2.0)))

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        idx = rng.integers(0, len(self.mus), n)
        draws = rng.normal(self.mus[idx], self.sigmas[idx])
        return np.clip(draws, self.low, self.high)

    def log_pdf(self, xs: np.ndarray) -> np.ndarray:
        z = (xs[:, None] - self.mus[None, :]) / self.sigmas[None, :]
        comp = (
            np.exp(-0.5 * z**2)
            / (self.sigmas[None, :] * math.sqrt(2.0 * math.pi))
            / self._z[None, :]
        )
        return np.log(np.maximum(comp.mean(axis=1), 1e-300))


class TPESampler:
    """Tree-structured Parzen Estimator, sampling each parameter
    independently (optuna's default mode): split prior trials into the
    gamma-best ("good") and the rest ("bad"), fit Parzen estimators l(x)
    and g(x), draw ``n_ei_candidates`` from l and keep the candidate
    maximizing l(x)/g(x). Falls back to random until ``n_startup_trials``
    scored trials exist (optuna defaults: 10 startup, 24 candidates,
    gamma(n) = min(ceil(0.1 n), 25))."""

    def __init__(self, n_startup_trials: int = 10, n_ei_candidates: int = 24,
                 seed: int = 0):
        self.n_startup_trials = n_startup_trials
        self.n_ei_candidates = n_ei_candidates
        self._rng = np.random.default_rng(seed)

    @staticmethod
    def _gamma(n: int) -> int:
        return min(int(np.ceil(0.1 * n)), 25)

    def _scored_observations(
        self, study: "Study", trial: FrozenTrial, name: str
    ) -> list[tuple[float, float]]:
        """(objective value, param value) for prior trials that drew
        ``name``; pruned trials count by their best intermediate, like
        optuna's TPE does."""
        out = []
        for t in study.trials:
            if t.number == trial.number or name not in t.params:
                continue
            if t.state == "complete" and t.value is not None:
                out.append((t.value, t.params[name]))
            elif t.state == "pruned" and t.intermediates:
                out.append((min(t.intermediates.values()), t.params[name]))
        return out

    def suggest(self, study: "Study", trial: FrozenTrial, name: str,
                dist: _Distribution) -> float | int:
        obs = self._scored_observations(study, trial, name)
        if len(obs) < self.n_startup_trials:
            x = self._rng.uniform(dist.internal_low, dist.internal_high)
            return dist.from_internal(x)

        obs.sort(key=lambda pair: pair[0])
        n_good = self._gamma(len(obs))
        xs = np.array([dist.to_internal(v) for _, v in obs])
        good = _ParzenEstimator(
            xs[:n_good], dist.internal_low, dist.internal_high
        )
        bad = _ParzenEstimator(
            xs[n_good:], dist.internal_low, dist.internal_high
        )
        candidates = good.sample(self._rng, self.n_ei_candidates)
        score = good.log_pdf(candidates) - bad.log_pdf(candidates)
        return dist.from_internal(float(candidates[int(np.argmax(score))]))


class Trial:
    """Sampling + reporting handle passed to the objective."""

    def __init__(self, study: "Study", record: FrozenTrial):
        self._study = study
        self._record = record

    @property
    def number(self) -> int:
        return self._record.number

    @property
    def params(self) -> dict[str, float | int]:
        return self._record.params

    def _suggest(self, name: str, dist: _Distribution) -> float | int:
        value = self._study.sampler.suggest(self._study, self._record, name, dist)
        self._record.params[name] = value
        return value

    def suggest_float(self, name: str, low: float, high: float,
                      log: bool = False) -> float:
        return float(self._suggest(name, _Distribution(low, high, log=log)))

    def suggest_int(self, name: str, low: int, high: int,
                    log: bool = False) -> int:
        return int(self._suggest(
            name, _Distribution(low, high, log=log, is_int=True)
        ))

    def report(self, value: float, step: int) -> None:
        self._record.intermediates[step] = float(value)

    def should_prune(self) -> bool:
        return self._study.pruner.should_prune(self._study, self._record)


class Study:
    """Minimizing study with pruning; TPE sampling by default (the
    reference's ``optuna.create_study`` default, main.py:460)."""

    def __init__(self, pruner: MedianPruner | None = None, seed: int = 0,
                 sampler: "TPESampler | RandomSampler | str | None" = None):
        self.pruner = pruner if pruner is not None else MedianPruner()
        if sampler is None or sampler == "tpe":
            sampler = TPESampler(seed=seed)
        elif sampler == "random":
            sampler = RandomSampler(seed=seed)
        self.sampler = sampler
        self.trials: list[FrozenTrial] = []

    def optimize(self, objective: Callable[[Trial], float],
                 n_trials: int) -> None:
        for _ in range(n_trials):
            record = FrozenTrial(number=len(self.trials), params={})
            self.trials.append(record)
            trial = Trial(self, record)
            try:
                record.value = float(objective(trial))
                record.state = "complete"
            except TrialPruned:
                # a pruned trial still scores: its best intermediate
                record.value = (
                    min(record.intermediates.values())
                    if record.intermediates else None
                )
                record.state = "pruned"
                logger.info("trial %d pruned at step %s", record.number,
                            max(record.intermediates, default=None))
            logger.info("trial %d %s value=%s params=%s", record.number,
                        record.state, record.value, record.params)

    @property
    def best_trial(self) -> FrozenTrial:
        scored = [t for t in self.trials
                  if t.state == "complete" and t.value is not None]
        if not scored:
            raise ValueError("no completed trials")
        return min(scored, key=lambda t: t.value)

    @property
    def best_value(self) -> float:
        return self.best_trial.value

    @property
    def best_params(self) -> dict[str, float | int]:
        return self.best_trial.params


def sample_train_config(trial: Trial, base_config):
    """Draw the reference's search space into a TrainConfig
    (main.py:447-449 for dims, 477-483 for Adam)."""
    return base_config.with_updates(
        encode_size=trial.suggest_int("encode_size", 100, 300, log=True),
        dropout_prob=trial.suggest_float("dropout_prob", 0.5, 0.9),
        batch_size=trial.suggest_int("batch_size", 256, 2048, log=True),
        lr=trial.suggest_float("adam_lr", 1e-5, 1e-1, log=True),
        weight_decay=trial.suggest_float(
            "adam_weight_decay", 1e-10, 1e-3, log=True),
    )


def _without_close(sink):
    """``sink`` without its ``close()``: train() closes closable sinks at
    its end, and the search shares one sink across its trials."""
    def call(epoch, metrics):
        sink(epoch, metrics)

    return call


def find_optimal_hyperparams(
    data,
    base_config,
    n_trials: int = 100,
    seed: int = 0,
    pruner: MedianPruner | None = None,
    sampler: TPESampler | RandomSampler | str | None = None,
    events=None,
    *,
    device=None,
    sinks: tuple = (),
    profile_dir: str | None = None,
) -> Study:
    """The ``--find_hyperparams`` entry (reference: main.py:429-488).

    Each trial trains with the sampled config on ``device``; the per-epoch
    ``1 - f1`` is reported for median pruning (main.py:207-211) and the
    objective is ``1 - best_f1``. No trial writes a checkpoint or vectors,
    as in the reference (main.py:226-231): ``train()`` gets no model dir,
    and its ``report_fn`` turns its saves off.

    ``events``: one ``obs.events.EventLog`` for the whole search. The
    manifest is written once, first, with the base config; each trial
    opens with a ``trial`` event (its number and params) and closes with
    a ``trial_result`` event (state and objective value), so everything
    between two ``trial`` events belongs to one trial. ``sinks`` see every
    trial's epochs and are closed once, after the last trial;
    ``profile_dir`` traces epoch 2 of the first trial.
    """
    import gc

    from code2vec_tpu_torch.train.loop import StopTraining, release_device_memory, train

    if events is not None:
        events.write_manifest(config=base_config, search={"n_trials": n_trials, "seed": seed})
    trial_sinks = tuple(_without_close(s) for s in sinks)

    def objective(trial: Trial) -> float:
        config = sample_train_config(trial, base_config)
        logger.info("trial %d config: %s", trial.number, trial.params)
        if events is not None:
            events.emit("trial", number=trial.number, params=dict(trial.params))
        pruned = False

        def report_fn(epoch: int, f1: float) -> None:
            nonlocal pruned
            trial.report(1.0 - f1, epoch)
            if trial.should_prune():
                pruned = True
                raise StopTraining  # caught by the train loop; ends the run

        result = train(config, data, report_fn=report_fn, events=events, device=device,
                       sinks=trial_sinks,
                       profile_dir=profile_dir if trial.number == 0 else None)
        value = 1.0 - result.best_f1
        # the trial's model, optimizer and workspaces go before the next trial
        del result
        gc.collect()
        release_device_memory()
        if events is not None:
            events.emit("trial_result", number=trial.number,
                        state="pruned" if pruned else "complete", value=value)
        if pruned:
            raise TrialPruned
        return value

    study = Study(pruner=pruner, seed=seed, sampler=sampler)
    try:
        study.optimize(objective, n_trials)
    finally:
        for sink in sinks:
            closer = getattr(sink, "close", None)
            if closer is not None:
                try:
                    closer()
                except Exception:
                    logger.warning("sink close() failed", exc_info=True)
    best = study.best_trial
    logger.info("best trial: #%d value=%s params=%s", best.number, best.value, best.params)
    return study
