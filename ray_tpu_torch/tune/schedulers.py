"""Trial schedulers (reference: python/ray/tune/schedulers/ — ASHA
`async_hyperband.py`, HyperBand `hyperband.py`, PBT `pbt.py`, median
stopping `median_stopping_rule.py`)."""

from __future__ import annotations

import math
import random
from typing import Any, Callable, Dict, List, Optional

TRAINING_ITERATION = "training_iteration"


class TrialScheduler:
    CONTINUE = "CONTINUE"
    PAUSE = "PAUSE"
    STOP = "STOP"

    def __init__(self, time_attr: str = TRAINING_ITERATION, metric: Optional[str] = None, mode: Optional[str] = None):
        self.time_attr = time_attr
        self.metric = metric
        self.mode = mode

    def set_search_properties(self, metric, mode) -> bool:
        if metric:
            self.metric = metric
        if mode:
            self.mode = mode
        return True

    def _score(self, result: Dict[str, Any]) -> Optional[float]:
        if self.metric is None or self.metric not in result:
            return None
        v = float(result[self.metric])
        return v if (self.mode or "max") == "max" else -v

    def on_trial_add(self, trial):
        pass

    def on_trial_result(self, trial, result: Dict[str, Any]) -> str:
        return TrialScheduler.CONTINUE

    def on_trial_complete(self, trial, result: Optional[Dict[str, Any]]):
        pass

    def on_trial_remove(self, trial):
        pass


class FIFOScheduler(TrialScheduler):
    """Run every trial to completion."""


class AsyncHyperBandScheduler(TrialScheduler):
    """ASHA (reference: tune/schedulers/async_hyperband.py): rungs at
    grace_period × reduction_factor^k; a trial reaching a rung is stopped
    unless its score is in the top 1/reduction_factor of results recorded
    at that rung (including its own).

    Unlike the reference's stopping-based ASHA, rung membership is
    re-evaluated on *every* subsequent report: a trial that slipped past
    a rung early (async first-arrival, ascending-quality arrival order)
    is still cut once enough peers record at that rung and its frozen
    rung score falls below the top-1/rf cutoff.  This recovers
    synchronous successive-halving's savings without rung barriers."""

    def __init__(
        self,
        time_attr: str = TRAINING_ITERATION,
        metric: Optional[str] = None,
        mode: Optional[str] = None,
        max_t: int = 100,
        grace_period: int = 1,
        reduction_factor: float = 4,
        brackets: int = 1,
    ):
        super().__init__(time_attr, metric, mode)
        self.max_t = max_t
        self.grace_period = grace_period
        self.rf = reduction_factor
        # Each bracket b has rungs grace*rf^(k+b); one bracket by default.
        # rung time -> {trial_id: score frozen at rung arrival}
        self._brackets: List[Dict[float, Dict[str, float]]] = []
        for b in range(brackets):
            rungs: Dict[float, Dict[str, float]] = {}
            t = grace_period * (self.rf ** b)
            while t < max_t:
                rungs[t] = {}
                t *= self.rf
            self._brackets.append(rungs)
        self._trial_bracket: Dict[str, int] = {}
        self._rng = random.Random(0)

    def on_trial_add(self, trial):
        self._trial_bracket[trial.trial_id] = self._rng.randrange(len(self._brackets))

    def _cutoff(self, recorded: Dict[str, float]) -> Optional[float]:
        k = int(len(recorded) / self.rf)
        if k < 1:
            return None
        return sorted(recorded.values(), reverse=True)[k - 1]

    def on_trial_result(self, trial, result: Dict[str, Any]) -> str:
        t = result.get(self.time_attr)
        score = self._score(result)
        if t is None or score is None:
            return TrialScheduler.CONTINUE
        rungs = self._brackets[self._trial_bracket.get(trial.trial_id, 0)]
        # Record at the highest rung reached (score frozen at arrival);
        # never backfill lower rungs with later scores.
        for rung_t in sorted(rungs, reverse=True):
            if t >= rung_t:
                rungs[rung_t].setdefault(trial.trial_id, score)
                break
        if t >= self.max_t:
            return TrialScheduler.STOP
        # Re-evaluate every rung this trial has recorded at: cut if its
        # frozen score is now below the top-1/rf cutoff among peers.
        for rung_t, recorded in rungs.items():
            s = recorded.get(trial.trial_id)
            if s is None:
                continue
            cutoff = self._cutoff(recorded)
            if cutoff is not None and s < cutoff:
                return TrialScheduler.STOP
        return TrialScheduler.CONTINUE


class HyperBandScheduler(AsyncHyperBandScheduler):
    """Multi-bracket ASHA — the asynchronous formulation subsumes the
    original synchronous HyperBand (reference: tune/schedulers/hyperband.py)
    without its straggler barriers."""

    def __init__(self, time_attr: str = TRAINING_ITERATION, metric=None, mode=None, max_t: int = 81, reduction_factor: float = 3):
        n_brackets = max(1, int(math.log(max_t, reduction_factor)))
        super().__init__(
            time_attr,
            metric,
            mode,
            max_t=max_t,
            grace_period=1,
            reduction_factor=reduction_factor,
            brackets=n_brackets,
        )


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose best score at step t is below the median of other
    trials' running averages at t (reference:
    tune/schedulers/median_stopping_rule.py)."""

    def __init__(
        self,
        time_attr: str = TRAINING_ITERATION,
        metric: Optional[str] = None,
        mode: Optional[str] = None,
        grace_period: int = 1,
        min_samples_required: int = 3,
    ):
        super().__init__(time_attr, metric, mode)
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self._histories: Dict[str, List[float]] = {}

    def on_trial_result(self, trial, result: Dict[str, Any]) -> str:
        t = result.get(self.time_attr, 0)
        score = self._score(result)
        if score is None:
            return TrialScheduler.CONTINUE
        hist = self._histories.setdefault(trial.trial_id, [])
        hist.append(score)
        if t < self.grace_period:
            return TrialScheduler.CONTINUE
        others = [
            sum(h) / len(h)
            for tid, h in self._histories.items()
            if tid != trial.trial_id and h
        ]
        if len(others) < self.min_samples:
            return TrialScheduler.CONTINUE
        median = sorted(others)[len(others) // 2]
        if max(hist) < median:
            return TrialScheduler.STOP
        return TrialScheduler.CONTINUE


class PopulationBasedTraining(TrialScheduler):
    """PBT (reference: tune/schedulers/pbt.py): at each perturbation
    interval, bottom-quantile trials clone the checkpoint of a top-quantile
    trial and continue with a mutated config.  The controller performs the
    exploit via trial.restart_with (checkpoint + new config)."""

    def __init__(
        self,
        time_attr: str = TRAINING_ITERATION,
        metric: Optional[str] = None,
        mode: Optional[str] = None,
        perturbation_interval: int = 4,
        hyperparam_mutations: Optional[Dict[str, Any]] = None,
        quantile_fraction: float = 0.25,
        resample_probability: float = 0.25,
        seed: int = 0,
    ):
        super().__init__(time_attr, metric, mode)
        self.perturbation_interval = perturbation_interval
        self.hyperparam_mutations = hyperparam_mutations or {}
        self.quantile_fraction = quantile_fraction
        self.resample_probability = resample_probability
        self._rng = random.Random(seed)
        self._last_perturb: Dict[str, float] = {}
        self._latest: Dict[str, float] = {}  # trial_id -> score

    def _mutate(self, config: Dict[str, Any]) -> Dict[str, Any]:
        from ray_tpu_torch.tune.sample import Domain

        new = dict(config)
        for key, spec in self.hyperparam_mutations.items():
            cur = new.get(key)
            if self._rng.random() < self.resample_probability or cur is None:
                if isinstance(spec, Domain):
                    new[key] = spec.sample(self._rng)
                elif isinstance(spec, list):
                    new[key] = self._rng.choice(spec)
                elif callable(spec):
                    new[key] = spec()
            else:
                if isinstance(cur, (int, float)) and not isinstance(cur, bool):
                    factor = self._rng.choice([0.8, 1.2])
                    new[key] = type(cur)(cur * factor) if isinstance(cur, float) else max(1, int(cur * factor))
                elif isinstance(spec, list):
                    # nudge along the list
                    try:
                        i = spec.index(cur)
                        new[key] = spec[max(0, min(len(spec) - 1, i + self._rng.choice([-1, 1])))]
                    except ValueError:
                        new[key] = self._rng.choice(spec)
        return new

    def on_trial_result(self, trial, result: Dict[str, Any]) -> str:
        t = result.get(self.time_attr, 0)
        score = self._score(result)
        if score is None:
            return TrialScheduler.CONTINUE
        self._latest[trial.trial_id] = score
        last = self._last_perturb.get(trial.trial_id, 0)
        if t - last < self.perturbation_interval:
            return TrialScheduler.CONTINUE

        scores = sorted(self._latest.values())
        n = len(scores)
        if n < 4:
            # Population not fully reporting yet (staggered actor starts):
            # do NOT consume the perturbation slot — retry next report.
            return TrialScheduler.CONTINUE
        self._last_perturb[trial.trial_id] = t
        k = max(1, int(n * self.quantile_fraction))
        lower_cut = scores[k - 1]
        upper_cut = scores[n - k]
        if score > lower_cut:
            return TrialScheduler.CONTINUE
        # bottom quantile: exploit a top trial
        top_ids = [tid for tid, s in self._latest.items() if s >= upper_cut and tid != trial.trial_id]
        if not top_ids:
            return TrialScheduler.CONTINUE
        source_id = self._rng.choice(top_ids)
        trial._pbt_exploit = {"source": source_id, "mutate": self._mutate}
        return TrialScheduler.PAUSE  # controller performs clone + restart

    def on_trial_complete(self, trial, result):
        self._latest.pop(trial.trial_id, None)


class PB2(PopulationBasedTraining):
    """PB2 — Population-Based Bandits (reference:
    tune/schedulers/pb2.py; Parker-Holder et al. 2020).

    PBT with the random mutations replaced by a GP-bandit: exploited
    trials pick their next hyperparameters by maximizing a UCB
    acquisition over a Gaussian-process fit to the population's
    (config, time, reward-change) history.  The reference wraps GPy;
    here the GP (RBF kernel + noise, exact inference) is a small numpy
    implementation — same algorithm, no dependency.

    ``hyperparam_bounds``: {key: [low, high]} continuous bounds (PB2 is
    defined for continuous ranges; categorical keys can stay in
    ``hyperparam_mutations`` and mutate PBT-style)."""

    def __init__(
        self,
        time_attr: str = TRAINING_ITERATION,
        metric: Optional[str] = None,
        mode: Optional[str] = None,
        perturbation_interval: int = 4,
        hyperparam_bounds: Optional[Dict[str, Any]] = None,
        quantile_fraction: float = 0.25,
        seed: int = 0,
    ):
        super().__init__(
            time_attr, metric, mode,
            perturbation_interval=perturbation_interval,
            hyperparam_mutations={},
            quantile_fraction=quantile_fraction,
            seed=seed,
        )
        self.hyperparam_bounds = hyperparam_bounds or {}
        # (t, config-vector, reward delta) observations across the pop
        self._history: list = []
        self._prev_score: Dict[str, float] = {}

    # -- data collection -------------------------------------------------
    def on_trial_result(self, trial, result: Dict[str, Any]) -> str:
        score = self._score(result)
        if score is not None:
            prev = self._prev_score.get(trial.trial_id)
            if prev is not None and self.hyperparam_bounds:
                x = self._vec(trial.config)
                if x is not None:
                    t = float(result.get(self.time_attr, 0))
                    self._history.append((t, x, score - prev))
                    self._history = self._history[-256:]
            self._prev_score[trial.trial_id] = score
        decision = super().on_trial_result(trial, result)
        if decision == TrialScheduler.PAUSE and getattr(trial, "_pbt_exploit", None):
            # swap PBT's random mutation for the GP-bandit selection
            trial._pbt_exploit["mutate"] = self._select_config
        return decision

    def _vec(self, config: Dict[str, Any]):
        try:
            return [float(config[k]) for k in sorted(self.hyperparam_bounds)]
        except (KeyError, TypeError, ValueError):
            return None

    # -- GP-UCB selection -------------------------------------------------
    def _select_config(self, config: Dict[str, Any]) -> Dict[str, Any]:
        import numpy as np

        keys = sorted(self.hyperparam_bounds)
        if not keys:
            return dict(config)
        lows = np.array([float(self.hyperparam_bounds[k][0]) for k in keys])
        highs = np.array([float(self.hyperparam_bounds[k][1]) for k in keys])
        span = np.where(highs > lows, highs - lows, 1.0)
        rng = np.random.default_rng(self._rng.randrange(2**31))
        n_cand = 64
        cands = rng.uniform(lows, highs, size=(n_cand, len(keys)))

        data = [h for h in self._history if h[1] is not None]
        if len(data) < 4:
            choice = cands[0]
        else:
            tmax = max(h[0] for h in data) or 1.0
            X = np.array([[h[0] / tmax] + [(v - l) / s for v, l, s in
                          zip(h[1], lows, span)] for h in data])
            y = np.array([h[2] for h in data], dtype=float)
            y_std = y.std() or 1.0
            y = (y - y.mean()) / y_std

            def rbf(A, B, ls=0.3):
                d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
                return np.exp(-0.5 * d2 / ls**2)

            K = rbf(X, X) + 1e-2 * np.eye(len(X))
            Kinv_y = np.linalg.solve(K, y)
            Xc = np.concatenate(
                [np.full((n_cand, 1), 1.0), (cands - lows) / span], axis=1
            )
            Ks = rbf(Xc, X)
            mu = Ks @ Kinv_y
            # one factorization serves both mean and variance
            KinvKs = np.linalg.solve(K, Ks.T)
            var = np.maximum(1.0 - np.einsum("ij,ji->i", Ks, KinvKs), 1e-9)
            ucb = mu + 2.0 * np.sqrt(var)
            choice = cands[int(np.argmax(ucb))]

        new = dict(config)
        for k, v in zip(keys, choice):
            cur = config.get(k)
            new[k] = int(round(v)) if isinstance(cur, int) and not isinstance(cur, bool) else float(v)
        return new


class HyperBandForBOHB(HyperBandScheduler):
    """HyperBand variant paired with the TuneBOHB searcher (reference:
    tune/schedulers/hb_bohb.py).  The budget rungs are HyperBand's; the
    model coupling BOHB adds happens through the controller's result
    feed — every intermediate result reaches
    ``TuneBOHB.on_trial_result``, so rung-stopped trials still train
    the KDE at their budget level."""
