"""The port's Tune searchers and schedulers against the JAX package's: the
same seed and the same results give the same configs and decisions.

Tune is plain Python in both packages (the port's is a fork with the
imports renamed), so every comparison here is exact.
"""

import math

import pytest

from ray_tpu import tune as jtune
from ray_tpu.tune.search import variant_generator as jvg
from ray_tpu_torch import tune as ttune
from ray_tpu_torch.tune.search import variant_generator as tvg


def _space(t):
    return {
        "lr": t.loguniform(1e-5, 1e-1),
        "layers": t.grid_search([1, 2, 3]),
        "act": t.choice(["relu", "tanh", "gelu"]),
        "nested": {"width": t.randint(8, 64), "drop": t.quniform(0.0, 0.5, 0.1)},
        "batch": t.grid_search([16, 32]),
        "const": 7,
    }


@pytest.mark.parametrize("seed,num_samples", [(0, 1), (3, 4), (11, 2)])
def test_variant_generation_matches_the_reference(seed, num_samples):
    want = list(jvg.generate_variants(_space(jtune), num_samples, seed))
    got = list(tvg.generate_variants(_space(ttune), num_samples, seed))
    assert got == want
    assert tvg.count_variants(_space(ttune), num_samples) == len(want) == 6 * num_samples


def test_basic_variant_generator_matches_the_reference():
    js = jtune.BasicVariantGenerator(_space(jtune), num_samples=2, seed=5)
    ts = ttune.BasicVariantGenerator(_space(ttune), num_samples=2, seed=5)
    want = [js.suggest(f"t{i}") for i in range(14)]
    got = [ts.suggest(f"t{i}") for i in range(14)]
    assert got[:12] == want[:12]
    assert got[12:] == want[12:]  # both finished


def _objective(cfg):
    return -((math.log10(cfg["lr"]) + 3.0) ** 2) - 0.1 * abs(cfg["nested"]["width"] - 40) \
        - (0.5 if cfg["act"] == "relu" else 0.0)


def _search_space(t):
    return {"lr": t.loguniform(1e-5, 1e-1), "act": t.choice(["relu", "tanh"]),
            "nested": {"width": t.randint(8, 64)}}


@pytest.mark.parametrize("seed", [1, 7])
def test_tpe_suggestions_match_the_reference(seed):
    """Twenty suggestions, each answered with the same score: past the
    random start-up trials TPE's KDE picks the same points."""
    js = jtune.TPESearcher(_search_space(jtune), metric="score", mode="max",
                           n_startup_trials=5, seed=seed)
    ts = ttune.TPESearcher(_search_space(ttune), metric="score", mode="max",
                           n_startup_trials=5, seed=seed)
    for i in range(20):
        a, b = js.suggest(f"t{i}"), ts.suggest(f"t{i}")
        assert b == a, i
        js.on_trial_complete(f"t{i}", {"score": _objective(a)})
        ts.on_trial_complete(f"t{i}", {"score": _objective(b)})


def test_bohb_suggestions_match_the_reference():
    """TuneBOHB fed intermediate results at three budgets: the same
    suggestions and the same observations by budget."""
    js = jtune.TuneBOHB(space=_search_space(jtune), metric="score", mode="max",
                        n_startup_trials=4, seed=2)
    ts = ttune.TuneBOHB(space=_search_space(ttune), metric="score", mode="max",
                        n_startup_trials=4, seed=2)
    for i in range(16):
        a, b = js.suggest(f"t{i}"), ts.suggest(f"t{i}")
        assert b == a, i
        for it in (1, 3, 9)[: 1 + i % 3]:
            res = {"score": _objective(a) - 1.0 / it, "training_iteration": it}
            js.on_trial_result(f"t{i}", res)
            ts.on_trial_result(f"t{i}", dict(res))
        js.on_trial_complete(f"t{i}", None)
        ts.on_trial_complete(f"t{i}", None)
    assert {k: len(v) for k, v in ts._by_budget.items()} == \
        {k: len(v) for k, v in js._by_budget.items()}


class _T:
    def __init__(self, trial_id):
        self.trial_id = trial_id
        self.config = {}
        self._pbt_exploit = None


def _stream(n_trials=8, steps=16):
    """(trial index, step, score) in an interleaved arrival order."""
    out = []
    for it in range(1, steps + 1):
        for k in range(n_trials):
            if (k + it) % 3:  # staggered: not every trial reports every round
                out.append((k, it, -((k - 5.0) ** 2) + 0.05 * it))
    return out


@pytest.mark.parametrize("which", ["asha", "hyperband", "median"])
def test_scheduler_decisions_match_the_reference(which):
    def make(t):
        if which == "asha":
            return t.ASHAScheduler(metric="score", mode="max", max_t=16, grace_period=2,
                                   reduction_factor=2)
        if which == "hyperband":
            return t.HyperBandScheduler(metric="score", mode="max", max_t=16, reduction_factor=2)
        return t.MedianStoppingRule(metric="score", mode="max", grace_period=2)

    js, ts = make(jtune), make(ttune)
    jtrials = [_T(f"t{k}") for k in range(8)]
    ttrials = [_T(f"t{k}") for k in range(8)]
    for a, b in zip(jtrials, ttrials):
        js.on_trial_add(a)
        ts.on_trial_add(b)
    stopped = set()
    for k, it, score in _stream():
        if k in stopped:
            continue
        res = {"score": score, "training_iteration": it}
        da = js.on_trial_result(jtrials[k], dict(res))
        db = ts.on_trial_result(ttrials[k], dict(res))
        assert db == da, (k, it)
        if da == jtune.TrialScheduler.STOP:
            stopped.add(k)
    assert stopped  # the stream exercises the stopping rule


@pytest.mark.parametrize("which", ["pbt", "pb2"])
def test_population_exploits_match_the_reference(which):
    """PBT's and PB2's exploit decisions and mutated configs (PB2's numpy
    GP bandit included) for the same population history."""
    def make(t):
        if which == "pbt":
            return t.PopulationBasedTraining(
                metric="score", mode="max", perturbation_interval=2,
                hyperparam_mutations={"lr": t.uniform(0.1, 10.0)}, quantile_fraction=0.5, seed=3)
        return t.PB2(metric="score", mode="max", perturbation_interval=2,
                     hyperparam_bounds={"lr": [0.1, 10.0]}, quantile_fraction=0.5, seed=3)

    js, ts = make(jtune), make(ttune)
    lrs = [0.1, 0.2, 5.0, 10.0]
    values = [0.0] * 4
    jtrials = [_T(f"t{k}") for k in range(4)]
    ttrials = [_T(f"t{k}") for k in range(4)]
    exploits = 0
    for it in range(1, 11):
        for k in range(4):
            values[k] += lrs[k]
            cfg = {"lr": lrs[k]}
            res = {"score": values[k], "training_iteration": it, "config": cfg}
            jtrials[k].config, ttrials[k].config = dict(cfg), dict(cfg)
            da = js.on_trial_result(jtrials[k], dict(res))
            db = ts.on_trial_result(ttrials[k], dict(res))
            assert db == da, (k, it)
            ea, eb = jtrials[k]._pbt_exploit, ttrials[k]._pbt_exploit
            assert (ea is None) == (eb is None)
            if ea is not None:
                exploits += 1
                assert eb["source"] == ea["source"]
                new_a, new_b = ea["mutate"](dict(cfg)), eb["mutate"](dict(cfg))
                assert new_b == pytest.approx(new_a, rel=1e-12, abs=0)
                jtrials[k]._pbt_exploit = ttrials[k]._pbt_exploit = None
                lrs[k] = new_a["lr"]
                values[k] = values[int(ea["source"][1:])]
    assert exploits > 0
