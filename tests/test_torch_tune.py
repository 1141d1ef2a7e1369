"""The port's Tune: searchers, schedulers, controller, resume — copies of
tests/test_tune.py's tests on the port's own cluster (no JAX here), each
sweep under test_torch_spmd's deadline; then a Tuner sweeping a
TorchTrainer, each trial running ``fit()`` inside its trial actor (0.5
CPU) whose worker then trains, the best trial equal to a direct
``fit()`` with the same seed, batch and learning rate (tiny GPT-2, f32,
CPU; the loop is ``ray_tpu_torch.train.torch.gpt2_loop``, since workers
import a pickled function's module); and the resource keys a trial may
ask for.  One cluster for the module.

Reference test model: python/ray/tune/tests/ (test_tune_restore.py,
test_trial_scheduler.py, test_searchers.py) — behavior parity checks over
a real local cluster.
"""

import os
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import tune
from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.tune import TuneConfig, Tuner
from ray_tpu_torch.tune.tune_controller import TuneController

# Trial actors import this module for its trainables: it imports no torch
# at module level (the suite runs near the box's memory).


def within(fn):
    """``fn()`` under test_torch_spmd's deadline (imported here: that
    module imports torch)."""
    from test_torch_spmd import within as deadline

    return deadline(fn)


@pytest.fixture(scope="module")
def ray_cluster():
    """One cluster of the port for the module (the conftest's fixture of
    this name starts the JAX package's)."""
    with pytest.MonkeyPatch.context() as mp:
        # The suite runs many clusters at once, the JAX package's among them:
        # no 2 GiB shm arena prefault per raylet, and no memory monitor,
        # which watches the whole machine and would kill this test's
        # workers for the others' memory.
        mp.setenv("RAY_TPU_TORCH_arena_prefault_bytes", "0")
        mp.setenv("RAY_TPU_TORCH_memory_monitor_enabled", "0")
        ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
        yield ray_tpu_torch
        ray_tpu_torch.shutdown()


def _quadratic(config):
    # maximize -(x-3)^2: optimum at x=3
    for i in range(5):
        tune.report({"score": -((config["x"] - 3.0) ** 2) - 0.01 * (5 - i)})


class _StepTrainable(tune.Trainable):
    def setup(self, config):
        self.x = config["x"]
        self.total = 0.0

    def step(self):
        self.total += self.x
        return {"total": self.total}

    def save_checkpoint(self, checkpoint_dir):
        with open(os.path.join(checkpoint_dir, "state.txt"), "w") as f:
            f.write(str(self.total))

    def load_checkpoint(self, checkpoint_dir):
        with open(os.path.join(checkpoint_dir, "state.txt")) as f:
            self.total = float(f.read())


def test_variant_generation():
    from ray_tpu_torch.tune.search.variant_generator import count_variants, generate_variants

    space = {
        "a": tune.grid_search([1, 2, 3]),
        "b": tune.uniform(0.0, 1.0),
        "nested": {"c": tune.choice(["x", "y"])},
    }
    variants = list(generate_variants(space, num_samples=2))
    assert len(variants) == 6 == count_variants(space, 2)
    assert {v["a"] for v in variants} == {1, 2, 3}
    for v in variants:
        assert 0.0 <= v["b"] <= 1.0
        assert v["nested"]["c"] in ("x", "y")


def test_function_trainable_sweep(ray_cluster, tmp_path):
    tuner = Tuner(
        _quadratic,
        param_space={"x": tune.grid_search([1.0, 3.0, 5.0])},
        tune_config=TuneConfig(metric="score", mode="max"),
        run_config=RunConfig(name="quad", storage_path=str(tmp_path)),
    )
    results = within(tuner.fit)
    assert len(results) == 3
    assert results.num_terminated == 3
    best = results.get_best_result()
    assert best.metrics["config"]["x"] == 3.0


def test_class_trainable_with_stop_and_checkpoint(ray_cluster, tmp_path):
    tuner = Tuner(
        _StepTrainable,
        param_space={"x": tune.grid_search([2.0, 7.0])},
        tune_config=TuneConfig(metric="total", mode="max"),
        run_config=RunConfig(
            name="steppy", storage_path=str(tmp_path), stop={"training_iteration": 4}
        ),
    )
    results = within(tuner.fit)
    assert len(results) == 2
    best = results.get_best_result()
    assert best.metrics["total"] == pytest.approx(4 * 7.0)
    # terminal checkpoint saved
    assert best.checkpoint is not None
    with open(os.path.join(best.checkpoint.path, "state.txt")) as f:
        assert float(f.read()) == pytest.approx(28.0)


def test_asha_stops_bad_trials(ray_cluster, tmp_path):
    def slow_quad(config):
        for i in range(16):
            # Keep the population running concurrently: with instant steps a
            # trial can reach max_t before later trials hit their first rung,
            # and async ASHA's first-arrival-survives rule then cuts nothing.
            # graftlint: disable=retry-gate -- a trial's pace between reports, not a retry
            time.sleep(0.05)
            tune.report({"score": -((config["x"] - 3.0) ** 2) + 0.05 * i})

    scheduler = tune.ASHAScheduler(max_t=16, grace_period=2, reduction_factor=2)
    bad_xs = [-6.0, -4.0, -2.0, 0.0, 1.0, 5.0]
    tuner = Tuner(
        slow_quad,
        param_space={"x": tune.grid_search(bad_xs + [2.5, 3.0])},
        tune_config=TuneConfig(metric="score", mode="max", scheduler=scheduler),
        run_config=RunConfig(name="asha", storage_path=str(tmp_path)),
    )
    results = within(tuner.fit)
    iters = {
        r.metrics["config"]["x"]: r.metrics["training_iteration"] for r in results if r.metrics
    }
    # the best config survives to max_t; ASHA is asynchronous, so the first
    # arrival at each rung always survives — assert aggregate savings, not
    # per-trial cuts
    assert iters[3.0] == 16
    assert sum(iters[x] for x in bad_xs) < 16 * len(bad_xs) * 0.75
    assert min(iters[x] for x in bad_xs) <= 4


def test_tpe_searcher_improves(ray_cluster, tmp_path):
    space = {"x": tune.uniform(-10.0, 10.0)}
    searcher = tune.TPESearcher(space, metric="score", mode="max", n_startup_trials=6, seed=1)
    tuner = Tuner(
        _quadratic,
        param_space=space,
        tune_config=TuneConfig(metric="score", mode="max", search_alg=searcher, num_samples=20),
        run_config=RunConfig(name="tpe", storage_path=str(tmp_path)),
    )
    results = within(tuner.fit)
    assert len(results) == 20
    best = results.get_best_result()
    # TPE should concentrate near x=3 by the end
    assert abs(best.metrics["config"]["x"] - 3.0) < 1.5


def test_experiment_resume(ray_cluster, tmp_path):
    exp_dir = str(tmp_path / "resumable")

    def failing_once(config):
        marker = os.path.join(exp_dir, f"ran_{config['x']}")
        first_time = not os.path.exists(marker)
        with open(marker, "a") as f:
            f.write("x")
        if first_time and config["x"] == 99:
            raise RuntimeError("boom")
        tune.report({"score": config["x"], "done": True})

    tuner = Tuner(
        failing_once,
        param_space={"x": tune.grid_search([1, 99])},
        tune_config=TuneConfig(metric="score", mode="max"),
        run_config=RunConfig(name="resumable", storage_path=str(tmp_path)),
    )
    results = within(tuner.fit)
    assert results.num_errors == 1
    assert Tuner.can_restore(exp_dir)

    restored = Tuner.restore(exp_dir, failing_once, resume_errored=True)
    results2 = within(restored.fit)
    assert results2.num_errors == 0
    scores = sorted(r.metrics["score"] for r in results2 if r.metrics and "score" in r.metrics)
    assert scores == [1, 99]


def test_pbt_exploits(ray_cluster, tmp_path):
    class PBTTrainable(tune.Trainable):
        def setup(self, config):
            self.value = 0.0

        def step(self):
            # lr=good makes fast progress; PBT should propagate it.
            # The sleep keeps the population running concurrently: with
            # instant steps a trial can finish all 12 iterations before the
            # other trials report once, and PBT's quantile logic (correctly)
            # refuses to exploit without a full population.  0.25s and
            # 16 iterations keep the population overlapping even when
            # actor starts stagger by seconds on a loaded 1-core box.
            time.sleep(0.25)
            self.value += self.config["lr"]
            return {"value": self.value}

        def save_checkpoint(self, d):
            with open(os.path.join(d, "v.txt"), "w") as f:
                f.write(str(self.value))

        def load_checkpoint(self, d):
            with open(os.path.join(d, "v.txt")) as f:
                self.value = float(f.read())

    pbt = tune.PopulationBasedTraining(
        metric="value",
        mode="max",
        perturbation_interval=3,
        hyperparam_mutations={"lr": tune.uniform(0.1, 10.0)},
        quantile_fraction=0.5,
        seed=0,
    )
    tuner = Tuner(
        # Fractional CPUs: PBT's quantile decisions need the whole
        # population reporting concurrently, even if earlier tests in the
        # shared module cluster leaked a CPU or two.
        tune.with_resources(PBTTrainable, {"cpu": 0.25}),
        param_space={"lr": tune.grid_search([0.1, 0.2, 5.0, 10.0])},
        tune_config=TuneConfig(metric="value", mode="max", scheduler=pbt),
        run_config=RunConfig(
            name="pbt", storage_path=str(tmp_path), stop={"training_iteration": 16}
        ),
    )
    results = within(tuner.fit)
    finals = [r.metrics["value"] for r in results if r.metrics and "value" in r.metrics]
    assert results.num_errors == 0
    # Exploitation: the bad trials (lr 0.1/0.2) clone a top trial's
    # checkpoint, so even the WORST final trajectory must beat the best
    # pure-bad-lr trajectory (12 * 0.2 = 2.4) by a wide margin.
    assert min(finals) > 16 * 0.2 * 2
    # Exploration: the exploited trials continue with a *mutated* config,
    # so some final lr must differ from every initial grid value.
    final_lrs = {r.metrics["config"]["lr"] for r in results if r.metrics}
    assert final_lrs - {0.1, 0.2, 5.0, 10.0}, f"no perturbed configs in {final_lrs}"


def test_pb2_exploits_with_gp_bandit(ray_cluster, tmp_path):
    """PB2: same exploit machinery as PBT, but new configs come from the
    GP-bandit over population history and must respect the bounds."""

    class PB2Trainable(tune.Trainable):
        def setup(self, config):
            self.value = 0.0

        def step(self):
            time.sleep(0.25)  # keep the population overlapping (see PBT test)
            self.value += self.config["lr"]
            return {"value": self.value}

        def save_checkpoint(self, d):
            with open(os.path.join(d, "v.txt"), "w") as f:
                f.write(str(self.value))

        def load_checkpoint(self, d):
            with open(os.path.join(d, "v.txt")) as f:
                self.value = float(f.read())

    pb2 = tune.PB2(
        metric="value",
        mode="max",
        perturbation_interval=3,
        hyperparam_bounds={"lr": [0.1, 10.0]},
        quantile_fraction=0.5,
        seed=0,
    )
    tuner = Tuner(
        tune.with_resources(PB2Trainable, {"cpu": 0.25}),
        param_space={"lr": tune.grid_search([0.1, 0.2, 5.0, 10.0])},
        tune_config=TuneConfig(metric="value", mode="max", scheduler=pb2),
        run_config=RunConfig(
            name="pb2", storage_path=str(tmp_path), stop={"training_iteration": 16}
        ),
    )
    results = within(tuner.fit)
    assert results.num_errors == 0
    finals = [r.metrics["value"] for r in results if r.metrics and "value" in r.metrics]
    assert min(finals) > 16 * 0.2 * 2  # bad trials exploited a top trial
    # the bandit saw population history
    assert len(pb2._history) > 0
    for r in results:
        assert 0.1 <= r.config["lr"] <= 10.0  # selections respect bounds


def test_bohb_searcher_with_hyperband(ray_cluster, tmp_path):
    """TuneBOHB + HyperBandForBOHB: suggestions respect the space, the
    KDE trains on intermediate (rung-budget) results, and the search
    converges toward the good region."""

    def objective(config):
        for i in range(6):
            tune.report({"score": -((config["x"] - 3.0) ** 2) - 0.1 * i ** 0.5})

    searcher = tune.TuneBOHB(
        space={"x": tune.uniform(-10.0, 10.0)},
        metric="score",
        mode="max",
        n_startup_trials=4,
        seed=1,
    )
    tuner = Tuner(
        objective,
        tune_config=TuneConfig(
            metric="score",
            mode="max",
            search_alg=searcher,
            scheduler=tune.HyperBandForBOHB(metric="score", mode="max", max_t=6),
            num_samples=16,
        ),
        run_config=RunConfig(name="bohb", storage_path=str(tmp_path)),
    )
    results = within(tuner.fit)
    assert results.num_errors == 0
    best = results.get_best_result(metric="score", mode="max")
    assert abs(best.config["x"] - 3.0) < 3.0, best.config
    # the model observed multiple budget levels (BOHB's point)
    assert len(searcher._by_budget) >= 2, list(searcher._by_budget)


def _trainer(tmp_path, lr):
    import torch

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train.torch import TorchTrainer
    from ray_tpu_torch.train.torch.gpt2_loop import train_loop_per_worker

    toks = np.random.default_rng(5).integers(0, 512, size=(4, 33)).astype(np.int64)
    return TorchTrainer(
        train_loop_per_worker,
        train_loop_config={"cfg": gpt2.GPT2Config.tiny(dtype=torch.float32, remat=False),
                           "seed": 0, "tokens": toks, "lr": lr, "steps": 3, "device": "cpu"},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(storage_path=str(tmp_path / "train")),
    )


def test_tuner_sweeps_a_torch_trainer_and_its_best_trial_is_a_direct_fit(ray_cluster, tmp_path):
    lrs = [1e-4, 3e-3]
    tuner = tune.Tuner(
        _trainer(tmp_path, lr=None),
        param_space={"train_loop_config": {"lr": tune.grid_search(lrs)}},
        tune_config=tune.TuneConfig(
            metric="loss", mode="min", max_concurrent_trials=1,
            scheduler=tune.ASHAScheduler(max_t=2, grace_period=1, reduction_factor=2)),
        run_config=RunConfig(name="sweep", storage_path=str(tmp_path)),
    )
    results = within(tuner.fit)
    assert len(results) == 2 and results.num_errors == 0
    by_lr = {r.metrics["config"]["train_loop_config"]["lr"]: r.metrics for r in results}
    assert sorted(by_lr) == lrs
    for m in by_lr.values():
        assert m["steps_run"] == 3 and m["device"] == "cpu" and m["world_size"] == 1
        assert m["launches"] == [0, 0, 0]  # the CPU runs the kernels' plain versions
    best = results.get_best_result()
    assert best.metrics["config"]["train_loop_config"]["lr"] == 3e-3
    assert best.metrics["loss"] == min(m["loss"] for m in by_lr.values())
    # the trial's worker is a process of its own, not the trial actor's
    assert len({m["pid"] for m in by_lr.values()}) == 2

    direct = within(_trainer(tmp_path, lr=3e-3).fit).metrics
    np.testing.assert_allclose(best.metrics["losses"], direct["losses"], rtol=1e-6, atol=0)


def test_a_trial_asks_for_cpu_gpu_or_custom_resources_and_never_tpu(tmp_path):
    """The reference maps "tpu" to num_tpus; the port's runtime has no
    TPU resource, so the key is refused with the key to use."""
    def fn(config):
        pass

    def controller(resources):
        return TuneController(tune.with_resources(fn, resources), tune.BasicVariantGenerator(),
                              None, str(tmp_path / "exp"))

    assert controller({"cpu": 1, "gpu": 1, "slot": 2})._resources() == {
        "num_cpus": 1, "num_gpus": 1, "resources": {"slot": 2}}
    with pytest.raises(ValueError, match='"gpu"'):
        controller({"cpu": 1, "tpu": 1})._resources()
