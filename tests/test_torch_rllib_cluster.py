"""The port's PPO on its own cluster, on the CPU: built with a remote env
runner, two train() iterations, a checkpoint round trip, one trial under
Tuner(PPO, param_space=...), connectors through the config.  No JAX here;
one cluster for the module, and only the tests that need it here (the
suite's workers each start the module's cluster for the tests they
take)."""

import os

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import tune
from ray_tpu_torch.air.config import RunConfig

from test_torch_spmd import within

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ray_cluster():
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


def _config(**runners):
    from ray_tpu_torch.rllib import PPOConfig

    return (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(**{"num_env_runners": 1, "num_envs_per_env_runner": 2,
                        "num_cpus_per_env_runner": 0.5, **runners})
        .training(lr=3e-4, train_batch_size=256, minibatch_size=64, num_epochs=2)
        .learners(device="cpu")
        .debugging(seed=1)
    )


def test_ppo_trains_and_its_checkpoint_restores_equal_weights(ray_cluster, tmp_path):
    from ray_tpu_torch.rllib import PPO

    def run():
        algo = _config().build()
        try:
            outs = [algo.train() for _ in range(2)]
            ckpt = str(tmp_path / "ppo_ckpt")
            os.makedirs(ckpt)
            algo.save_checkpoint(ckpt)
            return outs, algo.learner_group.get_state(), ckpt
        finally:
            algo.cleanup()

    outs, state, ckpt = within(run)
    for i, out in enumerate(outs, 1):
        assert out["training_iteration"] == i
        assert out["num_env_steps_sampled"] > 200  # autoreset rows dropped from 256
        assert np.isfinite(out["total_loss"]) and out["episode_return_mean"] > 0
    assert outs[1]["timesteps_total"] > outs[0]["timesteps_total"]
    assert os.path.exists(os.path.join(ckpt, "algorithm_state.pkl"))

    def restore():
        algo = PPO.from_checkpoint(ckpt)
        try:
            return algo.learner_group.get_state(), algo.train()
        finally:
            algo.cleanup()

    restored, out = within(restore)
    for k, v in state["weights"].items():
        np.testing.assert_array_equal(restored["weights"][k], v)
        for name in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(restored["opt_state"][k][name],
                                          state["opt_state"][k][name])
    assert out["num_env_steps_sampled"] > 0  # runners rebuilt from the blob


def test_tuner_runs_a_ppo_trial(ray_cluster, tmp_path):
    from ray_tpu_torch.rllib import PPO

    tuner = tune.Tuner(
        tune.with_resources(PPO, {"cpu": 1}),
        param_space={"env": "CartPole-v1", "num_env_runners": 1, "num_envs_per_env_runner": 2,
                     "num_cpus_per_env_runner": 0.5, "train_batch_size": 128,
                     "minibatch_size": 64, "num_epochs": 1, "learner_device": "cpu",
                     "lr": tune.grid_search([3e-4])},
        tune_config=tune.TuneConfig(metric="episode_return_mean", mode="max"),
        run_config=RunConfig(name="ppo", storage_path=str(tmp_path),
                             stop={"training_iteration": 2}),
    )
    results = within(tuner.fit)
    assert len(results) == 1 and results.num_errors == 0
    best = results.get_best_result()
    assert best.metrics["training_iteration"] == 2
    assert best.metrics["config"]["lr"] == 3e-4
    assert os.path.exists(os.path.join(best.checkpoint.path, "algorithm_state.pkl"))


def test_connectors_wired_through_config(ray_cluster):
    from ray_tpu_torch.rllib import ConnectorPipelineV2, FlattenObservations

    cfg = _config(num_env_runners=0, rollout_fragment_length=16,
                  env_to_module=ConnectorPipelineV2([FlattenObservations()]))
    cfg.training(train_batch_size=32, minibatch_size=16, num_epochs=1)
    algo = cfg.build()
    assert algo.env_runner_group.local_runner.env_to_module is not None
    out = algo.train()
    assert out["num_env_steps_sampled"] > 0
    algo.cleanup()
