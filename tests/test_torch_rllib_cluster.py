"""The port's PPO on its own cluster, on the CPU: built with a remote env
runner, two train() iterations, a checkpoint round trip, one trial under
Tuner(PPO, param_space=...), connectors through the config; multi-agent
PPO's checkpoint round trip and its remote runners; OfflineData reading
parquet the port's Data wrote.  No JAX here;
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


def test_multi_agent_checkpoint_roundtrip(ray_cluster, tmp_path):
    """Callable config fields (env_creator, policy_mapping_fn) must
    survive save_checkpoint → from_checkpoint (cloudpickled config)
    (a copy of tests/test_rllib.py's, the learners on the CPU)."""
    from ray_tpu_torch.rllib import PPO, PPOConfig

    class _DoubleCartPole:
        """Two CartPoles in one multi-agent env; either pole's fall ends
        the episode."""

        possible_agents = ["cart_0", "cart_1"]

        def __init__(self):
            import gymnasium as gym

            self._envs = {a: gym.make("CartPole-v1") for a in self.possible_agents}

        def observation_space_for(self, agent):
            return self._envs[agent].observation_space

        def action_space_for(self, agent):
            return self._envs[agent].action_space

        def reset(self, *, seed=None, options=None):
            return {a: e.reset(seed=None if seed is None else seed + i)[0]
                    for i, (a, e) in enumerate(self._envs.items())}, {}

        def step(self, action_dict):
            obs, rew, term, trunc = {}, {}, {}, {}
            for a, e in self._envs.items():
                obs[a], rew[a], term[a], trunc[a], _ = e.step(action_dict[a])
            term["__all__"] = any(term.values()) or any(trunc.values())
            trunc["__all__"] = False
            return obs, rew, term, trunc, {}

        def close(self):
            for e in self._envs.values():
                e.close()

    cfg = (
        PPOConfig()
        .environment(env_creator=lambda: _DoubleCartPole())
        .env_runners(num_env_runners=0, rollout_fragment_length=32)
        .multi_agent(
            policies={"p0": None, "p1": None},
            policy_mapping_fn=lambda agent_id: "p" + agent_id.split("_")[1],
        )
        .training(train_batch_size=64, minibatch_size=32, num_epochs=1)
        .learners(device="cpu")
    )
    ckpt = str(tmp_path / "ma_ckpt")
    os.makedirs(ckpt, exist_ok=True)

    def run():
        algo = cfg.build()
        try:
            algo.train()
            algo.save_checkpoint(ckpt)
            return algo.get_policy_weights()
        finally:
            algo.cleanup()

    w_before = within(run)

    def restore():
        algo2 = PPO.from_checkpoint(ckpt)
        try:
            w_after = algo2.get_policy_weights()
            algo2.train()  # runners rebuilt from the restored env_creator
            return w_after
        finally:
            algo2.cleanup()

    w_after = within(restore)
    for pid in ("p0", "p1"):
        assert set(w_after[pid]) == set(w_before[pid])
        for k, v in w_before[pid].items():
            np.testing.assert_allclose(w_after[pid][k], v, err_msg=(pid, k))


def test_multi_agent_ppo_on_remote_runners(ray_cluster):
    """Two MultiAgentEnvRunner actors on a plain-Python env of explicit
    specs (no gymnasium): a train() iteration reports both policies, the
    runners' batches merge per policy, fresh weights reach every runner."""
    from ray_tpu_torch.rllib import PPOConfig, RLModuleSpec

    class _Pair:
        """Two agents; each reward is 1 for action 1; episodes of 8 steps."""

        possible_agents = ["a_0", "a_1"]

        def reset(self, *, seed=None, options=None):
            self._t = 0
            return {a: np.full(2, i, np.float32) for i, a in enumerate(self.possible_agents)}, {}

        def step(self, actions):
            self._t += 1
            done = self._t >= 8
            obs = {a: np.array([i, self._t / 8], np.float32)
                   for i, a in enumerate(self.possible_agents)}
            rew = {a: float(int(actions[a]) == 1) for a in actions}
            return (obs, rew, {a: False for a in actions} | {"__all__": False},
                    {a: done for a in actions} | {"__all__": done}, {})

        def close(self):
            pass

    specs = {p: RLModuleSpec(observation_dim=2, action_dim=2, hidden=(8,)) for p in ("p0", "p1")}
    cfg = (PPOConfig().environment(env_creator=_Pair)
           .env_runners(num_env_runners=2, num_cpus_per_env_runner=0.5, rollout_fragment_length=16)
           .multi_agent(policies=specs, policy_mapping_fn=lambda a: "p" + a[-1])
           .training(train_batch_size=32, minibatch_size=16, num_epochs=1)
           .learners(device="cpu").debugging(seed=3))

    def run():
        algo = cfg.build()
        try:
            out = algo.train()
            weights = algo.get_policy_weights()
            seen = [ray_tpu_torch.get(r.__ray_call__.remote(
                lambda runner: {p: m.get_weights() for p, m in runner.modules.items()}))
                for r in algo.env_runner_group.runners]
            return out, weights, seen
        finally:
            algo.cleanup()

    out, weights, seen = within(run)
    assert {"p0", "p1"} <= set(out)
    assert out["num_env_steps_sampled"] == 2 * 2 * 16  # two runners, two agents each
    assert out["num_episodes"] == 4
    for runner_weights in seen:
        for pid, w in weights.items():
            for k, v in w.items():
                np.testing.assert_array_equal(runner_weights[pid][k], v)


def test_offline_data_reads_parquet_written_by_data(ray_cluster, tmp_path):
    """Transitions written as parquet through the port's Data read back
    through OfflineData (read_parquet) row for row, in order."""
    import ray_tpu_torch.data as rd
    from ray_tpu_torch.rllib.offline import OfflineData

    rng = np.random.default_rng(0)
    rows = [{"obs": rng.standard_normal(3).astype(np.float32).tolist(), "actions": int(i % 2),
             "rewards": float(i), "terminateds": i % 5 == 4, "eps_id": i // 5} for i in range(20)]
    path = str(tmp_path / "parquet")
    within(lambda: rd.from_items(rows, parallelism=1).write_parquet(path))
    ds = within(lambda: OfflineData(path))
    assert ds.count == 20
    np.testing.assert_allclose(np.stack(ds["obs"]), [r["obs"] for r in rows])
    np.testing.assert_array_equal(ds["rewards"], [r["rewards"] for r in rows])
    np.testing.assert_array_equal(ds["eps_id"], [r["eps_id"] for r in rows])
