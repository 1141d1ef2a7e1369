"""DQN (reference: rllib/algorithms/dqn/ — double-Q + dueling +
prioritized replay).  The sampler collects with epsilon-greedy
exploration; the learner's update takes double-Q targets from a target
network on the learner's device (``cuda`` by default).

The target network is a copy of the Q-net's parameters, never an alias:
Adam steps the online parameters in place, so a target that shared their
storage would move with every step."""

from __future__ import annotations

import copy
from typing import Any, Dict

import numpy as np

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import Learner, batch_tensor
from ray_tpu_torch.rllib.core.rl_module import QModule, load_weights, weights_of
from ray_tpu_torch.rllib.utils.replay_buffers import PrioritizedReplayBuffer, ReplayBuffer
from ray_tpu_torch.rllib.utils.sample_batch import (
    ACTIONS,
    NEXT_OBS,
    OBS,
    REWARDS,
    SampleBatch,
    TERMINATEDS,
)


class DQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 5e-4
        self.train_batch_size = 32
        self.replay_buffer_capacity = 50_000
        self.prioritized_replay = True
        self.num_steps_sampled_before_learning_starts = 1000
        self.target_network_update_freq = 500  # env steps
        self.epsilon_start = 1.0
        self.epsilon_end = 0.05
        self.epsilon_decay_timesteps = 10_000
        self.rollout_fragment_length = 4
        self.num_env_runners = 0  # DQN default: inline sampling
        self.sample_batch_size = 64
        self.updates_per_iteration = 32

    @property
    def algo_class(self):
        return DQN


class DQNLearner(Learner):
    """Double-Q learner with a target network."""

    def build_module(self):
        return QModule(self.module_spec, self._gen)

    def __init__(self, module_spec, config=None):
        super().__init__(module_spec, config)
        self.qmodule = self.module
        self.target = copy.deepcopy(self.module).requires_grad_(False)
        self._last_td = None

    def compute_loss(self, batch: Dict[str, Any]):
        import torch

        gamma = self.config.get("gamma", 0.99)
        q = self.module.q_values(batch[OBS])
        q_taken = q.gather(-1, batch[ACTIONS].long()[..., None])[..., 0]
        with torch.no_grad():  # the target: the reference's stop_gradient
            next_act = self.module.q_values(batch[NEXT_OBS]).argmax(dim=-1)
            next_q = self.target.q_values(batch[NEXT_OBS])
            next_val = next_q.gather(-1, next_act[..., None])[..., 0]
            target = batch[REWARDS] + gamma * (1.0 - batch[TERMINATEDS].float()) * next_val
        td = q_taken - target
        weights = batch["weights"] if "weights" in batch else torch.ones_like(td)
        loss = (weights * td.square()).mean()
        return loss, {"td_error_abs": td.detach().abs(), "qf_mean": q_taken.detach().mean()}

    def update_from_batch(self, batch) -> Dict[str, float]:
        """One Adam step on a replay batch (no row padding, as the
        reference's DQN update); the TD errors stay for
        ``last_td_error``."""
        rows = {k: batch_tensor(v, self.device) for k, v in batch.items() if k != "batch_indexes"}
        metrics = self._descend(lambda: self.compute_loss(rows))
        self._last_td = metrics.pop("td_error_abs").cpu().numpy()
        return self._finish(metrics)

    def last_td_error(self) -> np.ndarray:
        return self._last_td

    def update_target(self):
        """Copy the online parameters into the target's own storage."""
        self.target.load_state_dict(self.module.state_dict())

    def get_state(self):
        state = super().get_state()
        state["target"] = weights_of(self.target)
        return state

    def set_state(self, state):
        super().set_state(state)
        load_weights(self.target, state["target"])


class _EpsilonGreedySampler:
    """Inline sampler: epsilon-greedy over Q-values from the learner's
    Q-net on the learner's device; transition collection delegated to
    the shared VectorEnvCollector."""

    def __init__(self, env_creator, qmodule: QModule, cfg: "DQNConfig"):
        import gymnasium as gym

        from ray_tpu_torch.rllib.utils.collector import VectorEnvCollector

        self.envs = gym.vector.SyncVectorEnv([env_creator for _ in range(cfg.num_envs_per_env_runner)])
        self.qmodule = qmodule
        self.cfg = cfg
        self._rng = np.random.default_rng(cfg.seed)
        self._collector = VectorEnvCollector(self.envs, seed=cfg.seed)

    @property
    def completed_returns(self):
        return self._collector.completed_returns

    @property
    def completed_lens(self):
        return self._collector.completed_lens

    def epsilon(self, t: int) -> float:
        c = self.cfg
        frac = min(1.0, t / max(1, c.epsilon_decay_timesteps))
        return c.epsilon_start + frac * (c.epsilon_end - c.epsilon_start)

    def q_values(self, obs) -> np.ndarray:
        import torch

        with torch.no_grad():
            return self.qmodule.q_values(np.asarray(obs)).cpu().numpy()

    def sample(self, num_steps: int, t: int) -> SampleBatch:
        n_envs = self.envs.num_envs

        def act(obs, t_now):
            q = self.q_values(obs)
            greedy = q.argmax(axis=-1)
            rand = self._rng.integers(0, q.shape[-1], n_envs)
            return np.where(self._rng.random(n_envs) < self.epsilon(t_now), rand, greedy)

        return self._collector.collect(num_steps, act)


class DQN(Algorithm):
    config_class = DQNConfig
    learner_class = DQNLearner

    def _needs_advantages(self) -> bool:
        return False

    def setup(self, config: Dict[str, Any]):
        cfg = self.algo_config
        from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec

        env_creator = cfg.make_env_creator()
        probe = env_creator()
        self.module_spec = RLModuleSpec.from_gym_env(probe, hidden=tuple(cfg.model.get("hidden", (64, 64))))
        probe.close()
        self.learner = DQNLearner(self.module_spec, self._learner_config())
        self.sampler = _EpsilonGreedySampler(env_creator, self.learner.qmodule, cfg)
        self.buffer = (
            PrioritizedReplayBuffer(cfg.replay_buffer_capacity, seed=cfg.seed)
            if cfg.prioritized_replay
            else ReplayBuffer(cfg.replay_buffer_capacity, seed=cfg.seed)
        )
        self._timesteps_total = 0
        self._last_target_update = 0

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        batch = self.sampler.sample(cfg.sample_batch_size, self._timesteps_total)
        self.buffer.add(batch)
        self._timesteps_total += batch.count
        metrics: Dict[str, Any] = {"buffer_size": len(self.buffer)}
        if self._timesteps_total >= cfg.num_steps_sampled_before_learning_starts:
            for _ in range(cfg.updates_per_iteration):
                replay = self.buffer.sample(cfg.train_batch_size)
                metrics.update(self.learner.update_from_batch(replay))
                if isinstance(self.buffer, PrioritizedReplayBuffer):
                    self.buffer.update_priorities(replay["batch_indexes"], self.learner.last_td_error())
            if self._timesteps_total - self._last_target_update >= cfg.target_network_update_freq:
                self.learner.update_target()
                self._last_target_update = self._timesteps_total
        metrics["epsilon"] = self.sampler.epsilon(self._timesteps_total)
        metrics["num_env_steps_sampled"] = self._timesteps_total
        rets = self.sampler.completed_returns[-100:]
        metrics["episode_return_mean"] = float(np.mean(rets)) if rets else None
        return metrics

    def evaluate(self) -> Dict[str, Any]:
        """Greedy (argmax-Q) rollouts on a fresh env — the Q-net is not
        an RLModule, so the base eval-runner path doesn't apply
        (reference: DQN eval with explore=False)."""
        cfg = self.algo_config
        from ray_tpu_torch.rllib.utils.evaluation import greedy_eval

        act = lambda obs: int(self.sampler.q_values(obs[None]).argmax())  # noqa: E731
        return greedy_eval(cfg.make_env_creator(), act, cfg.evaluation_duration, cfg.seed)

    def save_checkpoint(self, checkpoint_dir: str):
        import os
        import pickle

        state = {
            "learner": self.learner.get_state(),
            "timesteps_total": self._timesteps_total,
            "config": self.algo_config.to_dict(),
        }
        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"), "wb") as f:
            pickle.dump(state, f)

    def load_checkpoint(self, checkpoint_dir: str):
        import os
        import pickle

        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"), "rb") as f:
            state = pickle.load(f)
        self.learner.set_state(state["learner"])
        self._timesteps_total = state.get("timesteps_total", 0)
        # The epsilon schedule anneals on the collector's step counter:
        # resume it or a restored run explores at epsilon_start again.
        self.sampler._collector.t = self._timesteps_total

    def get_policy_weights(self):
        return self.learner.get_weights()

    def cleanup(self):
        self.sampler.envs.close()

    stop = cleanup
