"""Shared off-policy transition collector (used by the DQN and SAC
samplers; reference: the common rollout bookkeeping inside
single_agent_env_runner.py, factored once instead of per-algorithm).

Handles the gymnasium >= 1.0 next-step-autoreset protocol: the step
after a done is a reset step whose transition (obs = previous episode's
terminal frame, action ignored, reward 0) is masked out of both the
batch and the episode statistics."""

from __future__ import annotations

from typing import Callable, List

import numpy as np

from ray_tpu_torch.rllib.utils.sample_batch import (
    ACTIONS,
    NEXT_OBS,
    OBS,
    REWARDS,
    SampleBatch,
    TERMINATEDS,
)


class VectorEnvCollector:
    """Steps a vector env with an injected ``action_fn(obs, t)`` and
    accumulates (obs, action, reward, next_obs, terminated) transitions.
    ``t`` is the running count of valid env steps (for epsilon/warmup
    schedules)."""

    def __init__(self, envs, seed: int = 0):
        self.envs = envs
        obs, _ = envs.reset(seed=seed)
        self._obs = obs
        self._prev_done = np.zeros(envs.num_envs, bool)
        self._episode_returns = np.zeros(envs.num_envs)
        self._episode_lens = np.zeros(envs.num_envs, dtype=np.int64)
        self.completed_returns: List[float] = []
        self.completed_lens: List[int] = []
        self.t = 0  # valid env steps collected so far

    def collect(self, num_steps: int, action_fn: Callable[[np.ndarray, int], np.ndarray]) -> SampleBatch:
        cols = {k: [] for k in (OBS, ACTIONS, REWARDS, NEXT_OBS, TERMINATEDS)}
        steps_left = num_steps
        # Keep stepping until at least one VALID transition exists: a
        # window of only masked autoreset steps (num_envs=1 right after
        # an episode end) would otherwise produce an empty batch.
        while steps_left > 0 or not cols[OBS]:
            steps_left -= 1
            actions = action_fn(self._obs, self.t)
            next_obs, rewards, term, trunc, _ = self.envs.step(actions)
            keep = ~self._prev_done
            if keep.any():
                cols[OBS].append(self._obs[keep].copy())
                cols[ACTIONS].append(actions[keep])
                cols[REWARDS].append(np.asarray(rewards, np.float32)[keep])
                cols[NEXT_OBS].append(next_obs[keep].copy())
                cols[TERMINATEDS].append(term[keep].copy())
            self._episode_returns[keep] += rewards[keep]
            self._episode_lens[keep] += 1
            for i in np.where((term | trunc) & keep)[0]:
                self.completed_returns.append(float(self._episode_returns[i]))
                self.completed_lens.append(int(self._episode_lens[i]))
                self._episode_returns[i] = 0.0
                self._episode_lens[i] = 0
            self._prev_done = term | trunc
            self._obs = next_obs
            self.t += int(keep.sum())
        return SampleBatch({k: np.concatenate(v, axis=0) for k, v in cols.items()})
