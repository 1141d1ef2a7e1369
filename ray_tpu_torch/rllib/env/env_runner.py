"""SingleAgentEnvRunner (reference: rllib/env/single_agent_env_runner.py:64,
sample() :125): a CPU actor stepping a gymnasium vector env with the
RLModule's inference.

Env runners infer on the CPU by default, as the reference's do: per-step
policy calls are latency-bound (one small batch a vector-env step) and the
card belongs to the learner.  ``inference_backend="cuda"`` puts the module
on the card and raises where there is none; nothing falls back.  A step's
inference is one tiny batch (``num_envs`` rows): ``sample`` runs it on one
intra-op thread, since torch's thread pool costs more than it gains there
(16x slower with 8 threads on a busy 8-core host).

The reference's streaming half (``stream_attach``, ``run_stream``,
``_collect_fragment``) belongs to the podracer plane, ROADMAP Queue A item
5(b), and is not here.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ray_tpu_torch.rllib.utils import postprocessing
from ray_tpu_torch.rllib.utils.sample_batch import (
    ACTIONS,
    EPS_ID,
    LOGP,
    LOSS_MASK,
    OBS,
    REWARDS,
    SampleBatch,
    TERMINATEDS,
    TRUNCATEDS,
    VF_PREDS,
)


class SingleAgentEnvRunner:
    """Created as a remote actor by EnvRunnerGroup; also usable inline."""

    def __init__(
        self,
        env_creator: Callable[[], Any],
        module_spec,
        num_envs: int = 1,
        rollout_fragment_length: int = 200,
        gamma: float = 0.99,
        lambda_: float = 0.95,
        compute_advantages: bool = True,
        worker_index: int = 0,
        seed: int = 0,
        inference_backend: str = "cpu",
        env_to_module=None,
        module_to_env=None,
        mask_autoreset: bool = True,
    ):
        import gymnasium as gym
        import torch

        from ray_tpu_torch._private.device import resolve_device

        if inference_backend not in ("cpu", "cuda"):
            raise ValueError(f"inference_backend must be 'cpu' or 'cuda', got {inference_backend!r}")
        self._device = resolve_device(inference_backend)
        self.envs = gym.vector.SyncVectorEnv([env_creator for _ in range(num_envs)])
        self.num_envs = num_envs
        self.fragment_length = rollout_fragment_length
        self.gamma = gamma
        self.lambda_ = lambda_
        self.compute_advantages = compute_advantages
        self.worker_index = worker_index
        self.module = module_spec.build().to(self._device).eval()
        # action sampling draws from a generator of the inference device
        self._gen = torch.Generator(device=self._device).manual_seed(seed * 100003 + worker_index)
        self._weights_set = False
        # connector pipelines (reference: env_to_module / module_to_env
        # insertion points in single_agent_env_runner.sample)
        self.env_to_module = env_to_module
        self.module_to_env = module_to_env
        obs, _ = self.envs.reset(seed=seed * 17 + worker_index)
        self._obs = obs
        # gymnasium >= 1.0 next-step autoreset: the step after a done is
        # a reset step — its recorded transition is dropped below when
        # mask_autoreset is set.  Temporal-loss consumers (V-trace) keep
        # the rows instead, marked by LOSS_MASK 0.
        self.mask_autoreset = mask_autoreset
        self._prev_done = np.zeros(num_envs, bool)
        self._eps_id = np.arange(num_envs, dtype=np.int64) + worker_index * 1_000_000
        self._next_eps = num_envs + worker_index * 1_000_000
        self._episode_returns = np.zeros(num_envs)
        self._episode_lens = np.zeros(num_envs, dtype=np.int64)
        self._completed_returns: List[float] = []
        self._completed_lens: List[int] = []

    def set_weights(self, weights):
        self.module.set_weights(weights)
        self._weights_set = True

    def get_weights(self):
        return self.module.get_weights()

    def _explore(self, obs):
        actions, logp, value = self.module.forward_exploration(obs, self._gen)
        return actions.cpu().numpy(), logp.cpu().numpy(), value.cpu().numpy()

    def _infer(self, obs):
        actions, value = self.module.forward_inference(obs)
        return actions.cpu().numpy(), value.cpu().numpy()

    def sample(self, num_steps: Optional[int] = None, explore: bool = True) -> SampleBatch:
        """Collect `num_steps` vector-env steps (reference: sample() :125).
        Returns a flat SampleBatch with GAE columns when enabled."""
        import torch

        assert self._weights_set, "set_weights before sampling"
        steps = num_steps or self.fragment_length
        cols: Dict[str, List[np.ndarray]] = {k: [] for k in
            (OBS, ACTIONS, REWARDS, TERMINATEDS, TRUNCATEDS, LOGP, VF_PREDS, EPS_ID)}
        valid_rows: List[np.ndarray] = []
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            with torch.no_grad():
                self._collect(steps, explore, cols, valid_rows)
                # bootstrap values for the still-running episodes
                final_obs = self._obs if self.env_to_module is None else self.env_to_module(self._obs)
                _, last_values = self._infer(final_obs)
        finally:
            torch.set_num_threads(threads)
        last_values = np.asarray(last_values, np.float32)
        return self._batch(cols, valid_rows, last_values)

    def _collect(self, steps: int, explore: bool, cols: Dict[str, List[np.ndarray]],
                 valid_rows: List[np.ndarray]) -> None:
        """Step the vector env ``steps`` times, appending each step's rows."""
        for _ in range(steps):
            mod_obs = self._obs if self.env_to_module is None else self.env_to_module(self._obs)
            if explore:
                actions, logp, value = self._explore(mod_obs)
            else:
                actions, value = self._infer(mod_obs)
                logp = np.zeros(self.num_envs, np.float32)
            env_actions = actions if self.module_to_env is None else self.module_to_env(actions)
            next_obs, rewards, term, trunc, _ = self.envs.step(env_actions)
            cols[OBS].append(np.asarray(mod_obs).copy())
            cols[ACTIONS].append(actions)
            cols[REWARDS].append(np.asarray(rewards, np.float32))
            cols[TERMINATEDS].append(term.copy())
            cols[TRUNCATEDS].append(trunc.copy())
            cols[LOGP].append(np.asarray(logp, np.float32))
            cols[VF_PREDS].append(np.asarray(value, np.float32))
            cols[EPS_ID].append(self._eps_id.copy())
            keep = ~self._prev_done
            valid_rows.append(keep)
            # episode bookkeeping (reset rows carry no reward/length)
            self._episode_returns[keep] += rewards[keep]
            self._episode_lens[keep] += 1
            done = (term | trunc) & keep
            self._prev_done = term | trunc
            for i in np.where(done)[0]:
                self._completed_returns.append(float(self._episode_returns[i]))
                self._completed_lens.append(int(self._episode_lens[i]))
                self._episode_returns[i] = 0.0
                self._episode_lens[i] = 0
                self._eps_id[i] = self._next_eps
                self._next_eps += 1
            self._obs = next_obs

    def _batch(self, cols: Dict[str, List[np.ndarray]], valid_rows: List[np.ndarray],
               last_values: np.ndarray) -> SampleBatch:
        # [T, N, ...] -> per-env episode fragments -> flat batch
        # (autoreset rows dropped: their obs is the previous episode's
        # terminal frame and the env ignored the recorded action)
        valid = np.stack(valid_rows)  # [T, N]
        batches = []
        for i in range(self.num_envs):
            if self.mask_autoreset:
                vi = valid[:, i]
                env_batch = SampleBatch(
                    {k: np.stack([row[i] for row in v])[vi] for k, v in cols.items()}
                )
            else:
                # fixed-shape consumer (V-trace): keep every row, mark
                # the autoreset garbage for the loss to exclude
                env_batch = SampleBatch(
                    {k: np.stack([row[i] for row in v]) for k, v in cols.items()}
                )
                env_batch[LOSS_MASK] = valid[:, i].astype(np.float32)
            if self.compute_advantages:
                for frag in env_batch.split_by_episode():
                    terminated_end = bool(frag[TERMINATEDS][-1])
                    truncated_end = bool(frag[TRUNCATEDS][-1])
                    last_v = 0.0 if terminated_end else (
                        float(last_values[i]) if not truncated_end else 0.0
                    )
                    # NOTE: for truncated episodes the correct bootstrap is
                    # the value of the final observation; the vector env has
                    # already reset, so 0 is used — acceptable bias at
                    # fragment boundaries (reference has the same caveat in
                    # its vectorized GAE connector).
                    batches.append(postprocessing.compute_gae(frag, last_v, self.gamma, self.lambda_))
            else:
                batches.append(env_batch)
        return SampleBatch.concat_samples(batches)

    def sample_episodes(self, num_episodes: int, explore: bool = False) -> List[float]:
        """Reset, then step until ``num_episodes`` episodes complete;
        return their returns (reference: env runner eval sampling with
        duration_unit="episodes").

        The reset matters on a CACHED eval runner: without it, episodes
        left mid-flight by the previous evaluate() call would finish
        under newly synced weights and blend two policies' returns."""
        self._eval_calls = getattr(self, "_eval_calls", 0) + 1
        obs, _ = self.envs.reset(seed=self.worker_index * 31 + self._eval_calls * 7919)
        self._obs = obs
        self._prev_done[:] = False
        self._episode_returns[:] = 0.0
        self._episode_lens[:] = 0
        target = len(self._completed_returns) + num_episodes
        while len(self._completed_returns) < target:
            self.sample(num_steps=32, explore=explore)
        return self._completed_returns[-num_episodes:]

    def get_metrics(self) -> Dict[str, Any]:
        out = {
            "num_episodes": len(self._completed_returns),
            "episode_return_mean": float(np.mean(self._completed_returns[-100:])) if self._completed_returns else None,
            "episode_len_mean": float(np.mean(self._completed_lens[-100:])) if self._completed_lens else None,
        }
        return out

    def ping(self) -> str:
        return "pong"

    def stop(self):
        self.envs.close()
