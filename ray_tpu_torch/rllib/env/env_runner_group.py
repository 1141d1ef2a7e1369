"""EnvRunnerGroup (reference: rllib/env/env_runner_group.py:70): manages
remote env-runner actors, weight sync, fault-tolerant sampling."""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner
from ray_tpu_torch.rllib.utils.sample_batch import SampleBatch

logger = logging.getLogger(__name__)


class EnvRunnerGroup:
    def __init__(
        self,
        env_creator: Callable[[], Any],
        module_spec,
        num_env_runners: int = 2,
        num_envs_per_runner: int = 1,
        rollout_fragment_length: int = 200,
        gamma: float = 0.99,
        lambda_: float = 0.95,
        compute_advantages: bool = True,
        num_cpus_per_runner: float = 1,
        restart_failed: bool = True,
        seed: int = 0,
        inference_backend: str = "cpu",
        env_to_module=None,
        module_to_env=None,
        mask_autoreset: bool = True,
    ):
        import ray_tpu_torch

        self._ray = ray_tpu_torch
        self._make_runner_args = dict(
            env_to_module=env_to_module,
            module_to_env=module_to_env,
            mask_autoreset=mask_autoreset,
            env_creator=env_creator,
            module_spec=module_spec,
            num_envs=num_envs_per_runner,
            rollout_fragment_length=rollout_fragment_length,
            gamma=gamma,
            lambda_=lambda_,
            compute_advantages=compute_advantages,
            seed=seed,
            inference_backend=inference_backend,
        )
        self.restart_failed = restart_failed
        self._remote_cls = ray_tpu_torch.remote(num_cpus=num_cpus_per_runner, max_restarts=3)(
            SingleAgentEnvRunner
        )
        self.num_env_runners = num_env_runners
        if num_env_runners == 0:
            self.local_runner = SingleAgentEnvRunner(worker_index=0, **self._make_runner_args)
            self.runners: List[Any] = []
        else:
            self.local_runner = None
            self.runners = [
                self._remote_cls.remote(worker_index=i + 1, **self._make_runner_args)
                for i in range(num_env_runners)
            ]

    def sync_weights(self, weights):
        """Broadcast learner weights (reference: sync_weights; ships one
        object-store copy, not per-actor copies)."""
        if self.local_runner is not None:
            self.local_runner.set_weights(weights)
        if self.runners:
            ref = self._ray.put(weights)
            self._ray.get([r.set_weights.remote(ref) for r in self.runners])

    def sample(self, num_steps_per_runner: Optional[int] = None, explore: bool = True) -> SampleBatch:
        """Synchronous parallel rollouts (reference:
        synchronous_parallel_sample, algorithms/ppo/ppo.py:408)."""
        if self.local_runner is not None:
            return self.local_runner.sample(num_steps_per_runner, explore)
        refs = [r.sample.remote(num_steps_per_runner, explore) for r in self.runners]
        batches, failed = [], []
        for i, ref in enumerate(refs):
            try:
                batches.append(self._ray.get(ref))
            except Exception as e:  # noqa: BLE001 — tolerate lost runners
                logger.warning("env runner %d failed: %s", i, e)
                failed.append(i)
        if failed and self.restart_failed:
            for i in failed:
                self.runners[i] = self._remote_cls.remote(
                    worker_index=i + 1, **self._make_runner_args
                )
        if not batches:
            raise RuntimeError("all env runners failed")
        return SampleBatch.concat_samples(batches)

    def sample_episodes(self, num_episodes: int, explore: bool = False) -> List[float]:
        """Collect episode returns across runners (evaluation path;
        reference: algorithm.py evaluate() duration-splitting across
        eval workers)."""
        if self.local_runner is not None:
            return self.local_runner.sample_episodes(num_episodes, explore)
        per = -(-num_episodes // len(self.runners))  # ceil split
        refs = [r.sample_episodes.remote(per, explore) for r in self.runners]
        returns: List[float] = []
        for i, ref in enumerate(refs):
            try:
                returns.extend(self._ray.get(ref))
            except Exception as e:  # noqa: BLE001 — tolerate lost runners
                logger.warning("eval env runner %d failed: %s", i, e)
        if not returns:
            raise RuntimeError("all evaluation env runners failed")
        return returns[:num_episodes]

    def aggregate_metrics(self) -> Dict[str, Any]:
        if self.local_runner is not None:
            per = [self.local_runner.get_metrics()]
        else:
            per = []
            for r in self.runners:
                try:
                    per.append(self._ray.get(r.get_metrics.remote()))
                except Exception:
                    pass
        returns = [m["episode_return_mean"] for m in per if m.get("episode_return_mean") is not None]
        lens = [m["episode_len_mean"] for m in per if m.get("episode_len_mean") is not None]
        return {
            "num_episodes": sum(m.get("num_episodes", 0) for m in per),
            "episode_return_mean": sum(returns) / len(returns) if returns else None,
            "episode_len_mean": sum(lens) / len(lens) if lens else None,
        }

    def stop(self):
        if self.local_runner is not None:
            self.local_runner.stop()
        for r in self.runners:
            try:
                self._ray.kill(r)
            except Exception:
                pass
        self.runners = []
