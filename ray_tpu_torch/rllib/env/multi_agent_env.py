"""Multi-agent environments + runner (reference:
rllib/env/multi_agent_env.py MultiAgentEnv and
rllib/env/multi_agent_env_runner.py MultiAgentEnvRunner).

Dict-keyed protocol: reset/step speak per-agent dicts; agents may appear
and disappear between steps (turn-based games); "__all__" in the
terminated/truncated dicts ends the episode for everyone.  Policies map
onto agents through ``policy_mapping_fn`` and each policy trains on the
concatenation of its agents' trajectories (reference: shared-policy
batching in multi_agent_episode.py).

The env half is the reference's.  The runner infers with the port's
RLModules on ``inference_backend`` (``"cpu"``, the default, or ``"cuda"``,
which raises without a card; nothing falls back), one intra-op thread a
``sample`` call as the single-agent runner, and draws its actions from a
``torch.Generator`` seeded as the reference's key."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ray_tpu_torch.rllib.utils import postprocessing
from ray_tpu_torch.rllib.utils.sample_batch import (
    ACTIONS,
    EPS_ID,
    LOGP,
    OBS,
    REWARDS,
    SampleBatch,
    TERMINATEDS,
    TRUNCATEDS,
    VF_PREDS,
)


class MultiAgentEnv:
    """Base class (reference: multi_agent_env.py:36).

    Subclasses define:
      possible_agents: List[str]
      observation_spaces / action_spaces: Dict[agent_id, gym.Space]
      reset() -> (obs_dict, info_dict)
      step(action_dict) -> (obs, rewards, terminateds, truncateds, infos)
        where terminateds/truncateds carry per-agent flags plus "__all__".
    """

    possible_agents: List[str] = []
    observation_spaces: Dict[str, Any] = {}
    action_spaces: Dict[str, Any] = {}

    def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None):
        raise NotImplementedError

    def step(self, action_dict: Dict[str, Any]):
        raise NotImplementedError

    def close(self):
        pass

    # reference helpers
    def observation_space_for(self, agent_id: str):
        return self.observation_spaces[agent_id]

    def action_space_for(self, agent_id: str):
        return self.action_spaces[agent_id]


class MultiAgentEnvRunner:
    """Samples one MultiAgentEnv, routing each agent through its policy
    (reference: multi_agent_env_runner.py:60 sample()).

    Returns Dict[policy_id, SampleBatch]; each policy's batch is the
    concat of its agents' episode fragments with GAE columns attached."""

    def __init__(
        self,
        env_creator: Callable[[], MultiAgentEnv],
        module_specs: Dict[str, Any],  # policy_id -> RLModuleSpec
        policy_mapping_fn: Callable[[str], str],
        rollout_fragment_length: int = 200,
        gamma: float = 0.99,
        lambda_: float = 0.95,
        worker_index: int = 0,
        seed: int = 0,
        inference_backend: str = "cpu",
    ):
        import torch

        from ray_tpu_torch._private.device import resolve_device

        if inference_backend not in ("cpu", "cuda"):
            raise ValueError(f"inference_backend must be 'cpu' or 'cuda', got {inference_backend!r}")
        self._device = resolve_device(inference_backend)
        self.env = env_creator()
        self.policy_mapping_fn = policy_mapping_fn
        self.fragment_length = rollout_fragment_length
        self.gamma = gamma
        self.lambda_ = lambda_
        self.worker_index = worker_index
        self.modules = {pid: spec.build().to(self._device).eval()
                        for pid, spec in module_specs.items()}
        self._weights_set = False
        # action sampling draws from a generator of the inference device
        self._gen = torch.Generator(device=self._device).manual_seed(seed * 100003 + worker_index)
        self._obs, _ = self.env.reset(seed=seed * 17 + worker_index)
        self._eps_seq = worker_index * 1_000_000
        self._episode_return = 0.0
        self._episode_len = 0
        self.completed_returns: List[float] = []
        self.completed_lens: List[int] = []

    def set_weights(self, weights: Dict[str, Any]):
        for pid, w in weights.items():
            self.modules[pid].set_weights(w)
        self._weights_set = True

    def _explore(self, pid: str, obs):
        a, logp, v = self.modules[pid].forward_exploration(obs[None], self._gen)
        return a.cpu().numpy(), logp.cpu().numpy(), v.cpu().numpy()

    def _infer(self, pid: str, obs):
        a, v = self.modules[pid].forward_inference(obs[None])
        return a.cpu().numpy(), v.cpu().numpy()

    def sample(self, num_steps: Optional[int] = None, explore: bool = True) -> Dict[str, SampleBatch]:
        import torch

        assert self._weights_set, "set_weights before sampling"
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            with torch.no_grad():
                return self._sample(num_steps, explore)
        finally:
            torch.set_num_threads(threads)

    def _sample(self, num_steps: Optional[int], explore: bool) -> Dict[str, SampleBatch]:
        steps = num_steps or self.fragment_length
        # per-agent column logs for the current episode fragment
        agent_cols: Dict[str, Dict[str, list]] = {}

        def cols_for(agent):
            if agent not in agent_cols:
                agent_cols[agent] = {k: [] for k in
                    (OBS, ACTIONS, REWARDS, TERMINATEDS, TRUNCATEDS, LOGP, VF_PREDS, EPS_ID)}
            return agent_cols[agent]

        per_policy_frags: Dict[str, List[SampleBatch]] = {}

        def flush_agent(agent, last_value: float, terminated: bool):
            """Close an agent's fragment: GAE + route to its policy."""
            cols = agent_cols.pop(agent, None)
            if not cols or not cols[OBS]:
                return
            frag = SampleBatch({k: np.asarray(v) for k, v in cols.items()})
            frag[TERMINATEDS][-1] = terminated or frag[TERMINATEDS][-1]
            frag = postprocessing.compute_gae(
                frag, 0.0 if terminated else last_value, self.gamma, self.lambda_
            )
            pid = self.policy_mapping_fn(agent)
            per_policy_frags.setdefault(pid, []).append(frag)

        for _ in range(steps):
            actions: Dict[str, Any] = {}
            step_info: Dict[str, tuple] = {}
            for agent, obs in self._obs.items():
                pid = self.policy_mapping_fn(agent)
                if explore:
                    a, logp, v = self._explore(pid, obs)
                else:
                    a, v = self._infer(pid, obs)
                    logp = np.zeros((1,), np.float32)
                a = a[0]
                actions[agent] = int(a) if self.modules[pid].spec.discrete else a
                step_info[agent] = (obs, a, float(np.asarray(logp)[0]), float(np.asarray(v)[0]))
            next_obs, rewards, terms, truncs, _ = self.env.step(actions)
            done_all = terms.get("__all__", False) or truncs.get("__all__", False)
            for agent, (obs, a, logp, v) in step_info.items():
                cols = cols_for(agent)
                cols[OBS].append(obs)
                cols[ACTIONS].append(a)
                cols[REWARDS].append(np.float32(rewards.get(agent, 0.0)))
                cols[TERMINATEDS].append(bool(terms.get(agent, False)))
                cols[TRUNCATEDS].append(bool(truncs.get(agent, False)))
                cols[LOGP].append(np.float32(logp))
                cols[VF_PREDS].append(np.float32(v))
                cols[EPS_ID].append(np.int64(self._eps_seq))
            self._episode_return += float(sum(rewards.values()))
            self._episode_len += 1

            def bootstrap(agent):
                """Value of the agent's final observation — agents cut
                off without terminating (truncation, or a peer ending
                the episode via __all__) still have return-to-go."""
                obs = next_obs.get(agent)
                if obs is None:
                    return 0.0
                _, v = self._infer(self.policy_mapping_fn(agent), obs)
                return float(v[0])

            # agents that terminated individually leave the episode
            for agent in list(step_info):
                if terms.get(agent, False):
                    flush_agent(agent, 0.0, True)
                elif truncs.get(agent, False):
                    flush_agent(agent, bootstrap(agent), False)
            if done_all:
                for agent in list(agent_cols):
                    terminated = terms.get(agent, False)
                    flush_agent(
                        agent, 0.0 if terminated else bootstrap(agent), terminated
                    )
                self.completed_returns.append(self._episode_return)
                self.completed_lens.append(self._episode_len)
                self._episode_return, self._episode_len = 0.0, 0
                self._eps_seq += 1
                self._obs, _ = self.env.reset()
            else:
                self._obs = {a: o for a, o in next_obs.items()}

        # close still-open fragments with bootstrapped values
        for agent in list(agent_cols):
            obs = self._obs.get(agent)
            if obs is None:
                flush_agent(agent, 0.0, False)
                continue
            _, v = self._infer(self.policy_mapping_fn(agent), obs)
            flush_agent(agent, float(v[0]), False)

        return {
            pid: SampleBatch.concat_samples(frags)
            for pid, frags in per_policy_frags.items()
        }

    def get_metrics(self) -> Dict[str, Any]:
        return {
            "num_episodes": len(self.completed_returns),
            "episode_return_mean": float(np.mean(self.completed_returns[-100:]))
            if self.completed_returns
            else None,
            "episode_len_mean": float(np.mean(self.completed_lens[-100:]))
            if self.completed_lens
            else None,
        }

    def ping(self) -> str:
        return "pong"

    def stop(self):
        self.env.close()


class MultiAgentEnvRunnerGroup:
    """EnvRunnerGroup-compatible surface over MultiAgentEnvRunner actors;
    sample() returns Dict[policy_id, SampleBatch] merged across runners."""

    def __init__(
        self,
        env_creator,
        module_specs: Dict[str, Any],
        policy_mapping_fn,
        num_env_runners: int = 2,
        rollout_fragment_length: int = 200,
        gamma: float = 0.99,
        lambda_: float = 0.95,
        num_cpus_per_runner: float = 1,
        seed: int = 0,
        inference_backend: str = "cpu",
    ):
        import ray_tpu_torch

        self._ray = ray_tpu_torch
        args = dict(
            env_creator=env_creator,
            module_specs=module_specs,
            policy_mapping_fn=policy_mapping_fn,
            rollout_fragment_length=rollout_fragment_length,
            gamma=gamma,
            lambda_=lambda_,
            seed=seed,
            inference_backend=inference_backend,
        )
        self.num_env_runners = num_env_runners
        if num_env_runners == 0:
            self.local_runner = MultiAgentEnvRunner(worker_index=0, **args)
            self.runners: List[Any] = []
        else:
            self.local_runner = None
            remote_cls = ray_tpu_torch.remote(num_cpus=num_cpus_per_runner, max_restarts=3)(
                MultiAgentEnvRunner
            )
            self.runners = [
                remote_cls.remote(worker_index=i + 1, **args)
                for i in range(num_env_runners)
            ]

    def sync_weights(self, weights: Dict[str, Any]):
        if self.local_runner is not None:
            self.local_runner.set_weights(weights)
        if self.runners:
            ref = self._ray.put(weights)
            self._ray.get([r.set_weights.remote(ref) for r in self.runners])

    def sample(self, num_steps_per_runner: Optional[int] = None, explore: bool = True) -> Dict[str, SampleBatch]:
        if self.local_runner is not None:
            return self.local_runner.sample(num_steps_per_runner, explore)
        refs = [r.sample.remote(num_steps_per_runner, explore) for r in self.runners]
        merged: Dict[str, List[SampleBatch]] = {}
        for ref in refs:
            for pid, b in self._ray.get(ref).items():
                merged.setdefault(pid, []).append(b)
        return {pid: SampleBatch.concat_samples(bs) for pid, bs in merged.items()}

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
