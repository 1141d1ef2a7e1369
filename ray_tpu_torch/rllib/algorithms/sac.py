"""SAC — Soft Actor-Critic (reference: rllib/algorithms/sac/sac.py +
sac_torch_learner losses: twin-Q soft targets, squashed-Gaussian policy,
auto-tuned entropy temperature; Haarnoja et al. 2018).

The update runs on the learner's device (``cuda`` by default) in the
reference's order: the critics step, the actor's loss reads the UPDATED
critics, alpha's loss reads the actor's logp, then Polyak averaging moves
the target critics.  Three Adams: the policy, the critics and the scalar
``log_alpha``.

The reference draws its Gaussian noise inside the jitted update; here the
update takes its noise as tensors (``noise=``), and ``update_from_batch``
draws them from the learner's ``torch.Generator`` in one place when the
caller passes none.  The function is the same; only the source of the
noise differs."""

from __future__ import annotations

import copy
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import batch_tensor, learner_device
from ray_tpu_torch.rllib.core.rl_module import _init_params, load_weights, weights_of
from ray_tpu_torch.rllib.utils.replay_buffers import ReplayBuffer
from ray_tpu_torch.rllib.utils.sample_batch import (
    ACTIONS,
    NEXT_OBS,
    OBS,
    REWARDS,
    SampleBatch,
    TERMINATEDS,
)

_LOG_2PI = math.log(2 * math.pi)


class SACConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 3e-4  # shared by actor/critic/alpha (reference defaults differ per-opt)
        self.tau = 0.005
        self.initial_alpha = 1.0
        self.target_entropy = "auto"  # -action_dim for continuous
        self.train_batch_size = 256
        self.replay_buffer_capacity = 100_000
        self.num_steps_sampled_before_learning_starts = 1000
        self.rollout_fragment_length = 1
        self.num_env_runners = 0
        self.sample_batch_size = 64
        self.updates_per_iteration = 32
        self.n_step = 1

    @property
    def algo_class(self):
        return SAC


class _SquashedGaussianPi(nn.Module):
    """tanh-squashed Gaussian policy head (``pi_dense_*``, ``pi_mean``,
    ``pi_log_std``, the reference's flax names); ``log_std`` clipped to
    [-20, 2]."""

    def __init__(self, obs_dim: int, hidden: tuple, action_dim: int):
        super().__init__()
        self.hidden = tuple(hidden)
        width = obs_dim
        for i, w in enumerate(self.hidden):
            self.add_module(f"pi_dense_{i}", nn.Linear(width, w))
            width = w
        self.pi_mean = nn.Linear(width, action_dim)
        self.pi_log_std = nn.Linear(width, action_dim)

    def forward(self, obs):
        h = obs.reshape(obs.shape[0], -1)
        for i in range(len(self.hidden)):
            h = torch.relu(getattr(self, f"pi_dense_{i}")(h))
        return self.pi_mean(h), torch.clamp(self.pi_log_std(h), -20.0, 2.0)


class _TwinQ(nn.Module):
    """Two independent Q(s, a) critics (``q1_*``, ``q2_*``) in one call."""

    def __init__(self, obs_dim: int, action_dim: int, hidden: tuple):
        super().__init__()
        self.hidden = tuple(hidden)
        for tag in ("q1", "q2"):
            width = obs_dim + action_dim
            for i, w in enumerate(self.hidden):
                self.add_module(f"{tag}_dense_{i}", nn.Linear(width, w))
                width = w
            self.add_module(f"{tag}_out", nn.Linear(width, 1))

    def forward(self, obs, act):
        x = torch.cat([obs.reshape(obs.shape[0], -1), act], dim=-1)

        def q(tag):
            h = x
            for i in range(len(self.hidden)):
                h = torch.relu(getattr(self, f"{tag}_dense_{i}")(h))
            return getattr(self, f"{tag}_out")(h)[..., 0]

        return q("q1"), q("q2")


class SACLearner:
    """Owns the policy, the twin critics, their target and ``log_alpha``
    on the learner's device; one update steps all three Adams.

    Not a `Learner` subclass: SAC's three-optimizer, target-network
    update doesn't fit the single-loss template (same reason the
    reference gives SAC its own learner class)."""

    def __init__(self, module_spec, config: Dict[str, Any]):
        self.config = config
        self.spec = module_spec
        if module_spec.discrete:
            raise ValueError(
                "SACLearner is continuous-action; discrete SAC is not implemented "
                "(reference SAC's primary domain is continuous control)"
            )
        self.device = learner_device(config.get("device", "cuda"))
        self._gen = torch.Generator().manual_seed(int(config.get("seed", 0)))
        adim, hidden = module_spec.action_dim, tuple(config.get("hidden", (256, 256)))
        self.pi_net = _SquashedGaussianPi(module_spec.observation_dim, hidden, adim)
        self.q_net = _TwinQ(module_spec.observation_dim, adim, hidden)
        _init_params(self.pi_net, self._gen)
        _init_params(self.q_net, self._gen)
        self.pi_net.to(self.device)
        self.q_net.to(self.device)
        self.target_q = copy.deepcopy(self.q_net).requires_grad_(False)
        self.log_alpha = torch.tensor(math.log(config.get("initial_alpha", 1.0)),
                                      device=self.device, requires_grad=True)
        te = config.get("target_entropy", "auto")
        self.target_entropy = float(-adim if te == "auto" else te)

        lr = config.get("lr", 3e-4)
        # optax.adam's defaults; torch's Adam takes the same step
        self.pi_opt = torch.optim.Adam(self.pi_net.parameters(), lr=lr, eps=1e-8)
        self.q_opt = torch.optim.Adam(self.q_net.parameters(), lr=lr, eps=1e-8)
        self.alpha_opt = torch.optim.Adam([self.log_alpha], lr=lr, eps=1e-8)
        self._metrics: Dict[str, float] = {}
        # Action bounds for rescaling tanh outputs (set from the env).
        self.action_low = np.asarray(config.get("action_low", -1.0), np.float32)
        self.action_high = np.asarray(config.get("action_high", 1.0), np.float32)
        self._low = torch.as_tensor(self.action_low).to(self.device)
        self._high = torch.as_tensor(self.action_high).to(self.device)

    # -- squashed-Gaussian math -----------------------------------------
    def _pi_sample_logp(self, obs, eps):
        """Squashed sample ``tanh(mean + std * eps)`` and its logp with
        the tanh correction (SAC appendix C); ``eps`` is standard normal
        noise of the action's shape."""
        mean, log_std = self.pi_net(obs)
        a = torch.tanh(mean + torch.exp(log_std) * eps)
        logp_gauss = -0.5 * (eps ** 2 + 2 * log_std + _LOG_2PI).sum(-1)
        logp = logp_gauss - torch.log(1 - a ** 2 + 1e-6).sum(-1)
        return a, logp

    def _scale(self, a):
        low, high = self._low, self._high
        return low + (a + 1.0) * 0.5 * (high - low)

    def _unscale(self, env_a):
        low, high = self._low, self._high
        return torch.clamp(2.0 * (env_a - low) / (high - low) - 1.0, -0.999999, 0.999999)

    def _normal(self, *shape):
        return torch.randn(shape, generator=self._gen)

    # -- update ---------------------------------------------------------
    def draw_noise(self, batch_size: int) -> Dict[str, torch.Tensor]:
        """One update's noise: the next state's and the actor's Gaussian
        draws (the reference's ``rng_next`` and ``rng_pi``)."""
        adim = self.spec.action_dim
        return {"eps_next": self._normal(batch_size, adim), "eps_pi": self._normal(batch_size, adim)}

    def _rows(self, batch) -> Dict[str, torch.Tensor]:
        return {k: batch_tensor(v, self.device) for k, v in batch.items() if k != "batch_indexes"}

    def _done(self, b: Dict[str, torch.Tensor]) -> torch.Tensor:
        return b[TERMINATEDS].float()

    def _critic_loss(self, b, act, target, noise):
        q1, q2 = self.q_net(b[OBS], act)
        loss = ((q1 - target) ** 2 + (q2 - target) ** 2).mean() * 0.5
        return loss, {"q_mean": q1.detach().mean()}

    def _actor_loss(self, b, act, alpha, noise):
        a, logp = self._pi_sample_logp(b[OBS], noise["eps_pi"])
        q1, q2 = self.q_net(b[OBS], a)
        return (alpha * logp - torch.minimum(q1, q2)).mean(), logp

    def _update(self, b: Dict[str, torch.Tensor], noise: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        gamma = self.config.get("gamma", 0.99)
        tau = self.config.get("tau", 0.005)
        alpha = torch.exp(self.log_alpha.detach())
        act = self._unscale(b[ACTIONS])
        # critic: soft Bellman target via the target twins (no gradient)
        with torch.no_grad():
            next_a, next_logp = self._pi_sample_logp(b[NEXT_OBS], noise["eps_next"])
            tq1, tq2 = self.target_q(b[NEXT_OBS], next_a)
            target = b[REWARDS] + gamma * (1.0 - self._done(b)) * (
                torch.minimum(tq1, tq2) - alpha * next_logp)
        self.q_opt.zero_grad(set_to_none=True)
        q_loss, q_metrics = self._critic_loss(b, act, target, noise)
        q_loss.backward()
        self.q_opt.step()
        # actor: alpha*logp - minQ(s, pi(s)) on the updated critics
        self.pi_opt.zero_grad(set_to_none=True)
        self.q_net.requires_grad_(False)
        try:
            pi_loss, logp = self._actor_loss(b, act, alpha, noise)
            pi_loss.backward()
        finally:
            self.q_net.requires_grad_(True)
        self.pi_opt.step()
        # temperature: drive policy entropy toward target_entropy
        logp = logp.detach()
        self.alpha_opt.zero_grad(set_to_none=True)
        alpha_loss = -(torch.exp(self.log_alpha) * (logp + self.target_entropy)).mean()
        alpha_loss.backward()
        self.alpha_opt.step()
        # polyak target sync
        with torch.no_grad():
            for t, o in zip(self.target_q.parameters(), self.q_net.parameters()):
                t.copy_((1.0 - tau) * t + tau * o)
        return {"critic_loss": q_loss.detach(), "actor_loss": pi_loss.detach(),
                "alpha_loss": alpha_loss.detach(), "alpha": torch.exp(self.log_alpha.detach()),
                **q_metrics, "entropy": -logp.mean()}

    def update_from_batch(self, batch, noise: Optional[Dict[str, Any]] = None) -> Dict[str, float]:
        """One update on ``batch``; ``noise`` (``draw_noise``'s keys) comes
        from the learner's generator when not given."""
        b = self._rows(batch)
        if noise is None:
            noise = self.draw_noise(len(b[OBS]))
        noise = {k: batch_tensor(v, self.device) for k, v in noise.items()}
        metrics = self._update(b, noise)
        self._metrics = {k: float(v) for k, v in metrics.items()}
        return self._metrics

    # -- acting ---------------------------------------------------------
    def sample_actions(self, obs) -> np.ndarray:
        """Stochastic env-scale actions for ``obs``, noise from the
        learner's generator."""
        with torch.no_grad():
            obs = torch.as_tensor(np.asarray(obs, np.float32)).to(self.device)
            eps = self._normal(obs.shape[0], self.spec.action_dim).to(self.device)
            a, _ = self._pi_sample_logp(obs, eps)
            return self._scale(a).cpu().numpy()

    def mean_actions(self, obs) -> np.ndarray:
        """Deterministic env-scale actions: tanh of the Gaussian mean."""
        with torch.no_grad():
            mean, _ = self.pi_net(torch.as_tensor(np.asarray(obs, np.float32)).to(self.device))
            return self._scale(torch.tanh(mean)).cpu().numpy()

    # -- state ----------------------------------------------------------
    def get_state(self) -> Dict[str, Any]:
        return {
            "pi": weights_of(self.pi_net),
            "q": weights_of(self.q_net),
            "target_q": weights_of(self.target_q),
            "log_alpha": self.log_alpha.detach().cpu().numpy().copy(),
            "config": self.config,
        }

    def set_state(self, state: Dict[str, Any]):
        load_weights(self.pi_net, state["pi"])
        load_weights(self.q_net, state["q"])
        load_weights(self.target_q, state["target_q"])
        with torch.no_grad():
            self.log_alpha.fill_(float(state["log_alpha"]))

    def metrics(self) -> Dict[str, float]:
        return self._metrics


class SAC(Algorithm):
    config_class = SACConfig
    learner_class = SACLearner

    def _needs_advantages(self) -> bool:
        return False

    def setup(self, config: Dict[str, Any]):
        import gymnasium as gym

        from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec

        cfg = self.algo_config
        env_creator = cfg.make_env_creator()
        probe = env_creator()
        self.module_spec = RLModuleSpec.from_gym_env(
            probe, hidden=tuple(cfg.model.get("hidden", (256, 256)))
        )
        act_space = probe.action_space
        if not isinstance(act_space, gym.spaces.Box):
            probe.close()
            raise ValueError("SAC requires a continuous (Box) action space")
        lcfg = self._learner_config()
        lcfg["action_low"] = np.asarray(act_space.low, np.float32)
        lcfg["action_high"] = np.asarray(act_space.high, np.float32)
        lcfg["hidden"] = tuple(cfg.model.get("hidden", (256, 256)))
        probe.close()
        self.learner = type(self).learner_class(self.module_spec, lcfg)
        self.sampler = _SACSampler(env_creator, self.learner, cfg)
        self.buffer = ReplayBuffer(cfg.replay_buffer_capacity, seed=cfg.seed)
        self._timesteps_total = 0

    def _learner_config(self) -> Dict[str, Any]:
        cfg = self.algo_config
        return {
            "lr": cfg.lr,
            "gamma": cfg.gamma,
            "tau": cfg.tau,
            "initial_alpha": cfg.initial_alpha,
            "target_entropy": cfg.target_entropy,
            "seed": cfg.seed,
            "device": cfg.learner_device,
        }

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        batch = self.sampler.sample(cfg.sample_batch_size)
        self.buffer.add(batch)
        self._timesteps_total += batch.count
        metrics: Dict[str, Any] = {"buffer_size": len(self.buffer)}
        if self._timesteps_total >= cfg.num_steps_sampled_before_learning_starts:
            for _ in range(cfg.updates_per_iteration):
                metrics.update(self.learner.update_from_batch(self.buffer.sample(cfg.train_batch_size)))
        metrics["num_env_steps_sampled"] = self._timesteps_total
        rets = self.sampler.completed_returns[-100:]
        metrics["episode_return_mean"] = float(np.mean(rets)) if rets else None
        return metrics

    def evaluate(self) -> Dict[str, Any]:
        """Deterministic (tanh of the Gaussian mean) rollouts — the
        squashed-Gaussian learner is not an RLModule, so the base
        eval-runner path doesn't apply."""
        cfg = self.algo_config
        from ray_tpu_torch.rllib.utils.evaluation import greedy_eval

        act = lambda obs: self.learner.mean_actions(obs[None])[0]  # noqa: E731
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
        # resume the warmup/exploration counter with the run
        self.sampler._collector.t = self._timesteps_total

    def get_policy_weights(self):
        return self.learner.get_state()["pi"]

    def cleanup(self):
        self.sampler.envs.close()

    stop = cleanup


class _SACSampler:
    """Inline off-policy collector: stochastic squashed-Gaussian actions
    (uniform random before learning starts, reference sac.py warmup);
    transition collection delegated to the shared VectorEnvCollector."""

    def __init__(self, env_creator, learner: SACLearner, cfg: SACConfig):
        import gymnasium as gym

        from ray_tpu_torch.rllib.utils.collector import VectorEnvCollector

        self.envs = gym.vector.SyncVectorEnv(
            [env_creator for _ in range(cfg.num_envs_per_env_runner)]
        )
        self.learner = learner
        self._warmup = cfg.num_steps_sampled_before_learning_starts
        self._np_rng = np.random.default_rng(cfg.seed + 2)
        self._collector = VectorEnvCollector(self.envs, seed=cfg.seed)

    @property
    def completed_returns(self):
        return self._collector.completed_returns

    @property
    def completed_lens(self):
        return self._collector.completed_lens

    def sample(self, num_steps: int) -> SampleBatch:
        space = self.envs.single_action_space

        def act(obs, t):
            if t < self._warmup:
                return self._np_rng.uniform(
                    space.low, space.high, (self.envs.num_envs,) + space.shape
                ).astype(np.float32)
            return self.learner.sample_actions(obs)

        return self._collector.collect(num_steps, act)
