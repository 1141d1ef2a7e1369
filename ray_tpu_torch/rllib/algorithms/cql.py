"""CQL — Conservative Q-Learning for offline RL (reference:
rllib/algorithms/cql/cql.py:390 + cql_torch_policy's loss: SAC plus a
conservative regularizer that pushes down Q on out-of-distribution
actions and up on dataset actions; Kumar et al. 2020).

Builds on the SAC learner exactly as the reference's CQLConfig extends
SACConfig.  Differences from SAC:
  * purely offline: the dataset flows through
    ray_tpu_torch.rllib.offline.OfflineData — no env interaction, no
    replay buffer (the dataset IS the buffer);
  * critic loss adds min_q_weight * (logsumexp_a Q(s,a) - Q(s,a_data)),
    with the logsumexp estimated over uniform + policy(s) + policy(s')
    action samples, importance-corrected (the reference's num_actions
    sampling in cql_torch_policy);
  * the actor warms up with behavior cloning for the first ``bc_iters``
    updates (reference: cql.py bc_iters) before switching to the SAC
    actor loss; the count of updates is checkpointed, so a resumed run
    stays in its BC phase.

As SAC's, the update takes its noise as tensors: the uniform actions and
the Gaussian draws of the logsumexp's policy samples join SAC's two.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.sac import SAC, SACConfig, SACLearner, _LOG_2PI
from ray_tpu_torch.rllib.offline import OfflineData
from ray_tpu_torch.rllib.utils.sample_batch import (
    ACTIONS,
    NEXT_OBS,
    OBS,
    TERMINATEDS,
    TRUNCATEDS,
)


class CQLConfig(SACConfig):
    def __init__(self):
        super().__init__()
        self.bc_iters = 200
        self.temperature = 1.0
        self.num_actions = 4      # sampled actions per logsumexp source
        self.min_q_weight = 5.0
        self.input_: Any = None
        self.num_env_runners = 0

    def offline_data(self, *, input_: Any = None):
        if input_ is not None:
            self.input_ = input_
        return self

    @property
    def algo_class(self):
        return CQL


class CQLLearner(SACLearner):
    """SAC learner + conservative penalty + BC actor warmup
    (critic/actor/alpha optimizers + polyak sync in one update)."""

    def __init__(self, module_spec, config: Dict[str, Any]):
        super().__init__(module_spec, config)
        self._num_updates = 0

    def _pi_logp_of(self, obs, act_unscaled):
        """log pi(a|s) of GIVEN (already unscaled to (-1,1)) actions
        under the squashed Gaussian — atanh-transform + tanh-Jacobian."""
        mean, log_std = self.pi_net(obs)
        a = torch.clamp(act_unscaled, -0.999999, 0.999999)
        pre_tanh = torch.atanh(a)
        var = torch.exp(2 * log_std)
        logp_gauss = -0.5 * (((pre_tanh - mean) ** 2) / var + 2 * log_std + _LOG_2PI).sum(-1)
        return logp_gauss - torch.log(1 - a ** 2 + 1e-6).sum(-1)

    def draw_noise(self, batch_size: int) -> Dict[str, torch.Tensor]:
        """SAC's two Gaussian draws, and for each logsumexp source (this
        state, the next) ``num_actions`` uniform actions in (-1, 1) and
        the Gaussian draws of as many policy samples a row."""
        noise = super().draw_noise(batch_size)
        rows, adim = batch_size * self.config.get("num_actions", 4), self.spec.action_dim
        for src in ("obs", "next_obs"):  # the reference's rng_cql, rng_cql2
            noise[f"unif_{src}"] = torch.rand((rows, adim), generator=self._gen) * 2.0 - 1.0
            noise[f"pi_{src}"] = self._normal(rows, adim)
        return noise

    def _done(self, b):
        # Truncated boundaries count as done for the TARGET: the recorded
        # dataset has no true next_obs there (ensure_next_obs copies the
        # row's own obs), so bootstrapping from it would bias Q at every
        # episode boundary.
        done = b[TERMINATEDS].float()
        if TRUNCATEDS in b:
            done = torch.clamp(done + b[TRUNCATEDS].float(), 0.0, 1.0)
        return done

    def _sampled_q(self, obs, unif, eps):
        """(B, 2*n_act) importance-corrected Q samples of each critic for
        the logsumexp: uniform actions, then policy samples (the policy
        before this update, its logp without gradient)."""
        n_act, adim = self.config.get("num_actions", 4), self.spec.action_dim
        B = obs.shape[0]
        rep = torch.repeat_interleave(obs, n_act, dim=0)  # (B*n_act, obs_dim)
        with torch.no_grad():
            a_pi, logp_pi = self._pi_sample_logp(rep, eps)
        q1u, q2u = self.q_net(rep, unif)
        q1p, q2p = self.q_net(rep, a_pi)
        log_unif = -adim * math.log(2.0)  # U(-1,1)^adim density

        def corrected(qu, qp):
            return torch.cat([qu.reshape(B, n_act) - log_unif,
                              qp.reshape(B, n_act) - logp_pi.reshape(B, n_act)], dim=1)

        return corrected(q1u, q1p), corrected(q2u, q2p)

    def _critic_loss(self, b, act, target, noise):
        temp = self.config.get("temperature", 1.0)
        min_q_w = self.config.get("min_q_weight", 5.0)
        q1, q2 = self.q_net(b[OBS], act)
        bellman = ((q1 - target) ** 2 + (q2 - target) ** 2).mean() * 0.5
        # conservative term: temp*logsumexp(Q/temp) - Q(s, a_data)
        cat1, cat2 = self._sampled_q(b[OBS], noise["unif_obs"], noise["pi_obs"])
        ncat1, ncat2 = self._sampled_q(b[NEXT_OBS], noise["unif_next_obs"], noise["pi_next_obs"])
        lse1 = temp * torch.logsumexp(torch.cat([cat1, ncat1], dim=1) / temp, dim=1)
        lse2 = temp * torch.logsumexp(torch.cat([cat2, ncat2], dim=1) / temp, dim=1)
        gap = (lse1 - q1).mean() + (lse2 - q2).mean()
        return bellman + min_q_w * gap, {"q_mean": q1.detach().mean(), "cql_gap": gap.detach()}

    def _actor_loss(self, b, act, alpha, noise):
        # BC warmup (alpha*logp - log pi(a_data|s)), then SAC's
        a, logp = self._pi_sample_logp(b[OBS], noise["eps_pi"])
        if self._num_updates < self.config.get("bc_iters", 200):
            return (alpha * logp - self._pi_logp_of(b[OBS], act)).mean(), logp
        q1, q2 = self.q_net(b[OBS], a)
        return (alpha * logp - torch.minimum(q1, q2)).mean(), logp

    def update_from_batch(self, batch, noise=None) -> Dict[str, float]:
        out = super().update_from_batch(batch, noise)
        self._num_updates += 1
        return out

    def get_state(self) -> Dict[str, Any]:
        state = super().get_state()
        state["num_updates"] = self._num_updates
        return state

    def set_state(self, state: Dict[str, Any]):
        super().set_state(state)
        self._num_updates = state.get("num_updates", 0)


class CQL(SAC):
    config_class = CQLConfig
    learner_class = CQLLearner

    def setup(self, config: Dict[str, Any]):
        from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec

        cfg = self.algo_config
        self._dataset = OfflineData(cfg.input_, shuffle_seed=cfg.seed)
        self._dataset.ensure_next_obs()
        acts = np.asarray(self._dataset[ACTIONS], np.float32)
        obs = np.asarray(self._dataset[OBS])
        if acts.ndim == 1:
            acts = acts[:, None]
            self._dataset.batch[ACTIONS] = acts
        self.module_spec = RLModuleSpec(
            observation_dim=int(np.prod(obs.shape[1:])),
            action_dim=int(acts.shape[-1]),
            discrete=False,
            hidden=tuple(cfg.model.get("hidden", (256, 256))),
        )
        lcfg = self._learner_config()
        # action bounds: from the env when given, else the data envelope
        if cfg.env is not None or cfg.env_creator is not None:
            import gymnasium as gym

            probe = cfg.make_env_creator()()
            space = probe.action_space
            if not isinstance(space, gym.spaces.Box):
                probe.close()
                raise ValueError("CQL requires a continuous (Box) action space")
            lcfg["action_low"] = np.asarray(space.low, np.float32)
            lcfg["action_high"] = np.asarray(space.high, np.float32)
            probe.close()
        else:
            lcfg["action_low"] = acts.min(axis=0)
            lcfg["action_high"] = acts.max(axis=0)
        lcfg["hidden"] = tuple(cfg.model.get("hidden", (256, 256)))
        self.learner = CQLLearner(self.module_spec, lcfg)
        self._timesteps_total = 0

    def _learner_config(self) -> Dict[str, Any]:
        cfg = self.algo_config
        out = super()._learner_config()
        out.update(
            bc_iters=cfg.bc_iters,
            temperature=cfg.temperature,
            num_actions=cfg.num_actions,
            min_q_weight=cfg.min_q_weight,
        )
        return out

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        metrics: Dict[str, Any] = {"dataset_size": self._dataset.count}
        for _ in range(cfg.updates_per_iteration):
            batch = self._dataset.sample(min(cfg.train_batch_size, self._dataset.count))
            metrics.update(self.learner.update_from_batch(batch))
        self._timesteps_total += cfg.updates_per_iteration * cfg.train_batch_size
        metrics["num_env_steps_trained"] = self._timesteps_total
        return metrics

    def load_checkpoint(self, checkpoint_dir: str):
        import os
        import pickle

        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"), "rb") as f:
            state = pickle.load(f)
        self.learner.set_state(state["learner"])
        self._timesteps_total = state.get("timesteps_total", 0)

    def cleanup(self):
        pass

    stop = cleanup
