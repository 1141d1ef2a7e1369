"""PPO (reference: rllib/algorithms/ppo/ppo.py:374, training_step :400;
loss parity with rllib/algorithms/ppo/torch/ppo_torch_learner.py —
clipped surrogate + clipped value loss + entropy bonus).

The update runs on the learner's device (``cuda`` by default); rollouts
come from CPU env-runner actors (SURVEY.md §2.5: env runners stay CPU
actors), synchronously or, with ``podracer()``, streamed as fragments
whose GAE the learner computes (``prepare_fragments``).  Multi-agent PPO
updates one learner group a policy, each on the learner's device."""

from __future__ import annotations

from typing import Any, Dict

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import Learner
from ray_tpu_torch.rllib.utils.postprocessing import standardize
from ray_tpu_torch.rllib.utils.sample_batch import (
    ACTIONS,
    ADVANTAGES,
    LOGP,
    LOSS_MASK,
    OBS,
    REWARDS,
    TERMINATEDS,
    TRUNCATEDS,
    VALUE_TARGETS,
    VF_PREDS,
)


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 3e-4
        self.lambda_ = 0.95
        self.clip_param = 0.3
        self.vf_clip_param = 10.0
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.0
        self.kl_coeff = 0.0  # clip-only variant by default (modern PPO)
        self.num_epochs = 8
        self.minibatch_size = 128
        self.train_batch_size = 4000

    @property
    def algo_class(self):
        return PPO


class PPOLearner(Learner):
    def compute_loss(self, batch: Dict[str, Any]):
        import torch

        logp, entropy, value = self.module.forward_train(batch[OBS], batch[ACTIONS])
        ratio = torch.exp(logp - batch[LOGP])
        adv = batch[ADVANTAGES]
        clip = self.config.get("clip_param", 0.3)
        surrogate = torch.minimum(ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv)

        vf_clip = self.config.get("vf_clip_param", 10.0)
        vf_err = torch.clamp((value - batch[VALUE_TARGETS]) ** 2, 0.0, vf_clip ** 2)

        # The synchronous path has no mask — all ones; the reference's
        # streaming fragments carry LOSS_MASK 0 on autoreset rows.
        mask = batch.get(LOSS_MASK)
        if mask is None:
            mask = torch.ones_like(adv)
        denom = mask.sum() + 1e-8
        pi_loss = -(surrogate * mask).sum() / denom
        vf_loss = (vf_err * mask).sum() / denom
        ent = (entropy * mask).sum() / denom
        total = (
            pi_loss
            + self.config.get("vf_loss_coeff", 0.5) * vf_loss
            - self.config.get("entropy_coeff", 0.0) * ent
        )
        metrics = {
            "policy_loss": pi_loss.detach(),
            "vf_loss": vf_loss.detach(),
            "entropy": ent.detach(),
            "mean_kl": (((batch[LOGP] - logp) * mask).sum() / denom).detach(),
        }
        return total, metrics

    def prepare_fragments(self, cols: Dict[str, Any], last_values):
        """GAE over time-major [T, B] fragment columns — the host-side
        per-episode scan + concat + standardize of the synchronous path,
        on the learner's device.  Truncation and termination both cut the
        advantage chain; truncated bootstraps are 0 (the same accepted
        bias as the host path's fragment boundaries).  Its inputs are
        data columns, so its outputs carry no gradient (the reference's
        stop_gradient on the targets)."""
        import torch

        gamma = self.config.get("gamma", 0.99)
        lam = self.config.get("lambda_", 0.95)
        v = cols[VF_PREDS]
        r = cols[REWARDS]
        done = torch.clamp(cols[TERMINATEDS].float() + cols[TRUNCATEDS].float(), 0.0, 1.0)
        valid = cols[LOSS_MASK] if LOSS_MASK in cols else torch.ones_like(r)
        next_v = torch.cat([v[1:], last_values[None]], dim=0) * (1.0 - done)
        deltas = r + gamma * next_v - v
        acc = torch.zeros_like(v[0])
        adv = torch.empty_like(v)
        for t in range(r.shape[0] - 1, -1, -1):
            acc = deltas[t] + gamma * lam * (1.0 - done[t]) * acc
            adv[t] = acc
        targets = adv + v
        denom = valid.sum() + 1e-8
        mean = (adv * valid).sum() / denom
        var = (((adv - mean) ** 2) * valid).sum() / denom
        adv = (adv - mean) / torch.clamp(torch.sqrt(var), min=1e-8)
        return {
            OBS: cols[OBS],
            ACTIONS: cols[ACTIONS],
            LOGP: cols[LOGP],
            ADVANTAGES: adv,
            VALUE_TARGETS: targets,
            LOSS_MASK: valid,
        }


class PPO(Algorithm):
    config_class = PPOConfig
    learner_class = PPOLearner
    supports_multi_agent = True

    def _learner_config(self) -> Dict[str, Any]:
        cfg = self.algo_config
        out = super()._learner_config()
        out.update(
            clip_param=cfg.clip_param,
            vf_clip_param=cfg.vf_clip_param,
            vf_loss_coeff=cfg.vf_loss_coeff,
            entropy_coeff=cfg.entropy_coeff,
            lambda_=cfg.lambda_,  # GAE on the streaming path
        )
        return out

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        if cfg.is_multi_agent:
            return self._multi_agent_training_step()
        if cfg.podracer_enabled:
            return self._podracer_step()
        # ① synchronous parallel rollouts (ppo.py:408)
        runners = max(1, cfg.num_env_runners)
        per_runner = max(1, cfg.train_batch_size // (runners * cfg.num_envs_per_env_runner))
        batch = self.env_runner_group.sample(per_runner)
        self._timesteps_total += batch.count
        batch[ADVANTAGES] = standardize(batch[ADVANTAGES])
        # ② minibatch SGD epochs on the learner (ppo.py:439)
        metrics = self.learner_group.update_from_batch(
            batch, minibatch_size=cfg.minibatch_size, num_epochs=cfg.num_epochs
        )
        # ③ broadcast fresh weights (ppo.py:466)
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        out = dict(metrics)
        out["num_env_steps_sampled"] = batch.count
        return out

    def _podracer_step(self) -> Dict[str, Any]:
        """Streaming PPO: a FIXED count of fragments per update (static
        (K, T, N) shapes), GAE/standardize/concat and the epoch x
        minibatch schedule on the learner's device, weights published
        back generation-tagged without stalling runners."""
        cfg = self.algo_config
        drv = self._podracer
        per_frag = cfg.rollout_fragment_length * cfg.num_envs_per_env_runner
        k = max(1, round(cfg.train_batch_size / per_frag))
        frags = drv.collect(k)
        metrics = self.learner_group.update_from_fragments(
            frags, minibatch_size=cfg.minibatch_size, num_epochs=cfg.num_epochs
        )
        drv.after_update()
        steps = sum(int(f["env_steps"]) for f in frags)
        self._timesteps_total += steps
        out = dict(metrics)
        out["num_env_steps_sampled"] = steps
        out.update(drv.metrics())
        return out

    def _multi_agent_training_step(self) -> Dict[str, Any]:
        """Per-policy PPO epochs over each policy's share of the joint
        rollout (reference: multi-agent training_step — one Learner per
        policy, sync weight fan-out keyed by policy id)."""
        cfg = self.algo_config
        runners = max(1, cfg.num_env_runners)
        per_runner = max(1, cfg.train_batch_size // runners)
        batches = self.env_runner_group.sample(per_runner)
        out: Dict[str, Any] = {}
        steps = 0
        for pid, batch in batches.items():
            steps += batch.count
            batch[ADVANTAGES] = standardize(batch[ADVANTAGES])
            metrics = self.learner_groups[pid].update_from_batch(
                batch, minibatch_size=cfg.minibatch_size, num_epochs=cfg.num_epochs
            )
            out[pid] = metrics
        self._timesteps_total += steps
        self.env_runner_group.sync_weights(
            {pid: lg.get_weights() for pid, lg in self.learner_groups.items()}
        )
        out["num_env_steps_sampled"] = steps
        return out
