"""PPO (reference: rllib/algorithms/ppo/ppo.py:374, training_step :400;
loss parity with rllib/algorithms/ppo/torch/ppo_torch_learner.py —
clipped surrogate + clipped value loss + entropy bonus).

The update runs on the learner's device (``cuda`` by default); rollouts
come from CPU env-runner actors (SURVEY.md §2.5: env runners stay CPU
actors).  The streaming path (``prepare_fragments``, the podracer step)
is ROADMAP Queue A item 5(b) and multi-agent PPO item 5(c)."""

from __future__ import annotations

from typing import Any, Dict

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import PODRACER_ITEM, Learner
from ray_tpu_torch.rllib.utils.postprocessing import standardize
from ray_tpu_torch.rllib.utils.sample_batch import (
    ACTIONS,
    ADVANTAGES,
    LOGP,
    LOSS_MASK,
    OBS,
    VALUE_TARGETS,
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
        raise NotImplementedError(f"PPOLearner.prepare_fragments: {PODRACER_ITEM}")


class PPO(Algorithm):
    config_class = PPOConfig
    learner_class = PPOLearner

    def _learner_config(self) -> Dict[str, Any]:
        cfg = self.algo_config
        out = super()._learner_config()
        out.update(
            clip_param=cfg.clip_param,
            vf_clip_param=cfg.vf_clip_param,
            vf_loss_coeff=cfg.vf_loss_coeff,
            entropy_coeff=cfg.entropy_coeff,
        )
        return out

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
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
