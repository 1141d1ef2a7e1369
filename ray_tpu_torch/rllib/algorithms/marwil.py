"""MARWIL — Monotonic Advantage Re-Weighted Imitation Learning
(reference: rllib/algorithms/marwil/marwil.py:543 + the torch learner's
loss: exp(beta * normalized advantage)-weighted log-likelihood plus a
value-function regression on returns-to-go; Wang et al. 2018.  BC is
the beta == 0 special case, which is exactly how the reference derives
its BC algorithm from MARWIL).

Offline-only: the dataset flows through ray_tpu_torch.rllib.offline.OfflineData
(returns-to-go precomputed once, vectorized), and the epoch x minibatch
schedule runs on the learner's device (``cuda`` by default).
"""

from __future__ import annotations

from typing import Any, Dict

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import Learner, LearnerGroup
from ray_tpu_torch.rllib.offline import OfflineData
from ray_tpu_torch.rllib.utils.sample_batch import ACTIONS, OBS, VALUE_TARGETS


class MARWILConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.train_batch_size = 2048
        self.minibatch_size = 256
        self.num_epochs = 1
        self.beta = 1.0          # 0 => plain behavior cloning
        self.vf_coeff = 1.0
        self.max_adv_exponent = 10.0  # clip on beta*adv/norm (stability)
        self.input_: Any = None
        self.num_env_runners = 0

    def offline_data(self, *, input_: Any = None):
        if input_ is not None:
            self.input_ = input_
        return self

    @property
    def algo_class(self):
        return MARWIL


class MARWILLearner(Learner):
    """exp-weighted imitation loss (reference:
    marwil/torch/marwil_torch_learner.py compute_loss_for_module).

    The reference normalizes advantages with a persistent moving average
    of squared advantages; here the normalizer is the batch RMS computed
    inside the loss — every minibatch is a fresh uniform draw from the
    dataset, so the batch RMS is an unbiased estimate of the same
    statistic without extra mutable state."""

    def compute_loss(self, batch: Dict[str, Any]):
        import torch

        beta = self.config.get("beta", 1.0)
        vf_coeff = self.config.get("vf_coeff", 1.0)
        max_exp = self.config.get("max_adv_exponent", 10.0)
        logp, entropy, value = self.module.forward_train(batch[OBS], batch[ACTIONS])
        adv = batch[VALUE_TARGETS] - value
        vf_loss = 0.5 * (adv ** 2).mean()
        if beta == 0.0:
            weights = torch.ones((), device=logp.device)
            policy_loss = -logp.mean()
        else:
            adv_d = adv.detach()
            norm = torch.sqrt((adv_d ** 2).mean() + 1e-8)
            weights = torch.exp(torch.clamp(beta * adv_d / norm, -max_exp, max_exp))
            policy_loss = -(weights * logp).mean()
        loss = policy_loss + vf_coeff * vf_loss
        return loss, {
            "policy_loss": policy_loss.detach(),
            "vf_loss": vf_loss.detach(),
            "mean_adv_weight": weights.mean(),
            "logp": logp.detach().mean(),
            "entropy": entropy.detach().mean(),
        }


class MARWIL(Algorithm):
    config_class = MARWILConfig
    learner_class = MARWILLearner

    def _needs_advantages(self) -> bool:
        return False

    def setup(self, config: Dict[str, Any]):
        cfg = self.algo_config
        self._dataset = OfflineData(cfg.input_, shuffle_seed=cfg.seed)
        self._dataset.ensure_value_targets(cfg.gamma)
        from ray_tpu_torch.rllib.offline.offline_data import module_spec_from_offline

        self.module_spec = module_spec_from_offline(cfg, self._dataset)
        self.learner_group = LearnerGroup(
            MARWILLearner,
            self.module_spec,
            config=self._learner_config(),
            num_learners=cfg.num_learners,
        )
        self._timesteps_total = 0

    def _learner_config(self) -> Dict[str, Any]:
        cfg = self.algo_config
        out = super()._learner_config()
        out.update(
            beta=cfg.beta,
            vf_coeff=cfg.vf_coeff,
            max_adv_exponent=cfg.max_adv_exponent,
        )
        return out

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        batch = self._dataset.sample(min(cfg.train_batch_size, self._dataset.count))
        metrics = self.learner_group.update_from_batch(
            batch, minibatch_size=cfg.minibatch_size, num_epochs=cfg.num_epochs
        )
        self._timesteps_total += batch.count
        metrics["num_env_steps_trained"] = self._timesteps_total
        return metrics

    def cleanup(self):
        self.learner_group.shutdown()

    stop = cleanup
