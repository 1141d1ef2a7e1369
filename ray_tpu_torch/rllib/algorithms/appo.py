"""APPO — Asynchronous PPO (reference: rllib/algorithms/appo/appo.py +
appo_torch_learner: IMPALA's async actor-learner architecture with PPO's
clipped surrogate computed on V-trace advantages, plus a periodically
synced target policy for the KL/clipping anchor).

Inherits IMPALA's pipeline (learner thread, bounded queue, broadcast
interval); only the loss and the target-network bookkeeping differ.  The
target policy is a copy of the module's parameters (``old_params``, its
own tensors, which the optimizer's in-place steps never touch); its
``logp`` is computed without autograd outside the loss and rides in the
batch as a column.  On the streaming path (``update_from_fragments``) the
learner takes IMPALA's ``fragment_loss``, as the reference's does."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ray_tpu_torch.rllib.algorithms.impala import (
    IMPALA,
    IMPALAConfig,
    IMPALALearner,
    vtrace_discounts_and_mask,
    vtrace_returns,
)
from ray_tpu_torch.rllib.utils.sample_batch import (
    ACTIONS,
    LOGP,
    OBS,
    REWARDS,
)


class APPOConfig(IMPALAConfig):
    def __init__(self):
        super().__init__()
        self.clip_param = 0.4
        self.use_kl_loss = False
        self.kl_coeff = 1.0
        self.kl_target = 0.01
        self.target_network_update_freq = 2  # learner batches

    @property
    def algo_class(self):
        return APPO


class APPOLearner(IMPALALearner):
    """Clipped-surrogate V-trace loss (reference: appo_torch_learner
    compute_loss_for_module)."""

    def __init__(self, module_spec, config=None):
        super().__init__(module_spec, config)
        self.old_params = self._copy_params()
        self._batches_since_target_sync = 0

    def _copy_params(self) -> Dict[str, Any]:
        """The target policy: a copy of every parameter and buffer, not an
        alias of the tensors the optimizer steps in place."""
        return {k: v.detach().clone() for k, v in self.module.state_dict().items()}

    def compute_loss(self, batch: Dict[str, Any]):
        import torch

        cfg = self.config
        clip = cfg.get("clip_param", 0.4)
        logp, entropy, values = self.module.forward_train(batch[OBS], batch[ACTIONS])
        discounts, mask = vtrace_discounts_and_mask(batch, cfg.get("gamma", 0.99))
        # Two-policy decomposition (reference appo_torch_learner):
        # V-trace corrects behaviour->TARGET staleness (its clipped-rho is
        # already inside pg_adv); the PPO clip then anchors on the slowly
        # moving target policy, ratio = pi_current / pi_target.
        target_logp = batch["target_logp"]
        vs, pg_adv, rhos = vtrace_returns(
            target_logp, batch[LOGP], values, batch[REWARDS], discounts,
            cfg.get("vtrace_clip_rho", 1.0), cfg.get("vtrace_clip_c", 1.0),
        )
        ratio = torch.exp(logp - target_logp)
        surrogate = torch.minimum(ratio * pg_adv, torch.clamp(ratio, 1 - clip, 1 + clip) * pg_adv)
        denom = mask.sum() + 1e-8
        pi_loss = -(surrogate * mask).sum() / denom
        vf_loss = 0.5 * (((values - vs) ** 2) * mask).sum() / denom
        ent = (entropy * mask).sum() / denom
        total = (
            pi_loss
            + cfg.get("vf_loss_coeff", 0.5) * vf_loss
            - cfg.get("entropy_coeff", 0.01) * ent
        )
        metrics = {
            "policy_loss": pi_loss.detach(),
            "vf_loss": vf_loss.detach(),
            "entropy": ent.detach(),
            "mean_rho": rhos.mean(),
        }
        if cfg.get("use_kl_loss"):
            kl = ((target_logp - logp) * mask).sum() / denom
            total = total + cfg.get("kl_coeff", 1.0) * kl
            metrics["mean_kl"] = kl.detach()
        return total, metrics

    def before_update(self, batch):
        """The target policy's logp of the batch, without autograd,
        attached as the ``target_logp`` column (numpy, as the batch's
        other columns)."""
        import torch
        from torch.func import functional_call

        with torch.no_grad():
            # copies: a batch from the object store is read-only
            logits, _ = functional_call(self.module, self.old_params,
                                        (np.array(batch[OBS]),))
            logp = self.module._dist_logp(logits, torch.as_tensor(np.array(batch[ACTIONS]),
                                                                  device=logits.device))
        batch["target_logp"] = logp.cpu().numpy()

    def after_update(self):
        self._batches_since_target_sync += 1
        if self._batches_since_target_sync >= self.config.get("target_network_update_freq", 2):
            self.old_params = self._copy_params()
            self._batches_since_target_sync = 0


class APPO(IMPALA):
    config_class = APPOConfig
    learner_class = APPOLearner

    def _learner_config(self) -> Dict[str, Any]:
        cfg = self.algo_config
        out = super()._learner_config()
        out.update(
            vtrace_clip_rho=cfg.vtrace_clip_rho,
            vtrace_clip_c=cfg.vtrace_clip_c,
            vf_loss_coeff=cfg.vf_loss_coeff,
            entropy_coeff=cfg.entropy_coeff,
            clip_param=cfg.clip_param,
            use_kl_loss=cfg.use_kl_loss,
            kl_coeff=cfg.kl_coeff,
            target_network_update_freq=cfg.target_network_update_freq,
        )
        return out
