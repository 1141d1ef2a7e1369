"""Off-policy evaluation estimators (reference: rllib/offline/estimators/
— importance_sampling.py, weighted_importance_sampling.py,
off_policy_estimator.py:1): estimate a TARGET policy's per-episode
return from a BEHAVIOR policy's recorded episodes, without touching the
environment.

Inputs are the shared offline plane's episodes (OfflineData batches with
OBS/ACTIONS/REWARDS/eps_id and the behavior policy's action
log-probabilities under LOGP — env-runner rollouts carry it; datasets
recorded via record_rollouts need the behavior logp added by the
recording policy).  The target policy is anything exposing
``forward_train(obs, actions) -> (logp, ...)`` — i.e. the port's
RLModule, which holds its own weights — so the same object that trains
is what gets evaluated.  Its logp is computed under ``no_grad`` on the
module's device (the RLModule moves its inputs there).

Estimators:
  * ImportanceSampling      — per-episode product of likelihood ratios
    times discounted return (unbiased, high variance).
  * WeightedImportanceSampling — ratios normalized per time step across
    episodes (biased, much lower variance; the reference's default).

Both report {v_behavior, v_target, v_gain} like the reference
(v_gain > 1 ⇒ the target policy is estimated to outperform the data's
behavior policy).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.rllib.utils.sample_batch import (
    ACTIONS,
    LOGP,
    OBS,
    REWARDS,
    SampleBatch,
)


class OffPolicyEstimator:
    """Base: splits the dataset into episodes, computes per-episode
    likelihood ratios of target vs behavior policy."""

    def __init__(self, module, params=None, gamma: float = 0.99,
                 logp_clip: float = 20.0):
        """``params``: weights (``{name: array}``) loaded into ``module``
        first, or None to evaluate the module as it is."""
        self.module = module
        if params is not None:
            module.set_weights(params)
        self.gamma = gamma
        # clip on the CUMULATIVE log-ratio: one unlikely action under a
        # near-deterministic target would otherwise zero/explode the
        # whole episode weight (reference clips ratios similarly)
        self.logp_clip = logp_clip

    def _target_logp(self, obs: np.ndarray, actions: np.ndarray) -> np.ndarray:
        import torch

        with torch.no_grad():
            logp = self.module.forward_train(torch.as_tensor(obs), torch.as_tensor(actions))[0]
        return logp.cpu().numpy()

    def _episode_stats(self, batch: SampleBatch):
        """Per episode: (discounted rewards array, step log-ratios array).

        Target logp is computed ONCE on the flat batch and then
        segmented — per-episode calls would run one forward an episode."""
        from ray_tpu_torch.rllib.utils.sample_batch import EPS_ID

        if batch.count == 0:
            raise ValueError("off-policy estimation got an empty batch")
        if LOGP not in batch:
            raise ValueError(
                "off-policy estimation needs the behavior policy's "
                f"{LOGP!r} column (env-runner rollouts emit it)"
            )
        if EPS_ID not in batch:
            raise ValueError(
                f"off-policy estimation needs {EPS_ID!r} to segment "
                "episodes — without it the whole batch would silently "
                "count as ONE episode"
            )
        t_logp = self._target_logp(
            np.asarray(batch[OBS]), np.asarray(batch[ACTIONS])
        ).astype(np.float64)
        log_ratio_flat = t_logp - np.asarray(batch[LOGP], np.float64)
        rew_flat = np.asarray(batch[REWARDS], np.float64)
        ids = np.asarray(batch[EPS_ID])
        bounds = np.concatenate(
            [[0], np.where(ids[1:] != ids[:-1])[0] + 1, [len(ids)]]
        )
        if len(np.unique(ids)) != len(bounds) - 1:
            raise ValueError(
                "off-policy estimation needs episode-CONTIGUOUS rows: the "
                "batch's eps_id values are interleaved (shuffled batch?) — "
                "ratio products over fragments would be silently wrong"
            )
        out = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            rew = rew_flat[lo:hi]
            disc_rew = rew * self.gamma ** np.arange(len(rew))
            out.append((disc_rew, log_ratio_flat[lo:hi]))
        return out

    def estimate(self, batch: SampleBatch) -> Dict[str, float]:
        raise NotImplementedError


class ImportanceSampling(OffPolicyEstimator):
    """reference: estimators/importance_sampling.py — episode weight =
    prod_t ratio_t; v_target = E[w * G]."""

    def estimate(self, batch: SampleBatch) -> Dict[str, float]:
        stats = self._episode_stats(batch)
        returns = np.array([dr.sum() for dr, _ in stats])
        log_w = np.array([
            np.clip(lr.sum(), -self.logp_clip, self.logp_clip) for _, lr in stats
        ])
        weights = np.exp(log_w)
        v_behavior = float(returns.mean())
        v_target = float((weights * returns).mean())
        return {
            "v_behavior": v_behavior,
            "v_target": v_target,
            "v_gain": v_target / v_behavior if v_behavior else float("nan"),
            "mean_weight": float(weights.mean()),
            "num_episodes": len(stats),
        }


class WeightedImportanceSampling(OffPolicyEstimator):
    """Per-decision WIS (reference:
    estimators/weighted_importance_sampling.py): each step's DISCOUNTED
    reward is weighted by that step's cumulative ratio normalized by the
    cross-episode mean cumulative ratio at the same t — a step where
    target and behavior agree keeps weight ~1 even if later steps
    diverge.  Self-normalizing: bounded weights, lower variance than
    IS."""

    def estimate(self, batch: SampleBatch) -> Dict[str, float]:
        stats = self._episode_stats(batch)
        returns = np.array([dr.sum() for dr, _ in stats])
        max_t = max(len(lr) for _, lr in stats)
        # cumulative weights + discounted rewards per episode per step,
        # NaN/0-padded
        cum = np.full((len(stats), max_t), np.nan)
        disc_rew = np.zeros((len(stats), max_t))
        for i, (dr, lr) in enumerate(stats):
            cum[i, : len(lr)] = np.exp(
                np.clip(np.cumsum(lr), -self.logp_clip, self.logp_clip)
            )
            disc_rew[i, : len(dr)] = dr
        # normalize each time column by its mean over the episodes alive
        # at that step
        col_mean = np.nanmean(cum, axis=0)
        norm = np.nan_to_num(cum / col_mean[None, :], nan=0.0)
        v_target = float((norm * disc_rew).sum(axis=1).mean())
        v_behavior = float(returns.mean())
        alive = ~np.isnan(cum)
        return {
            "v_behavior": v_behavior,
            "v_target": v_target,
            "v_gain": v_target / v_behavior if v_behavior else float("nan"),
            "mean_weight": float(norm[alive].mean()),
            "num_episodes": len(stats),
        }
