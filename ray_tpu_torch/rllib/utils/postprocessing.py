"""Advantage estimation (reference: rllib/evaluation/postprocessing.py
compute_gae_for_sample_batch / rllib/connectors GAE)."""

from __future__ import annotations

import numpy as np

from ray_tpu_torch.rllib.utils.sample_batch import (
    ADVANTAGES,
    REWARDS,
    SampleBatch,
    TERMINATEDS,
    TRUNCATEDS,
    VALUE_TARGETS,
    VF_PREDS,
)


def compute_gae(
    batch: SampleBatch,
    last_value: float,
    gamma: float = 0.99,
    lambda_: float = 0.95,
) -> SampleBatch:
    """Generalized Advantage Estimation over one episode fragment.

    `last_value` bootstraps the value beyond the fragment end (0 when the
    episode terminated).
    """
    rewards = batch[REWARDS].astype(np.float32)
    values = batch[VF_PREDS].astype(np.float32)
    n = len(rewards)
    terminated = batch[TERMINATEDS].astype(bool) if TERMINATEDS in batch else np.zeros(n, bool)

    next_values = np.append(values[1:], last_value)
    # no bootstrap across a terminal step
    next_values = np.where(terminated, 0.0, next_values)
    deltas = rewards + gamma * next_values - values

    adv = np.zeros(n, dtype=np.float32)
    running = 0.0
    for t in range(n - 1, -1, -1):
        running = deltas[t] + gamma * lambda_ * (0.0 if terminated[t] else running)
        adv[t] = running
    batch[ADVANTAGES] = adv
    batch[VALUE_TARGETS] = adv + values
    return batch


def standardize(x: np.ndarray) -> np.ndarray:
    return (x - x.mean()) / max(1e-8, x.std())
