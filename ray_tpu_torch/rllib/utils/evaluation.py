"""Shared greedy-rollout evaluation for algorithms whose policy is not
the standard RLModule (DQN's Q-net, SAC/CQL's squashed Gaussian) —
the base Algorithm.evaluate() eval-runner path covers the rest
(reference: algorithm.py evaluate() with explore=False)."""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np


def greedy_eval(
    env_creator: Callable[[], Any],
    action_fn: Callable[[np.ndarray], Any],
    num_episodes: int,
    seed: int,
) -> Dict[str, Any]:
    """Roll ``num_episodes`` episodes with deterministic ``action_fn``;
    returns the same metrics dict as Algorithm.evaluate()."""
    env = env_creator()
    returns = []
    for ep in range(num_episodes):
        obs, _ = env.reset(seed=seed + 20_000 + ep)
        done, total = False, 0.0
        while not done:
            obs, r, term, trunc, _ = env.step(action_fn(np.asarray(obs)))
            total += float(r)
            done = term or trunc
        returns.append(total)
    env.close()
    return {
        "num_episodes": len(returns),
        "episode_return_mean": float(np.mean(returns)),
        "episode_return_min": float(np.min(returns)),
        "episode_return_max": float(np.max(returns)),
    }
