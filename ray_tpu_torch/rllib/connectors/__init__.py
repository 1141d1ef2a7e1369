"""Connector pipelines (reference: rllib/connectors/connector_v2.py +
env_to_module / module_to_env pipelines).

A connector is a pure callable transforming the data flowing between
env and module (obs preprocessing) or module and env (action
postprocessing).  Pipelines compose them in order.  The env runner
applies `env_to_module` to every observation batch before inference and
`module_to_env` to every action batch before env.step() — the same two
insertion points the reference uses."""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import numpy as np


class ConnectorV2:
    """Base connector (reference: connector_v2.py).  Stateless by
    default; stateful connectors (e.g. running obs normalization) carry
    state that ships with checkpoints via get_state/set_state."""

    def __call__(self, data: Any) -> Any:
        raise NotImplementedError

    def get_state(self) -> dict:
        return {}

    def set_state(self, state: dict) -> None:
        pass


class ConnectorPipelineV2(ConnectorV2):
    """Ordered composition (reference: connector_pipeline_v2.py)."""

    def __init__(self, connectors: Optional[List[ConnectorV2]] = None):
        self.connectors = list(connectors or [])

    def __call__(self, data: Any) -> Any:
        for c in self.connectors:
            data = c(data)
        return data

    def append(self, connector: ConnectorV2) -> "ConnectorPipelineV2":
        self.connectors.append(connector)
        return self

    def prepend(self, connector: ConnectorV2) -> "ConnectorPipelineV2":
        self.connectors.insert(0, connector)
        return self

    def get_state(self) -> dict:
        return {i: c.get_state() for i, c in enumerate(self.connectors)}

    def set_state(self, state: dict) -> None:
        for i, c in enumerate(self.connectors):
            if i in state:
                c.set_state(state[i])


class FlattenObservations(ConnectorV2):
    """(B, ...) observations -> (B, prod(...)) (reference:
    connectors/env_to_module/flatten_observations.py)."""

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        obs = np.asarray(obs)
        return obs.reshape(obs.shape[0], -1)


class NormalizeObservations(ConnectorV2):
    """Running mean/std observation filter (reference:
    rllib/utils/filter.py MeanStdFilter as a connector).  Welford
    accumulation; stats ride checkpoints."""

    def __init__(self, epsilon: float = 1e-8, clip: Optional[float] = 10.0):
        self.eps = epsilon
        self.clip = clip
        self._count = 0.0
        self._mean: Optional[np.ndarray] = None
        self._m2: Optional[np.ndarray] = None

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        obs = np.asarray(obs, np.float32)
        flat = obs.reshape(obs.shape[0], -1)
        if self._mean is None:
            self._mean = np.zeros(flat.shape[1], np.float64)
            self._m2 = np.zeros(flat.shape[1], np.float64)
        for row in flat:  # batch sizes here are tiny (num_envs)
            self._count += 1.0
            delta = row - self._mean
            self._mean += delta / self._count
            self._m2 += delta * (row - self._mean)
        var = self._m2 / max(1.0, self._count - 1.0)
        out = (flat - self._mean) / np.sqrt(var + self.eps)
        if self.clip is not None:
            out = np.clip(out, -self.clip, self.clip)
        return out.astype(np.float32).reshape(obs.shape)

    def get_state(self) -> dict:
        return {
            "count": self._count,
            "mean": None if self._mean is None else self._mean.copy(),
            "m2": None if self._m2 is None else self._m2.copy(),
        }

    def set_state(self, state: dict) -> None:
        self._count = state["count"]
        self._mean = state["mean"]
        self._m2 = state["m2"]


class ClipActions(ConnectorV2):
    """Clip continuous actions into the env's bounds (reference:
    connectors/module_to_env/... clip_actions)."""

    def __init__(self, low, high):
        self.low = np.asarray(low, np.float32)
        self.high = np.asarray(high, np.float32)

    def __call__(self, actions: np.ndarray) -> np.ndarray:
        return np.clip(actions, self.low, self.high)


class LambdaConnector(ConnectorV2):
    """Wrap any fn(data)->data as a connector."""

    def __init__(self, fn: Callable[[Any], Any]):
        self.fn = fn

    def __call__(self, data: Any) -> Any:
        return self.fn(data)


__all__ = [
    "ConnectorV2",
    "ConnectorPipelineV2",
    "FlattenObservations",
    "NormalizeObservations",
    "ClipActions",
    "LambdaConnector",
]
