"""RLModule: the neural-network component of an algorithm (reference:
rllib/core/rl_module/rl_module.py — forward_inference /
forward_exploration / forward_train).

The port's RLModule is an ``nn.Module`` that owns its parameters: the
same definition runs in the env-runner actors (CPU inference) and in the
learner's train step on ``cuda``.  The layers and their names follow the
reference's flax ``_PiVfNet`` (``pi_*`` and ``vf_*`` torsos, ``pi_head``,
``vf_head``, ``log_std``), so ``models/convert.py`` carries a flax
``params`` tree across leaf by leaf.  Action distributions are plain
torch; sampling draws from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn


@dataclass(frozen=True)
class RLModuleSpec:
    """Builds an RLModule for an env's spaces (reference:
    rllib/core/rl_module/rl_module.py RLModuleSpec)."""

    observation_dim: int
    action_dim: int
    discrete: bool = True
    hidden: Tuple[int, ...] = (64, 64)
    vf_share_layers: bool = False
    dtype: Any = torch.float32
    # Image observations: original (H, W, C) shape + conv torso spec of
    # (out_channels, kernel, stride) triples (reference: the rllib model
    # catalog's conv_filters; the Nature-CNN is ((32, 8, 4), (64, 4, 2),
    # (64, 3, 1))).
    obs_shape: Optional[Tuple[int, ...]] = None
    conv_filters: Optional[Tuple[Tuple[int, int, int], ...]] = None

    @classmethod
    def from_gym_env(
        cls, env, hidden=(64, 64), vf_share_layers=False, conv_filters=None
    ) -> "RLModuleSpec":
        import gymnasium as gym  # only here: the package imports without it

        obs_space = env.single_observation_space if hasattr(env, "single_observation_space") else env.observation_space
        act_space = env.single_action_space if hasattr(env, "single_action_space") else env.action_space
        obs_dim = int(np.prod(obs_space.shape))
        obs_shape = None
        if conv_filters is not None:
            if len(obs_space.shape) != 3:
                raise ValueError(
                    f"conv_filters requires (H, W, C) observations, got {obs_space.shape}"
                )
            obs_shape = tuple(int(s) for s in obs_space.shape)
            conv_filters = tuple(tuple(f) for f in conv_filters)
        if isinstance(act_space, gym.spaces.Discrete):
            return cls(obs_dim, int(act_space.n), True, tuple(hidden), vf_share_layers,
                       obs_shape=obs_shape, conv_filters=conv_filters)
        return cls(obs_dim, int(np.prod(act_space.shape)), False, tuple(hidden), vf_share_layers,
                   obs_shape=obs_shape, conv_filters=conv_filters)

    def build(self, generator: Optional[torch.Generator] = None) -> "RLModule":
        """The module on the CPU, its weights drawn from ``generator``."""
        return RLModule(self, generator)


def _init_params(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Normal draws of std 1/sqrt(fan_in) for every ``Linear`` and
    ``Conv2d`` weight (fan-in in x k x k), zero biases, in module order;
    ``log_std`` stays 0 (flax's ``zeros``)."""
    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                fan_in = mod.weight[0].numel()
                w = torch.randn(mod.weight.shape, generator=generator, dtype=torch.float32)
                mod.weight.copy_(w / math.sqrt(fan_in))
                mod.bias.zero_()


class RLModule(nn.Module):
    """Policy + value network (the reference's ``_PiVfNet``) with the
    distribution math.  ``forward`` returns ``(logits, value)``; for
    continuous actions the logits are ``[mean, log_std]``."""

    def __init__(self, spec: RLModuleSpec, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.spec = spec
        dt = spec.dtype

        def torso(tag: str) -> int:
            width = spec.observation_dim
            if spec.conv_filters:
                h, w, c = spec.obs_shape
                for i, (ch, k, s) in enumerate(spec.conv_filters):
                    self.add_module(f"{tag}_conv_{i}", nn.Conv2d(c, ch, k, stride=s, dtype=dt))
                    h, w, c = (h - k) // s + 1, (w - k) // s + 1, ch  # VALID padding
                width = h * w * c
            for i, n in enumerate(spec.hidden):
                self.add_module(f"{tag}_dense_{i}", nn.Linear(width, n, dtype=dt))
                width = n
            return width

        pi_width = torso("pi")
        vf_width = pi_width if spec.vf_share_layers else torso("vf")
        self.pi_head = nn.Linear(pi_width, spec.action_dim, dtype=dt)
        if not spec.discrete:
            self.log_std = nn.Parameter(torch.zeros(spec.action_dim, dtype=dt))
        self.vf_head = nn.Linear(vf_width, 1, dtype=dt)
        _init_params(self, generator)

    def _torso(self, tag: str, x: torch.Tensor) -> torch.Tensor:
        spec = self.spec
        h = x
        if spec.conv_filters:
            h = h.permute(0, 3, 1, 2)  # NHWC -> NCHW for nn.Conv2d
            for i in range(len(spec.conv_filters)):
                h = torch.relu(getattr(self, f"{tag}_conv_{i}")(h))
            # flax flattens (H, W, C): back to NHWC first, or the first
            # dense layer's rows would not line up with the reference's
            h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        for i in range(len(spec.hidden)):
            h = torch.tanh(getattr(self, f"{tag}_dense_{i}")(h))
        return h

    def forward(self, obs) -> Tuple[torch.Tensor, torch.Tensor]:
        spec = self.spec
        obs = torch.as_tensor(obs, device=self.vf_head.weight.device)
        if spec.conv_filters:
            # uint8 images -> [0, 1] floats in (B, H, W, C)
            x = obs.reshape((obs.shape[0],) + tuple(spec.obs_shape)).to(spec.dtype) / 255.0
        else:
            x = obs.reshape(obs.shape[0], -1).to(spec.dtype)
        pi_h = self._torso("pi", x)
        vf_h = pi_h if spec.vf_share_layers else self._torso("vf", x)
        if spec.discrete:
            logits = self.pi_head(pi_h)
        else:
            mean = self.pi_head(pi_h)
            logits = torch.cat([mean, self.log_std.expand_as(mean)], dim=-1)
        value = self.vf_head(vf_h)[..., 0]
        return logits, value

    # -- distribution math ------------------------------------------------
    def _dist_sample(self, logits: torch.Tensor, generator: Optional[torch.Generator]):
        if self.spec.discrete:
            probs = torch.softmax(logits, dim=-1)
            return torch.multinomial(probs, 1, generator=generator)[..., 0]
        mean, log_std = logits.chunk(2, dim=-1)
        noise = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                            device=mean.device)
        return mean + torch.exp(log_std) * noise

    def _dist_logp(self, logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
        if self.spec.discrete:
            logp_all = torch.log_softmax(logits, dim=-1)
            return logp_all.gather(-1, actions.long()[..., None])[..., 0]
        mean, log_std = logits.chunk(2, dim=-1)
        var = torch.exp(2 * log_std)
        logp = -0.5 * (((actions - mean) ** 2) / var + 2 * log_std + math.log(2 * math.pi))
        return logp.sum(dim=-1)

    def _dist_entropy(self, logits: torch.Tensor) -> torch.Tensor:
        if self.spec.discrete:
            return -(torch.softmax(logits, -1) * torch.log_softmax(logits, -1)).sum(dim=-1)
        _, log_std = logits.chunk(2, dim=-1)
        return (log_std + 0.5 * math.log(2 * math.pi * math.e)).sum(dim=-1)

    # -- forward passes (reference: rl_module.py forward_{inference,
    # exploration,train}) ------------------------------------------------
    def forward_inference(self, obs):
        """Greedy/deterministic actions and values."""
        logits, value = self(obs)
        if self.spec.discrete:
            return logits.argmax(dim=-1), value
        mean, _ = logits.chunk(2, dim=-1)
        return mean, value

    def forward_exploration(self, obs, generator: Optional[torch.Generator] = None):
        """Stochastic actions + logp + value (rollout collection)."""
        logits, value = self(obs)
        actions = self._dist_sample(logits, generator)
        return actions, self._dist_logp(logits, actions), value

    def forward_train(self, obs, actions):
        """(logp, entropy, value) for the learner loss."""
        logits, value = self(obs)
        logp = self._dist_logp(logits, torch.as_tensor(actions, device=logits.device))
        return logp, self._dist_entropy(logits), value

    # -- weights ---------------------------------------------------------
    def get_weights(self) -> Dict[str, np.ndarray]:
        """{parameter name: float numpy array}, off the device."""
        return {k: v.detach().cpu().numpy().copy() for k, v in self.state_dict().items()}

    def set_weights(self, weights: Dict[str, Any]) -> None:
        self.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in weights.items()})


class QModule(nn.Module):
    """Q-network for value-based algorithms (DQN family): a relu MLP
    (``q_dense_*``) with dueling heads (``adv_head``, ``val_head``)."""

    def __init__(self, spec: RLModuleSpec, generator: Optional[torch.Generator] = None):
        super().__init__()
        if not spec.discrete:
            raise ValueError("QModule requires a discrete action space")
        self.spec = spec
        width = spec.observation_dim
        for i, n in enumerate(spec.hidden):
            self.add_module(f"q_dense_{i}", nn.Linear(width, n, dtype=spec.dtype))
            width = n
        # dueling heads (reference: rllib DQN dueling=True default)
        self.adv_head = nn.Linear(width, spec.action_dim, dtype=spec.dtype)
        self.val_head = nn.Linear(width, 1, dtype=spec.dtype)
        _init_params(self, generator)

    def q_values(self, obs) -> torch.Tensor:
        obs = torch.as_tensor(obs, device=self.val_head.weight.device)
        h = obs.reshape(obs.shape[0], -1).to(self.spec.dtype)
        for i in range(len(self.spec.hidden)):
            h = torch.relu(getattr(self, f"q_dense_{i}")(h))
        adv = self.adv_head(h)
        return self.val_head(h) + adv - adv.mean(dim=-1, keepdim=True)

    forward = q_values
