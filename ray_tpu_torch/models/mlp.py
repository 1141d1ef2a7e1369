"""MLP classifier in PyTorch (port of ``ray_tpu/models/mlp.py``): the
MNIST-class model, 784-256-256-10 with biases and ReLU, float32 by
default.

The module tree mirrors the flax tree (``dense_{i}``, ``head``); the
weights are float32 (flax's default ``param_dtype``, which the reference
does not set) and cast to ``cfg.dtype`` on every call.  As in the
reference, the loss takes ``log_softmax`` in the logits' own dtype, with
no float32 cast first.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.models import common


@dataclass(frozen=True)
class MLPConfig:
    in_dim: int = 784
    hidden: Tuple[int, ...] = (256, 256)
    num_classes: int = 10
    dtype: torch.dtype = torch.float32


class MLPNet(nn.Module):
    def __init__(self, cfg: MLPConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.in_dim
        for i, h in enumerate(cfg.hidden):
            self.add_module(f"dense_{i}", common.Linear(d, h, True, cfg.dtype, torch.float32))
            d = h
        self.head = common.Linear(d, cfg.num_classes, True, cfg.dtype, torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, ...] (flattened to [B, in_dim]) -> logits [B, classes]."""
        x = x.reshape(x.shape[0], -1).to(self.cfg.dtype)
        for i in range(len(self.cfg.hidden)):
            x = F.relu(getattr(self, f"dense_{i}")(x))
        return self.head(x)


def init_model(cfg: MLPConfig, generator: Optional[torch.Generator] = None,
               device: Union[str, torch.device] = "cuda") -> MLPNet:
    """Synthetic weights from ``generator`` (``models/common.py``
    ``init_model``) on ``device`` (the card unless the caller asks for the
    CPU)."""
    return common.init_model(lambda: MLPNet(cfg), generator, device)


def loss_fn(model: MLPNet, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Cross entropy against one-hot labels, ``log_softmax`` in the
    logits' dtype as the reference takes it."""
    return common.one_hot_loss(model(x), y, model.cfg.num_classes)


@torch.no_grad()
def accuracy(model: MLPNet, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (model(x).argmax(-1) == y).float().mean()


def make_train_step(cfg: MLPConfig, optimizer: torch.optim.Optimizer):
    """step(model, x, y) -> loss: one optimizer step of ``model`` in place
    (``models/common.py``); ``model`` must be built from ``cfg``."""
    return common.make_train_step(loss_fn, cfg, optimizer)


num_params = common.num_params
