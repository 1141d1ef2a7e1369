"""Shared training scaffolding for the model families (port of
``ray_tpu/models/common.py``: the loss, the train step, the parameter
count).

The reference's step is pure: it returns new params and optimizer state.
Here the model and the optimizer are updated in place, which keeps one
copy of the weights and of the AdamW moments on the card.  The sharded
recipes (``make_sharded_train_state``, ``make_sharded_train_step``) wait
for the port's sharded planes.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn


def next_token_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Cross entropy in logsumexp form, in float32: mean over positions
    of logsumexp(logits) - logits[target]."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    tgt = logits.gather(-1, targets[..., None].long())[..., 0]
    return (lse - tgt.float()).mean()


def make_train_step(loss_fn: Callable, optimizer: torch.optim.Optimizer):
    """train_step(model, tokens, targets) -> loss for a
    loss_fn(model, tokens, targets).  The reference's step also takes the
    model's config for its loss_fn to build the model from; a module
    carries its own.

    Each call computes the loss and its gradients and takes one optimizer
    step, updating ``model``'s parameters and ``optimizer``'s state in
    place.  The loss comes back as a detached tensor on the model's device,
    with no host sync: read it with ``.item()`` when it is needed."""

    def train_step(model: nn.Module, tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, tokens, targets)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


def num_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
