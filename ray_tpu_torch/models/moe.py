"""Mixture-of-Experts MLP in PyTorch (port of ``ray_tpu/models/moe.py``):
dense-dispatch top-k routing over stacked expert weights.

    dispatch  [S, E, C]  one-hot token -> (expert, capacity slot)
    x_e       [E, C, D]  = einsum('sec,sd->ecd', dispatch, x)
    h_e       [E, C, F]  = silu(x_e @ w_gate) * (x_e @ w_up)
    out       [S, D]     = einsum('sec,ecd->sd', combine, h_e @ w_down)

Parity with the reference, each visible below: the router is a bias-free
float32 Dense on float32 input; the aux loss is copied as the reference
computes it, with its ``num_experts`` factor twice; the capacity is
``max(1, int(capacity_factor * S * top_k / num_experts))``; capacity
slots follow token order by a cumulative sum and tokens past an expert's
capacity are dropped; the experts are stacked ``[E, D, F]`` / ``[E, F,
D]`` weights used as they are.  ``torch.topk`` picks among tied router
probabilities in its own order, where ``jax.lax.top_k`` takes the lower
expert index first.

Not ported: ``moe_sharding_rules``, which waits for the port's sharded
planes; on one device the experts run without their exchange.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.models import common


@dataclass(frozen=True)
class MoEConfig:
    d_model: int = 128
    d_ff: int = 256
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 2.0
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    aux_loss_weight: float = 0.01


def _top_k_gating(logits: torch.Tensor, cfg: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """gates [S, E] (zero outside the top-k, renormalised) and the
    load-balancing aux loss (the reference's GShard form)."""
    probs = torch.softmax(logits.float(), dim=-1)
    _, topi = torch.topk(probs, cfg.top_k, dim=-1)
    mask = F.one_hot(topi, cfg.num_experts).to(probs.dtype).sum(dim=1)
    gates = probs * mask
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    # fraction of tokens whose top-1 lands on e, times the mean router prob
    top1 = F.one_hot(topi[:, 0], cfg.num_experts).to(probs.dtype)
    aux = cfg.num_experts * torch.mean(top1.mean(0) * probs.mean(0)) * cfg.num_experts
    return gates, aux


def _dispatch_combine(gates: torch.Tensor, cfg: MoEConfig, capacity: int):
    """dispatch [S, E, C] {0, 1} and combine [S, E, C] (gate-weighted)."""
    chosen = (gates > 0).float()
    # each token's place in its expert's queue (capacity slot), -1 unchosen
    pos = torch.cumsum(chosen, dim=0) * chosen - 1.0
    keep = (pos >= 0) & (pos < capacity)
    slot = pos.clamp(0, capacity - 1).long()
    dispatch = F.one_hot(slot, capacity).float() * keep[..., None]
    combine = dispatch * gates.float()[..., None]
    return dispatch, combine


class MoEMLP(nn.Module):
    """Drop-in MLP replacement: x [B, T, D] -> (out [B, T, D], aux loss)."""

    def __init__(self, cfg: MoEConfig):
        super().__init__()
        self.cfg = cfg
        E, D, Fd = cfg.num_experts, cfg.d_model, cfg.d_ff
        self.router = common.Linear(D, E, False, torch.float32, cfg.param_dtype)
        self.experts_gate = nn.Parameter(torch.empty(E, D, Fd, dtype=cfg.param_dtype))
        self.experts_up = nn.Parameter(torch.empty(E, D, Fd, dtype=cfg.param_dtype))
        self.experts_down = nn.Parameter(torch.empty(E, Fd, D, dtype=cfg.param_dtype))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        B, T, D = x.shape
        S = B * T
        xs = x.reshape(S, D)
        gates, aux = _top_k_gating(self.router(xs.float()), cfg)
        capacity = max(1, int(cfg.capacity_factor * S * cfg.top_k / cfg.num_experts))
        dispatch, combine = _dispatch_combine(gates, cfg, capacity)
        dt = cfg.dtype
        xe = torch.einsum("sec,sd->ecd", dispatch.to(dt), xs.to(dt))
        he = (F.silu(torch.einsum("ecd,edf->ecf", xe, self.experts_gate.to(dt)))
              * torch.einsum("ecd,edf->ecf", xe, self.experts_up.to(dt)))
        ye = torch.einsum("ecf,efd->ecd", he, self.experts_down.to(dt))
        out = torch.einsum("sec,ecd->sd", combine.to(dt), ye)
        return out.reshape(B, T, D), cfg.aux_loss_weight * aux


def init_model(cfg: MoEConfig, generator: Optional[torch.Generator] = None,
               device: Union[str, torch.device] = "cuda") -> MoEMLP:
    """Synthetic weights from ``generator`` at the scales of the
    reference's initialisers: the router at std 1/sqrt(d_model), each
    stacked expert weight at flax ``lecun_normal``'s std 1/sqrt(fan_in),
    whose fan-in counts the leading expert axis as a receptive field
    (E x d_model, E x d_ff); on ``device`` (the card unless the caller
    asks for the CPU)."""
    model = common.init_model(lambda: MoEMLP(cfg), generator, device)
    gen_dev = generator.device if generator is not None else model.experts_up.device
    with torch.no_grad():
        for w in (model.experts_gate, model.experts_up, model.experts_down):
            std = 1.0 / math.sqrt(w.shape[0] * w.shape[1])
            w.copy_(common.normal(w.shape, std, generator, gen_dev))
    return model


num_params = common.num_params
