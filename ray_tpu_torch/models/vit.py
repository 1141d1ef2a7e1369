"""Vision Transformer in PyTorch (port of ``ray_tpu/models/vit.py``):
a strided-conv patch embedding, a CLS token, learned position
embeddings and pre-LayerNorm encoder blocks, float32 params with bfloat16
compute by default.

The module tree mirrors the flax tree name for name, flax's automatic
names included (``patch_embed``, ``cls_token``, ``pos_embed``,
``block_{i}.{LayerNorm_0, MultiHeadDotProductAttention_0.{query, key,
value, out}, LayerNorm_1, Dense_0, Dense_1}``, a top-level
``LayerNorm_0``, ``head``), so ``models/convert.py`` carries the
reference's weights across key by key.  flax's query/key/value kernels
``[D, H, Dh]`` with ``[H, Dh]`` biases and its out kernel ``[H, Dh, D]``
become ``Linear`` layers over the flattened heads.

Attention here is flax's ``MultiHeadDotProductAttention``, which XLA
computes outside any Pallas kernel, so the port computes it in plain
torch, not through the flash kernels.  Parity with the reference, each
visible below: LayerNorm eps 1e-6 with float32 statistics; ``nn.gelu``
is the tanh form; patches come from a VALID strided conv, flattened in
(h, w) order; the CLS token goes first; ``pos_embed`` is cast to the
compute dtype before the add.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.models import common

_LN_EPS = 1e-6  # flax.linen.LayerNorm default


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 32
    patch_size: int = 4
    num_classes: int = 10
    d_model: int = 192
    n_layer: int = 6
    n_head: int = 3
    mlp_ratio: int = 4
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @staticmethod
    def tiny(**kw) -> "ViTConfig":
        return ViTConfig(d_model=64, n_layer=2, n_head=2, **kw)

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


def _linear(d_in: int, d_out: int, cfg: ViTConfig) -> common.Linear:
    return common.Linear(d_in, d_out, True, cfg.dtype, cfg.param_dtype)


def _layer_norm(cfg: ViTConfig) -> nn.LayerNorm:
    return nn.LayerNorm(cfg.d_model, eps=_LN_EPS, dtype=cfg.param_dtype)


def _ln(x: torch.Tensor, ln: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    """flax ``LayerNorm(dtype)``: statistics and scale in float32, the
    result cast to ``dtype``."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps).to(dtype)


class MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` as ViT calls it (self
    attention, no mask, no dropout), each step in the compute dtype as
    flax 0.12.3's ``dot_product_attention_weights`` takes it: the query
    divided by sqrt(Dh) rounded to the dtype, the scores out of the
    product in the dtype, the softmax's output in the dtype, then P.V.
    In bfloat16 torch's softmax computes in float32 inside and rounds
    once, where XLA's may round its exp and sum on the way: the two agree
    to bfloat16 rounding, not bit for bit."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        self.query = _linear(cfg.d_model, cfg.d_model, cfg)
        self.key = _linear(cfg.d_model, cfg.d_model, cfg)
        self.value = _linear(cfg.d_model, cfg.d_model, cfg)
        self.out = _linear(cfg.d_model, cfg.d_model, cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, N, _ = x.shape
        heads = (cfg.n_head, cfg.d_model // cfg.n_head)
        q, k, v = (proj(x).unflatten(-1, heads) for proj in (self.query, self.key, self.value))
        depth = torch.tensor(math.sqrt(heads[1]), dtype=torch.float32).to(cfg.dtype)
        scores = torch.einsum("bqhd,bkhd->bhqk", q / depth, k)
        probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self.out(out.reshape(B, N, cfg.d_model))


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        self.LayerNorm_0 = _layer_norm(cfg)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(cfg)
        self.LayerNorm_1 = _layer_norm(cfg)
        self.Dense_0 = _linear(cfg.d_model, cfg.d_model * cfg.mlp_ratio, cfg)
        self.Dense_1 = _linear(cfg.d_model * cfg.mlp_ratio, cfg.d_model, cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        x = x + self.MultiHeadDotProductAttention_0(_ln(x, self.LayerNorm_0, dt))
        h = F.gelu(self.Dense_0(_ln(x, self.LayerNorm_1, dt)), approximate="tanh")
        return x + self.Dense_1(h)


class ViT(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        p = cfg.patch_size
        self.patch_embed = common.Conv(3, cfg.d_model, p, p, cfg.dtype, cfg.param_dtype,
                                       padding="VALID", bias=True)
        self.cls_token = nn.Parameter(torch.empty(1, 1, cfg.d_model, dtype=cfg.param_dtype))
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.n_patches + 1, cfg.d_model,
                                                  dtype=cfg.param_dtype))
        for i in range(cfg.n_layer):
            self.add_module(f"block_{i}", Block(cfg))
        self.LayerNorm_0 = _layer_norm(cfg)
        self.head = _linear(cfg.d_model, cfg.num_classes, cfg)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, 3] (NHWC) -> logits [B, classes] in the compute
        dtype, classified from the CLS token."""
        cfg = self.cfg
        B = images.shape[0]
        x = self.patch_embed(images.to(cfg.dtype).permute(0, 3, 1, 2))  # [B, D, h, w]
        x = x.flatten(2).transpose(1, 2)  # [B, h*w, D] in (h, w) order
        cls = self.cls_token.to(cfg.dtype).expand(B, 1, cfg.d_model)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(cfg.dtype)
        for i in range(cfg.n_layer):
            x = getattr(self, f"block_{i}")(x)
        x = _ln(x, self.LayerNorm_0, cfg.dtype)
        return self.head(x[:, 0])


def init_model(cfg: ViTConfig, generator: Optional[torch.Generator] = None,
               device: Union[str, torch.device] = "cuda") -> ViT:
    """Synthetic weights from ``generator`` (``models/common.py``
    ``init_model``), a zero CLS token and ``pos_embed`` drawn at std 0.02
    as the reference's initialisers, on ``device`` (the card unless the
    caller asks for the CPU)."""
    model = common.init_model(lambda: ViT(cfg), generator, device)
    gen_dev = generator.device if generator is not None else model.pos_embed.device
    with torch.no_grad():
        model.cls_token.zero_()
        model.pos_embed.copy_(common.normal(model.pos_embed.shape, 0.02, generator, gen_dev))
    return model


def loss_fn(model: ViT, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Cross entropy of the float32 log-softmax against one-hot labels."""
    return common.one_hot_loss(model(images).float(), labels, model.cfg.num_classes)


def make_train_step(cfg: ViTConfig, optimizer: torch.optim.Optimizer):
    """step(model, images, labels) -> loss: one optimizer step of ``model``
    in place (``models/common.py``); ``model`` must be built from
    ``cfg``."""
    return common.make_train_step(loss_fn, cfg, optimizer)


num_params = common.num_params
