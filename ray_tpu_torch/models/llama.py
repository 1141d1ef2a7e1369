"""Llama-family decoder in PyTorch (port of ``ray_tpu/models/llama.py``):
RMSNorm with no bias anywhere, rotary position embeddings on q and k,
grouped-query attention (each KV head repeated for its group of query
heads) and a SwiGLU MLP.

The module tree mirrors the flax parameter tree name for name
(``token_embed``, ``h_{i}.{ln_attn, attn.{q,k,v,o}_proj, ln_mlp,
mlp.{gate,up,down}_proj}``, ``ln_f``, ``lm_head``), so
``models/convert.py`` carries the reference's weights across key by key.
As in ``models/gpt2.py``, weights are stored in ``param_dtype`` (float32
by default, as the reference) and cast to the compute ``dtype`` on every
call, and ``remat`` (on by default, as the reference) recomputes each
block's forward in the backward with ``torch.utils.checkpoint``.

Parity with the reference, each visible below: RMSNorm takes the mean of
squares and the rsqrt in float32 and multiplies the float32 scale before
the cast, eps 1e-5; RoPE is the half-split form (``[x1 cos - x2 sin,
x1 sin + x2 cos]``, not interleaved pairs) with float32 angles; the GQA
repeat is ``repeat_interleave`` (heads 0,0,1,1,... as ``jnp.repeat``),
not ``Tensor.repeat``; the MLP is ``down(silu(gate(x)) * up(x))``.
Attention goes through ``ops/attention.py``'s ``causal_attention``: on
the card the flash kernels B1 (forward; twice a layer under remat), B2
and B3 (backward) at head dim d_model / n_head.  The repeated k and v are
contiguous ``[B, T, H, Dh]`` tensors, which the kernels read as they are;
autograd sums their gradients back over each group.

The sharded recipes ``make_sharded_train_{state,step}`` are
``models/common.py``'s: the rule table of ``parallel/sharding.py`` names
``{q,k,v,o}_proj`` and ``{gate,up,down}_proj``, and ``mesh``/``sp_axis``
run ring attention over a >1 ``sp`` axis, as in ``models/gpt2.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.models import common
from ray_tpu_torch.ops.attention import causal_attention


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    n_layer: int = 32
    n_head: int = 32
    n_kv_head: int = 8
    d_model: int = 4096
    d_ff: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16  # compute dtype
    param_dtype: torch.dtype = torch.float32  # storage dtype of every weight
    remat: bool = True  # recompute each block's forward in the backward
    mesh: Any = None
    sp_axis: Optional[str] = None

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_head

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        return LlamaConfig(vocab_size=512, n_layer=2, n_head=4, n_kv_head=2, d_model=128,
                           d_ff=256, max_seq_len=128, remat=False, **kw)

    @staticmethod
    def llama_7b(**kw) -> "LlamaConfig":
        return LlamaConfig(**kw)

    @staticmethod
    def llama_1b(**kw) -> "LlamaConfig":
        return LlamaConfig(n_layer=16, n_head=16, n_kv_head=8, d_model=2048, d_ff=5504, **kw)


class RMSNorm(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(cfg.d_model, dtype=cfg.param_dtype))
        self.eps = cfg.rms_eps
        self.compute_dtype = cfg.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = x32.square().mean(-1, keepdim=True)
        return (x32 * torch.rsqrt(var + self.eps) * self.weight).to(self.compute_dtype)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embeddings over the last dim of [B, T, H, D], half-split:
    the first and second halves of each head rotate as pairs."""
    _, T, _, D = x.shape
    half = D // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    angles = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * freqs[None, :]
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def _linear(d_in: int, d_out: int, cfg: LlamaConfig) -> common.Linear:
    return common.Linear(d_in, d_out, False, cfg.dtype, cfg.param_dtype)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.q_proj = _linear(cfg.d_model, cfg.n_head * cfg.d_head, cfg)
        self.k_proj = _linear(cfg.d_model, cfg.n_kv_head * cfg.d_head, cfg)
        self.v_proj = _linear(cfg.d_model, cfg.n_kv_head * cfg.d_head, cfg)
        self.o_proj = _linear(cfg.n_head * cfg.d_head, cfg.d_model, cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        q = common.split_heads(self.q_proj(x), cfg.n_head)
        k = common.split_heads(self.k_proj(x), cfg.n_kv_head)
        v = common.split_heads(self.v_proj(x), cfg.n_kv_head)
        q = rope(q, cfg.rope_theta)
        k = rope(k, cfg.rope_theta)
        rep = cfg.n_head // cfg.n_kv_head
        if rep > 1:  # jnp.repeat order: KV head h serves query heads h*rep .. h*rep+rep-1
            k = torch.repeat_interleave(k, rep, dim=2)
            v = torch.repeat_interleave(v, rep, dim=2)
        out = causal_attention(q, k, v, mesh=cfg.mesh, sp_axis=cfg.sp_axis)
        return self.o_proj(common.merge_heads(out))


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.gate_proj = _linear(cfg.d_model, cfg.d_ff, cfg)
        self.up_proj = _linear(cfg.d_model, cfg.d_ff, cfg)
        self.down_proj = _linear(cfg.d_ff, cfg.d_model, cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.ln_attn = RMSNorm(cfg)
        self.attn = LlamaAttention(cfg)
        self.ln_mlp = RMSNorm(cfg)
        self.mlp = LlamaMLP(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_attn(x))
        return x + self.mlp(self.ln_mlp(x))


class Llama(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.token_embed = common.Embedding(cfg.vocab_size, cfg.d_model, cfg.dtype,
                                            cfg.param_dtype)
        for i in range(cfg.n_layer):
            self.add_module(f"h_{i}", LlamaBlock(cfg))
        self.ln_f = RMSNorm(cfg)
        self.lm_head = _linear(cfg.d_model, cfg.vocab_size, cfg)

    def blocks(self) -> List[LlamaBlock]:
        return [getattr(self, f"h_{i}") for i in range(self.cfg.n_layer)]

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, T] -> logits [B, T, vocab] in the compute dtype.
        With ``remat``, each block is checkpointed when autograd records."""
        x = self.token_embed(tokens)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for blk in self.blocks():
            x = checkpoint(blk, x, use_reentrant=False) if remat else blk(x)
        return self.lm_head(self.ln_f(x))


def init_model(cfg: LlamaConfig, generator: Optional[torch.Generator] = None,
               device: Union[str, torch.device] = "cuda") -> Llama:
    """Synthetic weights from ``generator`` (``models/common.py``
    ``init_model``: std 1/sqrt(fan_in) for the projections, 1/sqrt(d_model)
    for the embedding, unit RMSNorm scales), stored in ``cfg.param_dtype``,
    on ``device`` (the card unless the caller asks for the CPU).  Carry the
    reference's weights across with ``models/convert.py`` for parity."""
    return common.init_model(lambda: Llama(cfg), generator, device)


def loss_fn(model: Llama, tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy (``models/common.py`` ``next_token_loss``)."""
    return common.next_token_loss(model(tokens), targets)


def make_train_step(cfg: LlamaConfig, optimizer: torch.optim.Optimizer):
    """train_step(model, tokens, targets) -> loss: one optimizer step of
    ``model`` in place (``models/common.py``); ``model`` must be built
    from ``cfg``."""
    return common.make_train_step(loss_fn, cfg, optimizer)


def make_sharded_train_state(cfg: LlamaConfig, mesh,
                             make_optimizer: Callable[[Any], torch.optim.Optimizer],
                             generator: Optional[torch.Generator] = None):
    """Shared recipe (``models/common.py``): (model, optimizer, specs) on
    ``mesh``, the weights ``init_model``'s from ``generator`` (default:
    seed 0 on the mesh's device)."""
    return common.make_sharded_train_state(
        lambda g: init_model(cfg, g, device=g.device), mesh, make_optimizer, generator=generator)


def make_sharded_train_step(cfg: LlamaConfig, mesh, optimizer: torch.optim.Optimizer):
    return common.make_sharded_train_step(make_train_step(cfg, optimizer), mesh)


num_params = common.num_params
