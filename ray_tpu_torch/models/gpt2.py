"""GPT-2 in PyTorch (port of ``ray_tpu/models/gpt2.py``): the model, its
training step and its inference plane.

The module tree mirrors the flax parameter tree name for name (``wte``,
``wpe``, ``h_{i}.{ln_1, attn.{qkv, attn_out}, ln_2, mlp.{mlp_up,
mlp_down}}``, ``ln_f``, ``lm_head``), so ``models/convert.py`` carries the
reference's weights across key by key.  Linear and embedding weights are
stored in ``param_dtype`` and cast to the compute ``dtype`` on every call,
as flax's ``Dense(dtype, param_dtype)`` does: training keeps float32
params with bfloat16 compute, as the reference does.  Left unset,
``param_dtype`` follows ``dtype``, so serving casts its weights once when
they are loaded (the values are the same).  The LayerNorm scale and bias
stay float32, because the reference normalises in float32.

Parity with the reference, each visible below: flax ``nn.gelu`` is the
tanh approximation; the LayerNorm eps is 1e-6; flax ``Dense.kernel`` is
``[in, out]`` where ``Linear.weight`` is ``[out, in]`` (convert.py
transposes); the fused qkv projection splits into q|k|v column blocks and
each into contiguous heads; ``lm_head`` has no bias and is not tied to
``wte``.

Training: ``loss_fn``, ``make_train_step`` (over ``models/common.py``),
``make_adamw``, ``flops_per_token`` and the sharded recipes
``make_sharded_train_{state,step}`` (DTensors on a ``DeviceMesh``, ring
attention over ``cfg.sp_axis``); ``remat`` recomputes each block's
forward in the backward (``torch.utils.checkpoint``), as the reference's
``nn.remat``.  Attention's backward runs the flash dq and dkv kernels.

The inference plane (``prefill_forward``, ``decode_forward``,
``sample_logits``) takes the module itself; the serving engine owns the
paged KV cache.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.models import common
from ray_tpu_torch.ops.attention import causal_attention

_LN_EPS = 1e-6  # flax.linen.LayerNorm default
_NEG = -1e30


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50304  # 50257 padded to a multiple of 128
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    max_seq_len: int = 1024
    dtype: torch.dtype = torch.bfloat16  # compute dtype
    # storage dtype of linear/embedding weights; None follows dtype
    param_dtype: Optional[torch.dtype] = None
    remat: bool = True  # recompute each block's forward in the backward
    use_bias: bool = True
    # Sequence parallelism: when mesh (a DeviceMesh) has a >1 `sp_axis`,
    # attention runs as ring attention over it (ops/ring_attention.py).
    mesh: Any = None
    sp_axis: Optional[str] = None

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_head

    @property
    def weight_dtype(self) -> torch.dtype:
        return self.dtype if self.param_dtype is None else self.param_dtype

    @staticmethod
    def tiny(**kw) -> "GPT2Config":
        return GPT2Config(vocab_size=512, n_layer=2, n_head=4, d_model=128, max_seq_len=128, **kw)

    @staticmethod
    def small(**kw) -> "GPT2Config":
        return GPT2Config(**kw)  # 124M

    @staticmethod
    def medium(**kw) -> "GPT2Config":
        return GPT2Config(n_layer=24, n_head=16, d_model=1024, **kw)  # 350M

    @staticmethod
    def large(**kw) -> "GPT2Config":
        return GPT2Config(n_layer=36, n_head=20, d_model=1280, **kw)  # 774M


def _linear(d_in: int, d_out: int, bias: bool, cfg: GPT2Config) -> common.Linear:
    return common.Linear(d_in, d_out, bias, cfg.dtype, cfg.weight_dtype)


class Attention(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.qkv = _linear(cfg.d_model, 3 * cfg.d_model, cfg.use_bias, cfg)
        self.attn_out = _linear(cfg.d_model, cfg.d_model, cfg.use_bias, cfg)


class MLP(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.mlp_up = _linear(cfg.d_model, 4 * cfg.d_model, cfg.use_bias, cfg)
        self.mlp_down = _linear(4 * cfg.d_model, cfg.d_model, cfg.use_bias, cfg)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.mlp_down(F.gelu(self.mlp_up(h), approximate="tanh"))


class Block(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.cfg = cfg
        self.ln_1 = nn.LayerNorm(cfg.d_model, eps=_LN_EPS, dtype=torch.float32)
        self.attn = Attention(cfg)
        self.ln_2 = nn.LayerNorm(cfg.d_model, eps=_LN_EPS, dtype=torch.float32)
        self.mlp = MLP(cfg)

    def forward(self, x: torch.Tensor):
        """Causal block over whole prompts from position 0: x [B, T, d] ->
        (x', k, v), k and v [B, T, H, Dh] for the serving engine's cache."""
        cfg = self.cfg
        q, k, v = _qkv(self, x, cfg)
        att = common.merge_heads(causal_attention(q, k, v, mesh=cfg.mesh, sp_axis=cfg.sp_axis))
        x = x + self.attn.attn_out(att)
        x = x + self.mlp(_ln(x, self.ln_2, cfg.dtype))
        return x, k, v


class GPT2(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.cfg = cfg
        self.wte = common.Embedding(cfg.vocab_size, cfg.d_model, cfg.dtype, cfg.weight_dtype)
        self.wpe = common.Embedding(cfg.max_seq_len, cfg.d_model, cfg.dtype, cfg.weight_dtype)
        for i in range(cfg.n_layer):
            self.add_module(f"h_{i}", Block(cfg))
        self.ln_f = nn.LayerNorm(cfg.d_model, eps=_LN_EPS, dtype=torch.float32)
        self.lm_head = _linear(cfg.d_model, cfg.vocab_size, False, cfg)

    def blocks(self) -> List[Block]:
        return [getattr(self, f"h_{i}") for i in range(self.cfg.n_layer)]

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, T] -> logits [B, T, vocab]."""
        x, _, _ = _forward_prompt(self, tokens)
        return self.lm_head(x)


def init_model(cfg: GPT2Config, generator: Optional[torch.Generator] = None,
               device: Union[str, torch.device] = "cuda") -> GPT2:
    """Synthetic weights from ``generator`` at the scales of flax's default
    initialisers: normal draws with std 1/sqrt(fan_in) for Dense kernels
    and 1/sqrt(d_model) for embeddings, zero biases, unit LayerNorm scale.
    Drawn in float32 and cast once to ``cfg.weight_dtype``; returns the
    model in eval mode (GPT-2 has no dropout: the mode changes nothing).
    The draws are not the reference's (different RNGs): carry its weights
    across with ``models/convert.py`` for parity."""
    return common.init_model(lambda: GPT2(cfg), generator, device)


num_params = common.num_params


# ----------------------------------------------------------------------
# Training plane.
# ----------------------------------------------------------------------
def loss_fn(model: GPT2, tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy; targets = tokens shifted by the caller
    (logsumexp form, ``models/common.py`` ``next_token_loss``)."""
    return common.next_token_loss(model(tokens), targets)


def make_train_step(cfg: GPT2Config, optimizer: torch.optim.Optimizer):
    """train_step(model, tokens, targets) -> loss: one AdamW step of
    ``model`` in place (see ``models/common.py``).  ``model`` must be
    built from ``cfg``, the config the reference's step applies."""
    return common.make_train_step(loss_fn, cfg, optimizer)


def make_adamw(params, lr: float = 3e-4, weight_decay: float = 0.1) -> torch.optim.AdamW:
    """The reference's ``optax.adamw(lr, b1=0.9, b2=0.95,
    weight_decay=0.1)``: one parameter group, so every parameter is
    decayed as optax decays it; optax's update -lr * (adam + wd * p) is
    torch's decoupled p * (1 - lr * wd) - lr * adam."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.95), eps=1e-8,
                             weight_decay=weight_decay)


def make_sharded_train_state(cfg: GPT2Config, mesh,
                             make_optimizer: Callable[[Any], torch.optim.Optimizer],
                             generator: Optional[torch.Generator] = None):
    """The model and its optimizer on ``mesh`` with the Megatron layout of
    ``parallel/sharding.py`` (shared recipe in ``models/common.py``):
    (model, optimizer, specs).  The weights are ``init_model``'s on the
    mesh's device from ``generator`` (default: seed 0 there), the same on
    every rank and the same as an unsharded init from it."""
    return common.make_sharded_train_state(
        lambda g: init_model(cfg, g, device=g.device), mesh, make_optimizer, generator=generator)


def make_sharded_train_step(cfg: GPT2Config, mesh, optimizer: torch.optim.Optimizer):
    """The SPMD train step: dp/fsdp over the batch, tp over hidden, sp
    over the sequence (ring attention when ``cfg.sp_axis`` names it); the
    model and optimizer from ``make_sharded_train_state`` (shared recipe
    in ``models/common.py``)."""
    return common.make_sharded_train_step(make_train_step(cfg, optimizer), mesh)


def flops_per_token(cfg: GPT2Config, seq_len: int) -> float:
    """Approximate training FLOPs/token: 6*N + attention term."""
    n = (
        cfg.n_layer * (12 * cfg.d_model**2)
        + cfg.vocab_size * cfg.d_model * 2
        + cfg.max_seq_len * cfg.d_model
    )
    attn = cfg.n_layer * 12 * seq_len * cfg.d_model  # fwd+bwd attention matmuls
    return 6.0 * n + attn


# ----------------------------------------------------------------------
# Inference plane: prefill / single-token decode with an external KV cache.
# ----------------------------------------------------------------------
def _ln(x: torch.Tensor, ln: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps).to(dtype)


def _qkv(blk: Block, x: torch.Tensor, cfg: GPT2Config):
    """ln_1 -> fused qkv projection -> (q, k, v), each [..., H, Dh]: views
    of the projection's output, which the flash kernel reads through their
    strides."""
    qkv = blk.attn.qkv(_ln(x, blk.ln_1, cfg.dtype))
    return tuple(common.split_heads(t, cfg.n_head) for t in qkv.split(cfg.d_model, dim=-1))


def _forward_prompt(model: GPT2, tokens: torch.Tensor):
    """Causal forward over whole prompts from position 0: the final
    hidden states after ln_f, and each layer's K and V [B, T, H, Dh].
    With ``remat``, each block's forward is checkpointed when autograd is
    recording (its recompute launches the attention forward again)."""
    cfg = model.cfg
    T = tokens.shape[1]
    pos = torch.arange(T, device=tokens.device)
    x = model.wte(tokens) + model.wpe(pos)[None]
    remat = cfg.remat and torch.is_grad_enabled()
    ks, vs = [], []
    for blk in model.blocks():
        x, k, v = checkpoint(blk, x, use_reentrant=False) if remat else blk(x)
        ks.append(k)
        vs.append(v)
    return _ln(x, model.ln_f, cfg.dtype), ks, vs


def prefill_forward(model: GPT2, tokens: torch.Tensor,
                    last_index: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-prompt forward from position 0.

    tokens [B, T] -> (logits_last [B, vocab], k [L, B, T, H, Dh],
    v [L, B, T, H, Dh]).  ``last_index`` [B] selects which position's
    logits to return (for right-padded prompts); default the final one.
    """
    B = tokens.shape[0]
    x, ks, vs = _forward_prompt(model, tokens)
    if last_index is None:
        x_last = x[:, -1, :]
    else:
        x_last = x[torch.arange(B, device=x.device), last_index.long()]
    return model.lm_head(x_last), torch.stack(ks), torch.stack(vs)


def decode_forward(model: GPT2, tok: torch.Tensor, pos: torch.Tensor, k_ctx: torch.Tensor,
                   v_ctx: torch.Tensor, ctx_mask: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step over an externally gathered KV context.

    tok [B] current token ids; pos [B] their positions; k_ctx/v_ctx
    [L, B, C, H, Dh] the cached keys/values (ctx_mask [B, C] marks real
    entries).  Returns (logits [B, vocab], k_new [L, B, H, Dh],
    v_new [L, B, H, Dh]) for the caller to write at position pos.  The
    new token's own score is appended after the context scores before the
    float32 softmax, and the probabilities are cast to the dtype before
    P.V, as in the reference.
    """
    cfg = model.cfg
    B = tok.shape[0]
    scale = 1.0 / math.sqrt(cfg.d_head)
    # The reference's position lookup is a JAX gather, which clamps an
    # index past the table to its last row (``ray_tpu/models/gpt2.py``
    # ``decode_forward``).  The static-batch server's finished lanes keep
    # decoding in lockstep and may run past max_seq_len, so clamp as the
    # reference does instead of raising (CPU) or faulting (CUDA).
    x = model.wte(tok) + model.wpe(pos.clamp(max=cfg.max_seq_len - 1))
    k_news, v_news = [], []
    for i, blk in enumerate(model.blocks()):
        q, k, v = _qkv(blk, x, cfg)  # [B, H, Dh]
        s_ctx = torch.einsum("bhd,bchd->bhc", q, k_ctx[i]).float() * scale
        s_ctx = s_ctx.masked_fill(~ctx_mask[:, None, :], _NEG)
        s_self = (q * k).sum(-1).float()[..., None] * scale
        probs = torch.softmax(torch.cat([s_ctx, s_self], dim=-1), dim=-1).to(cfg.dtype)
        att = torch.einsum("bhc,bchd->bhd", probs[..., :-1], v_ctx[i])
        att = att + probs[..., -1:] * v
        x = x + blk.attn.attn_out(att.reshape(B, cfg.d_model))
        x = x + blk.mlp(_ln(x, blk.ln_2, cfg.dtype))
        k_news.append(k)
        v_news.append(v)
    logits = model.lm_head(_ln(x, model.ln_f, cfg.dtype))
    return logits, torch.stack(k_news), torch.stack(v_news)


def sample_logits(logits: torch.Tensor, generator: Optional[torch.Generator],
                  temperature: torch.Tensor, top_k: int = 0) -> torch.Tensor:
    """Per-sequence sampling: temperature <= 0 means greedy (argmax);
    otherwise softmax sampling at that temperature (Gumbel-max over noise
    drawn from ``generator``), optionally truncated to the ``top_k``
    highest-probability tokens (static; 0 = off).

    logits [B, V], temperature [B] -> token ids [B] (int64).  Greedy
    matches the reference token for token; sampled tokens match it only in
    distribution, since the two frameworks draw different random bits.
    """
    logits = logits.float()
    greedy = logits.argmax(dim=-1)
    scaled = logits / temperature.clamp_min(1e-6)[:, None]
    if 0 < top_k < logits.shape[-1]:
        kth = scaled.topk(top_k, dim=-1).values[:, -1:]
        scaled = scaled.masked_fill(scaled < kth, _NEG)
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    sampled = (scaled + gumbel).argmax(dim=-1)
    return torch.where(temperature > 0.0, sampled, greedy)


@torch.inference_mode()
def generate_greedy(model: GPT2, tokens: torch.Tensor, n_new: int) -> torch.Tensor:
    """Reference full-forward greedy generation (no KV cache): re-runs the
    model over the growing sequence.  O(T^2) per token: the test oracle."""
    out = tokens
    for _ in range(n_new):
        nxt = model(out)[:, -1, :].argmax(dim=-1)
        out = torch.cat([out, nxt[:, None].to(out.dtype)], dim=1)
    return out[:, tokens.shape[1]:]
