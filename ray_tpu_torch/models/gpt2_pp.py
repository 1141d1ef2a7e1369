"""Pipeline-parallel GPT-2 (port of ``ray_tpu/models/gpt2_pp.py``):
transformer blocks staged over the "pp" mesh axis via the SPMD
microbatched pipeline in :mod:`ray_tpu_torch.parallel.pipeline`.

The embedding, final layernorm, and lm head run replicated over pp (they
are a tiny fraction of the FLOPs); the block stack — where the compute
lives — is split into pp stages of n_layer/pp layers each, and
activations rotate between stages point to point.

Parameters are the port's GPT-2 names (``dict(model.named_parameters())``
or a ``state_dict``): a block's tensors stack into leaves keyed by their
name inside the block (``attn.qkv.weight``: [pp, L/pp, 3d, d]), and a
stage applies its stacked layers in turn with ``torch.func.functional_call``
on a ``Block`` skeleton, which takes the place of the reference's
``lax.scan`` over the stack.  The embedding and the head are those of
``models/gpt2.py`` (``_forward_prompt``, ``loss_fn``): f32 rows cast to
the compute dtype, LayerNorm in f32, the logsumexp loss of
``models/common.py``.  ``mesh`` is a ``DeviceMesh`` with a ``pp`` dim, or
an int pp: the stages emulated on one device.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch.func import functional_call

from ray_tpu_torch.models import common
from ray_tpu_torch.models.gpt2 import _LN_EPS, Block, GPT2Config
from ray_tpu_torch.parallel.pipeline import (
    microbatch,
    pipeline_interleaved,
    pipeline_spmd,
    stack_stage_params,
    stack_stage_params_interleaved,
)

_FIRST = ("wte.weight", "wpe.weight")
_LAST = ("ln_f.weight", "ln_f.bias", "lm_head.weight")


def _blocks(params: Mapping[str, torch.Tensor], cfg: GPT2Config) -> list:
    """Each layer's tensors keyed by their name inside the block."""
    out = []
    for i in range(cfg.n_layer):
        prefix = f"h_{i}."
        out.append({k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)})
    return out


def split_pipeline_params(params: Mapping[str, torch.Tensor], cfg: GPT2Config,
                          pp: int) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(stage_params, rest): blocks h_0..h_{L-1} stacked into leaves of
    shape [pp, L/pp, ...]; `rest` holds the un-staged params (wte, wpe,
    ln_f, lm_head)."""
    if cfg.n_layer % pp:
        raise ValueError(f"n_layer {cfg.n_layer} not divisible by pp={pp}")
    per = cfg.n_layer // pp
    blocks = _blocks(params, cfg)
    stage_params = stack_stage_params(
        [stack_stage_params(blocks[s * per:(s + 1) * per]) for s in range(pp)])
    rest = {k: v for k, v in params.items() if not k.startswith("h_")}
    return stage_params, rest


def merge_pipeline_params(stage_params: Mapping[str, torch.Tensor],
                          rest: Mapping[str, torch.Tensor],
                          cfg: GPT2Config) -> Dict[str, torch.Tensor]:
    """Inverse of split_pipeline_params (for checkpoint interop)."""
    params = dict(rest)
    for name, x in stage_params.items():
        flat = x.reshape(-1, *x.shape[2:])
        for i in range(cfg.n_layer):
            params[f"h_{i}.{name}"] = flat[i]
    return params


def _embed(wte: torch.Tensor, wpe: torch.Tensor, tokens: torch.Tensor,
           cfg: GPT2Config) -> torch.Tensor:
    """Token + position embedding (shared by both pipeline variants)."""
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    return F.embedding(tokens, wte).to(cfg.dtype) + F.embedding(pos, wpe).to(cfg.dtype)[None]


def _head_loss(last: Mapping[str, torch.Tensor], x: torch.Tensor, targets: torch.Tensor,
               cfg: GPT2Config) -> torch.Tensor:
    """Final LN + lm head + fused-logsumexp mean loss (shared)."""
    x = F.layer_norm(x.float(), (cfg.d_model,), last["ln_f.weight"], last["ln_f.bias"],
                     _LN_EPS).to(cfg.dtype)
    logits = F.linear(x, last["lm_head.weight"].to(cfg.dtype))
    return common.next_token_loss(logits, targets)


def _stack_fn(cfg: GPT2Config):
    """fn(layers, x): the stacked layers ([n, ...] leaves) applied in turn."""
    block = common.meta_build(lambda: Block(cfg))

    def apply(layers: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        n = next(iter(layers.values())).shape[0]
        for i in range(n):
            x = functional_call(block, {k: v[i] for k, v in layers.items()}, (x,))[0]
        return x

    return apply


def make_pp_loss_fn(cfg: GPT2Config, mesh, n_micro: int, axis: str = "pp"):
    """loss(stage_params, rest, tokens, targets) — differentiable w.r.t.
    both parameter trees."""
    pipe = pipeline_spmd(_stack_fn(cfg), mesh, axis)

    def loss(stage_params, rest, tokens, targets):
        B, T = tokens.shape
        x = _embed(rest["wte.weight"], rest["wpe.weight"], tokens, cfg)
        x = pipe(stage_params, microbatch(x, n_micro)).reshape(B, T, -1)
        # final LN + head (replicated over pp).
        return _head_loss(rest, x, targets, cfg)

    return loss


# ---------------------------------------------------------------------------
# Interleaved schedule with embed/head as TRUE pipeline stages


def split_pipeline_params_interleaved(params: Mapping[str, torch.Tensor], cfg: GPT2Config,
                                      pp: int, v: int) -> Tuple[Any, Any, Any]:
    """(first_params, chunk_params, last_params): blocks split into
    S = pp*v chunks with the interleaved device assignment; wte/wpe go
    to the FIRST stage, ln_f/lm_head to the LAST (they are pipeline
    stages now, not replicated pre/post work)."""
    if cfg.n_layer % (pp * v):
        raise ValueError(f"n_layer {cfg.n_layer} not divisible by pp*v={pp * v}")
    per = cfg.n_layer // (pp * v)
    blocks = _blocks(params, cfg)
    chunks = [stack_stage_params(blocks[s * per:(s + 1) * per]) for s in range(pp * v)]
    first = {k: params[k] for k in _FIRST}
    last = {k: params[k] for k in _LAST}
    return first, stack_stage_params_interleaved(chunks, pp, v), last


def make_pp_loss_fn_interleaved(cfg: GPT2Config, mesh, n_micro: int, n_virtual: int = 1,
                                axis: str = "pp"):
    """loss(first_params, chunk_params, last_params, tokens, targets) —
    the full model staged over the pipeline: embed enters on device 0,
    per-token loss exits on device pp-1, blocks interleave v chunks per
    device (bubble (pp-1)/(pp-1+M*v))."""

    def first_fn(first, tokens_mb):
        return _embed(first["wte.weight"], first["wpe.weight"], tokens_mb, cfg)

    def last_fn(last, x, targets_mb):
        return _head_loss(last, x, targets_mb, cfg)

    pipe = pipeline_interleaved(first_fn, _stack_fn(cfg), last_fn, mesh, n_virtual, axis)

    def loss(first_params, chunk_params, last_params, tokens, targets):
        tok_mbs = microbatch(tokens, n_micro)
        tgt_mbs = microbatch(targets, n_micro)
        per_mb = pipe(first_params, chunk_params, last_params, tok_mbs, tgt_mbs)
        return per_mb.mean()

    return loss
