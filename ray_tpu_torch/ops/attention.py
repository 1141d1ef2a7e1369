"""Causal attention dispatch (port of ``ray_tpu/ops/attention.py``).

One entry point for the models: ``causal_attention`` takes ``[B, T, H, D]``
q, k, v and is differentiable.  On the card it launches the hand-written
flash kernels (``ops/flash_attention.py``: the forward, and the dq and dkv
kernels in the backward) for every shape; on the CPU it runs their plain
versions.  There is no shape gate and no fallback between the two.
Sequence-parallel ring attention (``mesh``/``sp_axis``) is not ported
yet.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ray_tpu_torch.ops.flash_attention import flash_attention


def reference_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[B, T, H, D] einsum attention with causal mask; f32 softmax, the
    probabilities cast to ``q.dtype`` before P.V, as the reference."""
    B, T, H, D = q.shape
    scale = 1.0 / (D**0.5)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    keep = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~keep, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     mesh: Any = None, sp_axis: Optional[str] = None) -> torch.Tensor:
    """Main entry: [B, T, H, D] -> [B, T, H, D], causal."""
    if mesh is not None or sp_axis is not None:
        raise NotImplementedError(
            "sequence-parallel ring attention is not ported to ray_tpu_torch yet"
        )
    return flash_attention(q, k, v, causal=True)
