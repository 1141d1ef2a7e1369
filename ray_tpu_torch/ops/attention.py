"""Causal attention dispatch (port of ``ray_tpu/ops/attention.py``).

One entry point for the models: ``causal_attention`` takes ``[B, T, H, D]``
q, k, v and is differentiable.  For the head dims the hand-written flash
kernels take (64 and 128) it runs ``flash_attention``
(``ops/flash_attention.py``: the forward, and the dq and dkv kernels in the
backward), which launches the kernels on the card and their plain
versions on the CPU.  Every other head dim takes the einsum path
``reference_causal_attention``, as the reference takes its einsum path
where its Pallas kernel does not fit (``_use_pallas``).  The condition is
on the shape alone, never on a failure: the wrappers stay strict.
Sequence-parallel ring attention (``mesh``/``sp_axis``) is not ported
yet.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ray_tpu_torch.ops.flash_attention import FLASH_HEAD_DIMS, flash_attention


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
    if q.shape[-1] in FLASH_HEAD_DIMS:
        return flash_attention(q, k, v, causal=True)
    return reference_causal_attention(q, k, v)
