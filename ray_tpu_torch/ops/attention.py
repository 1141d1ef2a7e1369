"""Causal attention dispatch (port of ``ray_tpu/ops/attention.py``).

One entry point for the models: ``causal_attention`` takes ``[B, T, H, D]``
q, k, v and is differentiable.  For the head dims the hand-written flash
kernels take (64, 128, 192 and 256, those the reference's ``_use_pallas``
sends to its Pallas kernels) it runs ``flash_attention``
(``ops/flash_attention.py``: the forward, and the dq and dkv kernels in the
backward), which launches the kernels on the card and their plain
versions on the CPU.  Every other head dim takes the einsum path
``reference_causal_attention``, as the reference takes its einsum path
where its Pallas kernel does not fit (``_use_pallas``).  The condition is
on the shape alone, never on a failure: the wrappers stay strict.

Sharded inputs, as the reference's placement dispatch:

- ``mesh`` given with an ``sp_axis`` of size above 1: the sequence is
  sharded over it and ring attention runs (``ops/ring_attention.py``,
  the flash kernels a block);
- q, k, v DTensors otherwise (a GSPMD plan's step, the Megatron
  recipes): each rank attends over its own batch rows and heads
  (``local_placements``), where attention is exact, through the same
  flash or einsum path, and the result is a DTensor with those
  placements.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

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
    """Main entry: [B, T, H, D] -> [B, T, H, D], causal.

    When ``mesh`` (a ``DeviceMesh``) has a >1 ``sp_axis``, T is sharded
    over it and ring attention runs over that axis."""
    if mesh is not None and sp_axis:
        from ray_tpu_torch.parallel.mesh import mesh_axis_size

        if mesh_axis_size(mesh, sp_axis) > 1:
            from ray_tpu_torch.ops.ring_attention import ring_causal_attention

            return ring_causal_attention(q, k, v, mesh=mesh, axis=sp_axis)
    if type(q) is not torch.Tensor and _is_dtensor(q):
        return _local_attention(q, k, v)
    return _attention(q, k, v)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if q.shape[-1] in FLASH_HEAD_DIMS:
        return flash_attention(q, k, v, causal=True)
    return reference_causal_attention(q, k, v)


def _is_dtensor(t: Any) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local_placements(shape: Sequence[int], mesh: Any, placements: Sequence[Any],
                     seq_dim: Optional[int] = None) -> list:
    """Placements of a [B, T, H, D] tensor under which each rank's
    attention is its own: mesh dim ``seq_dim`` shards T (the ring's
    axis), a mesh dim that shards the batch keeps it, and every other one
    shards the heads where they divide (else replicates)."""
    from torch.distributed.tensor import Replicate, Shard

    out, heads = [], 1
    for i, p in enumerate(placements):
        n = mesh.size(i)
        if i == seq_dim:
            out.append(Shard(1))
        elif isinstance(p, Shard) and p.dim == 0:
            out.append(p)
        elif shape[2] % (heads * n) == 0:
            heads *= n
            out.append(Shard(2))
        else:
            out.append(Replicate())
    return out


def _local_attention(q, k, v):
    """Causal attention of DTensors, each rank over its batch rows and
    heads: q, k, v are redistributed to ``local_placements`` (at most a
    local slice when they are replicated over the axis), attend locally,
    and come back as one DTensor with those placements."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.parallel.sharding import contiguous_stride

    mesh = q.device_mesh
    placements = local_placements(q.shape, mesh, q.placements)
    q, k, v = (t.redistribute(mesh, placements) for t in (q, k, v))
    out = _attention(q.to_local(), k.to_local(), v.to_local()).contiguous()
    return DTensor.from_local(out, mesh, placements, run_check=False, shape=q.shape,
                              stride=contiguous_stride(q.shape))
