"""Ring attention: exact causal attention with the sequence dim sharded
over a mesh axis (port of ``ray_tpu/ops/ring_attention.py``).

The reference rotates K/V blocks around the ring with ``ppermute`` while
each device keeps an einsum online-softmax accumulator.  Here the ring is
point-to-point sends and receives of K/V blocks on the ``axis`` sub-mesh's
process group, and each block goes through the flash kernels:

- **forward.** Rank ``me`` of ``n`` holds at step ``i`` the block of rank
  ``src = (me - i) % n``.  The diagonal block (``src == me``, step 0) runs
  B1 causal, an earlier block (``src < me``) B1 non-causal, and a later
  one (``src > me``) is skipped: all its keys lie in the future.  Each
  block's normalised O and float32 LSE merge into a running O and LSE:
  ``lse' = logaddexp(lse, lse_b)``, ``o' = o e^(lse - lse') + o_b
  e^(lse_b - lse')``, the same function as the reference's running
  max/sum (``tests/test_torch_ring_attention.py`` holds the two).
- **backward.** Delta = rowsum(dO * O) once; the ring runs again, B2
  giving each block's contribution to dQ and B3 its dK/dV against the
  merged LSE.  The dK/dV accumulators (float32) travel with their block
  and are back at their owner after ``n`` steps.

The per-block steps are plain functions (``block_forward``,
``block_backward``, ``merge``): on the card they launch the kernels, on
the CPU the kernels' plain versions, and head dims the kernels do not
take go through the plain versions as ``ops/attention.py`` sends them to
its einsum path.  Only the ``axis`` mesh dim is manual; the others keep
each rank's batch rows or heads, where attention is local.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops import flash_attention as fa


def _kernels(d: int):
    """(fwd, dq, dkv): the wrappers for the head dims the kernels take,
    their plain versions otherwise."""
    if d in fa.FLASH_HEAD_DIMS:
        return fa.flash_attention_fwd, fa.flash_attention_dq, fa.flash_attention_dkv
    return (fa.flash_attention_fwd_reference, fa.flash_attention_dq_reference,
            fa.flash_attention_dkv_reference)


def block_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ring step's attention of the local queries over one K/V block:
    (O [B, Tl, H, D] in q's dtype, normalised over the block; LSE
    [B, H, Tl] float32).  ``causal`` on the diagonal block only."""
    return _kernels(q.shape[-1])[0](q, k, v, causal)


def block_backward(q, k, v, do, lse, delta, causal: bool):
    """One ring step's (dQ, dK, dV) for one K/V block, with ``lse`` and
    ``delta`` the merged rows ([B, H, Tl] float32): P = exp(s - LSE) is
    the block's share of the whole softmax, so the block's gradients add
    up to the whole sequence's."""
    _, dq_fn, dkv_fn = _kernels(q.shape[-1])
    return (dq_fn(q, k, v, do, lse, delta, causal),
            *dkv_fn(q, k, v, do, lse, delta, causal))


def merge(o: Optional[torch.Tensor], lse: Optional[torch.Tensor], o_b: torch.Tensor,
          lse_b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Running (O float32 [B, Tl, H, D], LSE float32 [B, H, Tl]) after
    one more block's normalised output and LSE."""
    if o is None:
        return o_b.float(), lse_b
    new = torch.logaddexp(lse, lse_b)
    a = torch.exp(lse - new).transpose(1, 2)[..., None]
    b = torch.exp(lse_b - new).transpose(1, 2)[..., None]
    return o * a + o_b.float() * b, new


def emulate_ring(q, k, v, do, n: int, fwd=block_forward, bwd=block_backward):
    """The ring's arithmetic for ``n`` ranks emulated on one device, for
    whole [B, T, H, D] tensors split on T into ``n`` blocks: each rank's
    blocks in the ring's order, merged as ``_RingAttention.forward`` does,
    then the backward with each block's dK/dV summed in the order the ring
    carries its accumulator (owner first).  Returns (out, dq, dk, dv), each
    [B, T, H, D].  ``fwd`` and ``bwd`` take ``block_forward``'s and
    ``block_backward``'s places (a caller may hold each launch)."""
    qs, ks, vs, dos = (t.chunk(n, dim=1) for t in (q, k, v, do))
    outs, lses = [], []
    for me in range(n):
        o = lse = None
        for i in range(me + 1):  # src = me - i: the diagonal, then earlier blocks
            o, lse = merge(o, lse, *fwd(qs[me], ks[me - i], vs[me - i], i == 0))
        outs.append(o.to(q.dtype).contiguous())
        lses.append(lse)
    deltas = [fa._delta(outs[me], dos[me]) for me in range(n)]
    acc = [[torch.zeros(qs[j].shape, dtype=torch.float32, device=q.device) for j in range(n)]
           for _ in range(3)]  # dq by rank; dk, dv by block
    for i in range(n):  # ring step i: rank me holds block me - i
        for me in range(i, n):
            src = me - i
            dq, dk, dv = bwd(qs[me], ks[src], vs[src], dos[me], lses[me], deltas[me], i == 0)
            acc[0][me] += dq.float()
            acc[1][src] += dk.float()
            acc[2][src] += dv.float()
    return (torch.cat(outs, dim=1),
            *(torch.cat(a, dim=1).to(t.dtype) for a, t in zip(acc, (q, k, v))))


def _shift(tensors, group, me: int, n: int):
    """Send each tensor to rank ``me + 1`` of the ring and receive the
    same-shaped tensors from rank ``me - 1``."""
    import torch.distributed as dist

    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    out = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), nxt, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, t, prv, group) for t in out]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group):
        import torch.distributed as dist

        me, n = dist.get_rank(group), dist.get_world_size(group)
        o = lse = None
        kb, vb = k, v
        for i in range(n):
            src = (me - i) % n
            if src <= me:
                o, lse = merge(o, lse, *block_forward(q, kb, vb, causal=src == me))
            if i < n - 1:
                kb, vb = _shift((kb, vb), group, me, n)
        out = o.to(q.dtype).contiguous()
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group = group
        return out

    @staticmethod
    def backward(ctx, do):
        import torch.distributed as dist

        q, k, v, out, lse = ctx.saved_tensors
        group = ctx.group
        me, n = dist.get_rank(group), dist.get_world_size(group)
        if do.is_cuda and not fa._kernel_layout_ok(do):
            do = do.clone(memory_format=torch.contiguous_format)
        delta = fa._delta(out, do)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kb, vb = k, v
        dkb = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dvb = torch.zeros_like(dkb)
        for i in range(n):
            src = (me - i) % n
            if src <= me:
                dq_i, dk_i, dv_i = block_backward(q, kb, vb, do, lse, delta, causal=src == me)
                dq += dq_i.float()
                dkb += dk_i.float()
                dvb += dv_i.float()
            # the accumulators travel with their block: after n shifts each
            # is back at its owner; K and V need only the first n - 1
            if i < n - 1:
                kb, vb, dkb, dvb = _shift((kb, vb, dkb, dvb), group, me, n)
            elif n > 1:
                dkb, dvb = _shift((dkb, dvb), group, me, n)
        return dq.to(q.dtype), dkb.to(k.dtype), dvb.to(v.dtype), None


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         group) -> torch.Tensor:
    """Differentiable ring attention over this rank's sequence block
    ([B, Tl, H, D] local tensors) on ``group``, whose rank order is the
    blocks' order along the sequence."""
    return _RingAttention.apply(q, k, v, group)


def ring_causal_attention(q, k, v, *, mesh, axis: str = "sp"):
    """[B, T, H, D] DTensors on ``mesh`` with T sharded over ``axis`` ->
    the same sharding out.  The sequence goes to ``Shard(1)`` over
    ``axis``; the other mesh dims keep a batch shard or take the heads
    (``ops/attention.py`` ``local_placements``)."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.ops.attention import local_placements
    from ray_tpu_torch.parallel.sharding import contiguous_stride

    if not all(isinstance(t, DTensor) for t in (q, k, v)):
        raise TypeError("ring_causal_attention takes DTensors on the mesh "
                        "(parallel.sharding.place lays a tensor out)")
    sp = mesh.mesh_dim_names.index(axis)
    placements = local_placements(q.shape, mesh, q.placements, seq_dim=sp)
    q, k, v = (t.redistribute(mesh, placements) for t in (q, k, v))
    out = ring_attention_local(q.to_local(), k.to_local(), v.to_local(), mesh.get_group(sp))
    return DTensor.from_local(out, mesh, placements, run_check=False, shape=q.shape,
                              stride=contiguous_stride(q.shape))
