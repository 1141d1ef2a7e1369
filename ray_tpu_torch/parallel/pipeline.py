"""SPMD pipeline parallelism over a "pp" mesh axis (port of
``ray_tpu/parallel/pipeline.py``).

GPipe-style microbatched pipelining as one SPMD program: every rank of the
mesh's ``pp`` sub-group runs the same schedule, and activations rotate
between stages point to point, with no per-stage actor and no host-side
scheduler (the MPMD formulation is ``train/sharding/pipeline_plane.py``).

Schedule: with S stages and M microbatches the schedule runs S-1+M steps.
At step t, stage s computes microbatch t-s (when 0 <= t-s < M): stage 0
feeds from the input queue, later stages from the activation received at
the end of the previous step; the last stage writes its result into the
output buffer.  Bubble fraction = (S-1)/(S-1+M).

One per-step body (``_gpipe_step``, ``_interleaved_step``) decides, for a
stage and a step, which microbatch the stage works on, whether it is
active, what it feeds on, what it records and what it sends.  Two
transports run it:

- **real ranks** (``pipeline_spmd`` / ``pipeline_interleaved`` on a
  ``DeviceMesh``): the reference's ``lax.ppermute`` to ``(i+1) % pp`` is
  ``_Shift``, a differentiable point-to-point shift whose backward sends
  the gradient the other way (ppermute's transpose); the reference's final
  ``psum`` is ``_ReplicatedSum``, and the replicated inputs are
  ``_Replicated`` (identity forward, summed gradient), as ``shard_map``
  transposes a replicated input.  Every rank must run the same collectives
  in the same order in the backward too, though a stage uses only some of
  them (stage 0 never reads what it receives): each collective therefore
  takes and returns a scalar *schedule token*, threaded from the inputs
  through every shift into the output, so autograd runs every rank's
  collectives, each exactly once, in reverse schedule order.
- **one device** (``emulate_pipeline`` / ``emulate_pipeline_interleaved``,
  the counterpart of ``ops/ring_attention.py``'s ``emulate_ring``): pp
  stages in turn, the rotation a list shift, differentiated by plain
  autograd.

Both share the body, so a run of the emulation tests the schedule's own
code.  An inactive step skips ``stage_fn`` where the reference computes it
and zeroes the result (the same values and gradients); it still sends its
zeros.

Parameter trees are nested mappings of tensors (``parallel/sharding.py``'s
``tree_map``).  On real ranks each leaf of the stage parameters holds every
stage's slice on its leading dim (``stack_stage_params``), and rank i
uses slice i, so a parameter's gradient lands in the slice of the rank that
owns it: the reference's gradient sharded over ``pp``.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Union

import torch

from ray_tpu_torch.parallel.sharding import tree_leaves, tree_map


def stack_stage_params(params_per_stage: list) -> Any:
    """Stack a list of per-stage parameter trees along a new leading axis
    (the stage axis)."""
    return tree_map(lambda *xs: torch.stack(xs), *params_per_stage)


def microbatch(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """[B, ...] -> [M, B/M, ...]."""
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by {n_micro} microbatches")
    return x.reshape(n_micro, b // n_micro, *x.shape[1:])


def bubble_fraction(pp: int, n_micro: int, v: int = 1) -> float:
    """Idle fraction of the schedule: each device is busy M*v of the
    pp*v+M-1 total steps.  v=1 reduces to GPipe's (pp-1)/(pp-1+M); at
    M=pp the interleaved case is (pp-1)/(pp-1+M*v) — the same layer
    count pipelining with a v-fold smaller relative bubble (the
    Megatron interleaved-1F1B bubble result)."""
    total = pp * v + n_micro - 1
    return (total - n_micro * v) / total


def stack_stage_params_interleaved(params_per_stage: list, pp: int, v: int) -> Any:
    """Stack S = pp*v per-chunk parameter trees into leaves of shape
    [pp, v, ...] with device d owning chunks d, d+pp, ... (the
    interleaved assignment)."""
    if len(params_per_stage) != pp * v:
        raise ValueError(f"need {pp * v} chunks, got {len(params_per_stage)}")
    per_device = [stack_stage_params([params_per_stage[d + lap * pp] for lap in range(v)])
                  for d in range(pp)]
    return stack_stage_params(per_device)


# ----------------------------------------------------------------------
# The per-step bodies, shared by both transports
# ----------------------------------------------------------------------
def _gpipe_step(stage_fn, params, microbatches, recv, stage: int, pp: int, t: int,
                outputs: list) -> torch.Tensor:
    """Step ``t`` of ``stage``: the activation it sends on.  Stage s works
    on microbatch t - s; the last stage records it in ``outputs``."""
    j = t - stage
    if not 0 <= j < microbatches.shape[0]:
        return torch.zeros_like(microbatches[0])
    y = stage_fn(params, microbatches[j] if stage == 0 else recv)
    if stage == pp - 1:
        outputs[j] = y
    return y


def _interleaved_step(fns, params, inputs, aux, recv, d: int, pp: int, v: int, t: int,
                      outputs: list, zero_act: torch.Tensor) -> torch.Tensor:
    """Step ``t`` of device ``d`` holding ``v`` chunks: microbatch j enters
    device 0 on lap 0 through ``first_fn``, circulates the ring ``v`` laps
    (device d's chunk ``lap`` on lap ``lap``), and leaves device pp-1 on
    lap v-1 through ``last_fn`` into ``outputs``."""
    first_fn, mid_fn, last_fn = fns
    first_params, chunk_params, last_params = params
    tp = t - d
    lap, j = tp // pp, tp % pp  # j: the microbatch (m <= pp: no collisions)
    if not (tp >= 0 and lap < v and j < inputs.shape[0]):
        return zero_act
    x = first_fn(first_params, inputs[j]) if d == 0 and lap == 0 else recv
    y = mid_fn(tree_map(lambda p: p[lap], chunk_params), x)
    if d == pp - 1 and lap == v - 1:
        outputs[j] = last_fn(last_params, y, aux[j])
    return y


def _stack_outputs(outputs: list, like: torch.Tensor) -> torch.Tensor:
    """[M, ...]: the recorded outputs, zeros where this stage recorded none."""
    return torch.stack([o if o is not None else torch.zeros_like(like) for o in outputs])


def _meta_like(fn, *args) -> torch.Tensor:
    """Zeros shaped as ``fn(*args)``'s output on the first tensor
    argument's device, found by running ``fn`` on meta tensors (the
    reference's ``jax.eval_shape``)."""
    device = next(leaf for a in args for leaf in tree_leaves(a)).device
    with torch.no_grad():
        out = fn(*(tree_map(lambda x: x.detach().to("meta"), a) for a in args))
    return torch.zeros(out.shape, dtype=out.dtype, device=device)


# ----------------------------------------------------------------------
# One device: the stages emulated in turn
# ----------------------------------------------------------------------
def emulate_pipeline(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], pp: int):
    """``pipeline_spmd``'s schedule for ``pp`` stages on one device:
    ``f(stage_params, microbatches)`` with every leaf of ``stage_params``
    [pp, ...]; returns the last stage's [M, ...] outputs."""

    def run(stage_params, microbatches):
        params = [tree_map(lambda x: x[s], stage_params) for s in range(pp)]
        recv = [torch.zeros_like(microbatches[0])] * pp
        outputs: List[Optional[torch.Tensor]] = [None] * microbatches.shape[0]
        for t in range(pp - 1 + microbatches.shape[0]):
            sent = [_gpipe_step(stage_fn, params[s], microbatches, recv[s], s, pp, t, outputs)
                    for s in range(pp)]
            recv = [sent[(s - 1) % pp] for s in range(pp)]
        return torch.stack(outputs)

    return run


def emulate_pipeline_interleaved(first_fn, mid_fn, last_fn, pp: int, n_virtual: int = 1):
    """``pipeline_interleaved``'s schedule for ``pp`` devices of
    ``n_virtual`` chunks each on one device: ``f(first_params,
    chunk_params, last_params, inputs, aux)`` with chunk leaves [pp, v,
    ...]; returns the [M, ...] ``last_fn`` outputs."""
    v = n_virtual

    def run(first_params, chunk_params, last_params, inputs, aux):
        m = _check_rounds(inputs, pp)
        zero_act = _meta_like(first_fn, first_params, inputs[0])
        chunks = [tree_map(lambda x: x[d], chunk_params) for d in range(pp)]
        recv = [zero_act] * pp
        outputs: List[Optional[torch.Tensor]] = [None] * m
        for t in range(pp * v + m - 1):
            sent = [_interleaved_step((first_fn, mid_fn, last_fn),
                                      (first_params, chunks[d], last_params), inputs, aux,
                                      recv[d], d, pp, v, t, outputs, zero_act)
                    for d in range(pp)]
            recv = [sent[(d - 1) % pp] for d in range(pp)]
        return torch.stack(outputs)

    return run


def _check_rounds(inputs: torch.Tensor, pp: int) -> int:
    m = inputs.shape[0]
    if m > pp:
        raise ValueError(
            f"interleaved schedule needs n_micro ({m}) <= pp ({pp}); "
            "issue microbatch rounds upstream"
        )
    return m


# ----------------------------------------------------------------------
# Real ranks: the schedule-token collectives
# ----------------------------------------------------------------------
def _ring_peers(group):
    import torch.distributed as dist

    me, n = dist.get_rank(group), dist.get_world_size(group)
    return (n, dist.get_global_rank(group, (me + 1) % n),
            dist.get_global_rank(group, (me - 1) % n))


def _exchange(send: torch.Tensor, to: int, frm: int, group) -> torch.Tensor:
    """Send ``send`` to global rank ``to`` and receive a tensor of its
    shape from global rank ``frm``."""
    import torch.distributed as dist

    out = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send.contiguous(), to, group),
           dist.P2POp(dist.irecv, out, frm, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Shift(torch.autograd.Function):
    """(y from rank i-1 of the ring, token): forward sends ``y`` to rank
    i+1; backward sends the received value's gradient to rank i-1 and
    takes ``y``'s from rank i+1 (ppermute and its transpose)."""

    @staticmethod
    def forward(ctx, y, token, group):
        n, nxt, prv = _ring_peers(group)
        ctx.group = group
        return (y.clone() if n == 1 else _exchange(y, nxt, prv, group)), token.clone()

    @staticmethod
    def backward(ctx, g_recv, g_token):
        n, nxt, prv = _ring_peers(ctx.group)
        return (g_recv if n == 1 else _exchange(g_recv, prv, nxt, ctx.group)), g_token, None


class _Replicated(torch.autograd.Function):
    """(token, *tensors) unchanged; in the backward each tensor's gradient
    is summed over the group (a replicated input that only some stages
    read gets the whole gradient on every rank, as ``shard_map``'s
    transpose gives it)."""

    @staticmethod
    def forward(ctx, group, token, *tensors):
        ctx.group = group
        return (token.clone(), *(t.view_as(t) for t in tensors))

    @staticmethod
    def backward(ctx, g_token, *grads):
        import torch.distributed as dist

        grads = [g.contiguous().clone() for g in grads]
        for g in grads:
            dist.all_reduce(g, group=ctx.group)
        return (None, g_token, *grads)


class _ReplicatedSum(torch.autograd.Function):
    """The sum of ``x`` over the group (the last stage's outputs, zeros
    elsewhere), the same on every rank.  Every rank computes its loss from
    this replicated value, so the gradient it hands back is the loss's
    gradient as it is, not summed again."""

    @staticmethod
    def forward(ctx, x, token, group):
        import torch.distributed as dist

        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, torch.zeros((), dtype=torch.float32, device=g.device), None


def _token(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=like.device, requires_grad=True)


def _grad_leaves(tree) -> list:
    return [x for x in tree_leaves(tree) if x.requires_grad]


def _replicate_in(group, token, *trees):
    """``trees`` with every leaf that requires grad passed through
    ``_Replicated``; returns (token, *trees)."""
    leaves = [x for tree in trees for x in _grad_leaves(tree)]
    token, *outs = _Replicated.apply(group, token, *leaves)
    swap = {id(a): b for a, b in zip(leaves, outs)}
    return (token, *(tree_map(lambda x: swap.get(id(x), x), tree) for tree in trees))


def _pp_group(mesh, axis: str):
    import torch.distributed as dist

    group = mesh.get_group(axis)
    return group, dist.get_rank(group), dist.get_world_size(group)


# ----------------------------------------------------------------------
# The entry points
# ----------------------------------------------------------------------
def pipeline_spmd(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    mesh: Union["DeviceMesh", int],  # noqa: F821
    axis: str = "pp",
) -> Callable[[Any, torch.Tensor], torch.Tensor]:
    """Build the pipelined forward: ``f(stage_params, microbatches)``.

    stage_fn(stage_params_slice, x) -> y — one stage's computation; the
      output must have the same shape/dtype as ``x`` (inter-stage
      activations rotate through a single buffer).
    stage_params — tree whose leaves have leading dim = pp size (see
      :func:`stack_stage_params`); rank i of the ``axis`` group uses
      slice i.
    microbatches — [M, ...] tensor of M microbatch inputs, the same on
      every rank.
    mesh — a ``DeviceMesh`` whose ``axis`` dim holds the stages, or an int
      pp: that many stages emulated on one device (:func:`emulate_pipeline`).

    Returns [M, ...] outputs (from the last stage, the same on every rank
    of the group).
    """
    if isinstance(mesh, int):
        return emulate_pipeline(stage_fn, mesh)

    def run(stage_params, microbatches):
        group, me, pp = _pp_group(mesh, axis)
        params = tree_map(lambda x: x[me], stage_params)
        token, microbatches = _replicate_in(group, _token(microbatches), microbatches)
        recv = torch.zeros_like(microbatches[0])
        outputs: List[Optional[torch.Tensor]] = [None] * microbatches.shape[0]
        for t in range(pp - 1 + microbatches.shape[0]):
            y = _gpipe_step(stage_fn, params, microbatches, recv, me, pp, t, outputs)
            recv, token = _Shift.apply(y, token, group)
        return _ReplicatedSum.apply(_stack_outputs(outputs, microbatches[0]), token, group)

    return run


def pipeline_interleaved(
    first_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    mid_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    last_fn: Callable[[Any, torch.Tensor, torch.Tensor], torch.Tensor],
    mesh: Union["DeviceMesh", int],  # noqa: F821
    n_virtual: int = 1,
    axis: str = "pp",
) -> Callable:
    """Interleaved virtual-stage pipeline with NON-UNIFORM end stages
    (the Megatron interleaved schedule, in one SPMD program).

    Unlike :func:`pipeline_spmd`, the first and last stages need not
    preserve the rotating activation shape: ``first_fn`` consumes the
    raw input microbatch (e.g. token ids -> embeddings) on device 0,
    and ``last_fn`` consumes the final activation plus the microbatch's
    auxiliary input (e.g. targets -> loss) on the last device — embed
    and head are true pipeline stages instead of replicated pre/post
    work.  Each device additionally holds ``n_virtual`` layer chunks
    (device d owns chunks d, d+pp, ..): a microbatch circulates the
    ring v laps, shrinking the bubble from (S-1)/(S-1+M) to
    (pp-1)/(pp-1+M*v) for the same S = pp*v total stages.

    f(first_params, chunk_params, last_params, inputs, aux) -> [M, ...]
      chunk_params — leaves [pp, v, ...] (see
        :func:`stack_stage_params_interleaved`)
      inputs — [M, ...] raw microbatches (M <= pp: issue in rounds
        upstream for more)
      aux — [M, ...] per-microbatch auxiliary input for last_fn

    ``mesh`` as in :func:`pipeline_spmd` (an int emulates the devices on
    one, :func:`emulate_pipeline_interleaved`).  Returns [M, ...] of
    last_fn outputs, the same on every rank of the group.
    """
    if isinstance(mesh, int):
        return emulate_pipeline_interleaved(first_fn, mid_fn, last_fn, mesh, n_virtual)
    v = n_virtual

    def run(first_params, chunk_params, last_params, inputs, aux):
        group, d, pp = _pp_group(mesh, axis)
        m = _check_rounds(inputs, pp)
        chunks = tree_map(lambda x: x[d], chunk_params)
        zero_act = _meta_like(first_fn, first_params, inputs[0])
        out_zero = _meta_like(last_fn, last_params, zero_act, aux[0])
        token, first_params, last_params = _replicate_in(group, _token(zero_act), first_params,
                                                         last_params)
        recv = zero_act
        outputs: List[Optional[torch.Tensor]] = [None] * m
        for t in range(pp * v + m - 1):
            y = _interleaved_step((first_fn, mid_fn, last_fn), (first_params, chunks, last_params),
                                  inputs, aux, recv, d, pp, v, t, outputs, zero_act)
            recv, token = _Shift.apply(y, token, group)
        return _ReplicatedSum.apply(_stack_outputs(outputs, out_zero), token, group)

    return run
