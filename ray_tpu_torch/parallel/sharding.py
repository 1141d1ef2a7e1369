"""Sharding rules: map parameter paths to partition specs, and specs to
DTensor placements (port of ``ray_tpu/parallel/sharding.py``).

The reference answers the TP/FSDP/SP layout question with GSPMD: regex
rules over flattened param paths produce PartitionSpecs and XLA inserts
the collectives.  Here a spec keeps the reference's value type, a tuple
with one entry per tensor dim (an axis name, a tuple of axis names, or
None), and ``spec_to_placements`` turns it into the ``Shard``/``Replicate``
placements of a ``DTensor`` on a ``DeviceMesh``, whose dispatch then
inserts the collectives.  Megatron-style layout for transformers, on
``Linear.weight`` ``[out, in]`` (the reference's flax kernels are
``[in, out]``, so each spec below is the reference's transposed):

    qkv / mlp-up weights      [heads*dh | 4d, d_model]   -> (tp, fsdp)
    attn-out / mlp-down       [d_model, heads*dh | 4d]   -> (fsdp, tp)
    embeddings / lm head      vocab dim on tp
    norms / biases            replicated

so each matmul is local to a tp shard and activations cross the mesh only
at block boundaries.

A tree is a nested mapping of tensors or an ``nn.Module`` (its named
parameters); a leaf's path joins the keys with ``/`` and splits dotted
torch names at each dot (``h_0.attn.qkv.weight`` ->
``h_0/attn/qkv/weight``).  The module imports torch only inside the
functions that place tensors, so the spec functions serve
``train/sharding/rules.py``, which must unpickle without torch.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence, Tuple

from ray_tpu_torch.parallel.mesh import axis_sizes, mesh_device

Spec = Tuple[Any, ...]


@dataclass
class ShardingRules:
    """Ordered (path-regex, spec) rules; first match wins."""

    rules: List[Tuple[str, Spec]] = field(default_factory=list)
    default: Spec = ()

    def spec_for(self, path: str, shape: Tuple[int, ...]) -> Spec:
        for pattern, spec in self.rules:
            if re.search(pattern, path):
                return _clip_spec(spec, shape)
        return _clip_spec(self.default, shape)


def _clip_spec(spec: Spec, shape: Tuple[int, ...]) -> Spec:
    """Trim/pad a spec to the tensor rank.  Divisibility against the mesh
    is enforced later, in infer_param_spec (which knows the axis sizes)."""
    parts = list(spec)[: len(shape)]
    parts += [None] * (len(shape) - len(parts))
    return tuple(parts)


def gpt_sharding_rules() -> ShardingRules:
    """Megatron-style transformer layout over the port's parameter names
    (GPT-2's and Llama's; see module docstring)."""
    return ShardingRules(
        rules=[
            (r"(wte|token_embed|embedding)/weight", ("tp", None)),
            (r"(wpe|pos_embed)/weight", (None, None)),
            (r"(qkv|query|key|value|c_attn|[qkv]_proj)/weight", ("tp", "fsdp")),
            (r"(attn_out|c_proj|out_proj|o_proj)/weight", ("fsdp", "tp")),
            (r"(mlp_up|up_proj|gate_proj|c_fc|fc_in)/weight", ("tp", "fsdp")),
            (r"(mlp_down|down_proj|fc_out)/weight", ("fsdp", "tp")),
            (r"lm_head/weight", ("tp", None)),
            (r"(ln|norm|layernorm|scale|ln_f)", ()),
            (r"bias", ()),
        ],
        default=(),
    )


def _path_str(path: Sequence[Any]) -> str:
    return "/".join(str(k).replace(".", "/") for k in path)


def tree_map_with_path(fn: Callable[[Tuple[str, ...], Any], Any], tree: Any,
                       path: Tuple[str, ...] = ()) -> Any:
    """``fn(path, leaf)`` over a nested mapping (an ``nn.Module`` reads as
    its named parameters), rebuilt as plain dicts; anything that is not a
    mapping is a leaf (so a spec tuple is one)."""
    if hasattr(tree, "named_parameters") and not isinstance(tree, Mapping):
        tree = dict(tree.named_parameters())
    if isinstance(tree, Mapping):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def tree_items(tree: Any) -> list:
    """[(path, leaf)] in the tree's order."""
    out: list = []
    tree_map_with_path(lambda p, leaf: out.append((p, leaf)), tree)
    return out


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in tree_items(tree)]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of trees of its structure."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def infer_param_spec(params: Any, rules: ShardingRules, mesh) -> Any:
    """Spec tree for a parameter tree.  ``mesh`` is a ``DeviceMesh`` or a
    mapping of axis sizes (the reference reads ``mesh.shape``).  Axes not
    present in the mesh are dropped; mesh axes that don't divide a dim
    are dropped."""
    sizes = axis_sizes(mesh)

    def one(path, leaf):
        spec = rules.spec_for(_path_str(path), tuple(leaf.shape))
        parts = []
        for dim, axis in zip(leaf.shape, spec):
            if axis is None or axis not in sizes:
                parts.append(None)
            elif dim % sizes[axis] == 0:
                parts.append(axis)
            else:
                parts.append(None)
        return tuple(parts)

    return tree_map_with_path(one, params)


def spec_to_placements(spec: Spec, mesh) -> list:
    """DTensor placements on ``mesh`` for ``spec``: mesh dim i is
    ``Shard(d)`` when tensor dim d names its axis (alone or in a tuple,
    which shards d over those mesh dims in mesh order), else
    ``Replicate()``.  Axes the mesh lacks are ignored."""
    from torch.distributed.tensor import Replicate, Shard

    placements: list = [Replicate() for _ in mesh.mesh_dim_names]
    for d, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is None or axis not in mesh.mesh_dim_names:
                continue
            i = mesh.mesh_dim_names.index(axis)
            if not isinstance(placements[i], Replicate):
                raise ValueError(f"spec {spec} names mesh axis {axis!r} twice")
            placements[i] = Shard(d)
    return placements


@dataclass(frozen=True)
class NamedSharding:
    """A spec bound to a mesh (the reference's ``NamedSharding``)."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> list:
        return spec_to_placements(self.spec, self.mesh)


def tree_shardings(mesh, spec_tree: Any) -> Any:
    return tree_map(lambda s: NamedSharding(mesh, s), spec_tree)


def contiguous_stride(shape: Sequence[int]) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def place(t, mesh, placements):
    """A DTensor on ``mesh`` with ``placements`` from ``t``, the GLOBAL
    value, which every rank of the mesh holds alike (the same host batch,
    the same seed's weights, a checkpoint reassembled on the host): each
    rank keeps its own window of ``t`` and nothing crosses the mesh.  The
    window is a copy when it is not the whole of ``t``, so ``t`` can be
    freed; it lands on the mesh's device (the current card for ``cuda``)."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(t.shape, mesh, placements)
    local = t[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
    if local.numel() != t.numel():
        local = local.clone(memory_format=torch.contiguous_format)
    local = local.to(mesh_device(mesh))
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=t.shape,
                              stride=contiguous_stride(t.shape))


def shard_tree(tree: Any, mesh, spec_tree: Any) -> Any:
    """Place a host tree (every rank holding the same global values) onto
    the mesh with the given specs."""
    return tree_map(lambda t, s: place(t, mesh, spec_to_placements(s, mesh)), tree, spec_tree)


def batch_spec(mesh, *, batch_axes: Tuple[str, ...] = ("dp", "fsdp"),
               seq_axis: Optional[str] = "sp") -> Spec:
    """Spec for [batch, seq, ...] tensors: batch over dp(+fsdp), sequence
    over sp when those axes exist in the mesh."""
    sizes = axis_sizes(mesh)
    b = tuple(a for a in batch_axes if sizes.get(a, 1) > 1)
    s = seq_axis if seq_axis and sizes.get(seq_axis, 1) > 1 else None
    return (b if b else None, s)


def constrain(x, mesh, spec: Spec):
    """``with_sharding_constraint`` that tolerates axes missing from the
    mesh: a DTensor is redistributed to ``spec``'s placements, a plain
    tensor (the global value on every rank) is placed with them."""
    from torch.distributed.tensor import DTensor

    placements = spec_to_placements(spec, mesh)  # drops axes the mesh lacks
    if isinstance(x, DTensor):
        return x.redistribute(mesh, placements)
    return place(x, mesh, placements)


def shard_module(module, mesh, spec_tree: Any):
    """Replace each parameter of ``module`` (holding the global values on
    every rank) by a DTensor with its spec's placements, through
    ``distribute_module``; ``spec_tree`` is keyed by parameter name, as
    ``infer_param_spec`` and ``match_partition_rules`` give it for a
    module.  Returns ``module``."""
    from torch import nn
    from torch.distributed.tensor import distribute_module

    specs = {".".join(p): s for p, s in tree_items(spec_tree)}

    def partition(prefix, mod, device_mesh):
        for name, param in list(mod.named_parameters(recurse=False)):
            full = f"{prefix}.{name}" if prefix else name
            dt = place(param.detach(), device_mesh, spec_to_placements(specs[full], device_mesh))
            mod.register_parameter(name, nn.Parameter(dt, requires_grad=param.requires_grad))

    return distribute_module(module, mesh, partition)


def shard_optimizer(optimizer):
    """Make ``optimizer``'s state follow its DTensor parameters: Adam's
    and AdamW's moments are made now, zeros with each parameter's
    placements (the reference's ``optimizer.init`` on the mesh; torch
    would make them at the first step), and a step pre-hook reduces each
    gradient to its parameter's placements before the update (a
    replicated parameter's gradient comes out of the backward as a
    partial sum over the batch axes).  Returns ``optimizer``."""
    import torch

    for group in optimizer.param_groups:
        for p in group["params"]:
            if isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)):
                state = optimizer.state[p]
                if not state:
                    state["step"] = torch.tensor(0.0)
                    for name in ("exp_avg", "exp_avg_sq") + (
                            ("max_exp_avg_sq",) if group.get("amsgrad") else ()):
                        state[name] = torch.zeros_like(p, memory_format=torch.preserve_format)
    optimizer.register_step_pre_hook(_reduce_grads)
    return optimizer


def _reduce_grads(optimizer, args, kwargs) -> None:
    for group in optimizer.param_groups:
        for p in group["params"]:
            g = p.grad
            if g is not None and tuple(g.placements) != tuple(p.placements):
                p.grad = g.redistribute(p.device_mesh, p.placements)
