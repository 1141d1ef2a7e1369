"""Regex partition rules: parameter paths -> partition specs (port of
``ray_tpu/train/sharding/rules.py``).

The fmengine `match_partition_rules` shape: an ordered list of
``(path_regex, spec)`` pairs is searched first-match-wins against each
leaf's flattened ``a/b/c`` path.  Scalars and size-1 leaves are always
replicated; a leaf no rule matches is a TYPED error — silent replication
of a 2 GB embedding is exactly the bug class this plane exists to remove.

Differences from ``ray_tpu_torch.parallel.sharding.ShardingRules`` (the
Megatron dp/fsdp/tp/sp layout table used by the in-loop recipes): this
module is config-first (specs are plain tuples of axis names so a
``ShardingConfig`` pickles into trainer state and travels to workers),
uses the trainer-facing ``("batch", "model")`` axis vocabulary, and
*refuses* unmatched leaves instead of defaulting them.

A tree is a nested mapping of tensors (a ``state_dict``, an optimizer's
per-parameter state) or an ``nn.Module`` (its named parameters).  A
leaf's path joins the mapping keys with ``/``, a dotted torch name
splitting at each dot, so ``h_0.attn.qkv.weight`` reads
``h_0/attn/qkv/weight``.  The reference matches flax paths on flax
layouts (``qkv/kernel`` ``[in, out]``); the port's GPT-2 table names the
torch parameters (``qkv/weight``, ``[out, in]``) and transposes the specs
of the Dense kernels, so every port parameter gets the spec the reference
gives its flax counterpart (``models/convert.py`` carries one to the
other).  This module imports no torch: specs only read each leaf's
``shape``, so a ``ShardingConfig`` unpickles anywhere.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.parallel.mesh import axis_sizes
from ray_tpu_torch.parallel.sharding import _path_str, tree_map_with_path

SpecTuple = Tuple[Optional[Any], ...]
Rule = Tuple[str, SpecTuple]


class UnmatchedParamError(ValueError):
    """A parameter leaf matched no partition rule.  Carries every
    unmatched path so one failure names the whole gap, not the first
    leaf of it."""

    def __init__(self, paths: Sequence[str]):
        self.paths = list(paths)
        preview = ", ".join(self.paths[:8])
        more = f" (+{len(self.paths) - 8} more)" if len(self.paths) > 8 else ""
        super().__init__(
            f"{len(self.paths)} parameter leaf(s) matched no partition rule: "
            f"{preview}{more} — add a rule (a final catch-all like "
            f"(r'.*', ()) makes replication explicit)"
        )


@dataclass
class ShardingConfig:
    """GSPMD layout declaration carried by TorchTrainer.

    ``mesh`` names the axes (first axis is the data/batch axis by
    convention); ``mesh_shape`` maps axis -> size with at most one -1
    meaning "absorb the remaining devices".  ``partition_rules`` is the
    ordered ``(regex, spec_tuple)`` table; ``None`` selects the tested
    GPT-2 rule set (:func:`gpt2_partition_rules`).
    """

    mesh: Tuple[str, ...] = ("batch", "model")
    mesh_shape: Optional[Dict[str, int]] = None
    partition_rules: Optional[List[Rule]] = None
    batch_axis: str = "batch"

    def __post_init__(self):
        if self.batch_axis not in self.mesh:
            raise ValueError(
                f"batch_axis {self.batch_axis!r} not in mesh axes {self.mesh}"
            )
        if self.mesh_shape is not None:
            unknown = [a for a in self.mesh_shape if a not in self.mesh]
            if unknown:
                raise ValueError(
                    f"mesh_shape names axes {unknown} not in mesh {self.mesh}"
                )

    def rules(self) -> List[Rule]:
        return (
            list(self.partition_rules)
            if self.partition_rules is not None
            else gpt2_partition_rules()
        )

    def resolve_shape(self, n_devices: int) -> Dict[str, int]:
        """Axis -> size over ``n_devices``.  Default: the model axis
        takes the largest power of two <= 8 that divides the device
        count, batch absorbs the rest."""
        if self.mesh_shape:
            shape = dict(self.mesh_shape)
            # A partial shape ({"model": 2} on 8 devices) must not
            # silently idle devices: the batch axis absorbs the
            # remainder unless pinned (or another axis already carries
            # the -1); unnamed model axes default to 1.
            for a in self.mesh:
                if a == self.batch_axis and -1 not in shape.values():
                    shape.setdefault(a, -1)
                else:
                    shape.setdefault(a, 1)
            return shape
        model_axes = [a for a in self.mesh if a != self.batch_axis]
        shape = {self.batch_axis: -1}
        if model_axes:
            size = 1
            for cand in (8, 4, 2):
                if n_devices % cand == 0:
                    size = cand
                    break
            shape[model_axes[0]] = size
            for extra in model_axes[1:]:
                shape[extra] = 1
        return shape


def gpt2_partition_rules() -> List[Rule]:
    """Tested rule set for ``models/gpt2.py`` over a (batch, model) mesh:
    Megatron pairing — qkv/mlp-up shard their OUTPUT dim over ``model``
    (dim 0 of a ``Linear.weight``), attn-out/mlp-down their INPUT dim (dim
    1), so activations cross the mesh only at block boundaries; embeddings
    shard the vocab dim; norms and biases replicate."""
    return [
        (r"wte/weight", ("model", None)),
        (r"wpe/weight", (None, None)),
        (r"(qkv|c_attn)/weight", ("model", None)),
        (r"(attn_out|c_proj)/weight", (None, "model")),
        (r"(mlp_up|c_fc)/weight", ("model", None)),
        (r"(mlp_down|fc_out)/weight", (None, "model")),
        (r"lm_head/weight", ("model", None)),
        (r"(ln_1|ln_2|ln_f)/(weight|bias)", ()),
        (r"bias", ()),
    ]


def match_partition_rules(
    rules: Sequence[Rule], params: Any, mesh=None, strict: bool = True
) -> Any:
    """Spec tree (a tuple of axis names per leaf) for ``params`` under
    first-match-wins rules.

    * scalar / size-1 leaves -> replicated (never worth a collective);
    * the matched spec is clipped/padded to the leaf's rank;
    * with ``mesh`` given (a ``DeviceMesh``, or a mapping of axis sizes),
      axes absent from the mesh or not dividing their dim are dropped (a
      2-device model axis on an odd vocab replicates that dim instead of
      sharding it unevenly);
    * any leaf matching NO rule raises :class:`UnmatchedParamError`
      naming every gap at once (``strict=False`` replicates instead —
      for derived trees like optimizer state, where moment leaves match
      the param rules through their path and the step counts should just
      replicate).
    """
    compiled = [(re.compile(pat), tuple(spec)) for pat, spec in rules]
    sizes = None if mesh is None else axis_sizes(mesh)
    unmatched: List[str] = []

    def one(path, leaf):
        name = _path_str(path)
        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) == 0 or math.prod(shape) == 1:
            return ()
        for pat, spec in compiled:
            if pat.search(name):
                return _clip(spec, shape, sizes)
        unmatched.append(name)
        return ()

    out = tree_map_with_path(one, params)
    if unmatched and strict:
        raise UnmatchedParamError(unmatched)
    return out


def _clip(spec: SpecTuple, shape: Tuple[int, ...], sizes: Optional[Dict[str, int]]) -> SpecTuple:
    parts = list(spec)[: len(shape)]
    parts += [None] * (len(shape) - len(parts))
    if sizes is not None:
        out = []
        for dim, axis in zip(shape, parts):
            if axis is None or axis not in sizes:
                out.append(None)
            elif dim % sizes[axis] == 0:
                out.append(axis)
            else:
                out.append(None)
        parts = out
    return tuple(parts)
