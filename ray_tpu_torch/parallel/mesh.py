"""Device mesh construction (port of ``ray_tpu/parallel/mesh.py``).

Axis conventions used across the port (models, trainers):

    dp — data parallel (batch dim)
    fsdp — sharded data parallel (params sharded over dp replicas)
    tp — tensor/model parallel (hidden dims)
    sp — sequence/context parallel (sequence dim; ring attention)
    pp — pipeline parallel (layer dim)
    ep — expert parallel (MoE experts)

The reference lays a ``jax.sharding.Mesh`` over devices; here a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group (one card a rank), with ``mesh_dim_names`` in the same
order.  A "device" below is a global rank.  The pure functions
(``MeshConfig.resolve``, ``auto_mesh_shape``) need no process group.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

AXIS_ORDER = ("pp", "dp", "fsdp", "sp", "tp", "ep")


@dataclass
class MeshConfig:
    """Named axis sizes; -1 on one axis means 'absorb remaining devices'."""

    axes: Dict[str, int] = field(default_factory=dict)

    def resolve(self, n_devices: int) -> Dict[str, int]:
        axes = dict(self.axes)
        if not axes:
            return {"dp": n_devices}
        unknown = [k for k, v in axes.items() if v == -1]
        known = math.prod(v for v in axes.values() if v > 0)
        if len(unknown) > 1:
            raise ValueError("at most one axis may be -1")
        if unknown:
            if n_devices % known:
                raise ValueError(f"{n_devices} devices not divisible by {known}")
            axes[unknown[0]] = n_devices // known
        else:
            # A strict subset of devices is allowed (e.g. an sp-only mesh
            # over 4 of 8 devices); more than available is not.
            if known > n_devices:
                raise ValueError(f"mesh axes {axes} product {known} > {n_devices} devices")
        return axes


def auto_mesh_shape(n_devices: int, tp: Optional[int] = None) -> Dict[str, int]:
    """Pick a (dp, tp) factorization: tp up to 8 (one NVLink domain of an
    8-card host), rest data parallel."""
    if tp is None:
        tp = 1
        for cand in (8, 4, 2):
            if n_devices % cand == 0 and cand <= n_devices:
                tp = cand
                break
    return {"dp": n_devices // tp, "tp": tp}


def ensure_process_group(device_type: str = "cuda") -> None:
    """A ``DeviceMesh`` needs the default process group.  A lone process
    (a one-worker trainer, a script) has none: form a world of one with an
    in-process store (NCCL for ``cuda``, gloo for ``cpu``), as the
    reference's single process sees its local devices without
    ``jax.distributed``."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)


def create_mesh(axes: Dict[str, int], devices: Optional[Sequence[int]] = None,
                device_type: str = "cuda"):
    """``DeviceMesh`` with the named axes over ``devices`` (global ranks;
    default every rank of the default process group, which is formed at
    world size one when there is none).  Known axes take ``AXIS_ORDER``;
    others keep their order in ``axes``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a cuda mesh was asked for but torch.cuda.is_available() is False; "
                           "pass device_type='cpu'")
    ensure_process_group(device_type)
    devices = list(devices if devices is not None else range(dist.get_world_size()))
    cfg = MeshConfig(dict(axes)).resolve(len(devices))
    names = [a for a in AXIS_ORDER if a in cfg] + [a for a in cfg if a not in AXIS_ORDER]
    shape = [cfg[n] for n in names]
    ranks = np.array(devices[: math.prod(shape)]).reshape(shape)
    return DeviceMesh(device_type, torch.as_tensor(ranks), mesh_dim_names=tuple(names))


def local_mesh(axes: Optional[Dict[str, int]] = None, device_type: str = "cuda"):
    """Mesh over this host's ranks (single-host: every rank of the group)."""
    import torch.distributed as dist

    ensure_process_group(device_type)
    if axes is None:
        axes = auto_mesh_shape(dist.get_world_size())
    return create_mesh(axes, device_type=device_type)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``; a mapping passes through (the
    reference's ``mesh.shape``)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_axis_size(mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 1)


def mesh_device(mesh):
    """The ``torch.device`` a rank's shards live on: its current card for a
    ``cuda`` mesh."""
    import torch

    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
