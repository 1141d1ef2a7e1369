"""Collective API + group manager (reference:
python/ray/util/collective/collective.py:40 GroupManager, :120
init_collective_group, :258 allreduce ...).

Backends: "cpu" (alias "gloo"; TCP, ray_tpu_torch.util.collective.cpu_group).
The reference's "xla" backend (device arrays staged through the host) is
not ported: it raises until ROADMAP Queue A item 3 makes it an NCCL
group.

Elastic re-rendezvous: groups are **generation-tagged**.  Re-forming a
group after membership changes (a preempted rank, an elastic resize) is
``destroy + recreate under a generation bump``: the new generation
rendezvouses under fresh GCS-KV keys, and members still blocked in the
old mesh get a clean ``GroupInvalidatedError`` instead of hanging.  The
driver-side bump is ``invalidate_collective_group(name)`` (advances the
KV marker without being a member); members re-join with
``init_collective_group(..., generation=G)``.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.util.collective.cpu_group import (
    KV_NS,
    CPUCollectiveGroup,
    GroupInvalidatedError,
    RendezvousTimeoutError,
)


_BACKENDS = {"cpu": CPUCollectiveGroup, "gloo": CPUCollectiveGroup}


def _gcs_kv():
    from ray_tpu_torch._private.worker import get_global_worker

    worker = get_global_worker()

    def kv(method, payload):
        return worker.gcs_client.call(method, payload)

    return kv


class GroupManager:
    def __init__(self):
        self._groups: Dict[str, CPUCollectiveGroup] = {}
        self._lock = threading.Lock()

    def create(self, world_size: int, rank: int, backend: str, group_name: str,
               generation: int = 0):
        if backend in ("xla", "nccl"):
            raise NotImplementedError(
                f"collective backend '{backend}' is not ported yet: it waits for the "
                "NCCL group of ROADMAP Queue A item 3; use 'cpu'"
            )
        if backend not in _BACKENDS:
            raise ValueError(f"unknown collective backend '{backend}' (have {list(_BACKENDS)})")
        kv = _gcs_kv()

        with self._lock:
            existing = self._groups.get(group_name)
            if existing is not None:
                if existing.generation >= generation:
                    raise ValueError(
                        f"collective group '{group_name}' already initialized at "
                        f"generation {existing.generation} (requested {generation}); "
                        "re-joining requires a strictly higher generation"
                    )
                # Atomic destroy+recreate under the generation bump: the
                # old mesh is torn down before the new rendezvous begins,
                # so a collective on the old handle can only raise, never
                # cross-connect with the new generation.
                self._groups.pop(group_name, None)
                existing._invalidated = True
                existing.destroy()
            group = _BACKENDS[backend](
                world_size, rank, group_name, kv, generation=generation
            )
            self._groups[group_name] = group
            return group

    def get(self, group_name: str) -> CPUCollectiveGroup:
        g = self._groups.get(group_name)
        if g is None:
            raise ValueError(
                f"collective group '{group_name}' is not initialized in this process; "
                "call init_collective_group() first"
            )
        return g

    def destroy(self, group_name: str):
        with self._lock:
            g = self._groups.pop(group_name, None)
        if g is not None:
            g.destroy()


_manager = GroupManager()


def init_collective_group(world_size: int, rank: int, backend: str = "cpu",
                          group_name: str = "default", generation: int = 0):
    """Called by every member (inside its actor/task).  ``generation``
    tags the rendezvous epoch: re-forming a group after membership change
    requires a strictly higher generation (elastic resize)."""
    _manager.create(world_size, rank, backend, group_name, generation=generation)
    return True


def create_collective_group(actors: List[Any], world_size: int, ranks: List[int],
                            backend: str = "cpu", group_name: str = "default",
                            generation: int = 0):
    """Declarative setup from the driver: tells each actor to join."""
    import ray_tpu_torch

    refs = [
        actor.__ray_call__.remote(
            _join_group, world_size, rank, backend, group_name, generation
        )
        for actor, rank in zip(actors, ranks)
    ]
    ray_tpu_torch.get(refs)
    return True


def _join_group(self, world_size, rank, backend, group_name, generation=0):
    return init_collective_group(
        world_size, rank, backend, group_name, generation=generation
    )


def destroy_collective_group(group_name: str = "default"):
    _manager.destroy(group_name)


def get_collective_group_generation(group_name: str = "default") -> Optional[int]:
    """Latest generation recorded for the group in the GCS KV (readable
    from any connected process, member or not); None when the group has
    no marker yet."""
    blob = _gcs_kv()("kv_get", (KV_NS, f"{group_name}/gen".encode()))
    if blob is None:
        return None
    try:
        return int(blob.decode())
    except (ValueError, AttributeError):
        return None


def invalidate_collective_group(group_name: str = "default",
                                new_generation: Optional[int] = None) -> int:
    """Driver-side generation bump: advance the group's KV marker so
    every member of an older generation fails its next collective (or
    in-flight rendezvous) with GroupInvalidatedError instead of hanging.
    Also destroys any local member handle.  Returns the new generation.

    This is the atomic half of elastic ``destroy+recreate``: bump first,
    then tell the surviving members to re-join at the returned
    generation."""
    kv = _gcs_kv()
    cur = get_collective_group_generation(group_name)
    if new_generation is None:
        new_generation = (cur if cur is not None else -1) + 1
    elif cur is not None and new_generation <= cur:
        raise ValueError(
            f"collective group '{group_name}' is already at generation {cur}; "
            f"cannot invalidate to {new_generation}"
        )
    # Atomic max-write: a concurrent (higher) bump wins and is adopted.
    stored = kv("kv_put_max", (KV_NS, f"{group_name}/gen".encode(),
                               int(new_generation)))
    if stored is not None:
        new_generation = max(new_generation, int(stored))
    # Reap superseded rendezvous keys (bounded: only the generations we
    # can enumerate by prefix) so the KV doesn't grow one entry per
    # (group, generation, rank) forever.
    try:
        stale = kv("kv_keys", (KV_NS, f"{group_name}/gen".encode()))
        for key in stale or ():
            if not key.endswith(b"/gen") and not key.startswith(
                f"{group_name}/gen{new_generation}/".encode()
            ):
                kv("kv_del", (KV_NS, key))
    except Exception:
        pass
    _manager.destroy(group_name)
    return new_generation


def get_rank(group_name: str = "default") -> int:
    return _manager.get(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _manager.get(group_name).world_size


def allreduce(tensor, group_name: str = "default", op: str = "sum"):
    return _manager.get(group_name).allreduce(tensor, op)


def allgather(tensor, group_name: str = "default"):
    return _manager.get(group_name).allgather(tensor)


def reducescatter(tensor, group_name: str = "default", op: str = "sum"):
    return _manager.get(group_name).reducescatter(tensor, op)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    return _manager.get(group_name).broadcast(tensor, src_rank)


def reduce(tensor, dst_rank: int = 0, group_name: str = "default", op: str = "sum"):
    return _manager.get(group_name).reduce(tensor, dst_rank, op)


def barrier(group_name: str = "default"):
    _manager.get(group_name).barrier()


def send(tensor, dst_rank: int, group_name: str = "default"):
    _manager.get(group_name).send(tensor, dst_rank)


def recv(shape, dtype, src_rank: int, group_name: str = "default"):
    return _manager.get(group_name).recv(shape, dtype, src_rank)
