"""Out-of-band collectives between actors/tasks (reference:
python/ray/util/collective/collective.py — NCCL/Gloo groups rendezvoused
through the internal KV).  Backends:

- "cpu" (alias "gloo"): socket-based collectives (the Gloo-class path) —
  rendezvous via the GCS KV, direct TCP between members.
- "xla" in the reference, NCCL here: not ported yet (ROADMAP Queue A
  item 3); asking for it raises ``NotImplementedError``.
"""

from ray_tpu_torch.util.collective.collective import (
    GroupInvalidatedError,
    RendezvousTimeoutError,
    allgather,
    allreduce,
    barrier,
    broadcast,
    create_collective_group,
    destroy_collective_group,
    get_collective_group_generation,
    get_rank,
    get_collective_group_size,
    init_collective_group,
    invalidate_collective_group,
    recv,
    reduce,
    reducescatter,
    send,
)

__all__ = [
    "init_collective_group",
    "create_collective_group",
    "destroy_collective_group",
    "invalidate_collective_group",
    "get_collective_group_generation",
    "GroupInvalidatedError",
    "RendezvousTimeoutError",
    "allreduce",
    "allgather",
    "reducescatter",
    "broadcast",
    "reduce",
    "barrier",
    "send",
    "recv",
    "get_rank",
    "get_collective_group_size",
]
