"""TorchConfig backend: forms one ``torch.distributed`` process group
across the worker group (reference: python/ray/train/torch/config.py:153
``_TorchBackend``; the counterpart of the JAX package's ``JaxConfig``,
which bootstraps ``jax.distributed`` the same way).

Rank 0 picks the rendezvous address; each worker then calls
``init_process_group(backend, init_method="tcp://...", world_size=n,
rank=r)``.  The backend is NCCL for GPU workers and gloo otherwise.  An
actor restart means the whole group re-forms, as in the reference.

Every worker sees all of its node's cards (no device ids are assigned per
worker), so with more than one GPU worker on a node the loop must pick
the card of its local rank before its first collective, as the GPT-2
loop does (``gpt2_loop.worker_device``).
The rendezvous address is the loopback: the port's clusters run on one
host (multi-host rendezvous comes with the NCCL work of ROADMAP Queue A
item 3).
"""

from __future__ import annotations

import datetime
import logging
from dataclasses import dataclass
from typing import Optional

from ray_tpu_torch.train.backend import Backend, BackendConfig

logger = logging.getLogger(__name__)

# torch.distributed's own default for a collective's timeout
_TIMEOUT = datetime.timedelta(minutes=30)


@dataclass
class TorchConfig(BackendConfig):
    # None = auto: a process group iff more than one worker.
    distributed: Optional[bool] = None

    def backend_cls(self):
        return _TorchBackend


def _get_coordinator(self_unused=None) -> str:
    import socket

    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"127.0.0.1:{port}"


def _init_process_group(backend: str, coordinator: str, world_size: int, rank: int) -> int:
    import torch.distributed as dist

    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator}",
        world_size=world_size,
        rank=rank,
        timeout=_TIMEOUT,
    )
    return dist.get_world_size()


def _destroy_process_group() -> bool:
    import sys

    torch = sys.modules.get("torch")
    if torch is None:  # never imported here: no group to tear down
        return True
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    return True


class _TorchBackend(Backend):
    def on_start(self, worker_group, backend_config: TorchConfig):
        n = worker_group.num_workers
        distributed = backend_config.distributed
        if distributed is None:
            distributed = n > 1
        if not distributed:
            return
        gpus = worker_group._resources_per_worker.get("GPU", 0)
        backend = "nccl" if gpus > 0 else "gloo"
        # Elastic re-rendezvous: surviving workers may still hold the
        # previous generation's group — tear it down first so the new,
        # resized world forms (a no-op on fresh processes).
        try:
            worker_group.execute(_destroy_process_group)
        except Exception:
            pass
        coordinator = worker_group.execute_single(0, _get_coordinator)
        logger.info("torch.distributed %s rendezvous at %s (%d ranks)", backend, coordinator, n)
        refs = [
            w.execute_fn.remote(_init_process_group, backend, coordinator, n, rank)
            for rank, w in enumerate(worker_group.workers)
        ]
        import ray_tpu_torch

        sizes = ray_tpu_torch.get(refs)
        logger.info("torch.distributed up: world sizes %s", sizes)

    def on_shutdown(self, worker_group, backend_config: TorchConfig):
        try:
            worker_group.execute(_destroy_process_group)
        except Exception:
            pass
