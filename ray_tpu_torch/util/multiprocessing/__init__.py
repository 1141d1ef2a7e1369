"""Drop-in multiprocessing.Pool over the cluster (reference:
python/ray/util/multiprocessing/pool.py — same public surface, tasks
instead of forked processes, so pools span nodes and survive worker
crashes via normal task retry)."""

from ray_tpu_torch.util.multiprocessing.pool import AsyncResult, Pool, TimeoutError

__all__ = ["Pool", "AsyncResult", "TimeoutError"]
