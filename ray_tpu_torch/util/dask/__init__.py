"""Dask-on-ray_tpu_torch scheduler (reference: python/ray/util/dask/scheduler.py
ray_dask_get — a dask `get` function executing the task graph as remote
tasks with object refs flowing between them).

Usage with dask installed:

    import dask
    dask.config.set(scheduler=ray_dask_get)
    ddf.sum().compute()

The scheduler itself only needs the dask GRAPH PROTOCOL (a dict of
key -> task-tuple/literal, nested keys as arguments), so it is fully
functional — and hermetically tested — without the dask package: pass
any graph dict + keys to ``ray_dask_get`` directly."""

from ray_tpu_torch.util.dask.scheduler import ray_dask_get

__all__ = ["ray_dask_get"]
