"""Distributed queue backed by an async actor (reference:
python/ray/util/queue.py)."""

from __future__ import annotations

import asyncio
from typing import Any, List, Optional

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int):
        self.queue: asyncio.Queue = asyncio.Queue(maxsize)

    async def put(self, item, timeout: Optional[float] = None):
        if timeout is None:
            await self.queue.put(item)
            return True
        try:
            await asyncio.wait_for(self.queue.put(item), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    async def get(self, timeout: Optional[float] = None):
        if timeout is None:
            return (True, await self.queue.get())
        try:
            return (True, await asyncio.wait_for(self.queue.get(), timeout))
        except asyncio.TimeoutError:
            return (False, None)

    def put_nowait(self, item) -> bool:
        try:
            self.queue.put_nowait(item)
            return True
        except asyncio.QueueFull:
            return False

    def get_nowait(self):
        try:
            return (True, self.queue.get_nowait())
        except asyncio.QueueEmpty:
            return (False, None)

    def qsize(self) -> int:
        return self.queue.qsize()

    def empty(self) -> bool:
        return self.queue.empty()

    def full(self) -> bool:
        return self.queue.full()


class Queue:
    """Multi-producer multi-consumer queue usable from any worker."""

    def __init__(self, maxsize: int = 0, actor_options: Optional[dict] = None):
        opts = actor_options or {"num_cpus": 0.1}
        self.maxsize = maxsize
        self.actor = ray_tpu_torch.remote(**opts)(_QueueActor).remote(maxsize)

    def put(self, item: Any, block: bool = True, timeout: Optional[float] = None):
        if not block:
            if not ray_tpu_torch.get(self.actor.put_nowait.remote(item)):
                raise Full
            return
        ok = ray_tpu_torch.get(self.actor.put.remote(item, timeout))
        if not ok:
            raise Full

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        if not block:
            ok, item = ray_tpu_torch.get(self.actor.get_nowait.remote())
            if not ok:
                raise Empty
            return item
        ok, item = ray_tpu_torch.get(self.actor.get.remote(timeout))
        if not ok:
            raise Empty
        return item

    def put_nowait(self, item: Any):
        self.put(item, block=False)

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def put_async(self, item: Any):
        """Fire-and-forget put; returns the ObjectRef."""
        return self.actor.put.remote(item, None)

    def qsize(self) -> int:
        return ray_tpu_torch.get(self.actor.qsize.remote())

    def empty(self) -> bool:
        return ray_tpu_torch.get(self.actor.empty.remote())

    def full(self) -> bool:
        return ray_tpu_torch.get(self.actor.full.remote())

    def shutdown(self):
        ray_tpu_torch.kill(self.actor)
