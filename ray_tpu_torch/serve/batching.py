"""@serve.batch: transparent request batching (reference:
serve/batching.py) — queued calls are coalesced and handed to the
wrapped method as a list; perfect for batched model inference where the
device wants large leading dimensions."""

from __future__ import annotations

import asyncio
import functools
from typing import Any, Callable, List, Optional


class _BatchQueue:
    def __init__(self, fn, max_batch_size: int, batch_wait_timeout_s: float):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.timeout = batch_wait_timeout_s
        self.queue: Optional[asyncio.Queue] = None
        self._worker: Optional[asyncio.Task] = None

    def _ensure(self):
        if self.queue is None:
            # bind to the loop the first call RUNS on — get_event_loop()
            # returns the thread's (possibly different, possibly not yet
            # running) loop and the worker task then never wakes
            loop = asyncio.get_running_loop()
            self.queue = asyncio.Queue()
            self._worker = loop.create_task(self._loop())

    def shutdown(self):
        """Cancel the worker task (replica teardown) and fail pending
        callers instead of leaving them awaiting forever."""
        worker, self._worker = self._worker, None
        if worker is not None and not worker.done():
            worker.cancel()
        if self.queue is not None:
            while not self.queue.empty():
                _, fut = self.queue.get_nowait()
                if not fut.done():
                    fut.cancel()
            self.queue = None

    async def _loop(self):
        loop = asyncio.get_running_loop()
        while True:
            first = await self.queue.get()
            batch = [first]
            deadline = loop.time() + self.timeout
            while len(batch) < self.max_batch_size:
                remaining = deadline - loop.time()
                if remaining <= 0:
                    break
                try:
                    batch.append(await asyncio.wait_for(self.queue.get(), remaining))
                except asyncio.TimeoutError:
                    break
            args = [item[0] for item in batch]
            futures = [item[1] for item in batch]
            try:
                results = await self.fn(args)
                if len(results) != len(batch):
                    raise ValueError(
                        f"@serve.batch function returned {len(results)} results "
                        f"for a batch of {len(batch)}"
                    )
                for fut, res in zip(futures, results):
                    if not fut.done():
                        fut.set_result(res)
            except Exception as e:  # noqa: BLE001
                for fut in futures:
                    if not fut.done():
                        fut.set_exception(e)

    async def submit(self, arg) -> Any:
        self._ensure()
        fut = asyncio.get_running_loop().create_future()
        await self.queue.put((arg, fut))
        return await fut


def batch(_fn=None, *, max_batch_size: int = 8, batch_wait_timeout_s: float = 0.01):
    """Decorate an async method taking a LIST of requests; callers invoke
    it with single requests."""

    def wrap(fn):
        queues = {}

        @functools.wraps(fn)
        async def wrapper(*args):
            # method (self, item) or function (item)
            if len(args) == 2:
                self_obj, item = args
                key = id(self_obj)
                if key not in queues:
                    queues[key] = _BatchQueue(
                        lambda items: fn(self_obj, items), max_batch_size, batch_wait_timeout_s
                    )
                return await queues[key].submit(item)
            (item,) = args
            if None not in queues:
                queues[None] = _BatchQueue(fn, max_batch_size, batch_wait_timeout_s)
            return await queues[None].submit(item)

        # teardown hook: Replica.prepare_shutdown cancels these workers
        # so replica stop doesn't leak a pending task per batch method
        wrapper._serve_batch_queues = queues
        return wrapper

    if _fn is not None:
        return wrap(_fn)
    return wrap
