"""ActorPool (reference: python/ray/util/actor_pool.py)."""

from __future__ import annotations

from typing import Any, Callable, Iterable, List, Optional, TypeVar

import ray_tpu_torch

V = TypeVar("V")


class ActorPool:
    """Round-robins work over a fixed set of actors.

    pool = ActorPool([a1, a2])
    list(pool.map(lambda a, v: a.double.remote(v), [1, 2, 3, 4]))
    """

    def __init__(self, actors: Iterable[Any]):
        self._idle: List[Any] = list(actors)
        # future -> actor, only while the task is in flight
        self._future_to_actor = {}
        # submission index -> future, until the result is claimed
        self._index_to_future = {}
        self._next_task_index = 0
        self._next_return_index = 0
        self._claimed_unordered = set()
        self._pending_submits: List[tuple] = []

    def submit(self, fn: Callable[[Any, V], Any], value: V):
        if self._idle:
            actor = self._idle.pop()
            future = fn(actor, value)
            self._future_to_actor[future] = actor
            self._index_to_future[self._next_task_index] = future
            self._next_task_index += 1
        else:
            self._pending_submits.append((fn, value))

    def has_next(self) -> bool:
        return bool(self._index_to_future) or bool(self._pending_submits)

    def has_free(self) -> bool:
        return bool(self._idle) and not self._pending_submits

    def _flush_pending(self):
        while self._pending_submits and self._idle:
            fn, value = self._pending_submits.pop(0)
            self.submit(fn, value)

    def _wait_and_recycle(self, timeout: Optional[float]):
        """Block until any in-flight task finishes; free its actor."""
        ready, _ = ray_tpu_torch.wait(list(self._future_to_actor), num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("timed out waiting for actor pool result")
        actor = self._future_to_actor.pop(ready[0])
        self._idle.append(actor)
        self._flush_pending()

    def get_next(self, timeout: Optional[float] = None) -> Any:
        """Next result in submission order."""
        if not self.has_next():
            raise StopIteration("no more results to get")
        while self._next_return_index in self._claimed_unordered:
            self._claimed_unordered.discard(self._next_return_index)
            self._next_return_index += 1
        idx = self._next_return_index
        self._flush_pending()
        while idx not in self._index_to_future:
            self._wait_and_recycle(timeout)
        future = self._index_to_future[idx]
        value = ray_tpu_torch.get(future, timeout=timeout)
        del self._index_to_future[idx]
        self._next_return_index += 1
        actor = self._future_to_actor.pop(future, None)
        if actor is not None:
            self._idle.append(actor)
            self._flush_pending()
        return value

    def get_next_unordered(self, timeout: Optional[float] = None) -> Any:
        """Next result in completion order."""
        if not self.has_next():
            raise StopIteration("no more results to get")
        self._flush_pending()
        done = [i for i, f in self._index_to_future.items() if f not in self._future_to_actor]
        while not done:
            self._wait_and_recycle(timeout)
            done = [i for i, f in self._index_to_future.items() if f not in self._future_to_actor]
        idx = min(done)
        future = self._index_to_future.pop(idx)
        self._claimed_unordered.add(idx)
        return ray_tpu_torch.get(future)

    def map(self, fn: Callable[[Any, V], Any], values: Iterable[V]):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable[[Any, V], Any], values: Iterable[V]):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    def pop_idle(self):
        """Remove and return an idle actor, or None."""
        return self._idle.pop() if self._idle else None

    def push(self, actor):
        """Add an actor to the pool."""
        self._idle.append(actor)
        self._flush_pending()
