"""Streaming generators: ``num_returns="streaming"``.

Reference: src/ray/core_worker/generator_waiter.h + ObjectRefGenerator in
python/ray/_raylet.pyx; used pervasively by the reference Data executor
so a consumer can start on the first yielded block before the producer
finishes.

Protocol here: a streaming task's yields are sealed incrementally as
return indices 1..N of the task (``TaskSpec.stream_item_id``); return
index 0 is the end-of-stream sentinel — a :class:`StreamEnd` carrying the
item count on success, or the task's error.  On the direct call paths the
executing worker pushes a ``stream_item`` message per yield over the same
connection that later carries ``task_finished`` (socket FIFO ⇒ items are
seen before the end).  On the raylet-mediated path there are no pushes;
the owner's generator falls back to polling the store, where the items
and the sentinel were sealed.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.object_ref import ObjectRef


class StreamEnd:
    """End-of-stream sentinel stored as a streaming task's return 0."""

    __slots__ = ("count",)

    def __init__(self, count: int):
        self.count = count

    def __reduce__(self):
        return (StreamEnd, (self.count,))

    def __repr__(self):
        return f"StreamEnd(count={self.count})"


class _StreamState:
    """Owner-side arrival log for one streaming task."""

    __slots__ = ("cond", "arrived", "finished", "saw_push")

    def __init__(self):
        self.cond = threading.Condition()
        # item index -> True once its object is fetchable.
        self.arrived: Dict[int, bool] = {}
        # task_finished seen (sentinel resolvable).
        self.finished = False
        # Any stream_item/task_finished PUSH observed?  False means the
        # raylet-mediated path (items sealed in the store by construction,
        # no per-item existence check needed when draining after the end).
        self.saw_push = False

    def on_item(self, index: int):
        with self.cond:
            self.saw_push = True
            self.arrived[index] = True
            self.cond.notify_all()

    def on_finished(self, pushed: bool = True):
        with self.cond:
            if pushed:
                self.saw_push = True
            self.finished = True
            self.cond.notify_all()


class ObjectRefGenerator:
    """Iterator of ObjectRefs for a streaming task's yields, in yield
    order.  ``next()`` blocks until the next item is ready; when the task
    finishes it raises StopIteration (or the task's error, re-raised at
    the position the task failed)."""

    def __init__(self, worker, spec):
        self._worker = worker
        self._spec = spec
        self._task_id = spec.task_id
        self._consumed = 0
        self._count: Optional[int] = None  # known once the sentinel reads
        self._error: Optional[Exception] = None
        self._state = worker._register_stream(spec)
        self._last_poll = time.monotonic()
        self._fallback_deadline: Optional[float] = None
        # The GENERATOR owns the end-of-stream sentinel's lifetime: without
        # this owned ref, a submit path that builds-and-drops the usual
        # return-ref list would eagerly free the sentinel cluster-wide at
        # submit time, and any consumer reaching _resolve_sentinel after
        # the ~200ms free flush finds it gone (the first call on a fresh
        # driver won the race, every later one timed out — the bug shape
        # that surfaced through serve streaming).  Dropped with the
        # generator, so abandoned streams still free their sentinel.
        self._sentinel_ref = ObjectRef(spec.return_ids()[0], owned=True)

    # -- iteration ------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self) -> ObjectRef:
        return self._next_internal(timeout=None)

    def next(self, timeout: Optional[float] = None) -> ObjectRef:
        return self._next_internal(timeout)

    def _item_ref(self) -> ObjectRef:
        ref = ObjectRef(self._spec.stream_item_id(self._consumed), owned=True)
        self._consumed += 1
        return ref

    def _fallback_item_ref(
        self, block: bool = True, caller_deadline: Optional[float] = None
    ) -> Optional[ObjectRef]:
        """Sentinel says this item exists but its push never arrived.

        On the raylet-mediated path (no pushes ever observed) every item
        is sealed in the store by construction — hand the ref out for
        free.  On the push path a missing item means its inline push was
        lost (direct server loop stopped racing process exit): verify
        before handing out a ref the consumer's get() would hang on, and
        surface ObjectLostError if it truly never sealed.  With
        ``block=False`` (try_next) a single probe is made per call;
        None means "not confirmed yet, ask again"."""
        if not self._state.saw_push:
            return self._item_ref()
        oid = self._spec.stream_item_id(self._consumed)
        if self._fallback_deadline is None:
            self._fallback_deadline = time.monotonic() + 2.0
        from ray_tpu_torch._private import retry

        bo = retry.STREAM_POLL.start()
        while True:
            with self._state.cond:
                arrived = self._consumed in self._state.arrived
                if arrived:
                    del self._state.arrived[self._consumed]
            if arrived:
                # The push landed after all (e.g. shm promotion failed but
                # the owner's memory store holds it) — resolvable locally.
                self._fallback_deadline = None
                return self._item_ref()
            if self._store_has(oid):
                self._fallback_deadline = None
                return self._item_ref()
            if time.monotonic() > self._fallback_deadline:
                from ray_tpu_torch import exceptions

                self._worker._drop_stream(self._task_id)
                raise exceptions.ObjectLostError(
                    f"stream item {self._consumed} of {self._spec.name} was "
                    "announced by the end-of-stream sentinel but never sealed "
                    "(its inline push was lost)"
                )
            if caller_deadline is not None and time.monotonic() > caller_deadline:
                from ray_tpu_torch import exceptions

                raise exceptions.GetTimeoutError(
                    f"no stream item from {self._spec.name} before timeout"
                )
            if not block:
                return None
            time.sleep(bo.next_delay() or 0.1)

    def _resolve_sentinel(self):
        """Read return 0: StreamEnd(count) or raises the task error."""
        sentinel = ObjectRef(self._spec.return_ids()[0], owned=False)
        value = self._worker.get([sentinel], timeout=30)[0]
        if isinstance(value, StreamEnd):
            self._count = value.count
        else:  # pragma: no cover — get() re-raises stored errors
            raise RuntimeError(f"unexpected stream sentinel: {value!r}")

    def _next_internal(self, timeout: Optional[float]) -> ObjectRef:
        deadline = None if timeout is None else time.monotonic() + timeout
        state = self._state
        while True:
            with state.cond:
                if self._consumed in state.arrived:
                    del state.arrived[self._consumed]
                    return self._item_ref()
                finished = state.finished
            if self._count is not None or finished:
                if self._count is None:
                    self._resolve_sentinel()  # raises the task's error
                if self._consumed < self._count:
                    # Sentinel read but this item's push never arrived
                    # (raylet-mediated path, or push raced shutdown).
                    return self._fallback_item_ref(caller_deadline=deadline)
                self._worker._drop_stream(self._task_id)
                raise StopIteration
            # Raylet-mediated fallback: no pushes arrive at all — probe
            # for the next item / the sentinel (rate-limited; on the push
            # path these probes can never win, so they're pure overhead).
            now = time.monotonic()
            if now - self._last_poll > 0.2:
                self._last_poll = now
                if self._store_has(self._spec.stream_item_id(self._consumed)):
                    return self._item_ref()
                if self._store_has(self._spec.return_ids()[0]):
                    state.on_finished(pushed=False)
                    continue
            if deadline is not None and time.monotonic() > deadline:
                from ray_tpu_torch import exceptions

                raise exceptions.GetTimeoutError(
                    f"no stream item from {self._spec.name} within {timeout}s"
                )
            with state.cond:
                state.cond.wait(0.05)

    def try_next(self) -> Optional[ObjectRef]:
        """Non-blocking: the next item's ref if ready, None otherwise;
        raises StopIteration (or the task's error) at end of stream.
        Push-path checks are pure-local; the store fallback (for
        raylet-mediated submissions) is rate-limited to one probe per
        200 ms so pollers don't hammer the raylet with RPCs."""
        state = self._state
        with state.cond:
            if self._consumed in state.arrived:
                del state.arrived[self._consumed]
                return self._item_ref()
            finished = state.finished
        if self._count is not None or finished:
            if self._count is None:
                self._resolve_sentinel()  # raises the task's error
            if self._consumed < self._count:
                return self._fallback_item_ref(block=False)
            self._worker._drop_stream(self._task_id)
            raise StopIteration
        now = time.monotonic()
        if now - self._last_poll > 0.2:
            self._last_poll = now
            if self._store_has(self._spec.stream_item_id(self._consumed)):
                return self._item_ref()
            if self._store_has(self._spec.return_ids()[0]):
                state.on_finished(pushed=False)
        return None

    def _store_has(self, oid: ObjectID) -> bool:
        """Cluster-wide existence probe via the GCS object directory —
        on the raylet-mediated path the items are sealed on the executing
        node, which need not be the owner's (a local store_contains would
        never see them)."""
        try:
            gcs = self._worker.gcs_client
            # A best-effort probe must not park on the GCS reconnect gate:
            # during an outage, consumption continues on pushes + the
            # local store check (found by the gcs-restart-mid-stream
            # drill, which this once stalled for the whole 60 s budget).
            if getattr(gcs, "ready", False) and gcs.call(
                "object_locations_get", oid.binary(), timeout=10
            ):
                return True
            # Small objects can live only in the owner's raylet store
            # (inline put), which reports locations too — but check
            # locally as a cheap belt-and-braces fallback.
            return bool(
                self._worker.raylet_client.call("store_contains", oid.binary(), timeout=10)
            )
        except Exception:
            return False

    # -- conveniences ---------------------------------------------------
    def __del__(self):
        try:
            self._worker._drop_stream(self._task_id)
        except Exception:
            pass

    def __aiter__(self):
        return self

    async def __anext__(self):
        import asyncio

        loop = asyncio.get_running_loop()
        try:
            return await loop.run_in_executor(None, self.__next__)
        except StopIteration:
            raise StopAsyncIteration
