"""ObjectRef — a distributed future (reference: python/ray/_raylet.pyx
ObjectRef).  Client-side reference counting: when the last local reference
to an *owned* object drops, the owner releases it cluster-wide (reference:
src/ray/core_worker/reference_count.h:64 — the full borrowing protocol is
simplified to owner-local counting plus explicit free)."""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch._private.ids import ObjectID


class ObjectRef:
    __slots__ = ("_id", "_owned", "__weakref__")

    def __init__(self, object_id: ObjectID, owned: bool = False):
        self._id = object_id
        self._owned = owned
        if owned:
            from ray_tpu_torch._private.worker import global_worker_maybe

            w = global_worker_maybe()
            if w is not None:
                w.reference_counter.add_owned(object_id)

    @property
    def id(self) -> ObjectID:
        return self._id

    def binary(self) -> bytes:
        return self._id.binary()

    def hex(self) -> str:
        return self._id.hex()

    def task_id(self):
        return self._id.task_id()

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ObjectRef({self.hex()})"

    def __reduce__(self):
        # Crossing a process boundary always produces a borrowed ref.  The
        # owner promotes any memory-store-only value to the shm store at
        # this point so the borrower can fetch it (reference: memory store
        # → plasma promotion on escape).
        from ray_tpu_torch._private.worker import global_worker_maybe

        w = global_worker_maybe()
        if w is not None and w.connected:
            try:
                w.on_ref_serialized(self._id)
            except Exception:
                pass
        return (_restore_ref, (self._id.binary(),))

    def __del__(self):
        if self._owned:
            try:
                from ray_tpu_torch._private.worker import global_worker_maybe

                w = global_worker_maybe()
                if w is not None:
                    w.reference_counter.remove_owned(self._id)
            except Exception:
                return  # interpreter shutdown: import machinery torn down

    # Allow `await ref` inside async actors.
    def __await__(self):
        from ray_tpu_torch._private.worker import get_global_worker

        w = get_global_worker()
        result = yield from w.get_async(self).__await__()
        return result

    def future(self):
        """concurrent.futures.Future resolving to the object's value."""
        import concurrent.futures
        import threading

        from ray_tpu_torch._private.worker import get_global_worker

        w = get_global_worker()
        fut: concurrent.futures.Future = concurrent.futures.Future()

        def _fetch():
            try:
                fut.set_result(w.get([self])[0])
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

        threading.Thread(target=_fetch, daemon=True).start()
        return fut


def _restore_ref(binary: bytes) -> ObjectRef:
    return ObjectRef(ObjectID(binary), owned=False)
