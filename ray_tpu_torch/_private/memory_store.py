"""Owner-side in-process store for small task results.

Direct-pushed tasks return small results inline on the task-finished reply
instead of sealing them in the shared-memory store; the owner keeps them
here and `get`/`wait` resolve without any RPC (reference:
src/ray/core_worker/store_provider/memory_store/ — small returns are
piggybacked on the PushTask reply and live in the owner's memory store
until the ref escapes, at which point they are promoted to plasma).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, Optional


class MemoryStore:
    def __init__(self):
        self._data: Dict[bytes, bytes] = {}
        # Returns of in-flight direct tasks: a get on these waits for the
        # task-finished reply instead of falling through to the shm store
        # (which may never see the object).
        self._pending: set = set()
        # Pending oids whose value must be copied to the shm store on
        # arrival (their ref escaped while the task was in flight).
        self._promote: set = set()
        # Pending oids whose owner ref died: the arriving blob is promoted
        # (if flagged) but NOT retained — retaining results nobody can get
        # leaks owner memory on fire-and-forget workloads.
        self._drop: set = set()
        self._cond = threading.Condition()

    # -- owner bookkeeping -------------------------------------------------
    def add_pending(self, oids: Iterable[bytes]) -> None:
        with self._cond:
            self._pending.update(oids)

    def put(self, oid: bytes, blob: bytes) -> bool:
        """Returns True if the caller must promote the blob to the shm
        store (a consumer was promised it there while it was in flight).
        Results whose ref already died arrive, get promoted if promised,
        and are not retained."""
        with self._cond:
            was_pending = oid in self._pending
            self._pending.discard(oid)
            needs_promote = oid in self._promote
            self._promote.discard(oid)
            dropped = oid in self._drop or not was_pending
            self._drop.discard(oid)
            if not dropped:
                self._data[oid] = blob
            self._cond.notify_all()
        return needs_promote

    def mark_promote(self, oid: bytes):
        """Ask for promotion of an in-flight result.  If the value already
        arrived, returns its blob (caller promotes immediately)."""
        with self._cond:
            blob = self._data.get(oid)
            if blob is not None:
                return blob
            if oid in self._pending:
                self._promote.add(oid)
            return None

    def resolve_stored(self, oids: Iterable[bytes]) -> None:
        """The task finished but its results went to the shm store (too
        large to inline, or an error stored for non-owners too)."""
        with self._cond:
            for oid in oids:
                self._pending.discard(oid)
            self._cond.notify_all()

    def free(self, oid: bytes) -> None:
        with self._cond:
            self._data.pop(oid, None)
            self._pending.discard(oid)
            self._promote.discard(oid)
            self._drop.discard(oid)

    def free_if_settled(self, oid: bytes) -> None:
        """Drop the blob if the result already arrived; an in-flight one
        keeps its pending/promote state so arrival still runs promotion,
        but the arriving blob itself is not retained (no refs remain)."""
        with self._cond:
            if oid in self._pending:
                self._drop.add(oid)
            else:
                self._data.pop(oid, None)

    # -- read side ---------------------------------------------------------
    def contains(self, oid: bytes) -> bool:
        return oid in self._data

    def is_pending(self, oid: bytes) -> bool:
        return oid in self._pending

    def is_tracked(self, oid: bytes) -> bool:
        return oid in self._data or oid in self._pending

    def get(self, oid: bytes) -> Optional[bytes]:
        return self._data.get(oid)

    def get_wait(self, oid: bytes, deadline: Optional[float]) -> Optional[bytes]:
        """Block while `oid` is pending; return its blob, or None if the
        result was stored externally (caller falls through to the shm
        store) or the deadline passed."""
        with self._cond:
            while True:
                blob = self._data.get(oid)
                if blob is not None:
                    return blob
                if oid not in self._pending:
                    return None
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return None
                self._cond.wait(remaining if remaining is not None else 1.0)

    def wait_any(self, timeout: float) -> None:
        """Sleep until any put/resolve event (or timeout)."""
        with self._cond:
            self._cond.wait(timeout)
