"""Per-node shared-memory object store (plasma equivalent).

Role of the reference's plasma store embedded in the raylet (reference:
src/ray/object_manager/plasma/store.h:55, object_lifecycle_manager.h:101,
eviction_policy.h:160).

Two backends behind one API:

- **Native arena** (default when the C++ library builds —
  ray_tpu_torch/_native/shm_arena.cpp): one mmap'd shared-memory arena with an
  in-shm object index, first-fit allocator and LRU eviction, like
  plasma's dlmalloc arena.  Local `get` of a sealed object touches NO
  rpc: the client resolves (offset,size) from the shared index under a
  process-shared mutex and deserializes zero-copy from the mapping;
  per-object shm refcounts keep eviction from reclaiming mapped objects.
- **File-per-object fallback** (no C++ toolchain): objects as individual
  tmpfs files, mmap'd by clients; gets go through the raylet rpc.

Small objects (< max_direct_call_object_size) are stored inline in the
store process and returned inside RPC replies (the reference keeps these
in the owner's in-process memory store).  Clients write large objects
themselves, then `seal` with the store — a put is one RPC regardless of
size.

The *server* half (`ObjectStoreCore`) runs inside the raylet's asyncio
loop; the *client* half (`StoreClient`) runs in drivers and workers.
"""

from __future__ import annotations

import asyncio
import mmap
import os
import time
from typing import Any, Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private import telemetry

SEALED = 1
INLINE = 2


class ObjectEntry:
    __slots__ = (
        "object_id", "size", "state", "path", "inline_data",
        "pin_count", "last_access", "sealed_event", "is_error", "waiters",
    )

    def __init__(self, object_id: ObjectID):
        self.object_id = object_id
        self.size = 0
        self.state = 0
        self.path: Optional[str] = None
        self.inline_data: Optional[bytes] = None
        self.pin_count = 0
        self.last_access = time.monotonic()
        self.sealed_event: Optional[asyncio.Event] = None
        self.is_error = False
        self.waiters = 0  # live wait_sealed() calls on this entry


ARENA_FILENAME = "arena"


def _try_native_arena(store_dir: str, capacity: int, create: bool):
    try:
        from ray_tpu_torch._native.arena import NativeArena

        path = os.path.join(store_dir, ARENA_FILENAME)
        if create:
            return NativeArena.create(path, capacity)
        return NativeArena.attach(path) if os.path.exists(path) else None
    except Exception:
        return None


class ObjectStoreCore:
    """Server half; lives in the raylet process' asyncio loop."""

    def __init__(self, store_dir: str, capacity_bytes: int, on_seal=None, on_evict=None):
        self.store_dir = store_dir
        os.makedirs(store_dir, exist_ok=True)
        self.capacity = capacity_bytes
        self.used = 0
        self.objects: Dict[ObjectID, ObjectEntry] = {}
        # Callbacks into the raylet: directory updates to GCS.
        self.on_seal = on_seal
        self.on_evict = on_evict
        self.num_puts = 0
        self.num_gets = 0
        self.num_evictions = 0
        # Native arena backend (plasma-equivalent); None → file fallback.
        self.arena = _try_native_arena(store_dir, capacity_bytes, create=True)
        if self.arena is not None and CONFIG.arena_prefault_bytes > 0:
            # Background trickled prefault of the hot low region (the
            # bump allocator + freelist reuse low offsets): puts landing
            # there run at warm-page memcpy speed (~4x — see
            # PERF_ANALYSIS.md).  Capped + paced so a multi-raylet box
            # doesn't make capacity x raylets resident or saturate the
            # memory bus at startup.
            import threading

            threading.Thread(
                target=self.arena.prefault,
                args=(CONFIG.arena_prefault_bytes,),
                daemon=True,
                name="arena-prefault",
            ).start()
        # --- spilling (reference: external_storage.py FileSystemStorage +
        # raylet/local_object_manager.h SpillObjects) ---
        # Under memory pressure, LRU sealed objects are written to disk and
        # dropped from memory; reads serve straight from the spill file
        # (it is just another file-backed location), so no restore pass is
        # needed and the GCS directory keeps this node as a valid location.
        # Per-node subdirectory: a configured shared spill root must not
        # let one node's shutdown rmtree other nodes' spill files.
        self.spill_dir = os.path.join(
            CONFIG.object_spilling_dir or store_dir,
            "spill_" + os.path.basename(os.path.normpath(store_dir)),
        )
        self.spilled: Dict[ObjectID, Tuple[str, int]] = {}  # oid -> (path, size)
        self.spilled_bytes = 0
        self.num_spilled = 0
        # Async spills in flight (excluded from LRU candidate scans).
        self._spilling: set = set()
        self.num_restored = 0
        # In-progress chunked creates: oid -> ("arena", view) | ("file", mmap, path)
        self._creates: Dict[ObjectID, tuple] = {}

    # -- spilling ----------------------------------------------------------
    def _spill_one(self, e: ObjectEntry) -> bool:
        """Move one sealed in-memory object to the spill directory.

        The copy runs in bounded 8MB slices so peak extra memory stays
        constant regardless of object size.  The write itself is still
        synchronous on the raylet loop — local-disk bursts are ms-scale;
        a dedicated spill-IO thread pool (reference: IO workers driven by
        local_object_manager.h) is the next step if profiles demand it.
        """
        size = e.size
        os.makedirs(self.spill_dir, exist_ok=True)
        path = os.path.join(self.spill_dir, e.object_id.hex())
        tmp = path + ".w"
        slice_size = 8 * 1024 * 1024
        try:
            with open(tmp, "wb") as f:
                off = 0
                while off < size:
                    r = self.read_chunk(e.object_id, off, min(slice_size, size - off))
                    if r is None:
                        raise OSError("object vanished mid-spill")
                    f.write(r[1])
                    off += len(r[1])
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False
        # Delete the in-memory copy; a mapped arena slot (refcount > 0)
        # can't be reclaimed — undo the spill for that one.
        if not self.delete_in_memory(e.object_id):
            try:
                os.unlink(path)
            except OSError:
                pass
            return False
        self.spilled[e.object_id] = (path, size)
        self.spilled_bytes += size
        self.num_spilled += 1
        return True

    async def spill_pressure_async(self, loop) -> int:
        """Background high-watermark spilling with the file IO off the
        event loop (reference: local_object_manager.h:41 IO workers).
        Keeps the synchronous reserve() path a rare fallback: by the time
        an allocation needs room, LRU objects are already on disk."""
        if not CONFIG.object_spilling_enabled or self.capacity <= 0:
            return 0
        hi = CONFIG.object_spill_high_watermark * self.capacity
        lo = CONFIG.object_spill_low_watermark * self.capacity
        if self.used <= hi:
            return 0
        n = 0
        for e in self.lru_candidates():
            if self.used <= lo:
                break
            if await self._spill_one_async(e, loop):
                n += 1
        return n

    async def _spill_one_async(self, e: ObjectEntry, loop) -> bool:
        """Like _spill_one, but each disk write runs in the default
        executor so a multi-GB burst never stalls scheduling, heartbeats,
        or pulls.  Store bookkeeping stays on the loop thread; the entry
        is re-validated after every await (it can be deleted mid-spill),
        and marked in-flight so the synchronous reserve-path spiller
        doesn't duplicate the same disk write on the hot path."""
        self._spilling.add(e.object_id)
        try:
            return await self._spill_one_async_inner(e, loop)
        finally:
            self._spilling.discard(e.object_id)

    async def _spill_one_async_inner(self, e: ObjectEntry, loop) -> bool:
        size = e.size
        os.makedirs(self.spill_dir, exist_ok=True)
        path = os.path.join(self.spill_dir, e.object_id.hex())
        tmp = path + ".w"
        slice_size = 8 * 1024 * 1024
        try:
            with open(tmp, "wb") as f:
                off = 0
                while off < size:
                    r = self.read_chunk(e.object_id, off, min(slice_size, size - off))
                    if r is None:
                        raise OSError("object vanished mid-spill")
                    data = bytes(r[1])  # copy: the view dies across awaits
                    await loop.run_in_executor(None, f.write, data)
                    off += len(data)
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False
        if self.objects.get(e.object_id) is not e or not self.delete_in_memory(e.object_id):
            try:
                os.unlink(path)
            except OSError:
                pass
            return False
        self.spilled[e.object_id] = (path, size)
        self.spilled_bytes += size
        self.num_spilled += 1
        return True

    def _spill_until_fits(self, need: int) -> bool:
        if need > self.capacity:
            return False  # can never fit: don't drain the store trying
        if not CONFIG.object_spilling_enabled:
            return self.can_fit(need)
        for e in self.lru_candidates():
            if self.can_fit(need):
                return True
            self._spill_one(e)
        return self.can_fit(need)

    def lru_candidates(self) -> List[ObjectEntry]:
        return sorted(
            (
                e
                for e in self.objects.values()
                if e.state == SEALED
                and e.pin_count == 0
                and e.object_id not in self._spilling
            ),
            key=lambda e: e.last_access,
        )

    def can_fit(self, need: int) -> bool:
        if self.arena is not None:
            return bool(self.arena.can_fit(need))
        return self.used + need <= self.capacity

    def delete_in_memory(self, object_id: ObjectID) -> bool:
        """Remove the in-memory copy only (spill keeps serving the data).
        Returns False if an arena slot is still mapped by a reader."""
        e = self.objects.get(object_id)
        if e is None or not e.state:
            return False
        if e.state == SEALED and e.path is None and self.arena is not None:
            if not self.arena.delete(object_id.binary()):
                return False  # refcount > 0: a client has it mapped
        elif e.path:
            try:
                os.unlink(e.path)
            except OSError:
                pass
        self.objects.pop(object_id, None)
        self.used -= e.size
        return True

    def reserve(self, need: int) -> bool:
        """Make room for a `need`-byte allocation: spill LRU objects to
        disk first (they stay readable), evict outright as a last resort
        (client calls this when arena_alloc reports no space)."""
        if self._spill_until_fits(need):
            return True
        if self.arena is None:
            self._ensure_capacity(need)
            return True
        evicted = self.arena.evict_lru(need)
        if evicted is None:
            return False
        for padded in evicted:
            oid = ObjectID(padded[: ObjectID.SIZE])
            e = self.objects.pop(oid, None)
            if e is not None:
                self.used -= e.size
            self.num_evictions += 1
            if self.on_evict:
                self.on_evict(oid)
        return True

    # -- lifecycle ---------------------------------------------------------
    def object_path(self, object_id: ObjectID) -> str:
        return os.path.join(self.store_dir, object_id.hex())

    def contains(self, object_id: ObjectID) -> bool:
        e = self.objects.get(object_id)
        if e is not None and e.state in (SEALED, INLINE):
            return True
        return object_id in self.spilled

    def put_inline(self, object_id: ObjectID, data: bytes, is_error: bool = False) -> bool:
        if self.contains(object_id):
            return False
        e = self.objects.get(object_id) or ObjectEntry(object_id)
        # the server owns `data` after unpickling the request frame:
        # keep bytes/bytearray as-is instead of paying another full copy
        e.inline_data = data if isinstance(data, (bytes, bytearray)) else bytes(data)
        e.size = len(data)
        e.state = INLINE
        e.is_error = is_error
        self.objects[object_id] = e
        self.used += e.size
        self.num_puts += 1
        self._notify_sealed(e)
        return True

    def seal_file(self, object_id: ObjectID, size: int) -> bool:
        """Client already wrote the data (arena slot, or `store_dir/<hex>`
        in fallback mode); account + announce it."""
        if self.contains(object_id):
            return False
        e = self.objects.get(object_id) or ObjectEntry(object_id)
        if self.arena is not None and self.arena.contains(object_id.binary()):
            e.path = None  # arena-backed
        else:
            self._ensure_capacity(size)
            e.path = self.object_path(object_id)
        e.size = size
        e.state = SEALED
        self.objects[object_id] = e
        self.used += size
        self.num_puts += 1
        self._notify_sealed(e)
        return True

    def create_from_bytes(self, object_id: ObjectID, data: bytes) -> bool:
        """Store-side write (used by object pulls from remote nodes)."""
        if self.contains(object_id):
            return False
        if len(data) <= CONFIG.max_direct_call_object_size:
            return self.put_inline(object_id, data)
        if self.arena is not None:
            code, view = self.arena.alloc_status(object_id.binary(), len(data))
            if code == -1 and self.reserve(len(data)):
                code, view = self.arena.alloc_status(object_id.binary(), len(data))
            if code == 0:
                view[:] = data
                del view
                self.arena.seal(object_id.binary())
                ok = self.seal_file(object_id, len(data))
                self.arena.release_create(object_id.binary())
                return ok
            if code == -2:
                return False
            # fall through to file path on arena exhaustion
        self._ensure_capacity(len(data))
        path = self.object_path(object_id)
        with open(path, "wb") as f:
            f.write(data)
        return self.seal_file(object_id, len(data))

    def read_bytes(self, object_id: ObjectID) -> Optional[bytes]:
        e = self.objects.get(object_id)
        if e is None or not e.state:
            sp = self.spilled.get(object_id)
            if sp is not None:
                try:
                    with open(sp[0], "rb") as f:
                        return f.read()
                except OSError:
                    return None
            return None
        e.last_access = time.monotonic()
        if e.state == INLINE:
            return e.inline_data
        if e.path is None and self.arena is not None:
            view = self.arena.lookup(object_id.binary())
            if view is None:
                return None
            try:
                return bytes(view)
            finally:
                del view
                self.arena.decref(object_id.binary())
        with open(e.path, "rb") as f:
            return f.read()

    def get_meta(self, object_id: ObjectID):
        e = self.objects.get(object_id)
        if e is None or not e.state:
            sp = self.spilled.get(object_id)
            if sp is not None:
                # Spilled objects serve as plain file-backed objects —
                # clients mmap the spill file directly, no restore pass.
                self.num_gets += 1
                self.num_restored += 1
                return {"path": sp[0], "size": sp[1]}
            return None
        e.last_access = time.monotonic()
        self.num_gets += 1
        if e.state == INLINE:
            return {"inline": e.inline_data, "size": e.size}
        if e.path is None:
            return {"arena": True, "size": e.size}
        return {"path": e.path, "size": e.size}

    def read_chunk(self, object_id: ObjectID, offset: int, length: int):
        """(total_size, bytes) for node-to-node chunked transfer, or None
        (reference: object_manager push/pull chunking, push_manager.h:30)."""
        e = self.objects.get(object_id)
        if e is not None and e.state:
            e.last_access = time.monotonic()
            if e.state == INLINE:
                return e.size, e.inline_data[offset : offset + length]
            if e.path is None and self.arena is not None:
                view = self.arena.lookup(object_id.binary())
                if view is None:
                    return None
                try:
                    return e.size, bytes(view[offset : offset + length])
                finally:
                    del view
                    self.arena.decref(object_id.binary())
            try:
                with open(e.path, "rb") as f:
                    f.seek(offset)
                    return e.size, f.read(length)
            except OSError:
                return None
        sp = self.spilled.get(object_id)
        if sp is not None:
            try:
                with open(sp[0], "rb") as f:
                    f.seek(offset)
                    return sp[1], f.read(length)
            except OSError:
                return None
        return None

    # -- chunked creates (pulls from remote nodes) -------------------------
    def begin_create(self, object_id: ObjectID, size: int) -> Optional[memoryview]:
        """Allocate a writable buffer for an incoming object; pair with
        commit_create/abort_create.  None = already stored/in progress or
        no space."""
        if self.contains(object_id) or object_id in self._creates:
            return None
        if self.arena is not None:
            code, view = self.arena.alloc_status(object_id.binary(), size)
            if code == -1 and self.reserve(size):
                code, view = self.arena.alloc_status(object_id.binary(), size)
            if code == 0:
                self._creates[object_id] = ("arena", view)
                return view
            if code == -2:
                return None
            # fall through to file on arena exhaustion
        self._ensure_capacity(size)
        path = self.object_path(object_id) + ".w"
        try:
            f = open(path, "w+b")
            f.truncate(size)
            m = mmap.mmap(f.fileno(), size)
            f.close()
        except OSError:
            return None
        self._creates[object_id] = ("file", m, path)
        return memoryview(m)

    def commit_create(self, object_id: ObjectID, size: int) -> bool:
        rec = self._creates.pop(object_id, None)
        if rec is None:
            return False
        if rec[0] == "arena":
            view = rec[1]
            try:
                view.release()
            except BufferError:
                pass
            self.arena.seal(object_id.binary())
            ok = self.seal_file(object_id, size)
            self.arena.release_create(object_id.binary())
            return ok
        m, path = rec[1], rec[2]
        _close_mmap_quietly(m)
        os.rename(path, self.object_path(object_id))
        return self.seal_file(object_id, size)

    def abort_create(self, object_id: ObjectID):
        rec = self._creates.pop(object_id, None)
        if rec is None:
            return
        if rec[0] == "arena":
            view = rec[1]
            try:
                view.release()
            except BufferError:
                pass
            self.arena.release_create(object_id.binary())
            self.arena.delete(object_id.binary())
        else:
            m, path = rec[1], rec[2]
            _close_mmap_quietly(m)
            try:
                os.unlink(path)
            except OSError:
                pass

    def delete(self, object_id: ObjectID):
        sp = self.spilled.pop(object_id, None)
        if sp is not None:
            self.spilled_bytes -= sp[1]
            try:
                os.unlink(sp[0])
            except OSError:
                pass
        e = self.objects.get(object_id)
        if e is None:
            return
        if not e.state and e.waiters > 0:
            # Placeholder with live waiters (wait_sealed): there is no
            # data to delete, and popping it would strand the waiters'
            # event — a later seal would notify a fresh entry instead.
            # The last waiter reaps the placeholder itself.
            return
        self.objects.pop(object_id, None)
        if e.state:
            self.used -= e.size
        if e.path:
            try:
                os.unlink(e.path)
            except OSError:
                pass
        elif self.arena is not None:
            # refcounted readers block reclamation; LRU eviction retries
            self.arena.delete(object_id.binary())

    def pin(self, object_id: ObjectID):
        e = self.objects.get(object_id)
        if e is not None:
            e.pin_count += 1
            if e.state == SEALED and e.path is None and self.arena is not None:
                # hold an arena ref so LRU eviction can't reclaim it
                view = self.arena.lookup(object_id.binary())
                if view is not None:
                    del view

    def unpin(self, object_id: ObjectID):
        e = self.objects.get(object_id)
        if e is not None and e.pin_count > 0:
            e.pin_count -= 1
            if e.state == SEALED and e.path is None and self.arena is not None:
                self.arena.decref(object_id.binary())

    async def wait_sealed(self, object_id: ObjectID, timeout: Optional[float]) -> bool:
        e = self.objects.get(object_id)
        if e is not None and e.state:
            return True
        if object_id in self.spilled:
            return True  # available on disk — no seal event will fire
        if e is None:
            e = ObjectEntry(object_id)
            self.objects[object_id] = e
        if e.sealed_event is None:
            e.sealed_event = asyncio.Event()
        e.waiters += 1
        try:
            await asyncio.wait_for(e.sealed_event.wait(), timeout)
            return True
        except asyncio.TimeoutError:
            return False
        finally:
            e.waiters -= 1
            # Reap the placeholder when the last waiter leaves and nothing
            # was ever stored — otherwise timed-out gets leak entries.
            if e.waiters <= 0 and not e.state and self.objects.get(object_id) is e:
                del self.objects[object_id]

    def _notify_sealed(self, e: ObjectEntry):
        if e.sealed_event is not None:
            e.sealed_event.set()
            e.sealed_event = None
        if self.on_seal:
            self.on_seal(e.object_id)

    # -- eviction (LRU over unpinned sealed objects; reference:
    # plasma/eviction_policy.h) ------------------------------------------
    def _ensure_capacity(self, need: int):
        if self.used + need <= self.capacity:
            return
        # Spill before evicting: spilled objects remain readable.
        if CONFIG.object_spilling_enabled:
            for e in self.lru_candidates():
                if self.used + need <= self.capacity:
                    return
                self._spill_one(e)
        candidates = sorted(
            (e for e in self.objects.values() if e.state and e.pin_count == 0),
            key=lambda e: e.last_access,
        )
        for e in candidates:
            if self.used + need <= self.capacity:
                break
            self.num_evictions += 1
            if self.on_evict:
                self.on_evict(e.object_id)
            self.delete(e.object_id)

    def stats(self) -> dict:
        return {
            "num_objects": len(self.objects),
            "used_bytes": self.used,
            "capacity_bytes": self.capacity,
            "num_puts": self.num_puts,
            "num_gets": self.num_gets,
            "num_evictions": self.num_evictions,
            "num_spilled": self.num_spilled,
            "spilled_bytes": self.spilled_bytes,
            "num_restored": self.num_restored,
            # Pinned objects (actor/borrow pins + drain-time replicas):
            # excluded from LRU eviction, so drain migration can't be
            # silently undone by memory pressure.
            "num_pinned": sum(1 for e in self.objects.values() if e.pin_count > 0),
        }


def _close_mmap_quietly(m):
    try:
        m.close()
    except BufferError:
        # An extracted sub-buffer still aliases the mapping; leak it rather
        # than invalidate live views.
        pass


def _arena_release(arena, id_bytes: bytes, view):
    try:
        view.release()
    except BufferError:
        pass
    try:
        arena.decref(id_bytes)
    except Exception:
        pass


class StoreClient:
    """Client half; talks to the local raylet's store RPCs and mmaps shm
    files directly for large objects (zero-copy on the same node)."""

    def __init__(self, raylet_client, store_dir: str):
        self._raylet = raylet_client  # rpc.RpcClient to the local raylet
        self.store_dir = store_dir
        # Attach to the node's native arena if the raylet created one.
        self.arena = _try_native_arena(store_dir, 0, create=False)

    def put_blob(self, object_id: ObjectID, blob: bytes) -> int:
        """Store an already-flattened serialized blob."""
        t0 = time.perf_counter()
        stored = None
        try:
            if len(blob) <= CONFIG.max_direct_call_object_size:
                # bytearray ships as-is; the raylet's put_inline owns the copy
                self._raylet.call("store_put_inline", (object_id.binary(), blob))
                stored = len(blob)
                return stored
            path = os.path.join(self.store_dir, object_id.hex())
            tmp = path + ".w"
            with open(tmp, "w+b") as f:
                f.write(blob)
            os.rename(tmp, path)
            self._raylet.call("store_seal", (object_id.binary(), len(blob)))
            stored = len(blob)
            return stored
        finally:
            telemetry.observe_store("put", time.perf_counter() - t0, stored)

    def put_serialized(self, object_id: ObjectID, meta: bytes, buffers: List[memoryview]) -> int:
        t0 = time.perf_counter()
        total = None
        try:
            total = self._put_serialized_inner(object_id, meta, buffers)
            return total
        finally:
            telemetry.observe_store("put", time.perf_counter() - t0, total)

    def _put_serialized_inner(self, object_id: ObjectID, meta: bytes, buffers: List[memoryview]) -> int:
        from ray_tpu_torch._private import serialization

        total = serialization.total_size(meta, buffers)
        if total <= CONFIG.max_direct_call_object_size:
            blob = bytearray(total)
            serialization.write_into(memoryview(blob), meta, buffers)
            # no bytes(blob): the frame pickler copies the bytearray once
            # into the wire frame; a bytes() conversion would add a
            # second full copy of every small put
            self._raylet.call("store_put_inline", (object_id.binary(), blob))
            return total
        if self.arena is not None:
            code, view = self.arena.alloc_status(object_id.binary(), total)
            if code == -1:
                # ask the raylet to evict, then retry once
                if self._raylet.call("store_reserve", total):
                    code, view = self.arena.alloc_status(object_id.binary(), total)
            if code == 0:
                serialization.write_into(view, meta, buffers)
                del view
                self.arena.seal(object_id.binary())
                try:
                    self._raylet.call("store_seal", (object_id.binary(), total))
                finally:
                    # Creator ref held since alloc: only now — after the
                    # raylet registered the object — may eviction consider
                    # this slot.  (If this process dies first, eviction
                    # reclaims the creator ref via its pid.)
                    self.arena.release_create(object_id.binary())
                return total
            if code == -2:  # already stored by someone else
                return total
            # arena exhausted → file fallback below
        path = os.path.join(self.store_dir, object_id.hex())
        tmp = path + ".w"
        with open(tmp, "w+b") as f:
            f.truncate(total)
            with mmap.mmap(f.fileno(), total) as m:
                serialization.write_into(memoryview(m), meta, buffers)
        os.rename(tmp, path)
        self._raylet.call("store_seal", (object_id.binary(), total))
        return total

    def _deserialize_arena(self, object_id: ObjectID):
        """Zero-copy deserialize straight out of the shared arena; the
        object's shm refcount is held until the value is collected."""
        from ray_tpu_torch._private import serialization

        view = self.arena.lookup(object_id.binary())
        if view is None:
            return None
        tag, value = serialization.deserialize(view)
        arena, id_bytes = self.arena, object_id.binary()
        if serialization.buffer_count(view) == 0:
            # No out-of-band buffers → the value holds no aliases into the
            # arena (the pickle payload was copied): release immediately.
            _arena_release(arena, id_bytes, view)
            return tag, value
        import weakref

        try:
            weakref.finalize(value, _arena_release, arena, id_bytes, view)
        except TypeError:
            # Non-weakref-able container with aliasing buffers (e.g. a dict
            # of arrays): re-deserialize from a private copy so nothing
            # aliases the arena, then release the shm refcount immediately —
            # pinning it for the process lifetime would block eviction of
            # the slot forever.
            data = bytes(view)
            del value
            try:
                view.release()
            except BufferError:
                # The discarded value sits in a reference cycle still
                # exporting buffers over the view; collect it before
                # releasing the slot (decref'ing while the buffers are
                # alive would allow reuse under live array objects).
                import gc

                gc.collect()
                try:
                    view.release()
                except BufferError:
                    view = None  # give up: pin the slot for process life
            if view is not None:
                arena.decref(id_bytes)
            tag, value = serialization.deserialize(memoryview(data))
        return tag, value

    def _store_get_meta(self, object_id: ObjectID, timeout: Optional[float]):
        """store_get with bounded re-asks.

        The raylet parks the request until the object seals, so one lost
        frame (chaos drop, transient raylet stall) used to hang a
        timeout-less get forever.  Instead of one unbounded call, park in
        chunks and re-ask — the server-side wait is idempotent, so
        re-asking is free and every lost frame costs at most one chunk.
        Returns the meta dict, or None once the caller's deadline passes.
        """
        from ray_tpu_torch._private import rpc as rpc_mod

        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            park = min(30.0, max(1.0, CONFIG.rpc_call_timeout_s / 2))
            if deadline is not None:
                park = min(park, max(0.0, deadline - time.monotonic()))
            try:
                meta = self._raylet.call(
                    "store_get", (object_id.binary(), park), timeout=park + 5
                )
            except rpc_mod.CallTimeout:
                meta = None  # frame lost in flight: re-ask
            if meta is not None:
                return meta
            if deadline is not None and time.monotonic() >= deadline:
                return None

    def get_serialized(self, object_id: ObjectID, timeout: Optional[float]):
        """Returns (tag, value) or raises GetTimeoutError/ObjectLostError."""
        t0 = time.perf_counter()
        try:
            return self._get_serialized_inner(object_id, timeout)
        finally:
            telemetry.observe_store("get", time.perf_counter() - t0)

    def _get_serialized_inner(self, object_id: ObjectID, timeout: Optional[float]):
        from ray_tpu_torch import exceptions
        from ray_tpu_torch._private import serialization

        # Fast path: sealed in the local arena → no RPC at all.
        if self.arena is not None:
            out = self._deserialize_arena(object_id)
            if out is not None:
                return out
        from ray_tpu_torch._private import retry

        bo = retry.STORE_GET.start()
        while True:
            meta = self._store_get_meta(object_id, timeout)
            if meta is None:
                raise exceptions.GetTimeoutError(f"timed out getting {object_id}")
            if meta.get("lost"):
                # Every copy is gone (node death/eviction).  Owners repair
                # this via lineage reconstruction in Worker._get_one.
                raise exceptions.ObjectLostError(
                    object_id, f"all copies of {object_id} were lost from the cluster"
                )
            if "inline" in meta:
                telemetry.count_store_bytes("get", len(meta["inline"]))
                return serialization.deserialize(memoryview(meta["inline"]))
            if meta.get("arena"):
                out = self._deserialize_arena(object_id)
                if out is not None:
                    return out
                # Spilled or evicted between the reply and our lookup:
                # refetch the meta (a spilled object resolves to a file).
                f = None
            else:
                try:
                    f = open(meta["path"], "rb")
                except FileNotFoundError:
                    # The object spilled (original file moved) between the
                    # reply and our open: refetch the meta.
                    f = None
            if f is not None:
                break
            delay = bo.next_delay()
            if delay is None:
                raise exceptions.ObjectLostError(f"{object_id} evicted during get")
            time.sleep(delay)
        try:
            m = mmap.mmap(f.fileno(), meta["size"], prot=mmap.PROT_READ)
        finally:
            f.close()
        telemetry.count_store_bytes("get", meta["size"])
        tag, value = serialization.deserialize(memoryview(m))
        if serialization.buffer_count(memoryview(m)) == 0:
            _close_mmap_quietly(m)
            return tag, value
        # The mmap must outlive any buffers aliasing it.  Close it when the
        # deserialized value is collected; values that can't carry a weakref
        # (plain containers) are re-read from a private copy so the mapping
        # can close now instead of leaking for the process lifetime.
        import weakref

        try:
            weakref.finalize(value, _close_mmap_quietly, m)
        except TypeError:
            data = bytes(m)
            del value
            _close_mmap_quietly(m)
            tag, value = serialization.deserialize(memoryview(data))
        return tag, value

    def contains(self, object_id: ObjectID) -> bool:
        return self._raylet.call("store_contains", object_id.binary())

    def wait(self, object_ids: List[ObjectID], num_returns: int, timeout: Optional[float]) -> Tuple[Set[ObjectID], Set[ObjectID]]:
        ready = self._raylet.call(
            "store_wait",
            ([o.binary() for o in object_ids], num_returns, timeout),
            timeout=(timeout + 5) if timeout is not None else None,
        )
        ready_ids = {ObjectID(b) for b in ready}
        return ready_ids, {o for o in object_ids if o not in ready_ids}

    def free(self, object_ids: List[ObjectID]):
        self._raylet.push("store_free", [o.binary() for o in object_ids])
