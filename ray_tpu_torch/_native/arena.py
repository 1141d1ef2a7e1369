"""ctypes binding for the C++ shared-memory arena store
(ray_tpu_torch/_native/shm_arena.cpp — the native data plane of the object
store, playing plasma's role from the reference:
src/ray/object_manager/plasma/).

The library is compiled from the source in the checkout on first use (g++)
into ``build/native/`` at the root of the checkout (listed in
``.gitignore``), as ``ops/_build.py`` builds the CUDA kernels; its file
name carries a hash of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded.  No compiled library is
checked in.  Environments without a toolchain fall back to the
pure-Python file-per-object store automatically.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import Optional, Tuple

logger = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "shm_arena.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "native")
_CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

ID_SIZE = 32

_build_lock = threading.Lock()
_lib = None
_lib_failed = False


def _library_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_CXX_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libshm_arena-{digest}.so")


def _build() -> Optional[str]:
    lib = _library_path()
    if os.path.exists(lib):
        return lib
    # Per-process temp output: every worker on a host may build
    # concurrently, and a shared .tmp would race one compiler's
    # truncation against another's os.replace, promoting a partially
    # written library.
    tmp = f"{lib}.tmp.{os.getpid()}"
    cmd = ["g++", *_CXX_FLAGS, _SRC, "-o", tmp, "-lpthread"]
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
        return lib
    except (subprocess.SubprocessError, OSError) as e:
        stderr = getattr(e, "stderr", b"")
        logger.warning("native arena build failed (%s); falling back to file store: %s",
                       e, stderr.decode(errors="replace")[:500] if stderr else "")
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None


def load_library():
    """Build+load the shared library once per process; None if unavailable."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _build_lock:
        if _lib is not None or _lib_failed:
            return _lib
        path = _build()
        if path is None:
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            logger.warning("arena library %s does not load (%s); falling back to file store",
                           path, e)
            _lib_failed = True
            return None
        lib.arena_create.restype = ctypes.c_void_p
        lib.arena_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32]
        lib.arena_attach.restype = ctypes.c_void_p
        lib.arena_attach.argtypes = [ctypes.c_char_p]
        lib.arena_close.argtypes = [ctypes.c_void_p]
        lib.arena_base.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.arena_base.argtypes = [ctypes.c_void_p]
        lib.arena_alloc.restype = ctypes.c_int64
        lib.arena_alloc.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
        lib.arena_seal.restype = ctypes.c_int
        lib.arena_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.arena_lookup.restype = ctypes.c_int64
        lib.arena_lookup.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64)]
        lib.arena_contains.restype = ctypes.c_int
        lib.arena_contains.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.arena_decref.restype = ctypes.c_int
        lib.arena_decref.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.arena_delete.restype = ctypes.c_int
        lib.arena_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.arena_evict_lru.restype = ctypes.c_int
        lib.arena_evict_lru.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_int]
        lib.arena_used.restype = ctypes.c_uint64
        lib.arena_used.argtypes = [ctypes.c_void_p]
        lib.arena_data_capacity.restype = ctypes.c_uint64
        lib.arena_data_capacity.argtypes = [ctypes.c_void_p]
        lib.arena_num_objects.restype = ctypes.c_uint32
        lib.arena_num_objects.argtypes = [ctypes.c_void_p]
        lib.arena_num_evictions.restype = ctypes.c_uint64
        lib.arena_num_evictions.argtypes = [ctypes.c_void_p]
        lib.arena_test_lock_and_abandon.restype = ctypes.c_int
        lib.arena_test_lock_and_abandon.argtypes = [ctypes.c_void_p]
        lib.arena_can_fit.restype = ctypes.c_int
        lib.arena_can_fit.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.arena_release_create.restype = ctypes.c_int
        lib.arena_release_create.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.arena_prefault_range.restype = ctypes.c_int
        lib.arena_prefault_range.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
        ]
        _lib = lib
        return _lib


def _pad_id(object_id: bytes) -> bytes:
    if len(object_id) > ID_SIZE:
        raise ValueError(f"object id longer than {ID_SIZE} bytes")
    return object_id.ljust(ID_SIZE, b"\0")


class NativeArena:
    """One process' handle to the node's shared arena."""

    def __init__(self, handle, lib):
        self._h = handle
        self._lib = lib
        self._base_addr = ctypes.addressof(lib.arena_base(handle).contents)
        self._closed = False

    # -- constructors ----------------------------------------------------
    @classmethod
    def create(cls, path: str, capacity: int, table_cap: int = 65536, free_cap: int = 65536) -> Optional["NativeArena"]:
        lib = load_library()
        if lib is None:
            return None
        h = lib.arena_create(path.encode(), capacity, table_cap, free_cap)
        if not h:
            return None
        return cls(h, lib)

    @classmethod
    def attach(cls, path: str) -> Optional["NativeArena"]:
        lib = load_library()
        if lib is None:
            return None
        h = lib.arena_attach(path.encode())
        if not h:
            return None
        return cls(h, lib)

    def prefault(self, max_bytes: Optional[int] = None,
                 chunk: int = 32 << 20, duty: float = 0.25):
        """Populate up to max_bytes of the data region (kernel-side via
        MADV_POPULATE_WRITE — see shm_arena.cpp) from a background
        thread (ctypes releases the GIL).  Pacing is adaptive: after
        each chunk we sleep (1-duty)/duty × the time the chunk took, so
        population consumes at most ~duty of one core/memory lane no
        matter how slow the box is — startup work (registrations,
        heartbeats) keeps running."""
        import time as _time

        limit = min(max_bytes, self.capacity) if max_bytes is not None else self.capacity
        off = 0
        while off < limit:
            t0 = _time.monotonic()
            step = min(chunk, limit - off)
            if self._lib.arena_prefault_range(self._h, off, step) != 0:
                return  # kernel lacks MADV_POPULATE_WRITE: skip
            off += step
            took = _time.monotonic() - t0
            _time.sleep(took * (1.0 - duty) / duty)

    def close(self):
        if not self._closed:
            self._lib.arena_close(self._h)
            self._closed = True

    # -- object API ------------------------------------------------------
    def alloc(self, object_id: bytes, size: int) -> Optional[memoryview]:
        """Returns a writable view over the object's buffer, or None."""
        off = self._lib.arena_alloc(self._h, _pad_id(object_id), size)
        if off < 0:
            return None if off == -1 else None
        buf = (ctypes.c_char * size).from_address(self._base_addr + off)
        return memoryview(buf).cast("B")

    def alloc_status(self, object_id: bytes, size: int) -> Tuple[int, Optional[memoryview]]:
        """(code, view): code 0 ok, -1 no space, -2 exists."""
        off = self._lib.arena_alloc(self._h, _pad_id(object_id), size)
        if off == -1:
            return -1, None
        if off == -2:
            return -2, None
        buf = (ctypes.c_char * size).from_address(self._base_addr + off)
        return 0, memoryview(buf).cast("B")

    def seal(self, object_id: bytes) -> bool:
        return self._lib.arena_seal(self._h, _pad_id(object_id)) == 0

    def lookup(self, object_id: bytes) -> Optional[memoryview]:
        """Read-only view of a sealed object; bumps its refcount — pair
        with decref when the consumer is done (eviction skips objects
        with live refs)."""
        size = ctypes.c_uint64()
        off = self._lib.arena_lookup(self._h, _pad_id(object_id), ctypes.byref(size))
        if off < 0:
            return None
        buf = (ctypes.c_char * size.value).from_address(self._base_addr + off)
        return memoryview(buf).cast("B")

    def contains(self, object_id: bytes) -> bool:
        return self._lib.arena_contains(self._h, _pad_id(object_id)) == 1

    def decref(self, object_id: bytes):
        self._lib.arena_decref(self._h, _pad_id(object_id))

    def release_create(self, object_id: bytes):
        """Drop the creator reference held since alloc() — call once the
        object is registered with the store.  If the creator dies first,
        eviction/delete reclaims the reference automatically."""
        self._lib.arena_release_create(self._h, _pad_id(object_id))

    def delete(self, object_id: bytes) -> bool:
        return self._lib.arena_delete(self._h, _pad_id(object_id)) == 0

    def can_fit(self, need: int) -> bool:
        """A contiguous `need`-byte block is currently allocatable."""
        return self._lib.arena_can_fit(self._h, need) == 1

    def evict_lru(self, need: int, max_out: int = 256):
        """Evict until `need` bytes fit; returns list of evicted ids (padded
        32B) or None if impossible."""
        out = ctypes.create_string_buffer(max_out * ID_SIZE)
        n = self._lib.arena_evict_lru(self._h, need, out, max_out)
        if n < 0:
            return None
        return [out.raw[i * ID_SIZE:(i + 1) * ID_SIZE] for i in range(min(n, max_out))]

    def _test_lock_and_abandon(self):
        """Test-only: take the arena mutex and never release it, so the
        process can exit "inside" the critical section (EOWNERDEAD)."""
        self._lib.arena_test_lock_and_abandon(self._h)

    # -- stats -----------------------------------------------------------
    @property
    def used(self) -> int:
        return self._lib.arena_used(self._h)

    @property
    def capacity(self) -> int:
        return self._lib.arena_data_capacity(self._h)

    @property
    def num_objects(self) -> int:
        return self._lib.arena_num_objects(self._h)

    @property
    def num_evictions(self) -> int:
        return self._lib.arena_num_evictions(self._h)
