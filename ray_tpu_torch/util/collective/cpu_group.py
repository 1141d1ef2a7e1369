"""CPU collective group: TCP mesh between members, GCS-KV rendezvous.

The Gloo-class backend (reference:
python/ray/util/collective/collective_group/gloo_collective_group.py) —
each member runs a listener; addresses rendezvous through the GCS KV;
peers connect lazily.  Reductions use a ring for large arrays
(reduce-scatter + allgather) and a star through rank 0 for small ones.

Elasticity: every group carries a **generation** — a monotonically
increasing epoch baked into its rendezvous keys
(``<group>/gen<G>/<rank>``) and recorded in a per-group marker key
(``<group>/gen``).  Tearing a group down and re-forming it at a new size
is atomic under a generation bump: members of the new generation
rendezvous under fresh keys and can never cross-connect with the old
mesh, while stragglers still blocked in the old mesh surface a clean
``GroupInvalidatedError`` (instead of hanging in TCP receives that will
never complete) the moment a peer socket dies or a rendezvous poll sees
the marker advance.
"""

from __future__ import annotations

import pickle
import socket
import struct
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

_LEN = struct.Struct("<Q")
KV_NS = "collective"
RING_THRESHOLD = 1 << 20  # 1MB: below this a star is faster than a ring

REDUCE_OPS = {
    "sum": np.add,
    "product": np.multiply,
    "min": np.minimum,
    "max": np.maximum,
}


class RendezvousTimeoutError(TimeoutError):
    """Rendezvous deadline expired before every member published its
    address.  Names the ranks that never showed up so the operator can
    tell a dead member from a slow one."""

    def __init__(self, group_name: str, generation: int, missing_ranks: List[int],
                 timeout_s: float):
        self.group_name = group_name
        self.generation = generation
        self.missing_ranks = list(missing_ranks)
        self.timeout_s = timeout_s
        super().__init__(
            f"collective group '{group_name}' (generation {generation}): "
            f"rank(s) {self.missing_ranks} never joined within {timeout_s:.1f}s"
        )


class GroupInvalidatedError(RuntimeError):
    """This member belongs to a superseded generation of the group: the
    group was destroyed and re-formed (elastic resize) while this rank
    was still using the old mesh.  Re-join at the current generation."""

    def __init__(self, group_name: str, generation: int,
                 current_generation: Optional[int] = None):
        self.group_name = group_name
        self.generation = generation
        self.current_generation = current_generation
        cur = (f" (current generation is {current_generation})"
               if current_generation is not None else "")
        super().__init__(
            f"collective group '{group_name}' generation {generation} was "
            f"invalidated{cur}; re-join the group at the current generation"
        )


def _send_msg(sock: socket.socket, obj: Any):
    data = pickle.dumps(obj, protocol=5)
    sock.sendall(_LEN.pack(len(data)) + data)

def _recv_msg(sock: socket.socket) -> Any:
    hdr = _recv_exact(sock, _LEN.size)
    (length,) = _LEN.unpack(hdr)
    return pickle.loads(_recv_exact(sock, length))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        c = sock.recv(min(n, 1 << 20))
        if not c:
            raise ConnectionError("collective peer closed")
        chunks.append(c)
        n -= len(c)
    return b"".join(chunks)


class CPUCollectiveGroup:
    def __init__(self, world_size: int, rank: int, group_name: str, kv,
                 generation: int = 0, rendezvous_timeout_s: Optional[float] = None):
        self.world_size = world_size
        self.rank = rank
        self.group_name = group_name
        self.generation = generation
        self._kv = kv  # callable kv interface: put(key, val), get(key)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(world_size)
        self._addr = self._listener.getsockname()
        self._peers: Dict[int, socket.socket] = {}
        self._peer_locks: Dict[int, threading.Lock] = {}
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._accepted: Dict[int, socket.socket] = {}
        self._accept_cond = threading.Condition()
        self._closed = False
        self._invalidated = False
        self._accept_thread.start()
        self._rendezvous(rendezvous_timeout_s)

    # -- rendezvous through GCS KV ----------------------------------------
    def _key(self, rank: int) -> bytes:
        return f"{self.group_name}/gen{self.generation}/{rank}".encode()

    def _gen_key(self) -> bytes:
        return f"{self.group_name}/gen".encode()

    def current_generation(self) -> Optional[int]:
        """Latest generation recorded for this group name in the GCS KV
        (None when no marker exists — a pre-elastic group)."""
        try:
            blob = self._kv_get(self._gen_key())
        except Exception:
            return None
        if blob is None:
            return None
        try:
            return int(blob.decode())
        except (ValueError, AttributeError):
            return None

    def _rendezvous(self, timeout: Optional[float] = None):
        """Publish this rank's address and collect every peer's, under a
        deadline budget with the unified backoff policy (no fixed-interval
        polling).  Raises RendezvousTimeoutError naming ALL missing ranks,
        or GroupInvalidatedError if the group's generation marker advances
        past ours while we wait (the group was re-formed without us)."""
        from ray_tpu_torch._private import retry
        from ray_tpu_torch._private.config import CONFIG

        if timeout is None:
            timeout = float(CONFIG.collective_rendezvous_timeout_s)
        # Advance the generation marker ATOMICALLY (kv_put_max: the GCS
        # stores max(current, ours) in one handler).  A read-then-write
        # here would let a stale gen-0 joiner overwrite a concurrent
        # generation bump and regress the marker.  Every member writes it
        # so a fresh joiner can detect staleness even when the re-forming
        # coordinator died mid-bump.
        cur = self._kv("kv_put_max", (KV_NS, self._gen_key(), self.generation))
        if cur is not None and int(cur) > self.generation:
            self._closed = True
            self._listener.close()
            raise GroupInvalidatedError(self.group_name, self.generation, int(cur))
        self._kv_put(self._key(self.rank), pickle.dumps(self._addr))
        self._peer_addrs: Dict[int, Any] = {}
        missing = [r for r in range(self.world_size) if r != self.rank]
        bo = retry.RENDEZVOUS.start(deadline_s=timeout)
        while missing:
            still_missing = []
            for r in missing:
                blob = self._kv_get(self._key(r))
                if blob is not None:
                    self._peer_addrs[r] = pickle.loads(blob)
                else:
                    still_missing.append(r)
            missing = still_missing
            if not missing:
                break
            cur = self.current_generation()
            if cur is not None and cur > self.generation:
                self._closed = True
                self._listener.close()
                raise GroupInvalidatedError(self.group_name, self.generation, cur)
            delay = bo.next_delay()
            if delay is None:
                self._closed = True
                self._listener.close()
                raise RendezvousTimeoutError(
                    self.group_name, self.generation, missing, timeout
                )
            time.sleep(delay)

    def _kv_put(self, key: bytes, val: bytes):
        self._kv("kv_put", (KV_NS, key, val, True))

    def _kv_get(self, key: bytes) -> Optional[bytes]:
        return self._kv("kv_get", (KV_NS, key))

    def _check_invalidated(self, cause: BaseException):
        """A transport error inside a collective op: if the group's
        generation has moved on (elastic re-form), surface that as the
        typed invalidation instead of a raw socket error."""
        if self._invalidated:
            raise GroupInvalidatedError(
                self.group_name, self.generation, self.current_generation()
            ) from cause
        cur = self.current_generation()
        if cur is not None and cur > self.generation:
            self._invalidated = True
            raise GroupInvalidatedError(self.group_name, self.generation, cur) from cause
        raise cause

    # -- connections -------------------------------------------------------
    def _accept_loop(self):
        while not self._closed:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            peer_rank = _recv_msg(conn)
            with self._accept_cond:
                self._accepted[peer_rank] = conn
                self._accept_cond.notify_all()

    def _peer(self, rank: int) -> socket.socket:
        """Connection to a peer.  Lower rank dials; higher rank accepts —
        one deterministic connection per pair."""
        if rank in self._peers:
            return self._peers[rank]
        if self.rank < rank:
            s = socket.create_connection(self._peer_addrs[rank], timeout=30)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            _send_msg(s, self.rank)
        else:
            with self._accept_cond:
                while rank not in self._accepted:
                    if self._closed:
                        raise ConnectionError("collective group destroyed")
                    if not self._accept_cond.wait(timeout=30):
                        raise TimeoutError(f"rank {rank} never connected")
                s = self._accepted.pop(rank)
        self._peers[rank] = s
        self._peer_locks[rank] = threading.Lock()
        return s

    # -- point to point ----------------------------------------------------
    def send(self, tensor, dst_rank: int):
        try:
            s = self._peer(dst_rank)
            with self._peer_locks[dst_rank]:
                _send_msg(s, np.asarray(tensor))
        except (ConnectionError, TimeoutError, OSError) as e:
            self._check_invalidated(e)

    def recv(self, shape, dtype, src_rank: int):
        try:
            s = self._peer(src_rank)
            return _recv_msg(s)
        except (ConnectionError, TimeoutError, OSError, EOFError) as e:
            self._check_invalidated(e)

    # -- collectives -------------------------------------------------------
    def broadcast(self, tensor, src_rank: int = 0):
        arr = np.asarray(tensor)
        if self.rank == src_rank:
            for r in range(self.world_size):
                if r != self.rank:
                    self.send(arr, r)
            return arr
        return self.recv(None, None, src_rank)

    def reduce(self, tensor, dst_rank: int = 0, op: str = "sum"):
        arr = np.asarray(tensor)
        if self.rank == dst_rank:
            acc = arr.copy()
            for r in range(self.world_size):
                if r != self.rank:
                    acc = REDUCE_OPS[op](acc, self.recv(None, None, r))
            return acc
        self.send(arr, dst_rank)
        return arr

    def allreduce(self, tensor, op: str = "sum"):
        arr = np.asarray(tensor)
        if self.world_size == 1:
            return arr
        if arr.nbytes < RING_THRESHOLD:
            out = self.reduce(arr, 0, op)
            return self.broadcast(out, 0)
        return self._ring_allreduce(arr, op)

    def _ring_allreduce(self, arr: np.ndarray, op: str):
        """Bandwidth-optimal ring: reduce-scatter then allgather."""
        n = self.world_size
        flat = arr.reshape(-1).copy()
        chunks = np.array_split(flat, n)
        right = (self.rank + 1) % n
        left = (self.rank - 1) % n
        # reduce-scatter
        for step in range(n - 1):
            send_idx = (self.rank - step) % n
            recv_idx = (self.rank - step - 1) % n
            self.send(chunks[send_idx], right)
            incoming = self.recv(None, None, left)
            chunks[recv_idx] = REDUCE_OPS[op](chunks[recv_idx], incoming)
        # allgather
        for step in range(n - 1):
            send_idx = (self.rank - step + 1) % n
            recv_idx = (self.rank - step) % n
            self.send(chunks[send_idx], right)
            chunks[recv_idx] = self.recv(None, None, left)
        return np.concatenate(chunks).reshape(arr.shape)

    def allgather(self, tensor):
        arr = np.asarray(tensor)
        out: List[np.ndarray] = [None] * self.world_size  # type: ignore
        out[self.rank] = arr
        # Simple doubling-free exchange: everyone sends to everyone.
        for r in range(self.world_size):
            if r == self.rank:
                continue
            if self.rank < r:
                self.send(arr, r)
                out[r] = self.recv(None, None, r)
            else:
                out[r] = self.recv(None, None, r)
                self.send(arr, r)
        return out

    def reducescatter(self, tensor, op: str = "sum"):
        arr = np.asarray(tensor)
        reduced = self.allreduce(arr, op)
        return np.array_split(reduced.reshape(-1), self.world_size)[self.rank]

    def barrier(self):
        self.allreduce(np.zeros(1, np.float32))

    def destroy(self):
        # Rendezvous-key cleanup is NOT done here: reaping superseded
        # generations belongs to invalidate_collective_group (the
        # generation bump), which can enumerate them via kv_keys.
        self._closed = True
        try:
            self._listener.close()
        except OSError:
            pass
        with self._accept_cond:
            for s in self._accepted.values():
                try:
                    s.close()
                except OSError:
                    pass
            self._accepted.clear()
            self._accept_cond.notify_all()
        for s in self._peers.values():
            try:
                s.close()
            except OSError:
                pass
