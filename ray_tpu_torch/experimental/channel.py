"""Channels for compiled DAGs: same-host shm ring buffers + cross-host sockets.

Reference: src/ray/core_worker/experimental_mutable_object_manager.h:48
and python/ray/experimental/channel/shared_memory_channel.py — a
fixed-size buffer written in place per message instead of allocating a
new object in the store per message.

``Channel`` is a single-writer / single-reader, same-host ring buffer
over an mmap'd file:

    [wbytes u64][rbytes u64][closed u64][pad..64][ring payload ...]

Records are ``[u64 len][payload][u32 crc32][pad to 8]`` appended at
``wbytes % capacity``; a len of 2**64-2 is a wrap marker (the rest of
the region is skipped), and the writer publishes ``wbytes`` only after
the payload AND its CRC trailer are in place.  ``rbytes`` advancing IS
the consume-ack: free space is ``capacity - (wbytes - rbytes)``, so the
writer blocks only when the ring is genuinely full — multiple messages
ride in flight per edge (pipelined compiled executions).  ``closed`` is
a drain-then-close flag: readers see ChannelClosed only after consuming
the backlog; blocked writers see it immediately.

Frame integrity: every record carries a CRC32 trailer validated on
read.  A mismatch (bit rot, a torn write from a SIGKILLed writer, a
chaos ``corrupt_frame``/``torn_write`` injection) consumes the garbage
record and raises the typed ``ChannelCorruptionError`` — a corrupted
frame is NEVER delivered as data.  An implausible record length (torn
header) raises the same error without advancing (the ring framing is
unrecoverable from that position; the consumer's heavy recovery path
owns it).

``SocketChannel`` carries the same write/read/pending contract over one
long-lived TCP connection for compiled edges whose endpoints live on
different nodes: framed messages one way (``[u64 len][u64 seq][payload]
[u32 crc]``), consume-acks the other, a bounded unacked window as flow
control.  Channels carry an **epoch**: after a connection-level death
the writer may re-dial its reader's still-open listener with the
listener's pairing token at a bumped epoch, and frames the reader never
received are replayed from the writer's bounded unacked-frame buffer
(seq-resume; duplicates are dropped by seq).  ``reattach(chan)`` is the
one shared recovery helper the DAG / serve / stream attach paths call
on ``ChannelClosed`` before falling back to their heavy per-consumer
recovery.

Chaos: when the fault plane (``_private/chaos.py``) is active, every
write consults ``chan:<path-glob>:<action>`` rules — ``drop_frame``,
``delay_frame``, ``corrupt_frame``, ``torn_write``, ``close`` — so the
layer that carries all dataplane traffic is drillable with the same
seeded, replayable schedule as the RPC plane.

Orphan reclamation: every endpoint opened under a managed ring
directory registers its PID in ``<dir>/.pids``;
``sweep_orphan_ring_dirs()`` (run by the raylet) reclaims directories
whose registered owners are ALL dead — the tmpfs leak after SIGKILL.
"""

from __future__ import annotations

import mmap
import os
import struct
import time
import zlib
from typing import Any, List, Optional, Sequence, Tuple

_U64 = struct.Struct("<Q")
_U32C = struct.Struct("<I")
HEADER = 64
POISON = (1 << 64) - 1  # socket framing: orderly close
WRAP = (1 << 64) - 2  # ring: rest of region is skipped
_WOFF, _ROFF, _COFF = 0, 8, 16


def _align8(n: int) -> int:
    return (n + 7) & ~7


def _u64_view(mm, nbytes: int):
    """Aligned u64 accessor over the mmap's first ``nbytes`` bytes.

    Shared header fields (write/read offsets, cursors, closed flag) are
    mutated by one process while the peer polls them.  struct's "<Q"
    pack/unpack loops BYTE-WISE, so a peer that preempts the writer
    mid-store observes a torn offset — seen in practice as phantom
    zero-length records on contended single-core hosts (the reader
    passes the occupancy check on the torn value, then reads a length
    word the writer hasn't stored yet).  A cast-memoryview item access
    is one aligned 8-byte load/store, which x86-64 keeps atomic."""
    return memoryview(mm)[:nbytes].cast("Q")


class ChannelClosed(Exception):
    """The peer closed the channel (drained) or died (socket EOF)."""


class ChannelTimeout(Exception):
    """The peer is alive but didn't produce/consume within the timeout."""


class ChannelCapacityError(ValueError):
    """Payload exceeds the channel's fixed capacity (typed, never a hang)."""


class ChannelConnectionError(ConnectionError):
    """A socket channel could not (re)connect: the endpoint is dead,
    or a reconnect handshake was refused (bad pairing token / stale
    epoch)."""


class ChannelCorruptionError(Exception):
    """A frame failed integrity validation (CRC32 trailer mismatch,
    torn record, undecodable payload).  The garbage is consumed where
    the framing allows it and NEVER delivered as data.

    ``advanced`` tells the consumer whether the read cursor moved past
    the garbage: True (the default) means the next read returns the
    next frame, so skip-and-continue is safe; False (torn/implausible
    record LENGTH — the framing itself is broken) means a retry re-reads
    the same garbage forever, so the consumer must run its heavy
    recovery instead of retrying."""

    advanced = True


class _DefaultTimeout:
    def __repr__(self):  # shows up in signatures/help
        return "<channel_default_timeout_s>"


#: Sentinel default for every channel read/write timeout: resolved at
#: call time from CONFIG.channel_default_timeout_s (one knob, so drills
#: can tighten every edge uniformly).  Pass None to block forever.
DEFAULT_TIMEOUT = _DefaultTimeout()


# ((env string, override value), resolved float) — CONFIG.get does a
# live os.environ read per access (~1.6 us), far too hot for a per-frame
# path; keying the cache on the raw env value AND the system_config
# override keeps the knob live through both routes (tests flip the env
# between ops; init(system_config=...) may land after early channel
# ops) at dict-lookup cost.  Only consulted when an op actually blocks.
_timeout_cache: Tuple[Any, Optional[float]] = (None, None)

_wire = None  # lazy module ref: the per-frame paths skip the import dance


def _wire_mod():
    global _wire
    if _wire is None:
        from ray_tpu_torch._private import wire

        _wire = wire
    return _wire


_tracing = None  # lazy module ref (same pattern as _wire)


def _tracing_mod():
    global _tracing
    if _tracing is None:
        from ray_tpu_torch.util import tracing

        _tracing = tracing
    return _tracing


def _trace_begin():
    """Per-frame write-side trace state: ``None`` when the writing
    context is untraced (ONE contextvar read — the untraced hot path
    pays nothing else), otherwise a mutable ``[trace_id, write_span_id,
    caller_span_id, t_entry]``.  One state per (frame, target) so every
    channel edge gets its own write span and blocked retries of the
    same frame never mint new span ids."""
    tr = _tracing_mod()
    ctx = tr.current_context()
    if ctx is None:
        return None
    return [ctx[0], tr.new_span_id(), ctx[1], time.time()]


def _trace_trailer(ts):
    """Wire trailer for one publish attempt.  write_ts is re-stamped per
    attempt so the committed frame carries ~commit time, making the
    reader's queue-wait attribution blocked-writer-proof."""
    return (ts[0], ts[1], 0, time.time())


def _trace_commit_write(ts, kind: str, path: str) -> None:
    """Record the frame's ``channel.write`` span (entry → commit) at the
    pre-minted write span id, parented under the caller's span."""
    _tracing_mod().record_span(
        "channel.write",
        ts[3],
        time.time(),
        {"kind": kind, "path": path},
        context=(ts[0], ts[1], ts[2]),
    )


def _trace_read(tr_tuple, kind: str, path: str):
    """Record the read-side hop span for a traced frame and return the
    frame context ``(trace_id, read_span_id, write_span_id)`` consumers
    adopt via ``tracing.set_frame_context``.  The span covers
    write-commit → read-return, so its duration IS the edge's queue
    wait (same-host clocks for rings; sockets carry the writer's stamp,
    close enough for attribution)."""
    trm = _tracing_mod()
    tid, wsid, _flags, wts = tr_tuple
    rsid = trm.new_span_id()
    end = time.time()
    start = wts if 0 < wts <= end else end
    trm.record_span(
        "channel.read",
        start,
        end,
        {"kind": kind, "path": path, "queue_wait_s": max(0.0, end - start)},
        context=(tid, rsid, wsid),
    )
    return (tid, rsid, wsid)


def _trace_reattach(path: str, ok: bool, epoch: int) -> None:
    """A reattach is an ANNOTATED event on the live trace (child span
    when a context is active, standalone event span otherwise) — never a
    break in the tree."""
    try:
        trm = _tracing_mod()
        now = time.time()
        attrs = {"path": path, "result": "ok" if ok else "failed",
                 "epoch": epoch}
        ctx = trm.current_context()
        if ctx is not None:
            trm.record_span(
                "channel.reattach", now, now, attrs,
                context=(ctx[0], trm.new_span_id(), ctx[1]),
            )
        else:
            trm.record_event_span("channel.reattach", now, now, attrs)
    except Exception:
        pass


def _resolve_timeout(timeout) -> Optional[float]:
    if timeout is not DEFAULT_TIMEOUT:
        return timeout
    global _timeout_cache
    from ray_tpu_torch._private.config import CONFIG

    key = (
        os.environ.get("RAY_TPU_TORCH_channel_default_timeout_s"),
        CONFIG._overrides.get("channel_default_timeout_s"),
    )
    cached_key, val = _timeout_cache
    if key == cached_key and val is not None:
        return val
    val = float(CONFIG.channel_default_timeout_s)
    _timeout_cache = (key, val)
    return val


# (plane, plane.rev at last check, active at last check): the no-chaos
# fast path is one int compare per frame instead of the plane's
# monotonic-throttled revalidation.  CHAOS.reset() bumps rev, so tests
# that flip the spec in-process are picked up on the very next frame;
# worker processes get their spec from the env at spawn (first check).
_chaos_cache = (None, -1, False)

#: "not decided yet" sentinel for try_write_value's ``cd`` parameter —
#: distinct from None, which means "decided: clean".
_CHAOS_UNDECIDED = object()


def _mutate_payload(mm, base: int, n: int, crc: int, cd) -> int:
    """Post-CRC payload mutation for corrupt_frame / torn_write, shared
    by the ring and fan-out writers (ONE fault model, not per-transport
    copies).  Both actions guarantee a CRC mismatch on read: corrupt
    flips a payload byte after the trailer was computed; torn models a
    writer killed mid-record (latter half never written, trailer
    stale).  The socket writer models torn differently by design — a
    mid-frame connection cut (see SocketChannel._write_payload).
    ``base`` is the absolute offset of the payload's first byte."""
    if cd.corrupt:
        if n > 0:
            mm[base] ^= 0xFF
        else:
            crc ^= 0xFFFFFFFF
    if cd.torn:
        half = n // 2
        if n - half > 0:
            mm[base + half : base + n] = b"\x00" * (n - half)
        crc ^= 0xA5A5A5A5
    return crc & 0xFFFFFFFF


def _chaos_decide(path: str):
    """Per-frame fault verdict (None on the no-chaos fast path)."""
    global _chaos_cache
    c, rev, active = _chaos_cache
    if c is None:
        from ray_tpu_torch._private.chaos import CHAOS as c0

        c = c0
        rev = -1
    if rev != c.rev:
        # full (throttled) spec revalidation; an RPC-only spec leaves
        # the dataplane fast path untouched
        active = c.active and c.has_channel_rules
        _chaos_cache = (c, c.rev, active)
    if not active:
        return None
    d = c.decide_channel(path)
    return None if d.clean else d


def _chaos_net_decide(peer_addr):
    """Directional link verdict for one socket-channel dial or frame
    toward ``peer_addr`` (None on the no-net-chaos fast path).  The dst
    identity is ``addr:<host>:<port>`` — an RPC-plane partition
    (``net:raylet*->gcs:cut``) leaves the compiled dataplane connected
    unless a rule targets the channel address explicitly
    (``net:node1->addr:*:cut``)."""
    if peer_addr is None:
        return None
    from ray_tpu_torch._private.chaos import CHAOS, net_name

    if not (CHAOS.active and CHAOS.has_net_rules):
        return None
    d = CHAOS.decide_net(net_name(), f"addr:{peer_addr[0]}:{peer_addr[1]}")
    return None if d.clean else d


def _count_corruption() -> None:
    try:
        from ray_tpu_torch._private import telemetry

        telemetry.count_channel_corruption()
    except Exception:
        pass


def _count_reattach(ok: bool) -> None:
    try:
        from ray_tpu_torch._private import telemetry

        telemetry.count_channel_reattach("ok" if ok else "failed")
    except Exception:
        pass


def _register_shm_pid(path: str) -> None:
    """Record this process as an owner of the ring directory holding
    ``path`` (sweep registry; see sweep_orphan_ring_dirs).  Only
    sweep-managed dirs (ray_tpu_torch_* directly under ring_base_dir) are
    registered — test channels in tmp dirs are untouched."""
    d = os.path.dirname(path)
    if not os.path.basename(d).startswith("ray_tpu_torch_"):
        return
    if os.path.dirname(d) != ring_base_dir():
        return
    try:
        with open(os.path.join(d, ".pids"), "a") as f:
            f.write(f"{os.getpid()}\n")
    except OSError:
        pass


_SMALL_HOST = (os.cpu_count() or 1) <= 2


def _poll_wait(spins: int) -> None:
    """One blocked-poll backoff step (spins counts from 0 per block).

    Big hosts: sched_yield for ~4k spins, then ramp sleeps 20us -> 1ms
    so a long-idle resident loop doesn't pin a core (the reference's
    channels busy-wait the same way).

    Small (1-2 core) hosts: the peer needs THIS core, and sched_yield
    may return without descheduling the caller (EEVDF keeps an eligible
    task running), so a yield phase can starve the peer for the whole
    quantum.  Go straight to tiny timer sleeps — a sleep always cedes
    the core, waking in ~0.1ms — then ramp to 1ms the same way.
    """
    if _SMALL_HOST:
        if spins < 256:
            time.sleep(0.000001)
        else:
            time.sleep(min(0.001, 0.00002 * (spins - 255)))
    elif spins < 4000:
        time.sleep(0)
    else:
        time.sleep(min(0.001, 0.00002 * (spins - 3999)))


def _pid_alive(pid: int) -> bool:
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True  # EPERM etc: it exists
    return True


class Channel:
    kind = "ring"

    @staticmethod
    def create_file(path: str, max_size: int = 8 * 1024 * 1024) -> None:
        """Allocate a channel's backing file without opening an endpoint
        (the single place that knows the on-disk layout)."""
        with open(path, "wb") as f:
            f.truncate(HEADER + max_size)

    def __init__(self, path: str, max_size: int = 8 * 1024 * 1024, create: bool = False):
        self.path = path
        if create:
            with open(path, "wb") as f:
                f.truncate(HEADER + max_size)
        # Open by both sides; size from the file (reader may not know).
        self._f = open(path, "r+b")
        size = os.fstat(self._f.fileno()).st_size
        cap = size - HEADER
        self.capacity = cap - (cap % 8)
        # Largest single payload (header + aligned payload + CRC) the
        # ring can carry: one wrap marker must always fit beside it.
        self.max_size = self.capacity - 24
        self._mm = mmap.mmap(self._f.fileno(), size)
        self._hdr = _u64_view(self._mm, HEADER)
        _register_shm_pid(path)
        # Dataplane counters (item-2 hot path must land measurable):
        # plain dict increments on the fast path (~100 ns), folded into
        # telemetry in batches of _TELE_FLUSH_OPS so per-op cost stays
        # far inside the <5% budget at channel rates.
        self.stats = {
            "writes": 0,
            "reads": 0,
            "bytes_written": 0,
            "bytes_read": 0,
            "write_blocked_s": 0.0,
            "read_blocked_s": 0.0,
            "write_timeouts": 0,
            "read_timeouts": 0,
            "corruptions": 0,
        }
        self._tele_ops = 0
        self._tele_flushed = dict(self.stats)

    # -- raw fields (single atomic 8-byte access; see _u64_view) --------
    def _get(self, off: int) -> int:
        return self._hdr[off >> 3]

    def _set(self, off: int, v: int) -> None:
        self._hdr[off >> 3] = v

    # Hot-spinning only helps when the peer can run on another core;
    # on a 1-2 core host it starves the peer for a whole scheduler
    # quantum (~1 ms RTT).  sched_yield-first is ~10x faster there and
    # within noise on big hosts.
    _HOT_SPINS = 1500 if (os.cpu_count() or 1) > 2 else 0

    def _backoff(self, spins: int) -> None:
        """Latency-first wait: (multicore only) hot-spin ~0.1ms, then
        the host-size-aware poll wait (see _poll_wait)."""
        if spins < self._HOT_SPINS:
            return
        _poll_wait(spins - self._HOT_SPINS)

    _TELE_FLUSH_OPS = 512

    def _tele_flush(self) -> None:
        """Push counter deltas since the last flush to telemetry (one
        batched inc per series); called every _TELE_FLUSH_OPS ops, on
        timeout, and on close."""
        from ray_tpu_torch._private import telemetry

        s, last = self.stats, self._tele_flushed
        telemetry.count_channel_ops("write", s["writes"] - last["writes"])
        telemetry.count_channel_ops("read", s["reads"] - last["reads"])
        telemetry.add_channel_blocked(
            "write", s["write_blocked_s"] - last["write_blocked_s"], self.kind
        )
        telemetry.add_channel_blocked(
            "read", s["read_blocked_s"] - last["read_blocked_s"], self.kind
        )
        telemetry.count_channel_timeout(
            "write", s["write_timeouts"] - last["write_timeouts"]
        )
        telemetry.count_channel_timeout(
            "read", s["read_timeouts"] - last["read_timeouts"]
        )
        self._tele_flushed = dict(s)
        self._tele_ops = 0

    def pending(self) -> bool:
        """Occupancy: published bytes the reader hasn't consumed yet."""
        try:
            return self._get(_WOFF) != self._get(_ROFF)
        except ValueError:
            return False  # mmap closed

    def _closed_flag(self) -> bool:
        try:
            return self._get(_COFF) != 0
        except ValueError:
            return True

    # -- writer ---------------------------------------------------------
    def _count_write(self, nbytes: int) -> None:
        s = self.stats
        s["writes"] += 1
        s["bytes_written"] += nbytes
        self._tele_ops += 1
        if self._tele_ops >= self._TELE_FLUSH_OPS:
            self._tele_flush()

    def _record_corruption(self) -> None:
        self.stats["corruptions"] += 1
        _count_corruption()

    def _write_wait(self, spins: int, t_block: float, deadline: Optional[float]) -> float:
        """One blocked-writer backoff step (shared by write paths)."""
        if self._closed_flag():
            self.stats["write_blocked_s"] += time.monotonic() - t_block if spins else 0.0
            raise ChannelClosed(self.path)
        self._backoff(spins)
        if (
            deadline is not None
            and (spins >= 2000 or spins % 512 == 0)
            and time.monotonic() > deadline
        ):
            self.stats["write_timeouts"] += 1
            self.stats["write_blocked_s"] += time.monotonic() - t_block
            self._tele_flush()
            raise ChannelTimeout(
                f"reader of {self.path} did not free ring space in time"
            )
        return t_block

    def _wrap(self, wb: int, tail: int) -> int:
        """Write a wrap marker (when it fits) and skip the tail region.
        Caller has verified the tail is free."""
        wpos = wb % self.capacity
        if tail >= 8:
            _U64.pack_into(self._mm, HEADER + wpos, WRAP)
        wb += tail
        self._set(_WOFF, wb)
        return wb

    def _apply_write_chaos(self, cd, nbytes: int):
        """Pre-publish actions of one frame's fault verdict.  Returns
        True when the frame must be silently dropped; raises for close.
        corrupt/torn mutate at publish time (the caller passes cd down)."""
        if cd.delay_s > 0:
            time.sleep(cd.delay_s)
        if cd.close:
            self.close()
            raise ChannelClosed(f"{self.path}: chaos close")
        if cd.drop:
            self._count_write(nbytes)
            return True
        return False

    def _chaos_mutate(self, cd, wpos: int, n: int, crc: int) -> int:
        return _mutate_payload(self._mm, HEADER + wpos + 8, n, crc, cd)

    def write(self, data: bytes, timeout=DEFAULT_TIMEOUT) -> None:
        cd = _chaos_decide(self.path)
        if cd is not None and self._apply_write_chaos(cd, len(data)):
            return
        need = 8 + _align8(len(data) + 4)
        if need > self.max_size:
            raise ChannelCapacityError(
                f"message of {len(data)} bytes exceeds channel capacity "
                f"{self.max_size}; raise the buffer size at compile time"
            )
        deadline = None  # resolved at first block: the happy path never
        spins = 0        # pays the timeout-knob lookup
        t_block = 0.0
        cap = self.capacity
        while True:
            wb = self._get(_WOFF)
            free = cap - (wb - self._get(_ROFF))
            tail = cap - (wb % cap)
            if tail < need:
                # Wrap once the tail region is free, then retry.
                if free >= tail:
                    self._wrap(wb, tail)
                    continue
            elif free >= need:
                break
            if spins == 0:
                t_block = time.monotonic()
                timeout = _resolve_timeout(timeout)
                deadline = None if timeout is None else t_block + timeout
            spins += 1
            self._write_wait(spins, t_block, deadline)
        wpos = wb % cap
        self._mm[HEADER + wpos + 8 : HEADER + wpos + 8 + len(data)] = data
        crc = zlib.crc32(data)
        if cd is not None:
            crc = self._chaos_mutate(cd, wpos, len(data), crc)
        _U32C.pack_into(self._mm, HEADER + wpos + 8 + len(data), crc)
        _U64.pack_into(self._mm, HEADER + wpos, len(data))
        self._set(_WOFF, wb + need)
        if spins:
            self.stats["write_blocked_s"] += time.monotonic() - t_block
        self._count_write(len(data))

    def _try_publish_value(self, value: Any, tag: int, cd=None,
                           trace=None) -> Tuple[bool, bool]:
        """One encode attempt at the current write position.  Returns
        (published, blocked_on_reader): encoding straight into the ring
        means the payload size is unknown up front, so an overflow is
        disambiguated by WHAT bounded the window — the region tail
        (fixable by wrapping), the reader's position (fixable by
        waiting), or the whole ring (typed capacity error)."""
        wire = _wire_mod()
        cap = self.capacity
        wb = self._get(_WOFF)
        free = cap - (wb - self._get(_ROFF))
        wpos = wb % cap
        tail = cap - wpos
        window = min(tail, free)
        if window >= 16:
            try:
                n = wire.encode_into(
                    memoryview(self._mm)[
                        HEADER + wpos + 8 : HEADER + wpos + window - 4
                    ],
                    value,
                    tag,
                    trace,
                )
            except (struct.error, ValueError, IndexError):
                n = -1
            if n >= 0 and 8 + _align8(n + 4) <= window:
                crc = zlib.crc32(
                    memoryview(self._mm)[HEADER + wpos + 8 : HEADER + wpos + 8 + n]
                )
                if cd is not None:
                    crc = self._chaos_mutate(cd, wpos, n, crc)
                _U32C.pack_into(self._mm, HEADER + wpos + 8 + n, crc)
                _U64.pack_into(self._mm, HEADER + wpos, n)
                self._set(_WOFF, wb + 8 + _align8(n + 4))
                self._count_write(n)
                return True, False
        if window >= tail:
            # Tail-bounded: wrap (the tail is fully free) and retry.
            if tail >= cap - 16:
                # Full, empty ring couldn't hold it: genuinely too big.
                raise ChannelCapacityError(
                    f"value exceeds ring capacity {self.max_size} of "
                    f"{self.path}; raise the buffer size at compile time"
                )
            self._wrap(wb, tail)
            return False, False
        return False, True  # reader-bounded: wait for consumption

    def write_value(self, value: Any, tag: int = 0, timeout=DEFAULT_TIMEOUT) -> None:
        """Fast-path write: wire-encode ``value`` directly into the ring.

        A reader-bounded attempt partially ENCODES into the free window
        before discovering it doesn't fit, so the blocked loop must not
        re-attempt until the reader has actually consumed something — a
        parked writer of a large payload would otherwise burn a core
        re-encoding the same prefix every backoff wakeup (the podracer
        profile found runners spending >90% of parked CPU there)."""
        cd = _chaos_decide(self.path)
        if cd is not None and self._apply_write_chaos(cd, 0):
            return
        ts = _trace_begin()
        deadline = None  # resolved at first block (see write())
        spins = 0
        t_block = 0.0
        blocked_at_rb = None  # _ROFF snapshot taken BEFORE the blocked attempt
        while True:
            rb_before = self._get(_ROFF)
            if blocked_at_rb is not None:
                if rb_before == blocked_at_rb:
                    spins += 1
                    self._write_wait(spins, t_block, deadline)
                    continue
                blocked_at_rb = None
            published, blocked = self._try_publish_value(
                value, tag, cd, None if ts is None else _trace_trailer(ts)
            )
            if published:
                if spins:
                    self.stats["write_blocked_s"] += time.monotonic() - t_block
                if ts is not None:
                    _trace_commit_write(ts, self.kind, self.path)
                return
            if blocked:
                if spins == 0:
                    t_block = time.monotonic()
                    timeout = _resolve_timeout(timeout)
                    deadline = None if timeout is None else t_block + timeout
                # The pre-attempt snapshot is the race-safe anchor: a
                # reader advance DURING the attempt leaves _ROFF !=
                # rb_before, so the gate above retries immediately
                # instead of waiting on a ring the reader has already
                # drained (which would never advance again).
                blocked_at_rb = rb_before
                spins += 1
                self._write_wait(spins, t_block, deadline)

    def try_write_value(self, value: Any, tag: int = 0,
                        cd=_CHAOS_UNDECIDED, trace_state=None) -> bool:
        """Non-blocking write attempt (fan-out scheduling): False when
        the ring lacks free space right now.

        ``cd`` lets a fan-out scheduler pre-decide this frame's chaos
        verdict ONCE (pre-actions already applied) so blocked retries of
        the same frame don't consume extra rule match-ordinals — the
        seeded schedule must be deterministic per FRAME, not per retry
        (retry counts are timing-dependent).  ``trace_state`` is the
        frame's pre-minted _trace_begin state for the same reason: one
        write span per (frame, edge) no matter how many retries."""
        if self._closed_flag():
            raise ChannelClosed(self.path)
        if cd is _CHAOS_UNDECIDED:
            cd = _chaos_decide(self.path)
            if cd is not None and self._apply_write_chaos(cd, 0):
                return True
        if trace_state is None:
            trace_state = _trace_begin()
        while True:
            published, blocked = self._try_publish_value(
                value, tag, cd,
                None if trace_state is None else _trace_trailer(trace_state),
            )
            if published:
                if trace_state is not None:
                    _trace_commit_write(trace_state, self.kind, self.path)
                return True
            if blocked:
                return False
            # wrapped: retry immediately at the region start

    def close(self) -> None:
        """Drain-then-close: the reader sees ChannelClosed after
        consuming the backlog; blocked writers see it immediately.
        Either side may close (teardown path)."""
        try:
            self._tele_flush()
        except Exception:
            pass
        try:
            self._set(_COFF, 1)
        except ValueError:
            pass  # mmap already closed
        try:
            self._hdr.release()
        except Exception:
            pass
        try:
            self._mm.close()
            self._f.close()
        except Exception:
            pass

    # -- reader ---------------------------------------------------------
    def _read_slot(self) -> Optional[Tuple[int, int]]:
        """(rpos, len) of the next record, advancing past wrap markers;
        None when the ring is empty.  An implausible record length (the
        torn-header signature of a writer killed mid-publish, or shm
        corruption) raises the typed corruption error WITHOUT advancing:
        the framing is unrecoverable from this position and the
        consumer's heavy recovery owns the edge."""
        cap = self.capacity
        while True:
            rb = self._get(_ROFF)
            if self._get(_WOFF) == rb:
                return None
            rpos = rb % cap
            tail = cap - rpos
            if tail < 8:
                self._set(_ROFF, rb + tail)
                continue
            n = _U64.unpack_from(self._mm, HEADER + rpos)[0]
            if n == WRAP:
                self._set(_ROFF, rb + tail)
                continue
            if n > self.max_size or 8 + _align8(n + 4) > tail:
                self._record_corruption()
                err = ChannelCorruptionError(
                    f"{self.path}: torn/garbage record length {n} at "
                    f"offset {rpos}"
                )
                err.advanced = False  # framing broken: no way past it
                raise err
            return rpos, n

    def _consume(self, rpos: int, n: int, blocked_since: float) -> None:
        self._set(_ROFF, self._get(_ROFF) + 8 + _align8(n + 4))
        s = self.stats
        s["reads"] += 1
        s["bytes_read"] += n
        if blocked_since:
            s["read_blocked_s"] += time.monotonic() - blocked_since
        self._tele_ops += 1
        if self._tele_ops >= self._TELE_FLUSH_OPS:
            self._tele_flush()

    def _read_wait(self, spins: int, t_block: float, deadline: Optional[float], timeout) -> None:
        if self._closed_flag():
            raise ChannelClosed(self.path)
        self._backoff(spins)
        if (
            deadline is not None
            and (spins >= 2000 or spins % 512 == 0)
            and time.monotonic() > deadline
        ):
            self.stats["read_timeouts"] += 1
            self.stats["read_blocked_s"] += time.monotonic() - t_block
            self._tele_flush()
            raise ChannelTimeout(f"no message on {self.path} within {timeout}s")

    def read(self, timeout=DEFAULT_TIMEOUT) -> bytes:
        deadline = None  # resolved at first block (see write())
        spins = 0
        t_block = 0.0
        while True:
            slot = self._read_slot()
            if slot is not None:
                rpos, n = slot
                blocked = t_block if spins else 0.0
                data = bytes(self._mm[HEADER + rpos + 8 : HEADER + rpos + 8 + n])
                stored = _U32C.unpack_from(self._mm, HEADER + rpos + 8 + n)[0]
                if zlib.crc32(data) != stored:
                    self._consume(rpos, n, blocked)
                    self._record_corruption()
                    raise ChannelCorruptionError(
                        f"{self.path}: CRC mismatch on {n}-byte record"
                    )
                self._consume(rpos, n, blocked)
                return data
            if spins == 0:
                t_block = time.monotonic()
                timeout = _resolve_timeout(timeout)
                deadline = None if timeout is None else t_block + timeout
            spins += 1
            self._read_wait(spins, t_block, deadline, timeout)

    def read_value(self, timeout=DEFAULT_TIMEOUT) -> Tuple[int, Any]:
        """Fast-path read: wire-decode straight from the ring; returns
        ``(tag, value)``.  Array payloads are copied out before the
        consume-ack (the writer reuses the region afterwards)."""
        return self.read_value_traced(timeout)[:2]

    def read_value_traced(self, timeout=DEFAULT_TIMEOUT) -> Tuple[int, Any, Any]:
        """``read_value`` plus the frame's trace context: ``(tag, value,
        tctx)`` where tctx is ``None`` for untraced frames or
        ``(trace_id, read_span_id, write_span_id)`` — the tuple a
        consumer hands to ``tracing.set_frame_context`` to re-parent its
        own spans under this hop."""
        wire = _wire_mod()
        deadline = None  # resolved at first block (see write())
        spins = 0
        t_block = 0.0
        while True:
            slot = self._read_slot()
            if slot is not None:
                rpos, n = slot
                blocked = t_block if spins else 0.0
                # ONE payload view serves both the CRC check and decode
                mv = memoryview(self._mm)[HEADER + rpos + 8 : HEADER + rpos + 8 + n]
                stored = _U32C.unpack_from(self._mm, HEADER + rpos + 8 + n)[0]
                if zlib.crc32(mv) != stored:
                    self._consume(rpos, n, blocked)
                    self._record_corruption()
                    raise ChannelCorruptionError(
                        f"{self.path}: CRC mismatch on {n}-byte record"
                    )
                try:
                    tag, value, tr = wire.decode_traced(mv, copy_arrays=True)
                except wire.WireFormatError as e:
                    self._consume(rpos, n, blocked)
                    self._record_corruption()
                    raise ChannelCorruptionError(
                        f"{self.path}: undecodable record ({e})"
                    ) from e
                self._consume(rpos, n, blocked)
                tctx = None if tr is None else _trace_read(tr, self.kind, self.path)
                return tag, value, tctx
            if spins == 0:
                t_block = time.monotonic()
                timeout = _resolve_timeout(timeout)
                deadline = None if timeout is None else t_block + timeout
            spins += 1
            self._read_wait(spins, t_block, deadline, timeout)

    def unlink(self) -> None:
        try:
            os.unlink(self.path)
        except OSError:
            pass


# ---------------------------------------------------------------------------
# Cross-host socket channels


_FRAME = struct.Struct("<Q")
_FRAME_HDR = struct.Struct("<QQ")  # payload len, seq
_ACK = b"\x01"
_MAGIC = b"RTPUCHN2"
_HELLO = struct.Struct("<8sQ16sQ")  # magic, epoch, token, writer sent_seq
_REPLY = struct.Struct("<8sQ16sQQ")  # magic, epoch, token, rx_seq, consumed


def _recv_exact_sock(sock, n: int) -> Optional[bytes]:
    """None on EOF; honors the socket's current timeout."""
    chunks = []
    while n:
        chunk = sock.recv(n)
        if not chunk:
            return None
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks) if len(chunks) != 1 else chunks[0]


class SocketListener:
    """One listening endpoint for one compiled edge.  The first accept
    pairs the edge (single-writer/single-reader contract); the listening
    socket then STAYS open so the paired writer can reattach after a
    connection-level failure by presenting the pairing token at a
    bumped epoch.  Unauthenticated or stale-epoch reconnects are
    rejected at the handshake and never reach the consumer."""

    def __init__(self):
        import socket as _socket

        self._sock = _socket.socket(_socket.AF_INET, _socket.SOCK_STREAM)
        self._sock.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEADDR, 1)
        self._sock.bind(("0.0.0.0", 0))
        self._sock.listen(4)
        self.port = self._sock.getsockname()[1]
        self.token = os.urandom(16)
        self.epoch = 0
        self._paired = False

    def accept(self, role: str, timeout: Optional[float] = 30.0) -> "SocketChannel":
        conn, epoch = self._accept_conn(timeout, rx_seq=0, consumed=0)
        return SocketChannel(conn, role, listener=self, epoch=epoch)

    def _accept_conn(self, timeout: Optional[float], rx_seq: int, consumed: int):
        """Accept + handshake one connection.  First pairing accepts
        epoch >= 1 from anyone; later connections must present this
        listener's token at an epoch strictly above the current one
        (the authenticated-reattach contract).  Rejected dials are
        closed and the accept loop continues until the deadline."""
        import socket as _socket

        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise ChannelTimeout(
                        f"no peer dialed listener :{self.port} within {timeout}s"
                    )
            self._sock.settimeout(remaining)
            try:
                conn, _peer = self._sock.accept()
            except _socket.timeout:
                raise ChannelTimeout(
                    f"no peer dialed listener :{self.port} within {timeout}s"
                ) from None
            except OSError:
                raise ChannelClosed(f"listener :{self.port} closed") from None
            try:
                # The handshake recv must not outlive the accept window:
                # an idle queued dial (stray scanner, rogue dial) sitting
                # first in the backlog would otherwise eat the whole
                # reattach budget before the authentic peer is examined.
                if deadline is not None:
                    conn.settimeout(
                        max(0.05, min(5.0, deadline - time.monotonic()))
                    )
                else:
                    conn.settimeout(5.0)
                hello = _recv_exact_sock(conn, _HELLO.size)
                if hello is None:
                    raise OSError("EOF during channel handshake")
                magic, epoch, token, _sent_seq = _HELLO.unpack(hello)
                ok = magic == _MAGIC and (
                    (not self._paired and epoch >= 1)
                    or (self._paired and token == self.token and epoch > self.epoch)
                )
                if not ok:
                    conn.close()
                    continue
                conn.sendall(_REPLY.pack(_MAGIC, epoch, self.token, rx_seq, consumed))
                conn.settimeout(None)
                conn.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
                self._paired = True
                self.epoch = int(epoch)
                return conn, int(epoch)
            except OSError:
                try:
                    conn.close()
                except OSError:
                    pass
                continue

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def dial(addr: Tuple[str, int], role: str, timeout: float = 15.0) -> "SocketChannel":
    """Connect to a bound listener; retries transient refusals on the
    unified CONNECT policy until ``timeout`` (listener startup races),
    then raises the typed ``ChannelConnectionError``.

    The pairing handshake is deliberately asynchronous: the hello frame
    is sent here, but the listener's reply is absorbed later from the
    ack stream — a graph with mutual socket edges would deadlock if
    every dial blocked on its reader reaching accept()."""
    import socket as _socket

    from ray_tpu_torch._private import retry, telemetry

    assert role == "write", "channel listeners are reader-side by contract"
    bo = retry.CONNECT.start(deadline_s=timeout)
    last: Optional[Exception] = None
    while True:
        nd = _chaos_net_decide(tuple(addr))
        if nd is not None:
            if nd.delay_s > 0:
                time.sleep(nd.delay_s)
            if nd.drop:
                # A cut link refuses dials exactly like a dead listener:
                # retry on the CONNECT policy until heal or deadline.
                last = OSError("chaos net cut")
                delay = bo.next_delay()
                if delay is None:
                    telemetry.count_socket_connect("refused")
                    raise ChannelConnectionError(
                        f"socket channel endpoint {addr} refused ({last}); "
                        "the reader endpoint is gone — the edge must be "
                        "reattached from a live listener or rebuilt"
                    ) from last
                time.sleep(delay)
                continue
        try:
            sock = _socket.create_connection(tuple(addr), timeout=min(timeout, 5.0))
            try:
                sock.sendall(_HELLO.pack(_MAGIC, 1, bytes(16), 0))
            except OSError:
                sock.close()
                raise
            telemetry.count_socket_connect("ok")
            return SocketChannel(sock, role, peer_addr=tuple(addr))
        except OSError as e:
            last = e
            delay = bo.next_delay()
            if delay is None:
                telemetry.count_socket_connect("refused")
                raise ChannelConnectionError(
                    f"socket channel endpoint {addr} refused ({last}); "
                    "the reader endpoint is gone — the edge must be "
                    "reattached from a live listener or rebuilt"
                ) from last
            time.sleep(delay)


class SocketChannel:
    """The mmap ring's write/read/pending contract over one long-lived
    TCP connection (one per compiled REMOTE edge, chosen at compile time
    by placement).

    Data frames (``[u64 len][u64 seq][payload][u32 crc]``) flow
    writer→reader; one ack byte per *consumed* message flows back.
    Flow control is a bounded unacked window (like the ring's free
    space, widened to hide the network RTT); the unacked frames double
    as the bounded replay buffer for epoch reattach.  Reader-side: a
    daemonized reader thread validates CRC trailers and drains frames
    into a local queue so ``pending()`` is local and writer death (EOF /
    reset) is detected immediately as ``ChannelClosed`` — distinct from
    ``ChannelTimeout``, which means the peer is alive but silent.
    After a connection-level death either side can resume the session:
    the writer transparently re-dials (bounded, once per failed send)
    and the reader's consumer calls :func:`reattach`, which re-accepts
    at a bumped epoch and seq-resumes from the replay buffer."""

    kind = "socket"

    _CLOSED = object()  # poison frame received (orderly close)
    _DIED = object()  # EOF/reset without poison (peer death)
    _CORRUPT = object()  # CRC-mismatched frame (consumed as typed error)

    def __init__(self, sock, role: str, window: Optional[int] = None,
                 listener: Optional[SocketListener] = None,
                 peer_addr: Optional[Tuple[str, int]] = None,
                 epoch: int = 1):
        import collections
        import queue as _queue
        import socket as _socket
        import threading as _threading

        assert role in ("read", "write"), role
        if window is None:
            from ray_tpu_torch._private.config import CONFIG

            window = int(getattr(CONFIG, "socket_channel_window", 8))
        self.role = role
        self.path = f"socket:{sock.getpeername()}"
        self._sock = sock
        # A dialed socket inherits create_connection's CONNECT timeout;
        # left in place it would make every later sendall of a frame
        # larger than the kernel buffers raise socket.timeout (read as
        # ChannelClosed) when the peer is slow to drain.  Steady-state
        # blocking is governed by the ack-window flow control, not a
        # per-syscall timeout.
        self._sock.settimeout(None)
        self._sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        self._window = max(1, window)
        self._unacked = 0
        self._closed = False
        # -- epoch-reattach state --
        self.epoch = int(epoch)
        self._listener = listener  # read role: stays open for reattach
        self._peer_addr = peer_addr  # write role: re-dial target
        self._token: Optional[bytes] = listener.token if listener is not None else None
        # write role: the pairing reply (carrying the listener token)
        # arrives interleaved ahead of the ack stream; buffered here
        # until complete.
        self._reply_buf: Optional[bytes] = b"" if role == "write" else None
        self._sent_seq = 0  # frames transmitted (write role)
        self._acked_seq = 0  # frames consumed by the peer (write role)
        self._replay = collections.deque()  # (seq, frame bytes), unacked
        self._rx_seq = 0  # read role: highest seq enqueued
        self._consumed_seq = 0  # read role: frames delivered to consumer
        self._eof = None  # read role: death sentinel after rx exit
        self.stats = {
            "writes": 0,
            "reads": 0,
            "bytes_written": 0,
            "bytes_read": 0,
            "write_blocked_s": 0.0,
            "read_blocked_s": 0.0,
            "write_timeouts": 0,
            "read_timeouts": 0,
            "corruptions": 0,
        }
        self._tele_ops = 0
        self._tele_flushed = dict(self.stats)
        self._scratch = bytearray(64 * 1024)
        self._rx = None
        if role == "read":
            self._q: "_queue.Queue" = _queue.Queue()
            self._start_rx()

    def _start_rx(self) -> None:
        import threading as _threading

        self._rx = _threading.Thread(
            target=self._rx_loop, args=(self._sock,), daemon=True,
            name="socket-channel-rx",
        )
        self._rx.start()

    # Telemetry rides the SAME channel_* series as the ring (op labels
    # read/write) — one dataplane, two transports.
    _TELE_FLUSH_OPS = Channel._TELE_FLUSH_OPS
    _tele_flush = Channel._tele_flush
    _record_corruption = Channel._record_corruption

    # -- reader ---------------------------------------------------------
    def _rx_loop(self, sock) -> None:
        """Drains frames from ``sock`` (captured at thread start: a
        reattach swaps self._sock for a new connection and a new rx
        thread — this one must never read from it)."""
        while True:
            try:
                head = _recv_exact_sock(sock, 8)
                if head is None:
                    self._q.put(self._DIED)
                    return
                (n,) = _FRAME.unpack(head)
                if n == POISON:
                    self._q.put(self._CLOSED)
                    return
                seq_b = _recv_exact_sock(sock, 8)
                if seq_b is None:
                    self._q.put(self._DIED)
                    return
                (seq,) = _FRAME.unpack(seq_b)
                payload = _recv_exact_sock(sock, n)
                if payload is None:
                    self._q.put(self._DIED)
                    return
                crc_b = _recv_exact_sock(sock, 4)
                if crc_b is None:
                    self._q.put(self._DIED)
                    return
                if seq <= self._rx_seq:
                    continue  # replay duplicate after a reattach
                self._rx_seq = seq
                if zlib.crc32(payload) != _U32C.unpack(crc_b)[0]:
                    self._record_corruption()
                    self._q.put(self._CORRUPT)
                    continue
                self._q.put(payload)
            except OSError:
                self._q.put(self._DIED)
                return

    def _pop_frame(self, timeout: Optional[float]) -> bytes:
        import queue as _queue

        if self._eof is not None and self._q.empty():
            raise ChannelClosed(
                f"{self.path}: "
                + ("closed by writer" if self._eof is self._CLOSED else "writer died")
            )
        t0 = time.monotonic()
        try:
            item = self._q.get(timeout=timeout)
        except _queue.Empty:
            self.stats["read_timeouts"] += 1
            self.stats["read_blocked_s"] += time.monotonic() - t0
            self._tele_flush()
            raise ChannelTimeout(
                f"no message on {self.path} within {timeout}s"
            ) from None
        waited = time.monotonic() - t0
        if waited > 0.0005:
            self.stats["read_blocked_s"] += waited
        if item is self._CLOSED or item is self._DIED:
            # Remember the death so later reads fail the same way (until
            # a successful reattach clears it).
            self._eof = item
            raise ChannelClosed(
                f"{self.path}: "
                + ("closed by writer" if item is self._CLOSED else "writer died")
            )
        # Consume-ack: flow control counts messages the CONSUMER has
        # taken, not what the rx thread buffered.
        self._consumed_seq += 1
        try:
            self._sock.sendall(_ACK)
        except OSError:
            pass  # writer already gone; reads of buffered frames still valid
        if item is self._CORRUPT:
            raise ChannelCorruptionError(
                f"{self.path}: frame failed CRC validation"
            )
        s = self.stats
        s["reads"] += 1
        s["bytes_read"] += len(item)
        self._tele_ops += 1
        if self._tele_ops >= self._TELE_FLUSH_OPS:
            self._tele_flush()
        return item

    def read(self, timeout=DEFAULT_TIMEOUT) -> bytes:
        return self._pop_frame(_resolve_timeout(timeout))

    def read_value(self, timeout=DEFAULT_TIMEOUT) -> Tuple[int, Any]:
        return self.read_value_traced(timeout)[:2]

    def read_value_traced(self, timeout=DEFAULT_TIMEOUT) -> Tuple[int, Any, Any]:
        """(tag, value, tctx) — see Channel.read_value_traced."""
        wire = _wire_mod()
        frame = self._pop_frame(_resolve_timeout(timeout))
        try:
            # One-shot frame owned by us: arrays may alias it (no copy).
            tag, value, tr = wire.decode_traced(memoryview(frame), copy_arrays=False)
        except wire.WireFormatError as e:
            self._record_corruption()
            raise ChannelCorruptionError(
                f"{self.path}: undecodable frame ({e})"
            ) from e
        tctx = None if tr is None else _trace_read(tr, self.kind, self.path)
        return tag, value, tctx

    def pending(self) -> bool:
        if self.role == "read":
            return not self._q.empty()
        return self._unacked > 0

    # -- reattach -------------------------------------------------------
    def _reattach_read(self, timeout: float) -> bool:
        """Re-accept the writer's epoch-bumped dial on the still-open
        listener and resume the frame stream (the handshake reply tells
        the writer where to seq-resume from)."""
        ok = False
        try:
            if self._listener is None or self._eof is self._CLOSED:
                return False  # orderly close is final; only deaths reattach
            old_rx = self._rx
            conn, epoch = self._listener._accept_conn(
                timeout, rx_seq=self._rx_seq, consumed=self._consumed_seq
            )
            if old_rx is not None and old_rx.is_alive():
                old_rx.join(timeout=1.0)
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = conn
            self.epoch = epoch
            self._eof = None
            self._closed = False
            self._start_rx()
            ok = True
            return True
        except (ChannelTimeout, ChannelClosed, OSError):
            return False
        finally:
            _count_reattach(ok)

    def _reattach_write(self, timeout: float) -> bool:
        """Re-dial the reader's listener with the pairing token at a
        bumped epoch; the reply's rx_seq/consumed resync flow control
        and select which unacked frames to replay."""
        import socket as _socket

        ok = False
        try:
            if self._peer_addr is None:
                return False
            # The pairing reply may still sit in the dead socket's
            # receive buffer (delivered before the FIN): salvage it so
            # the token is known even when no ack was ever drained.
            if self._token is None:
                try:
                    self._sock.setblocking(False)
                    tail = self._sock.recv(4096)
                    if tail:
                        self._absorb_rx_bytes(tail)
                except OSError:
                    pass
            if self._token is None:
                return False
            try:
                self._sock.close()
            except OSError:
                pass
            nd = _chaos_net_decide(self._peer_addr)
            if nd is not None and nd.drop:
                raise OSError("chaos net cut")  # re-dial blocked by the partition
            sock = _socket.create_connection(self._peer_addr, timeout=min(timeout, 5.0))
            try:
                sock.settimeout(timeout)
                sock.sendall(
                    _HELLO.pack(_MAGIC, self.epoch + 1, self._token, self._sent_seq)
                )
                reply = _recv_exact_sock(sock, _REPLY.size)
                if reply is None:
                    raise OSError("EOF during reattach handshake")
                magic, epoch, _token, rx_seq, consumed = _REPLY.unpack(reply)
                if magic != _MAGIC or epoch != self.epoch + 1:
                    raise OSError("reattach handshake refused")
                sock.settimeout(None)
                sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
            except OSError:
                sock.close()
                raise
            self.epoch = int(epoch)
            # Resync: acks lost with the connection are recovered from
            # the reader's consumed count; frames it never enqueued are
            # replayed (duplicates beyond rx_seq are dropped by seq).
            if consumed > self._acked_seq:
                self._ack_frames(consumed - self._acked_seq)
            self._sock = sock
            self._closed = False
            for seq, frame in self._replay:
                if seq > rx_seq:
                    self._sock.sendall(frame)
            ok = True
            return True
        except OSError:
            self._closed = True
            return False
        finally:
            _count_reattach(ok)

    # -- writer ---------------------------------------------------------
    def _ack_frames(self, n: int) -> None:
        self._acked_seq += n
        self._unacked = max(0, self._sent_seq - self._acked_seq)
        while self._replay and self._replay[0][0] <= self._acked_seq:
            self._replay.popleft()

    def _absorb_rx_bytes(self, data: bytes) -> None:
        """Writer-side rx stream: the pairing reply first (once), then
        one ack byte per frame the reader consumed."""
        if self._reply_buf is not None:
            take = _REPLY.size - len(self._reply_buf)
            self._reply_buf += data[:take]
            data = data[take:]
            if len(self._reply_buf) == _REPLY.size:
                magic, epoch, token, _rx, _cons = _REPLY.unpack(self._reply_buf)
                self._reply_buf = None
                if magic == _MAGIC:
                    self._token = bytes(token)
                    self.epoch = int(epoch)
        if data:
            self._ack_frames(len(data))

    def _await_reply(self, deadline: Optional[float]) -> None:
        """Block (bounded) until the pairing reply is absorbed.  Runs
        once, before the FIRST frame send: dial() deliberately does not
        wait for it (mutual-edge deadlock), but the reply must be in
        hand before any frame could need replaying — it carries the
        reattach token."""
        import select as _select

        while self._reply_buf is not None:
            timeout = 1.0
            if deadline is not None:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    self.stats["write_timeouts"] += 1
                    raise ChannelTimeout(
                        f"pairing reply from {self.path} not received in time"
                    )
            try:
                ready, _, _ = _select.select([self._sock], [], [], timeout)
            except ValueError:
                raise OSError("socket closed") from None
            if not ready:
                continue
            data = self._sock.recv(4096)
            if not data:
                raise OSError("peer hung up before pairing reply")
            self._absorb_rx_bytes(data)

    def _drain_acks(self, deadline: Optional[float]) -> None:
        """Consume available acks; when the window is full, block (up to
        the deadline) for the next one."""
        import select as _select

        while True:
            timeout = 0.0
            if self._unacked >= self._window:
                if deadline is None:
                    timeout = 1.0
                else:
                    timeout = max(0.0, deadline - time.monotonic())
                    if timeout == 0.0:
                        self.stats["write_timeouts"] += 1
                        self._tele_flush()
                        raise ChannelTimeout(
                            f"reader of {self.path} did not consume "
                            f"(window {self._window} full)"
                        )
            try:
                ready, _, _ = _select.select([self._sock], [], [], timeout)
            except ValueError:  # closed fd: same meaning as a dead peer
                raise OSError("socket closed") from None
            if not ready:
                if self._unacked < self._window:
                    return
                continue  # window full: keep waiting for the ack
            acks = self._sock.recv(4096)
            if not acks:
                raise OSError("reader endpoint hung up")
            self._absorb_rx_bytes(acks)
            if self._unacked < self._window:
                return

    def _encode_scratch(self, value: Any, tag: int, trace=None) -> int:
        wire = _wire_mod()
        while True:
            try:
                return wire.encode_into(
                    memoryview(self._scratch)[_FRAME_HDR.size:len(self._scratch) - 4],
                    value, tag, trace,
                )
            except (struct.error, ValueError, IndexError):
                if len(self._scratch) >= 1 << 31:
                    raise ChannelCapacityError(
                        "value exceeds socket channel frame limit (2 GiB)"
                    ) from None
                self._scratch = bytearray(len(self._scratch) * 4)

    def _reattach_budget(self, deadline: Optional[float]) -> float:
        from ray_tpu_torch._private.config import CONFIG

        budget = float(CONFIG.channel_reattach_timeout_s)
        if deadline is not None:
            budget = max(0.5, min(budget, deadline - time.monotonic()))
        return budget

    def _write_payload(self, value: Any, tag: int, timeout: Optional[float],
                       data: Optional[bytes], trace_state=None) -> None:
        if self._closed:
            raise ChannelClosed(self.path)
        ts = trace_state if trace_state is not None else _trace_begin()
        cd = _chaos_decide(self.path)
        if cd is not None:
            if cd.delay_s > 0:
                time.sleep(cd.delay_s)
            if cd.drop:
                self._count_write(len(data) if data is not None else 0)
                return
            if cd.close:
                # Abrupt connection loss (no poison): the send below
                # fails and takes the real reattach path — the drill
                # exercises exactly what a transient TCP drop does.
                try:
                    self._sock.close()
                except OSError:
                    pass
        nd = _chaos_net_decide(self._peer_addr)
        if nd is not None:
            if nd.delay_s > 0:
                time.sleep(nd.delay_s)
            if nd.drop:
                # A cut link looks like a dead connection to TCP: close
                # the socket so the send below takes the reattach path,
                # whose re-dial keeps failing through the same cut until
                # the link heals.
                try:
                    self._sock.close()
                except OSError:
                    pass
        deadline = None if timeout is None else time.monotonic() + timeout
        t0 = time.monotonic()
        # Encode the full frame once; it is also the replay entry.
        hdr = _FRAME_HDR.size
        if data is not None:
            n = len(data)
            if len(self._scratch) < hdr + n + 4:
                self._scratch = bytearray(hdr + n + 4)
            self._scratch[hdr : hdr + n] = data
            ts = None  # raw frames carry no wire header to trail
        else:
            n = self._encode_scratch(
                value, tag, None if ts is None else _trace_trailer(ts)
            )
        crc = zlib.crc32(memoryview(self._scratch)[hdr : hdr + n])
        if cd is not None and cd.corrupt:
            if n > 0:
                self._scratch[hdr] ^= 0xFF
            else:
                crc ^= 0xFFFFFFFF
        seq = self._sent_seq + 1
        _FRAME_HDR.pack_into(self._scratch, 0, n, seq)
        _U32C.pack_into(self._scratch, hdr + n, crc & 0xFFFFFFFF)
        frame = bytes(memoryview(self._scratch)[: hdr + n + 4])
        # Window space (one transparent reattach on a dead connection).
        for attempt in (0, 1):
            try:
                if self._reply_buf is not None:
                    self._await_reply(deadline)
                self._drain_acks(deadline)
                break
            except OSError:
                if attempt or not self._reattach_write(self._reattach_budget(deadline)):
                    self._closed = True
                    raise ChannelClosed(f"{self.path}: reader died") from None
        self._replay.append((seq, frame))
        self._sent_seq = seq
        self._unacked += 1
        try:
            if cd is not None and cd.torn:
                # Mid-frame writer kill: header + half the payload on
                # the wire, then the connection dies.
                self._sock.sendall(frame[: hdr + max(1, n // 2)])
                self._sock.close()
                raise OSError("chaos torn write")
            self._sock.sendall(frame)
        except OSError:
            if not self._reattach_write(self._reattach_budget(deadline)):
                # Never delivered and never will be: withdraw the frame.
                self._replay.pop()
                self._sent_seq -= 1
                self._unacked -= 1
                self._closed = True
                raise ChannelClosed(f"{self.path}: connection lost") from None
            # _reattach_write replayed every frame past the reader's
            # rx_seq — including this one.
        waited = time.monotonic() - t0
        if waited > 0.0005:
            self.stats["write_blocked_s"] += waited
        self._count_write(n)
        if ts is not None:
            _trace_commit_write(ts, self.kind, self.path)

    _count_write = Channel._count_write

    def write(self, data: bytes, timeout=DEFAULT_TIMEOUT) -> None:
        self._write_payload(None, 0, _resolve_timeout(timeout), data)

    def write_value(self, value: Any, tag: int = 0, timeout=DEFAULT_TIMEOUT) -> None:
        self._write_payload(value, tag, _resolve_timeout(timeout), None)

    def try_write_value(self, value: Any, tag: int = 0,
                        trace_state=None) -> bool:
        if self._closed:
            raise ChannelClosed(self.path)
        if self._unacked >= self._window:
            import select as _select

            try:
                ready, _, _ = _select.select([self._sock], [], [], 0.0)
            except ValueError:
                ready = []
            if ready:
                try:
                    acks = self._sock.recv(4096)
                except OSError:
                    acks = b""
                if not acks:
                    # Transient connection loss: the same transparent
                    # reattach the blocking write path gets — an edge
                    # write_value would heal must not tear down here —
                    # but bounded at 1 s, not the full reattach budget:
                    # try-writes are the fan-out scheduling primitive
                    # and independent sibling edges are stalled while
                    # this one re-dials.
                    if not self._reattach_write(
                        self._reattach_budget(time.monotonic() + 1.0)
                    ):
                        self._closed = True
                        raise ChannelClosed(f"{self.path}: reader died")
                    return False  # window/acks resynced; caller retries
                self._absorb_rx_bytes(acks)
            if self._unacked >= self._window:
                return False
        self._write_payload(value, tag, None, None, trace_state)
        return True

    # -- teardown -------------------------------------------------------
    def close(self) -> None:
        try:
            self._tele_flush()
        except Exception:
            pass
        if self.role == "write" and not self._closed:
            try:
                self._sock.sendall(_FRAME.pack(POISON))
            except OSError:
                pass
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass
        if self._listener is not None:
            self._listener.close()

    def unlink(self) -> None:  # contract parity with the ring
        pass


def reattach(chan, timeout: Optional[float] = None) -> bool:
    """ONE shared recovery step for a channel that raised
    ``ChannelClosed``: returns True when the edge is live again (resume
    reading/writing), False when the peer is really gone and the
    caller's heavy recovery (replica evict + RPC fallback, runner
    respawn, pipeline restart) must run.  Socket endpoints perform the
    epoch-bumped reconnect with seq-resume; ring endpoints are only
    "reattachable" if the closed flag was never set (a local mmap
    failure), since a set flag means the peer deliberately closed.

    Counted via ``channel_reattach_total{result}``."""
    if timeout is None:
        from ray_tpu_torch._private.config import CONFIG

        timeout = float(CONFIG.channel_reattach_timeout_s)
    try:
        if isinstance(chan, SocketChannel):
            if chan.role == "read":
                ok = chan._reattach_read(timeout)
            else:
                ok = chan._reattach_write(timeout)
            _trace_reattach(chan.path, ok, getattr(chan, "epoch", 0))
            return ok
        ok = False
        if isinstance(chan, Channel):
            ok = os.path.exists(chan.path) and not chan._closed_flag()
        _count_reattach(ok)
        _trace_reattach(chan.path, ok, getattr(chan, "epoch", 0))
        return ok
    except Exception:
        _count_reattach(False)
        _trace_reattach(getattr(chan, "path", "?"), False,
                        getattr(chan, "epoch", 0))
        return False


# ---------------------------------------------------------------------------
# Shared-memory fan-out: one writer, N same-node readers
#
# Broadcasting one payload to N co-located consumers (pipeline weight
# restore, activation/weight broadcast) previously cost N duplicate ring
# writes — N encodes and N payload copies through N rings.  A fan-out
# ring stores the payload ONCE; each reader owns a consume cursor, and
# the writer's free space is bounded by the SLOWEST reader (min over
# cursors), so flow control degrades exactly like a single-reader ring.
# Every reader registers its PID beside its cursor: a reader that dies
# without consuming (SIGKILL) is detected by the blocked writer and its
# cursor EVICTED, so a dead reader can no longer wedge the broadcast
# forever (counted via channel_fanout_evictions_total).
#
#     [wbytes u64][closed u64][n_readers u64][writer_pid u64]
#     [cursor0 u64]..[cursorN-1 u64][pid0 u64]..[pidN-1 u64][pad..64]
#     [ring payload: [u64 len][data][u32 crc][pad8] / WRAP markers ...]


_EVICTED_PID = (1 << 64) - 1


def _fanout_header(n_readers: int) -> int:
    return ((32 + 16 * n_readers + 63) // 64) * 64


class FanoutChannel:
    """Writer endpoint of a 1-to-N shm ring: write once, every reader
    consumes independently (N consume-acks)."""

    kind = "fanout"

    def __init__(self, path: str, n_readers: int,
                 max_size: int = 8 * 1024 * 1024, create: bool = False):
        if n_readers < 1:
            raise ValueError("fan-out channel needs at least one reader")
        self.path = path
        self.n_readers = n_readers
        header = _fanout_header(n_readers)
        if create:
            with open(path, "wb") as f:
                f.truncate(header + max_size)
        self._f = open(path, "r+b")
        size = os.fstat(self._f.fileno()).st_size
        self._header = header
        cap = size - header
        self.capacity = cap - (cap % 8)
        self.max_size = self.capacity - 24
        self._mm = mmap.mmap(self._f.fileno(), size)
        self._hdr = _u64_view(self._mm, header)
        if create:
            self._hdr[2] = n_readers
        else:
            stored = self._hdr[2]
            if stored != n_readers:
                raise ValueError(
                    f"fan-out channel {path} was created for {stored} "
                    f"readers, opened for {n_readers}"
                )
        self._hdr[3] = os.getpid()
        _register_shm_pid(path)
        self.stats = {"writes": 0, "bytes_written": 0, "write_blocked_s": 0.0,
                      "evictions": 0}

    def _cursor_off(self, idx: int) -> int:
        return 32 + 8 * idx

    def _pid_off(self, idx: int) -> int:
        return 32 + 8 * self.n_readers + 8 * idx

    def _min_read(self) -> int:
        """Free-space bound: min cursor over NON-evicted readers.  When
        every reader has been evicted the broadcast has no audience —
        typed close, never a silent write into the void."""
        lo = None
        for i in range(self.n_readers):
            if self._hdr[self._pid_off(i) >> 3] == _EVICTED_PID:
                continue
            cur = self._hdr[self._cursor_off(i) >> 3]
            lo = cur if lo is None or cur < lo else lo
        if lo is None:
            raise ChannelClosed(
                f"{self.path}: every fan-out reader is dead (evicted)"
            )
        return lo

    def _evict_dead_readers(self) -> int:
        """Evict readers whose registered PID is dead: their cursor no
        longer bounds the writer's free space.  A reader that never
        attached (pid slot 0) is NOT evicted — it may still be on its
        way; the write timeout covers that case exactly as before."""
        evicted = 0
        for i in range(self.n_readers):
            pid = self._hdr[self._pid_off(i) >> 3]
            if pid in (0, _EVICTED_PID) or _pid_alive(pid):
                continue
            self._hdr[self._pid_off(i) >> 3] = _EVICTED_PID
            evicted += 1
        if evicted:
            self.stats["evictions"] += evicted
            try:
                from ray_tpu_torch._private import telemetry

                telemetry.count_fanout_eviction(evicted)
            except Exception:
                pass
        return evicted

    def write(self, data: bytes, timeout=DEFAULT_TIMEOUT) -> None:
        cd = _chaos_decide(self.path)
        if cd is not None:
            if cd.delay_s > 0:
                time.sleep(cd.delay_s)
            if cd.close:
                self.close()
                raise ChannelClosed(f"{self.path}: chaos close")
            if cd.drop:
                self.stats["writes"] += 1
                return
        need = 8 + _align8(len(data) + 4)
        if need > self.max_size:
            raise ChannelCapacityError(
                f"message of {len(data)} bytes exceeds fan-out channel "
                f"capacity {self.max_size}; raise the buffer size"
            )
        deadline = None  # resolved at first block (see Channel.write)
        spins = 0
        t_block = 0.0
        cap = self.capacity
        hdr = self._header
        while True:
            if self._hdr[1]:
                raise ChannelClosed(self.path)
            wb = self._hdr[0]
            free = cap - (wb - self._min_read())
            tail = cap - (wb % cap)
            if tail < need:
                if free >= tail:
                    # Wrap: the tail region is free for EVERY reader.
                    if tail >= 8:
                        _U64.pack_into(self._mm, hdr + (wb % cap), WRAP)
                    self._hdr[0] = wb + tail
                    continue
            elif free >= need:
                break
            if spins == 0:
                t_block = time.monotonic()
                timeout = _resolve_timeout(timeout)
                deadline = None if timeout is None else t_block + timeout
            spins += 1
            # A blocked broadcast probes for dead readers: a SIGKILLed
            # reader's un-advanced cursor must not wedge the writer for
            # the whole timeout (or forever, with timeout=None).
            if spins % 512 == 0 and self._evict_dead_readers():
                continue
            _poll_wait(spins - 1)
            if deadline is not None and time.monotonic() > deadline:
                self._evict_dead_readers()
                self.stats["write_blocked_s"] += time.monotonic() - t_block
                raise ChannelTimeout(
                    f"slowest of {self.n_readers} fan-out readers of "
                    f"{self.path} did not free ring space in time"
                )
        wpos = wb % cap
        self._mm[hdr + wpos + 8: hdr + wpos + 8 + len(data)] = data
        crc = zlib.crc32(data)
        if cd is not None:
            crc = _mutate_payload(self._mm, hdr + wpos + 8, len(data), crc, cd)
        _U32C.pack_into(self._mm, hdr + wpos + 8 + len(data), crc)
        _U64.pack_into(self._mm, hdr + wpos, len(data))
        self._hdr[0] = wb + need
        if spins:
            self.stats["write_blocked_s"] += time.monotonic() - t_block
        self.stats["writes"] += 1
        self.stats["bytes_written"] += len(data)

    def write_value(self, value: Any, tag: int = 0,
                    timeout=DEFAULT_TIMEOUT) -> None:
        """One encode, N consumers.  The broadcast path is not the
        per-microbatch hot loop, so the simple encode-then-copy beats
        duplicating the ring's in-place encoder for a third layout."""
        from ray_tpu_torch._private import wire

        ts = _trace_begin()
        self.write(
            wire.encode(value, tag, None if ts is None else _trace_trailer(ts)),
            timeout=timeout,
        )
        if ts is not None:
            _trace_commit_write(ts, self.kind, self.path)

    def close(self) -> None:
        try:
            self._hdr[1] = 1
        except ValueError:
            pass
        try:
            self._hdr.release()
        except Exception:
            pass
        try:
            self._mm.close()
            self._f.close()
        except Exception:
            pass

    def unlink(self) -> None:
        try:
            os.unlink(self.path)
        except OSError:
            pass


class FanoutReader:
    """Reader endpoint ``index`` of a :class:`FanoutChannel`: consumes
    every message exactly once at its own pace; advancing its cursor IS
    its consume-ack.  The reader registers its PID beside the cursor at
    open so a blocked writer can detect its death and evict it; an
    evicted reader that was NOT actually dead finds out typed (its pid
    slot is tombstoned) instead of silently losing frames."""

    kind = "fanout"

    def __init__(self, path: str, index: int):
        self.path = path
        self.index = index
        self._f = open(path, "r+b")
        size = os.fstat(self._f.fileno()).st_size
        self._mm = mmap.mmap(self._f.fileno(), size)
        n = _U64.unpack_from(self._mm, 16)[0]
        if not 0 <= index < n:
            raise ValueError(f"reader index {index} out of range (n={n})")
        self.n_readers = n
        self._header = _fanout_header(n)
        self._hdr = _u64_view(self._mm, self._header)
        cap = size - self._header
        self.capacity = cap - (cap % 8)
        self.max_size = self.capacity - 24
        self._off = 32 + 8 * index
        self._pid_slot = 32 + 8 * n + 8 * index
        self._hdr[self._pid_slot >> 3] = os.getpid()
        _register_shm_pid(path)
        self.stats = {"reads": 0, "bytes_read": 0, "read_blocked_s": 0.0,
                      "corruptions": 0}

    def pending(self) -> bool:
        try:
            return self._hdr[0] != self._hdr[self._off >> 3]
        except ValueError:
            return False

    def _check_evicted(self) -> None:
        if self._hdr[self._pid_slot >> 3] == _EVICTED_PID:
            raise ChannelClosed(
                f"{self.path}: reader {self.index} was evicted (writer "
                f"presumed this PID dead)"
            )

    def _next_slot(self) -> Optional[Tuple[int, int]]:
        cap = self.capacity
        while True:
            rb = self._hdr[self._off >> 3]
            if self._hdr[0] == rb:
                return None
            rpos = rb % cap
            tail = cap - rpos
            if tail < 8:
                self._hdr[self._off >> 3] = rb + tail
                continue
            n = _U64.unpack_from(self._mm, self._header + rpos)[0]
            if n == WRAP:
                self._hdr[self._off >> 3] = rb + tail
                continue
            if n > self.max_size or 8 + _align8(n + 4) > tail:
                self.stats["corruptions"] += 1
                _count_corruption()
                err = ChannelCorruptionError(
                    f"{self.path}: torn/garbage fan-out record length {n}"
                )
                err.advanced = False  # framing broken: no way past it
                raise err
            return rpos, n

    def read(self, timeout=DEFAULT_TIMEOUT) -> bytes:
        deadline = None  # resolved at first block (see write())
        spins = 0
        t_block = 0.0
        while True:
            # Eviction outranks everything: once the writer tombstoned
            # this cursor it may have overwritten the unread region, so
            # interpreting it would misreport corruption.
            self._check_evicted()
            slot = self._next_slot()
            if slot is not None:
                rpos, n = slot
                data = bytes(
                    self._mm[self._header + rpos + 8: self._header + rpos + 8 + n]
                )
                stored = _U32C.unpack_from(self._mm, self._header + rpos + 8 + n)[0]
                rb = self._hdr[self._off >> 3]
                self._hdr[self._off >> 3] = rb + 8 + _align8(n + 4)
                if zlib.crc32(data) != stored:
                    self.stats["corruptions"] += 1
                    _count_corruption()
                    raise ChannelCorruptionError(
                        f"{self.path}: fan-out record failed CRC validation"
                    )
                self.stats["reads"] += 1
                self.stats["bytes_read"] += n
                if spins:
                    self.stats["read_blocked_s"] += time.monotonic() - t_block
                return data
            if self._hdr[1]:
                raise ChannelClosed(self.path)
            if spins == 0:
                t_block = time.monotonic()
                timeout = _resolve_timeout(timeout)
                deadline = None if timeout is None else t_block + timeout
            spins += 1
            _poll_wait(spins - 1)
            if deadline is not None and time.monotonic() > deadline:
                self.stats["read_blocked_s"] += time.monotonic() - t_block
                raise ChannelTimeout(
                    f"no fan-out message on {self.path} within {timeout}s"
                )

    def read_value(self, timeout=DEFAULT_TIMEOUT) -> Tuple[int, Any]:
        return self.read_value_traced(timeout)[:2]

    def read_value_traced(self, timeout=DEFAULT_TIMEOUT) -> Tuple[int, Any, Any]:
        """(tag, value, tctx) — see Channel.read_value_traced."""
        from ray_tpu_torch._private import wire

        # The frame was copied out of the ring by read(); arrays may
        # alias the private copy.
        try:
            tag, value, tr = wire.decode_traced(
                memoryview(self.read(timeout)), copy_arrays=False
            )
        except wire.WireFormatError as e:
            self.stats["corruptions"] += 1
            _count_corruption()
            raise ChannelCorruptionError(
                f"{self.path}: undecodable fan-out record ({e})"
            ) from e
        tctx = None if tr is None else _trace_read(tr, self.kind, self.path)
        return tag, value, tctx

    def close(self) -> None:
        try:
            self._hdr.release()
        except Exception:
            pass
        try:
            self._mm.close()
            self._f.close()
        except Exception:
            pass

    def unlink(self) -> None:
        try:
            os.unlink(self.path)
        except OSError:
            pass


# ---------------------------------------------------------------------------
# Compile-time endpoint plumbing


# Listeners bound during a compiled graph's setup phase, consumed when
# its resident loop (or the driver) opens the read side.  Keyed by
# (dag token, channel id); same process between setup and loop start.
_BOUND_LISTENERS: dict = {}


def bind_listener(token: str, cid: str) -> int:
    lst = SocketListener()
    _BOUND_LISTENERS[(token, cid)] = lst
    return lst.port


def take_listener(token: str, cid: str) -> SocketListener:
    return _BOUND_LISTENERS.pop((token, cid))


def drop_listeners(token: str) -> None:
    for key in [k for k in _BOUND_LISTENERS if k[0] == token]:
        _BOUND_LISTENERS.pop(key).close()


def ring_base_dir() -> str:
    """Filesystem base for ring-channel files: tmpfs when available.
    The single place that picks it — compiled-DAG and serve ring
    directories must land on the same filesystem."""
    import tempfile

    return "/dev/shm" if os.path.isdir("/dev/shm") else tempfile.gettempdir()


def sweep_orphan_ring_dirs(base: Optional[str] = None,
                           grace_s: Optional[float] = None) -> int:
    """Reclaim ring/fan-out shm directories whose registered owner PIDs
    are ALL dead (the tmpfs leak after a SIGKILL skipped every teardown
    path).  Run by the raylet on a channel_shm_sweep_period_s cadence;
    safe to run from multiple raylets of one host (unlink succeeds once,
    so files are never double-counted).  Conservative by construction:
    a directory with no PID registry yet, or any live registered owner,
    is never touched, and directories younger than the grace window are
    skipped (the mkdir→first-open registration gap).

    Returns the number of channel files reclaimed (counted via
    ``channel_shm_reclaimed_total``)."""
    from ray_tpu_torch._private.config import CONFIG

    if base is None:
        base = ring_base_dir()
    if grace_s is None:
        grace_s = float(CONFIG.channel_shm_orphan_grace_s)
    reclaimed = 0
    try:
        names = os.listdir(base)
    except OSError:
        return 0
    now = time.time()
    for name in names:
        if not name.startswith("ray_tpu_torch_"):
            continue
        d = os.path.join(base, name)
        try:
            if not os.path.isdir(d) or now - os.stat(d).st_mtime < grace_s:
                continue
            with open(os.path.join(d, ".pids")) as f:
                pids = {int(line) for line in f if line.strip()}
        except (OSError, ValueError):
            continue  # no/invalid registry: conservative, skip
        if not pids or any(_pid_alive(p) for p in pids):
            continue
        # Narrow the attach race: a process registering between the
        # first read and the unlink below would lose its live files.
        # Creating channel files bumps the dir mtime (grace-protected),
        # but pure-open endpoints only append to .pids — re-read it
        # immediately before destruction so the window shrinks from one
        # sweep period to microseconds.
        try:
            with open(os.path.join(d, ".pids")) as f:
                pids2 = {int(line) for line in f if line.strip()}
        except (OSError, ValueError):
            continue
        if pids2 != pids and any(_pid_alive(p) for p in pids2):
            continue
        try:
            entries = os.listdir(d)
        except OSError:
            continue
        for fn in entries:
            try:
                os.unlink(os.path.join(d, fn))
                if fn != ".pids":
                    reclaimed += 1
            except OSError:
                pass
        try:
            os.rmdir(d)
        except OSError:
            pass
    if reclaimed:
        try:
            from ray_tpu_torch._private import telemetry

            telemetry.count_shm_reclaimed(reclaimed)
        except Exception:
            pass
    return reclaimed


def node_hosts(worker) -> dict:
    """node id (hex) -> reachable host, from the GCS cluster view.
    Local (unix-socket) raylets are same-machine by definition."""
    from ray_tpu_torch._private.ids import NodeID

    info = worker.gcs_client.call("get_cluster_info")
    hosts = {}
    for n in info["nodes"].values():
        addr = str(n.get("raylet_address", ""))
        if addr.startswith("unix:") or ":" not in addr:
            host = "127.0.0.1"
        else:
            host = addr.rsplit(":", 1)[0] or "127.0.0.1"
        if host == "0.0.0.0":
            host = "127.0.0.1"
        hosts[NodeID(n["node_id"]).hex()] = host
    return hosts


def open_channel(desc: dict, role: str, timeout: float = 30.0):
    """Open one endpoint of a planned channel.

    ``desc`` is the compile-time descriptor: ``{"kind": "ring", "path"}``
    or ``{"kind": "socket", "token", "id", "addr": (host, port)}``.
    Socket rule: the READER bound the listener during setup (and accepts
    here); the WRITER dials.  Dials never deadlock accepts because every
    listener is bound before any loop starts (TCP completes the
    handshake from the backlog; the pairing reply is absorbed lazily
    from the ack stream)."""
    if desc["kind"] == "ring":
        return Channel(desc["path"])
    if role == "write":
        return dial(tuple(desc["addr"]), "write", timeout=timeout)
    return take_listener(desc["token"], desc["id"]).accept("read", timeout=timeout)


def write_value_fanout(
    targets: Sequence[Tuple[Any, Any, int]], timeout=DEFAULT_TIMEOUT
) -> None:
    """Write a batch of (channel, value, tag) with fan-out overlap: each
    blocked edge is retried round-robin via ``try_write_value`` so one
    slow consumer never head-of-line-blocks an independent branch (the
    graph-level scheduling rule: issue every fan-out write before
    blocking on any single peer)."""
    if len(targets) == 1:
        chan, value, tag = targets[0]
        chan.write_value(value, tag, timeout=timeout)  # resolves lazily
        return
    # Ring frames get their chaos verdict HERE, once per frame, with the
    # pre-actions (drop / delay / close) applied exactly once — blocked
    # retry rounds below must not consume extra match ordinals or
    # re-sleep a delay (seeded schedules are per-frame deterministic).
    # Socket channels decide inside the actual send, which try-writes
    # reach at most once per frame.
    pending = []
    for chan, value, tag in targets:
        cd = _CHAOS_UNDECIDED
        if isinstance(chan, Channel):
            cd = _chaos_decide(chan.path)
            if cd is not None and chan._apply_write_chaos(cd, 0):
                continue  # dropped: the frame silently vanishes
        # One trace state per (frame, target): each edge gets its own
        # write span, and blocked retry rounds reuse the same span id.
        pending.append((chan, value, tag, cd, _trace_begin()))
    deadline = None  # resolved at first blocked round (see Channel.write)
    spins = 0
    while pending:
        rest = []
        for chan, value, tag, cd, ts in pending:
            if cd is _CHAOS_UNDECIDED:
                ok = chan.try_write_value(value, tag, trace_state=ts)
            else:
                ok = chan.try_write_value(value, tag, cd=cd, trace_state=ts)
            if not ok:
                rest.append((chan, value, tag, cd, ts))
        if not rest:
            return
        pending = rest
        if spins == 0:
            timeout = _resolve_timeout(timeout)
            deadline = None if timeout is None else time.monotonic() + timeout
        spins += 1
        _poll_wait(spins - 1)
        if deadline is not None and time.monotonic() > deadline:
            raise ChannelTimeout(
                f"{len(pending)} fan-out peers did not consume within {timeout}s"
            )
