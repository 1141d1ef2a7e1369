"""RPC substrate: length-framed messages over unix/TCP sockets.

Fills the role of the reference's gRPC wrappers (reference: src/ray/rpc/
grpc_server.h, grpc_client.h, client_call.h) without a grpc dependency:
asyncio servers with per-connection dispatch, a threaded synchronous client
for drivers/workers, an async client for service-to-service calls, and
the fault-injection plane (reference: src/ray/rpc/rpc_chaos.h:23,
RAY_testing_rpc_failure; generalized in chaos.py to seeded drop/delay/
duplicate schedules) wired into every dispatch.

Wire format: [u32 length][pickle payload]
Payload tuples:
    ("req",  req_id, method, payload)
    ("rep",  req_id, ok, result)          ok=False → result is an Exception
    ("push", method, payload)             one-way, either direction
"""

from __future__ import annotations

import asyncio
import os
import pickle
import socket
import struct
import threading
import time
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch._private.chaos import CHAOS, net_name as _net_name
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private import retry, telemetry

_LEN = struct.Struct("<I")
MAX_FRAME = 1 << 31


def _net_decision(peer_name: str):
    """Link verdict for one frame leaving this process toward
    ``peer_name`` (None on the no-net-chaos fast path).  Every send
    site — request, reply, push, dial — consults its own direction of
    travel exactly once, so ``net:a->b:cut`` blackholes a→b while b→a
    keeps flowing (the asymmetric-partition model)."""
    if not (CHAOS.active and CHAOS.has_net_rules):
        return None
    d = CHAOS.decide_net(_net_name(), peer_name or "?")
    return None if d.clean else d

# Sentinel distinguishing "caller did not pass a timeout" (use the config
# default) from an explicit None (wait forever).
_UNSET_TIMEOUT = object()


class RpcError(Exception):
    pass


class ConnectionLost(RpcError):
    pass


class CallTimeout(RpcError):
    pass


def _parse_address(address: str):
    if address.startswith("unix:"):
        return ("unix", address[5:])
    if address.startswith("tcp:"):
        host, port = address[4:].rsplit(":", 1)
        return ("tcp", (host, int(port)))
    raise ValueError(f"bad address {address}")


# --------------------------------------------------------------------------
# Async server
# --------------------------------------------------------------------------
class ClientConn:
    """Server-side handle to one connected client; supports pushes."""

    __slots__ = ("writer", "peer", "_lock", "meta", "closed")

    def __init__(self, writer: asyncio.StreamWriter):
        self.writer = writer
        self.peer = None
        self.meta: Dict[str, Any] = {}
        self.closed = False

    def push(self, method: str, payload: Any):
        if self.closed:
            return
        # Link chaos, drop only: this runs on the event loop, so a slow
        # link cannot sleep here — server-side delays are modeled on the
        # reply path (_deliver) instead.
        nd = _net_decision(self.meta.get("net_name", ""))
        if nd is not None and nd.drop:
            return
        data = pickle.dumps(("push", method, payload), protocol=5)
        try:
            self.writer.write(_LEN.pack(len(data)) + data)
        except Exception:
            self.closed = True

    async def drain(self):
        try:
            await self.writer.drain()
        except Exception:
            self.closed = True


class RpcServer:
    """Dispatches ("req", ...) frames to `handler.rpc_<method>(payload, conn)`
    coroutines; ("push", ...) frames to `handler.push_<method>(payload, conn)`.
    """

    def __init__(self, handler: Any, address: str, loop: asyncio.AbstractEventLoop):
        self.handler = handler
        self.address = address
        self.loop = loop
        self._server = None
        self.conns: set = set()
        self.on_disconnect: Optional[Callable[[ClientConn], Any]] = None

    async def start(self):
        kind, target = _parse_address(self.address)
        if kind == "unix":
            os.makedirs(os.path.dirname(target), exist_ok=True)
            if os.path.exists(target):
                os.unlink(target)
            self._server = await asyncio.start_unix_server(self._on_conn, path=target)
        else:
            host, port = target
            self._server = await asyncio.start_server(self._on_conn, host=host, port=port)
        return self

    async def stop(self):
        # Close live connections first — wait_closed() blocks until every
        # connection handler finishes, which would never happen otherwise.
        for c in list(self.conns):
            c.closed = True
            try:
                c.writer.close()
            except Exception:
                pass
        if self._server:
            self._server.close()
            try:
                await asyncio.wait_for(self._server.wait_closed(), timeout=2)
            except Exception:
                pass

    async def _on_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        conn = ClientConn(writer)
        self.conns.add(conn)
        try:
            while True:
                hdr = await reader.readexactly(_LEN.size)
                (length,) = _LEN.unpack(hdr)
                data = await reader.readexactly(length)
                msg = pickle.loads(data)
                asyncio.ensure_future(self._dispatch(msg, conn))
        except (asyncio.IncompleteReadError, ConnectionResetError, BrokenPipeError):
            pass
        finally:
            conn.closed = True
            self.conns.discard(conn)
            try:
                writer.close()
            except Exception:
                pass
            if self.on_disconnect:
                res = self.on_disconnect(conn)
                if asyncio.iscoroutine(res):
                    await res

    async def _dispatch(self, msg, conn: ClientConn):
        if msg[0] == "hello":
            # Connection identity frame (first thing a client sends):
            # carries the peer's chaos net name so server-originated
            # frames (replies, pushes) can be matched against
            # directional net: rules.  Never itself faulted — a link
            # that admits the connect admits the hello.
            if isinstance(msg[1], dict):
                conn.meta.update(msg[1])
            return
        delay_us = CONFIG.testing_asio_delay_us
        if delay_us:
            await asyncio.sleep(delay_us / 1e6)
        if CHAOS.active:
            # One decision per delivery: drop (handler never runs), delay
            # (handler runs late), duplicate (handler runs twice — the
            # second run models a retried RPC whose first reply was lost,
            # so idempotency tokens on lease/submit are load-bearing).
            method = msg[2] if msg[0] == "req" else msg[1]
            d = CHAOS.decide(method, "req")
            if d.delay_s > 0:
                await asyncio.sleep(d.delay_s)
            if d.drop:
                return
            if d.dup:
                asyncio.ensure_future(self._deliver(msg, conn))
        await self._deliver(msg, conn)

    async def _deliver(self, msg, conn: ClientConn):
        if msg[0] == "req":
            _, req_id, method, payload = msg
            fn = getattr(self.handler, "rpc_" + method, None)
            # Metric label must stay bounded: the method string comes off
            # the wire, so unknown methods collapse to one label instead
            # of minting a registry series per (possibly hostile) name.
            label = method if fn is not None else "<unknown>"
            t0 = time.perf_counter()
            try:
                if fn is None:
                    raise RpcError(f"no such rpc method: {method}")
                result = await fn(payload, conn)
                ok = True
            except Exception as e:  # noqa: BLE001 — errors cross the wire
                result, ok = e, False
                telemetry.count_rpc_error(label, "handler")
            telemetry.observe_rpc(label, "server", time.perf_counter() - t0)
            if CHAOS.active:
                rep = CHAOS.decide(method, "rep")
                if rep.delay_s > 0:
                    await asyncio.sleep(rep.delay_s)
                if rep.drop:
                    return
                # The reply travels server→client: its own link
                # direction, consulted independently of the request's.
                nd = _net_decision(conn.meta.get("net_name", ""))
                if nd is not None:
                    if nd.delay_s > 0:
                        await asyncio.sleep(nd.delay_s)
                    if nd.drop:
                        return
            if conn.closed:
                return
            try:
                data = pickle.dumps(("rep", req_id, ok, result), protocol=5)
            except Exception:
                # Dynamically-created exception classes (e.g. RayTaskError
                # derived from the user's error type) need pickle-by-value.
                try:
                    import cloudpickle

                    data = cloudpickle.dumps(("rep", req_id, ok, result), protocol=5)
                except Exception as ser_err:
                    # Truly unserializable: reply with an error instead of
                    # leaving the caller to hit its full call timeout.
                    data = pickle.dumps(
                        (
                            "rep",
                            req_id,
                            False,
                            RpcError(f"unserializable {method} reply: {ser_err}"),
                        ),
                        protocol=5,
                    )
            conn.writer.write(_LEN.pack(len(data)) + data)
            await conn.drain()
        elif msg[0] == "push":
            _, method, payload = msg
            fn = getattr(self.handler, "push_" + method, None)
            if fn is not None:
                await fn(payload, conn)


# --------------------------------------------------------------------------
# Async client (service ↔ service, runs inside an asyncio loop)
# --------------------------------------------------------------------------
class AsyncRpcClient:
    def __init__(self, address: str, peer_name: str = ""):
        self.address = address
        self.peer_name = peer_name
        self._reader = None
        self._writer = None
        self._req_id = 0
        self._pending: Dict[int, asyncio.Future] = {}
        self._read_task = None
        self.on_push: Optional[Callable[[str, Any], Any]] = None
        self.on_close: Optional[Callable[[], Any]] = None
        self._connected = False
        self._wlock = asyncio.Lock()

    async def connect(self, timeout: float = None):
        timeout = timeout or CONFIG.rpc_connect_timeout_s
        kind, target = _parse_address(self.address)
        bo = retry.CONNECT.start(deadline_s=timeout)
        while True:
            nd = _net_decision(self.peer_name)
            if nd is not None and nd.drop:
                # A cut link refuses dials exactly like a dead listener:
                # take the backoff path until the spec heals or the
                # deadline expires.
                delay = bo.next_delay()
                if delay is None:
                    raise ConnectionLost(f"cannot connect to {self.address}")
                await asyncio.sleep(delay)
                continue
            try:
                if kind == "unix":
                    self._reader, self._writer = await asyncio.open_unix_connection(target)
                else:
                    self._reader, self._writer = await asyncio.open_connection(*target)
                break
            except (ConnectionRefusedError, FileNotFoundError):
                delay = bo.next_delay()
                if delay is None:
                    raise ConnectionLost(f"cannot connect to {self.address}")
                await asyncio.sleep(delay)
        self._connected = True
        self._read_task = asyncio.ensure_future(self._read_loop())
        data = pickle.dumps(("hello", {"net_name": _net_name()}), protocol=5)
        self._writer.write(_LEN.pack(len(data)) + data)
        return self

    async def _read_loop(self):
        try:
            while True:
                hdr = await self._reader.readexactly(_LEN.size)
                (length,) = _LEN.unpack(hdr)
                data = await self._reader.readexactly(length)
                msg = pickle.loads(data)
                if msg[0] == "rep":
                    _, req_id, ok, result = msg
                    fut = self._pending.pop(req_id, None)
                    if fut is not None and not fut.done():
                        if ok:
                            fut.set_result(result)
                        else:
                            fut.set_exception(result)
                elif msg[0] == "push" and self.on_push:
                    res = self.on_push(msg[1], msg[2])
                    if asyncio.iscoroutine(res):
                        asyncio.ensure_future(res)
        except (asyncio.IncompleteReadError, ConnectionResetError, BrokenPipeError, asyncio.CancelledError):
            pass
        finally:
            self._connected = False
            err = ConnectionLost(f"connection to {self.address} lost")
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(err)
            self._pending.clear()
            if self.on_close is not None:
                try:
                    res = self.on_close()
                    if asyncio.iscoroutine(res):
                        asyncio.ensure_future(res)
                except Exception:
                    pass

    async def call(self, method: str, payload: Any = None, timeout: float = _UNSET_TIMEOUT):
        """timeout semantics: unset → config default; None → wait forever."""
        if not self._connected:
            raise ConnectionLost(f"not connected to {self.address}")
        self._req_id += 1
        req_id = self._req_id
        fut = asyncio.get_event_loop().create_future()
        self._pending[req_id] = fut
        data = pickle.dumps(("req", req_id, method, payload), protocol=5)
        t0 = time.perf_counter()
        nd = _net_decision(self.peer_name)
        if nd is not None and nd.delay_s > 0:
            await asyncio.sleep(nd.delay_s)
        if nd is not None and nd.drop:
            # Blackholed on the wire: the caller waits out its timeout
            # exactly as with a real partition.
            pass
        else:
            async with self._wlock:
                self._writer.write(_LEN.pack(len(data)) + data)
                await self._writer.drain()
        if timeout is _UNSET_TIMEOUT:
            timeout = CONFIG.rpc_call_timeout_s
        try:
            if timeout is None:
                result = await fut
            else:
                result = await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            self._pending.pop(req_id, None)
            telemetry.count_rpc_error(method, "timeout")
            raise CallTimeout(f"{method} on {self.address} timed out after {timeout}s")
        except ConnectionLost:
            telemetry.count_rpc_error(method, "connection_lost")
            raise
        except Exception:
            # Handler error crossed the wire: the round trip completed,
            # so it still counts toward client-side latency (matches the
            # sync RpcClient path).
            telemetry.observe_rpc(method, "client", time.perf_counter() - t0)
            raise
        telemetry.observe_rpc(method, "client", time.perf_counter() - t0)
        return result

    async def push(self, method: str, payload: Any = None):
        if not self._connected:
            raise ConnectionLost(f"not connected to {self.address}")
        nd = _net_decision(self.peer_name)
        if nd is not None:
            if nd.delay_s > 0:
                await asyncio.sleep(nd.delay_s)
            if nd.drop:
                return  # a push into a cut link vanishes silently
        data = pickle.dumps(("push", method, payload), protocol=5)
        async with self._wlock:
            self._writer.write(_LEN.pack(len(data)) + data)
            await self._writer.drain()

    def close(self):
        if self._read_task:
            self._read_task.cancel()
        if self._writer:
            try:
                self._writer.close()
            except Exception:
                pass
        self._connected = False


# --------------------------------------------------------------------------
# Sync client (drivers / worker main threads)
# --------------------------------------------------------------------------
class RpcClient:
    def __init__(self, address: str, on_push: Callable[[str, Any], None] = None,
                 on_close: Callable[[], None] = None, peer_name: str = ""):
        self.address = address
        self.on_push = on_push
        self.on_close = on_close
        self.peer_name = peer_name
        self._sock = self._connect()
        self._req_id = 0
        self._lock = threading.Lock()
        self._pending: Dict[int, "threading.Event"] = {}
        self._results: Dict[int, Any] = {}
        self._closed = False
        self._reader = threading.Thread(target=self._read_loop, daemon=True, name=f"rpc-read-{address[-16:]}")
        self._reader.start()

    def _connect(self):
        kind, target = _parse_address(self.address)
        bo = retry.CONNECT.start(deadline_s=CONFIG.rpc_connect_timeout_s)
        while True:
            nd = _net_decision(self.peer_name)
            if nd is not None and nd.drop:
                # A cut link refuses dials exactly like a dead listener.
                delay = bo.next_delay()
                if delay is None:
                    raise ConnectionLost(f"cannot connect to {self.address}")
                time.sleep(delay)
                continue
            s = None
            try:
                if kind == "unix":
                    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                    s.connect(target)
                else:
                    s = socket.create_connection(target)
                    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                data = pickle.dumps(("hello", {"net_name": _net_name()}),
                                    protocol=5)
                s.sendall(_LEN.pack(len(data)) + data)
                return s
            except (ConnectionRefusedError, FileNotFoundError, BrokenPipeError,
                    ConnectionResetError):
                # a listener that is going away can accept and then drop
                # the hello (a GCS killed mid-reconnect): dial again
                if s is not None:
                    s.close()
                delay = bo.next_delay()
                if delay is None:
                    raise ConnectionLost(f"cannot connect to {self.address}")
                time.sleep(delay)

    def _recv_exact(self, n: int) -> bytes:
        chunks = []
        while n:
            chunk = self._sock.recv(min(n, 1 << 20))
            if not chunk:
                raise ConnectionLost("socket closed")
            chunks.append(chunk)
            n -= len(chunk)
        return b"".join(chunks)

    def _read_loop(self):
        try:
            while not self._closed:
                hdr = self._recv_exact(_LEN.size)
                (length,) = _LEN.unpack(hdr)
                data = self._recv_exact(length)
                msg = pickle.loads(data)
                if msg[0] == "rep":
                    _, req_id, ok, result = msg
                    with self._lock:
                        ev = self._pending.pop(req_id, None)
                        if ev is not None:
                            self._results[req_id] = (ok, result)
                            ev.set()
                elif msg[0] == "push" and self.on_push:
                    try:
                        self.on_push(msg[1], msg[2])
                    except Exception:
                        import traceback

                        traceback.print_exc()
        except (ConnectionLost, OSError):
            pass
        finally:
            self._closed = True
            with self._lock:
                for req_id, ev in self._pending.items():
                    self._results[req_id] = (False, ConnectionLost(f"connection to {self.address} lost"))
                    ev.set()
                self._pending.clear()
            if self.on_close is not None:
                try:
                    self.on_close()
                except Exception:
                    pass

    def call(self, method: str, payload: Any = None, timeout: float = _UNSET_TIMEOUT):
        """timeout semantics: unset → config default; None → wait forever."""
        if self._closed:
            raise ConnectionLost(f"not connected to {self.address}")
        with self._lock:
            self._req_id += 1
            req_id = self._req_id
            ev = threading.Event()
            self._pending[req_id] = ev
        data = pickle.dumps(("req", req_id, method, payload), protocol=5)
        t0 = time.perf_counter()
        nd = _net_decision(self.peer_name)
        if nd is not None and nd.delay_s > 0:
            time.sleep(nd.delay_s)
        if nd is not None and nd.drop:
            # Blackholed on the wire: skip the send and wait out the
            # timeout below, exactly as with a real partition.
            pass
        else:
            try:
                with self._lock:
                    self._sock.sendall(_LEN.pack(len(data)) + data)
            except OSError as e:
                with self._lock:
                    self._pending.pop(req_id, None)
                telemetry.count_rpc_error(method, "connection_lost")
                raise ConnectionLost(f"send to {self.address} failed: {e}") from e
        if timeout is _UNSET_TIMEOUT:
            timeout = CONFIG.rpc_call_timeout_s
        if not ev.wait(timeout):
            with self._lock:
                self._pending.pop(req_id, None)
            telemetry.count_rpc_error(method, "timeout")
            raise CallTimeout(f"{method} on {self.address} timed out after {timeout}s")
        with self._lock:
            ok, result = self._results.pop(req_id)
        telemetry.observe_rpc(method, "client", time.perf_counter() - t0)
        if not ok:
            if isinstance(result, ConnectionLost):
                telemetry.count_rpc_error(method, "connection_lost")
            raise result
        return result

    def push(self, method: str, payload: Any = None):
        if self._closed:
            raise ConnectionLost(f"not connected to {self.address}")
        nd = _net_decision(self.peer_name)
        if nd is not None:
            if nd.delay_s > 0:
                time.sleep(nd.delay_s)
            if nd.drop:
                return  # a push into a cut link vanishes silently
        data = pickle.dumps(("push", method, payload), protocol=5)
        try:
            with self._lock:
                self._sock.sendall(_LEN.pack(len(data)) + data)
        except OSError as e:
            # Surface dead sockets as RpcError so callers' fallback paths
            # fire instead of a raw BrokenPipeError escaping to user code.
            raise ConnectionLost(f"send to {self.address} failed: {e}") from e

    def close(self):
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except Exception:
            pass
        try:
            self._sock.close()
        except Exception:
            pass

    @property
    def closed(self):
        return self._closed

    @property
    def ready(self) -> bool:
        return not self._closed


# --------------------------------------------------------------------------
# Reconnecting sync client (drivers/workers -> GCS).  The reference keeps
# GCS clients in retry loops against a Redis-backed GCS that may restart
# (reference: gcs_redis_failure_detector.cc, retryable_grpc_client.cc);
# here calls block until the GCS is back (bounded) and then retry.
# --------------------------------------------------------------------------
class ReconnectingRpcClient:
    def __init__(self, address: str, on_push: Callable[[str, Any], None] = None,
                 on_reconnect: Callable[[], None] = None,
                 on_giveup: Callable[[], None] = None, peer_name: str = ""):
        self.address = address
        self.on_push = on_push
        self.on_reconnect = on_reconnect
        self.on_giveup = on_giveup
        self.peer_name = peer_name
        self._closed = False
        self._ready = threading.Event()
        self._lock = threading.Lock()
        self._inner = RpcClient(address, on_push=on_push, on_close=self._on_inner_close,
                                peer_name=peer_name)
        self._ready.set()

    def _on_inner_close(self):
        if self._closed:
            return
        self._ready.clear()
        threading.Thread(target=self._reconnect_loop, daemon=True,
                         name=f"rpc-reconnect-{self.address[-16:]}").start()

    def _reconnect_loop(self):
        bo = retry.RECONNECT.start(deadline_s=CONFIG.gcs_reconnect_timeout_s)
        while not self._closed:
            try:
                inner = RpcClient(self.address, on_push=self.on_push,
                                  on_close=self._on_inner_close,
                                  peer_name=self.peer_name)
            except RpcError:
                delay = bo.next_delay()
                if delay is None:
                    break
                time.sleep(delay)
                continue
            with self._lock:
                self._inner = inner
            self._ready.set()  # before on_reconnect: its calls go via _client()
            if self.on_reconnect is not None:
                try:
                    self.on_reconnect()
                except Exception:
                    pass
            return
        self._closed = True
        self._ready.set()  # unblock waiters; calls will raise
        if self.on_giveup is not None:
            try:
                self.on_giveup()
            except Exception:
                pass

    def _client(self) -> RpcClient:
        # Block while a reconnect is in progress (bounded by the loop).
        self._ready.wait(CONFIG.gcs_reconnect_timeout_s + 5)
        if self._closed:
            raise ConnectionLost(f"gave up reconnecting to {self.address}")
        with self._lock:
            return self._inner

    def call(self, method: str, payload: Any = None, timeout: float = _UNSET_TIMEOUT):
        for _ in range(2):
            inner = self._client()
            try:
                return inner.call(method, payload, timeout)
            except ConnectionLost:
                if self._closed:
                    raise
                # wait for reconnect, retry once.  A send can fail before
                # the dead connection's reader has marked it closed and
                # run the close callback that starts the reconnect: the
                # retry waits for the reader to end (briefly: a
                # ConnectionLost that the peer returned leaves the
                # connection open) rather than fail again on the same
                # connection
                reader = inner._reader
                if reader is not threading.current_thread():
                    reader.join(timeout=1.0)
                with self._lock:
                    if inner._closed and self._inner is inner:
                        self._ready.clear()  # the close callback's reconnect sets it
                continue
        raise ConnectionLost(f"connection to {self.address} lost")

    def push(self, method: str, payload: Any = None):
        for _ in range(2):
            if not self._ready.is_set():
                # Reconnect in progress.  Pushes are best-effort by
                # contract (every caller catches and compensates) — fail
                # fast rather than parking the caller for the whole
                # reconnect window: a blocking push here once stalled
                # stream consumption for the full 60 s GCS outage budget
                # (found by the gcs-restart-mid-stream drill).
                raise ConnectionLost(f"reconnecting to {self.address}")
            try:
                return self._client().push(method, payload)
            except ConnectionLost:
                if self._closed:
                    raise
                continue
        raise ConnectionLost(f"connection to {self.address} lost")

    def close(self):
        self._closed = True
        self._ready.set()
        with self._lock:
            inner = self._inner
        try:
            inner.close()
        except Exception:
            pass

    @property
    def closed(self):
        return self._closed

    @property
    def ready(self) -> bool:
        """Non-blocking liveness probe: False while a reconnect is in
        progress (calls would park on the reconnect gate) or after
        give-up.  Best-effort callers consult this instead of blocking."""
        return self._ready.is_set() and not self._closed


# --------------------------------------------------------------------------
# Idempotent reads.  GCS lookups (kv_get, object locations) are safe to
# re-ask on a lost reply — re-reading returns the same (or fresher) value
# with no side effects — so a CallTimeout becomes a bounded retry instead
# of an immediate failure.
# --------------------------------------------------------------------------
def call_idempotent(client, method: str, payload: Any = None,
                    timeout: float = _UNSET_TIMEOUT, policy=None):
    """Sync read with CallTimeout retries under retry.GCS_READ (or the
    given policy).  Only for idempotent methods — never writes."""
    bo = (policy or retry.GCS_READ).start()
    while True:
        try:
            if timeout is _UNSET_TIMEOUT:
                return client.call(method, payload)
            return client.call(method, payload, timeout=timeout)
        except CallTimeout:
            delay = bo.next_delay()
            if delay is None:
                raise
            time.sleep(delay)


async def call_idempotent_async(client, method: str, payload: Any = None,
                                timeout: float = _UNSET_TIMEOUT, policy=None):
    """Async twin of call_idempotent for service-to-service reads."""
    bo = (policy or retry.GCS_READ).start()
    while True:
        try:
            if timeout is _UNSET_TIMEOUT:
                return await client.call(method, payload)
            return await client.call(method, payload, timeout=timeout)
        except CallTimeout:
            delay = bo.next_delay()
            if delay is None:
                raise
            await asyncio.sleep(delay)
