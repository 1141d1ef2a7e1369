"""Serve router→replica channel dataplane.

The serve hot path used to pay one actor RPC per request and one
object-store item per streamed token.  This module rides the compiled
dataplane instead: per replica, the router attaches ONE pair of
persistent channels (mmap ring same-node, socket cross-node — the same
compile-time placement rule as compiled DAGs) and multiplexes every
call and token stream over them in the binary wire format.  One
request frame per call, one response frame per result/token — no task
submission, no object store, no pickling for fast-path payloads.

Frames (wire-encoded tuples):

    router → replica:  (kind, req_id, method, args, kwargs, model_id
                        [, request_meta])
                       kind = "call" | "stream" | "cancel"
                       request_meta: optional identity dict ({"tenant",
                       "slo"}) — receivers slice ``frame[:6]`` and treat
                       the 7th element as optional, so 6-tuple senders
                       (cancel frames, older routers) stay compatible
    replica → router:  (kind, req_id, payload)
                       kind = "r" result | "s" stream item |
                              "end" stream end | "e" error (RayTaskError)

Attach is best-effort: any failure (old replica, config off, channel
death) falls the affected replica back to the per-call RPC path — the
dataplane is an optimization, never a correctness dependency.

Port of ``ray_tpu/serve/_private/dataplane.py``.  One addition:
``SERVED`` counts, in plain ints of the replica's process, the calls,
streams and stream items its dataplane served.  The reference's
``serve_dataplane_*`` counters are the router's (the proxy's process,
items folded in batches of 256), so they cannot show from the replica
that a request did not fall back to RPC; these can.
"""

from __future__ import annotations

import os
import queue
import threading
import uuid
from typing import Any, Dict, Optional, Tuple

from ray_tpu_torch.experimental.channel import (
    Channel,
    ChannelClosed,
    ChannelCorruptionError,
    SocketListener,
    dial,
    node_hosts,
    reattach,
)

_DEAD = object()  # rx-thread sentinel fanned out to every waiter on death

#: Requests and stream items served over the dataplane in this (replica)
#: process; the replica's event loop is the only writer.
SERVED = {"call": 0, "stream": 0, "stream_items": 0}


class ReplicaDataplane:
    """Replica-side endpoint: lives inside the replica actor.  A daemon
    rx thread reads request frames and schedules them onto the replica's
    asyncio loop (the same handle_request/handle_request_stream paths as
    RPC — semaphores, stats and shed bounds all apply); a daemon tx
    thread serializes response frames (single-writer contract) so the
    event loop never blocks on channel flow control."""

    def __init__(self, replica, spec: dict):
        import asyncio

        self._replica = replica
        self._loop = asyncio.get_running_loop()
        self._out_q: "queue.Queue" = queue.Queue()
        self._tasks: Dict[int, Any] = {}  # req_id -> asyncio.Task (cancel)
        # Cancels that arrived before their request's dispatch coroutine
        # registered its task (stream + immediate disconnect race): the
        # dispatch checks this set at start so the cancel can't be lost.
        self._pre_cancelled: set = set()
        self._closed = False
        # Guards _req: the rx thread binds it after a socket accept while
        # shutdown (tx thread or event loop) snapshots it for close.
        self._chan_lock = threading.Lock()
        self._req = None
        self._resp = None
        self._req_listener: Optional[SocketListener] = None
        self.req_port: Optional[int] = None
        if spec["kind"] == "ring":
            self._req = Channel(spec["req_path"])
            self._resp = Channel(spec["resp_path"])
        else:
            self._req_listener = SocketListener()
            self.req_port = self._req_listener.port
            self._resp = dial(tuple(spec["resp_addr"]), "write")
        self._rx = threading.Thread(
            target=self._rx_loop, daemon=True, name="serve-dataplane-rx"
        )
        self._tx = threading.Thread(
            target=self._tx_loop, daemon=True, name="serve-dataplane-tx"
        )
        self._rx.start()
        self._tx.start()

    # -- request side ---------------------------------------------------
    def _rx_loop(self) -> None:
        import asyncio

        try:
            if self._req_listener is not None:
                accepted = self._req_listener.accept("read", timeout=30.0)
                with self._chan_lock:
                    self._req = accepted
            while True:
                try:
                    _tag, frame, tctx = self._req.read_value_traced(timeout=None)
                except ChannelCorruptionError as e:
                    # The corrupted frame is consumed and its request id
                    # unknowable — nothing wrong is ever dispatched.
                    # The router's call/stream surfaces a typed timeout/
                    # ActorDiedError, never a garbage payload.  A
                    # NON-advancing corruption (torn framing) would spin
                    # on the same garbage forever: detach instead (the
                    # router falls back to the RPC path).
                    if e.advanced:
                        continue
                    raise
                except ChannelClosed:
                    # Connection-level death: one shared reattach (the
                    # router's writer re-dials with the pairing token)
                    # before detaching back to the RPC path.
                    if reattach(self._req):
                        continue
                    raise
                kind, rid, method, args, kwargs, model_id = frame[:6]
                meta = frame[6] if len(frame) > 6 else None
                if kind == "cancel":
                    # park-then-recheck (the dispatch does the mirrored
                    # register-then-check): whichever side runs second
                    # sees the other's write, so the cancel can't be
                    # lost to the scheduling race
                    self._pre_cancelled.add(rid)
                    task = self._tasks.get(rid)
                    if task is not None:
                        self._pre_cancelled.discard(rid)
                        self._loop.call_soon_threadsafe(task.cancel)
                    continue
                asyncio.run_coroutine_threadsafe(
                    self._dispatch(
                        kind, rid, method, tuple(args), dict(kwargs or {}),
                        model_id, tctx, meta,
                    ),
                    self._loop,
                )
        except (ChannelClosed, Exception):  # noqa: BLE001 — rx death = detach
            self.shutdown()

    async def _dispatch(self, kind, rid, method, args, kwargs, model_id,
                        tctx=None, request_meta=None) -> None:
        import asyncio
        import time as _time

        from ray_tpu_torch import exceptions
        from ray_tpu_torch.util import tracing

        # Adopt the request frame's trace context PER EXECUTION (the
        # dispatch task owns a fresh contextvar context, so this never
        # leaks into other requests); engine spans and the response
        # frames below then chain under the inbound hop.
        if tctx is not None:
            tracing.set_frame_context(tctx)
        t0 = _time.time()
        put = self._put_frame
        self._tasks[rid] = asyncio.current_task()
        if rid in self._pre_cancelled:
            # the cancel frame won the race with this coroutine
            self._pre_cancelled.discard(rid)
            self._tasks.pop(rid, None)
            put(("end", rid, None))
            return
        SERVED[kind] += 1
        try:
            if kind == "call":
                result = await self._replica.handle_request(
                    method, args, kwargs, model_id, request_meta
                )
                put(("r", rid, result))
            else:
                agen = self._replica.handle_request_stream(
                    method, args, kwargs, model_id, request_meta
                )
                async for item in agen:
                    SERVED["stream_items"] += 1
                    put(("s", rid, item))
                put(("end", rid, None))
        except asyncio.CancelledError:
            put(("end", rid, None))
        except Exception as e:  # noqa: BLE001 — ships to the caller like RPC
            put(
                ("e", rid, exceptions.RayTaskError.from_exception(e, f"serve.{method}"))
            )
        finally:
            self._tasks.pop(rid, None)
            if tctx is not None:
                # The dispatch's own span: the parent every engine span
                # and response-frame write span links through.
                tracing.record_span(
                    f"serve.replica.{kind}", t0, _time.time(),
                    {"method": method},
                    context=tracing.current_context(),
                )

    def _put_frame(self, frame) -> None:
        """Enqueue a response frame with the dispatch task's trace
        context attached, so the tx thread's channel write parents
        correctly (the tx thread itself has no ambient context)."""
        from ray_tpu_torch.util import tracing

        self._out_q.put((frame, tracing.current_context()))

    # -- response side --------------------------------------------------
    def _tx_loop(self) -> None:
        from ray_tpu_torch.util import tracing

        while True:
            item = self._out_q.get()
            if item is None:
                return
            frame, rctx = item
            try:
                if rctx is not None:
                    tok = tracing.adopt_context(rctx)
                    try:
                        self._resp.write_value(frame, timeout=None)
                    finally:
                        tracing.reset_context(tok)
                else:
                    self._resp.write_value(frame, timeout=None)
            except (ChannelClosed, Exception):  # noqa: BLE001
                self.shutdown()
                return

    def shutdown(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._out_q.put(None)
        with self._chan_lock:
            chans = (self._req, self._resp)
        for chan in chans:
            try:
                if chan is not None:
                    chan.close()
            except Exception:  # noqa: BLE001
                pass
        if self._req_listener is not None:
            self._req_listener.close()


class ChannelFuture:
    """One in-flight dataplane call; duck-compatible with ray_tpu_torch.get via
    ``__channel_get__`` so the proxy's await path needs no changes."""

    def __init__(self, client: "ChannelClient", rid: int, q: "queue.Queue"):
        self._client = client
        self._rid = rid
        self._q = q

    def __channel_get__(self, timeout: Optional[float]):
        from ray_tpu_torch import exceptions

        try:
            frame = self._q.get(timeout=timeout)
        except queue.Empty:
            # stay registered: a retried get() on this future must still
            # resolve when the response frame lands (ObjectRef parity)
            raise exceptions.GetTimeoutError(
                f"dataplane call {self._rid} not ready within {timeout}s"
            ) from None
        # one response per call: the waiter slot is done once resolved
        self._client._done(self._rid)
        if frame is _DEAD:
            raise exceptions.ActorDiedError(
                f"replica channel to {self._client.replica_id} died"
            )
        kind, _rid, payload = frame
        if kind == "e":
            raise payload.as_instanceof_cause()
        return payload


class ChannelStream:
    """One in-flight dataplane stream; consumed by the serve handle's
    DeploymentResponseGenerator (iteration, try_next, close)."""

    _is_channel_stream = True

    def __init__(self, client: "ChannelClient", rid: int, q: "queue.Queue"):
        self._client = client
        self._rid = rid
        self._q = q
        self._done = False

    def _finish(self) -> None:
        if not self._done:
            self._done = True
            self._client._done(self._rid)

    def _resolve(self, frame):
        from ray_tpu_torch import exceptions

        if frame is _DEAD:
            self._finish()
            raise exceptions.ActorDiedError(
                f"replica channel to {self._client.replica_id} died"
            )
        kind, _rid, payload = frame
        if kind == "s":
            return payload
        self._finish()
        if kind == "e":
            raise payload.as_instanceof_cause()
        raise StopIteration  # "end"

    def __iter__(self):
        while True:
            try:
                yield self._resolve(self._q.get())
            except StopIteration:
                return

    def try_next(self):
        """Non-blocking poll: next item if ready, None otherwise; raises
        StopIteration at end of stream (or the deployment's error)."""
        try:
            frame = self._q.get_nowait()
        except queue.Empty:
            return None
        return self._resolve(frame)

    def close(self) -> None:
        """Client went away: tell the replica to cancel the request (the
        same disconnect-cancel semantics as the RPC stream path)."""
        if not self._done:
            try:
                self._client._send(("cancel", self._rid, None, None, None, None))
            except Exception:  # noqa: BLE001
                pass
            self._finish()


class ChannelClient:
    """Router-side endpoint: one per (router, replica).  Thread-safe —
    proxy executor threads multiplex concurrent calls/streams over the
    single request channel under a send lock; one daemon rx thread
    demultiplexes response frames into per-request queues."""

    def __init__(self, replica_id: str, req_chan, resp_chan):
        self.replica_id = replica_id
        self.dead = False
        self._req = req_chan
        self._resp = resp_chan
        self._send_lock = threading.Lock()
        self._waiters: Dict[int, "queue.Queue"] = {}
        self._waiters_lock = threading.Lock()
        self._next_rid = 0
        self._rx = threading.Thread(
            target=self._rx_loop, daemon=True, name="serve-dataplane-client-rx"
        )
        self._rx.start()

    # -- attach ---------------------------------------------------------
    @classmethod
    def attach(cls, replica_id: str, actor) -> "ChannelClient":
        """Build the channel pair to one replica.  Placement decides the
        transport exactly like compiled DAGs: same node → two shm rings,
        cross node → two socket connections (replica listens for
        requests, router listens for responses)."""
        import ray_tpu_torch
        from ray_tpu_torch._private.ids import ActorID, NodeID
        from ray_tpu_torch._private.worker import get_global_worker

        worker = get_global_worker()
        my_node = worker.node_id.hex() if worker.node_id is not None else ""
        replica_node = None
        for a in worker.gcs_client.call("list_actors", None):
            if ActorID(a["actor_id"]) == actor._actor_id:
                replica_node = NodeID(a["node_id"]).hex() if a.get("node_id") else None
                break
        if replica_node is None:
            raise RuntimeError(f"replica {replica_id} has no node yet")

        if replica_node == my_node:
            from ray_tpu_torch.experimental.channel import ring_base_dir

            d = os.path.join(ring_base_dir(), f"ray_tpu_torch_serve_{uuid.uuid4().hex[:12]}")
            os.makedirs(d, exist_ok=True)
            req_path = os.path.join(d, "req")
            resp_path = os.path.join(d, "resp")
            Channel.create_file(req_path)
            Channel.create_file(resp_path)
            spec = {"kind": "ring", "req_path": req_path, "resp_path": resp_path}
            ray_tpu_torch.get(actor.dataplane_attach.remote(spec), timeout=30)
            client = cls(replica_id, Channel(req_path), Channel(resp_path))
            client._ring_dir = d
            # tmpfs must not outlive an abandoned router (mirror the
            # compiled-DAG ring-dir finalizer)
            import shutil
            import weakref

            client._ring_finalizer = weakref.finalize(
                client, shutil.rmtree, d, ignore_errors=True
            )
            return client
        hosts = node_hosts(worker)
        listener = SocketListener()
        spec = {
            "kind": "socket",
            "resp_addr": (hosts.get(my_node, "127.0.0.1"), listener.port),
        }
        try:
            reply = ray_tpu_torch.get(actor.dataplane_attach.remote(spec), timeout=30)
            req = dial((hosts.get(replica_node, "127.0.0.1"), reply["req_port"]), "write")
        except Exception:
            listener.close()
            raise
        resp = listener.accept("read", timeout=30.0)
        return cls(replica_id, req, resp)

    # -- demux ----------------------------------------------------------
    def _rx_loop(self) -> None:
        from ray_tpu_torch._private import telemetry

        items = 0
        try:
            while True:
                try:
                    # read_value_traced records the response hop span
                    # (write→read queue wait); the frame context itself
                    # ends here — the waiter thread owns the caller span.
                    _tag, frame, _tctx = self._resp.read_value_traced(timeout=None)
                except ChannelCorruptionError:
                    # A response frame is gone and its request id with
                    # it: the waiter would hang, so the affected client
                    # fails over like a replica death — every in-flight
                    # request gets the typed ActorDiedError and the
                    # router evicts + falls back to RPC.  Zero corrupted
                    # values ever reach user code.
                    raise
                except ChannelClosed:
                    # Transient connection loss: one shared reattach
                    # (epoch bump + seq replay) keeps every in-flight
                    # call/stream alive; failure falls through to the
                    # death path below.
                    if reattach(self._resp):
                        continue
                    raise
                rid = frame[1]
                with self._waiters_lock:
                    q = self._waiters.get(rid)
                if q is not None:
                    q.put(frame)
                if frame[0] == "s":
                    items += 1
                    if items >= 256:
                        telemetry.count_serve_dataplane_items(items)
                        items = 0
        except (ChannelClosed, Exception):  # noqa: BLE001 — channel death
            self.dead = True
            telemetry.count_serve_dataplane_items(items)
            with self._waiters_lock:
                waiters = list(self._waiters.values())
            for q in waiters:
                q.put(_DEAD)

    def _register(self) -> Tuple[int, "queue.Queue"]:
        q: "queue.Queue" = queue.Queue()
        with self._waiters_lock:
            self._next_rid += 1
            rid = self._next_rid
            self._waiters[rid] = q
        return rid, q

    def _done(self, rid: int) -> None:
        with self._waiters_lock:
            self._waiters.pop(rid, None)

    def _send(self, frame) -> None:
        if self.dead:
            raise ChannelClosed(self.replica_id)
        with self._send_lock:
            self._req.write_value(frame)

    # -- public ---------------------------------------------------------
    def call(self, method: str, args: tuple, kwargs: dict, model_id: str = "",
             request_meta: Optional[dict] = None) -> ChannelFuture:
        from ray_tpu_torch._private import telemetry

        rid, q = self._register()
        try:
            self._send(("call", rid, method, tuple(args), dict(kwargs or {}),
                        model_id, request_meta))
        except Exception:
            self._done(rid)
            raise
        telemetry.count_serve_dataplane_request("call")
        return ChannelFuture(self, rid, q)

    def stream(self, method: str, args: tuple, kwargs: dict, model_id: str = "",
               request_meta: Optional[dict] = None) -> ChannelStream:
        from ray_tpu_torch._private import telemetry

        rid, q = self._register()
        try:
            self._send(("stream", rid, method, tuple(args), dict(kwargs or {}),
                        model_id, request_meta))
        except Exception:
            self._done(rid)
            raise
        telemetry.count_serve_dataplane_request("stream")
        return ChannelStream(self, rid, q)

    def close(self) -> None:
        self.dead = True
        for chan in (self._req, self._resp):
            try:
                chan.close()
            except Exception:  # noqa: BLE001
                pass
        import shutil

        shutil.rmtree(getattr(self, "_ring_dir", ""), ignore_errors=True)
