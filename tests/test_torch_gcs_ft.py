"""GCS fault tolerance on the port (a copy of the JAX package's
tests/test_gcs_ft.py; it imports neither JAX nor the JAX package): kill
+ restart the GCS mid-run.

The cluster must survive: raylets reconnect with backoff and resync,
drivers reattach their job, actors keep serving direct calls throughout
the outage, and work that needs the GCS (new function pushes) blocks and
completes once it's back (reference: redis-backed GCS restart,
gcs/store_client/redis_store_client.h:106, gcs_redis_failure_detector.cc;
test model: python/ray/tests external-redis GCS FT fixtures).
"""

import subprocess
import sys
import threading
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private.config import CONFIG


@pytest.fixture(autouse=True)
def _cluster_settings(monkeypatch):
    """Every process a test spawns runs without the 2 GiB shm arena
    prefault and without the memory monitor: the suite runs many
    clusters at once, and the monitor watches the whole machine."""
    monkeypatch.setenv("RAY_TPU_TORCH_arena_prefault_bytes", "0")
    monkeypatch.setenv("RAY_TPU_TORCH_memory_monitor_enabled", "0")


def _spawn_gcs(session_dir: str, gcs_address: str) -> subprocess.Popen:
    from ray_tpu_torch._private.node import child_env

    return subprocess.Popen(
        [
            sys.executable,
            "-m",
            "ray_tpu_torch._private.gcs_main",
            "--address", gcs_address,
            "--session-dir", session_dir,
            "--config", CONFIG.dump(),
        ],
        env=child_env(),
        start_new_session=True,
    )


def test_gcs_restart_mid_run():
    from ray_tpu_torch._private import node as node_mod

    session_dir = node_mod.new_session_dir()
    gcs_address = f"unix:{session_dir}/sockets/gcs.sock"
    gcs = _spawn_gcs(session_dir, gcs_address)
    raylet_proc = None
    gcs2 = None
    try:
        raylet_proc, _ = node_mod.start_worker_node(
            gcs_address, session_dir, num_cpus=4, wait=True
        )
        ray_tpu_torch.init(address=gcs_address)

        @ray_tpu_torch.remote
        class Counter:
            def __init__(self):
                self.n = 0

            def incr(self):
                self.n += 1
                return self.n

        @ray_tpu_torch.remote
        def f(x):
            return x + 1

        c = Counter.remote()
        assert ray_tpu_torch.get(c.incr.remote(), timeout=60) == 1
        assert ray_tpu_torch.get(f.remote(1), timeout=60) == 2
        time.sleep(1.0)  # let the snapshot loop persist the state above

        # ---- kill the GCS hard ----
        gcs.kill()
        gcs.wait(timeout=10)

        # Running actors keep serving during the outage (direct channels
        # don't involve the GCS).
        assert ray_tpu_torch.get(c.incr.remote(), timeout=30) == 2

        # Work needing the GCS (a NEW function's first push) blocks until
        # the GCS is back, then completes — no error surfaces.
        result = {}

        def submit_new_fn():
            @ray_tpu_torch.remote
            def g(x):
                return x * 3

            result["v"] = ray_tpu_torch.get(g.remote(7), timeout=90)

        t = threading.Thread(target=submit_new_fn, daemon=True)
        t.start()
        time.sleep(1.0)
        assert "v" not in result  # still blocked on the dead GCS

        # ---- restart the GCS against the same session dir ----
        gcs2 = _spawn_gcs(session_dir, gcs_address)
        t.join(timeout=90)
        assert result.get("v") == 21, "queued task did not complete after GCS restart"

        # The actor survived the restart with its state intact.
        assert ray_tpu_torch.get(c.incr.remote(), timeout=60) == 3
        # And the restarted GCS knows about it (restored from snapshot,
        # reconciled with the raylet's live_actors resync).
        from ray_tpu_torch._private.worker import get_global_worker

        w = get_global_worker()
        info = w.gcs_client.call("get_actor_info", c._actor_id.binary())
        assert info is not None and info["state"] == "ALIVE"
    finally:
        ray_tpu_torch.shutdown()
        for p in (gcs2, gcs, raylet_proc):
            if p is not None and p.poll() is None:
                p.terminate()
                try:
                    p.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    p.kill()


def test_gcs_restart_mid_stream():
    """Recovery drill: kill + restart the GCS while a streaming
    generator is mid-flight.  Stream items ride worker->owner pushes, not
    the GCS, so consumption must continue through the outage and the
    stream must complete after the restart — no hang, no lost items."""
    from ray_tpu_torch._private import node as node_mod

    session_dir = node_mod.new_session_dir()
    gcs_address = f"unix:{session_dir}/sockets/gcs.sock"
    gcs = _spawn_gcs(session_dir, gcs_address)
    raylet_proc = None
    gcs2 = None
    try:
        raylet_proc, _ = node_mod.start_worker_node(
            gcs_address, session_dir, num_cpus=4, wait=True
        )
        ray_tpu_torch.init(address=gcs_address)

        @ray_tpu_torch.remote(num_returns="streaming")
        def slowgen(n):
            for i in range(n):
                # graftlint: disable=retry-gate -- test-side condition poll/pacing: the fixed interval is the scan resolution of an assertion with its own deadline, not a retry delay
                time.sleep(0.5)
                yield i * 11

        g = slowgen.remote(10)
        got = [ray_tpu_torch.get(next(g)) for _ in range(2)]

        # ---- kill the GCS hard, mid-stream ----
        gcs.kill()
        gcs.wait(timeout=10)

        # Items keep arriving during the outage.
        got.append(ray_tpu_torch.get(next(g)))

        # ---- restart against the same session dir; drain the rest ----
        gcs2 = _spawn_gcs(session_dir, gcs_address)
        for r in g:
            got.append(ray_tpu_torch.get(r, timeout=60))
        assert got == [i * 11 for i in range(10)]

        # The cluster is still fully functional after the restart.
        @ray_tpu_torch.remote
        def probe():
            return "alive"

        assert ray_tpu_torch.get(probe.remote(), timeout=90) == "alive"
    finally:
        ray_tpu_torch.shutdown()
        for p in (gcs2, gcs, raylet_proc):
            if p is not None and p.poll() is None:
                p.terminate()
                try:
                    p.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    p.kill()


class _MiniRedis:
    """Threaded in-test RESP2 server: SET/GET/PING/AUTH on a dict —
    enough surface to prove RedisSnapshotStore's wire protocol without
    a redis binary (test model: the reference's external-redis FT
    fixtures, hermetic here)."""

    def __init__(self):
        import socket
        import threading as _t

        self.data = {}
        self._srv = socket.create_server(("127.0.0.1", 0))
        self.port = self._srv.getsockname()[1]
        self._stop = False
        self._thread = _t.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        while not self._stop:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            f = conn.makefile("rb")
            try:
                while True:
                    line = f.readline()
                    if not line:
                        break
                    assert line[:1] == b"*", line
                    nargs = int(line[1:-2])
                    args = []
                    for _ in range(nargs):
                        hdr = f.readline()
                        assert hdr[:1] == b"$"
                        n = int(hdr[1:-2])
                        args.append(f.read(n + 2)[:-2])
                    cmd = args[0].upper()
                    if cmd == b"PING":
                        conn.sendall(b"+PONG\r\n")
                    elif cmd == b"AUTH":
                        conn.sendall(b"+OK\r\n")
                    elif cmd == b"SET":
                        self.data[args[1]] = args[2]
                        conn.sendall(b"+OK\r\n")
                    elif cmd == b"GET":
                        v = self.data.get(args[1])
                        if v is None:
                            conn.sendall(b"$-1\r\n")
                        else:
                            conn.sendall(b"$%d\r\n%s\r\n" % (len(v), v))
                    else:
                        conn.sendall(b"-ERR unknown\r\n")
            except Exception:
                pass
            finally:
                conn.close()

    def stop(self):
        self._stop = True
        self._srv.close()


def test_redis_snapshot_store_roundtrip():
    from ray_tpu_torch._private.gcs_store import RedisSnapshotStore, make_snapshot_store

    srv = _MiniRedis()
    try:
        store = RedisSnapshotStore("127.0.0.1", srv.port, key="k1")
        assert store.ping()
        assert store.load() is None
        blob = b"\x00\x01binary\r\nsafe" * 1000
        store.save(blob)
        assert store.load() == blob
        # URI parsing picks the redis backend + custom key
        s2 = make_snapshot_store(f"redis://127.0.0.1:{srv.port}/custom", None)
        s2.save(b"x")
        assert srv.data[b"custom"] == b"x"
    finally:
        srv.stop()


def test_gcs_state_survives_head_node_loss_via_external_redis():
    """With gcs_external_storage=redis://..., a
    REPLACEMENT head (fresh session dir — the old head's disk is gone)
    restores the durable tables from the external store (reference:
    redis_store_client.h head-loss recovery)."""
    from ray_tpu_torch._private import node as node_mod
    from ray_tpu_torch._private import rpc

    srv = _MiniRedis()
    CONFIG._overrides["gcs_external_storage"] = f"redis://127.0.0.1:{srv.port}"
    gcs = gcs2 = None
    raylet_proc = None
    try:
        session_dir = node_mod.new_session_dir()
        gcs_address = f"unix:{session_dir}/sockets/gcs.sock"
        gcs = _spawn_gcs(session_dir, gcs_address)
        raylet_proc, _ = node_mod.start_worker_node(
            gcs_address, session_dir, num_cpus=2, wait=True
        )
        ray_tpu_torch.init(address=gcs_address, namespace="ftns")

        @ray_tpu_torch.remote
        class Keeper:
            def ping(self):
                return "ok"

        k = Keeper.options(name="keeper", lifetime="detached").remote()
        assert ray_tpu_torch.get(k.ping.remote(), timeout=60) == "ok"
        ray_tpu_torch._private.worker.get_global_worker().gcs_client.call(
            "kv_put", ("ns", b"durable-key", b"durable-value", True)
        )
        time.sleep(1.2)  # snapshot loop cadence is 500ms
        assert srv.data, "no snapshot reached the external store"
        ray_tpu_torch.shutdown()

        # ---- the whole head node is lost: kill GCS AND its session dir
        # is abandoned; the replacement head uses a FRESH session dir ----
        gcs.kill()
        gcs.wait(timeout=10)
        session2 = node_mod.new_session_dir()
        gcs2_address = f"unix:{session2}/sockets/gcs.sock"
        gcs2 = _spawn_gcs(session2, gcs2_address)

        deadline = time.time() + 30
        client = None
        while time.time() < deadline:
            try:
                client = rpc.RpcClient(gcs2_address)
                break
            except OSError:
                # graftlint: disable=retry-gate -- test-side condition poll/pacing: the fixed interval is the scan resolution of an assertion with its own deadline, not a retry delay
                time.sleep(0.3)
        assert client is not None, "replacement GCS never came up"
        try:
            named = client.call("get_named_actor", ("ftns", "keeper"))
            assert named is not None, "detached actor lost with the head node"
            assert client.call("kv_get", ("ns", b"durable-key")) == b"durable-value"
        finally:
            client.close()
    finally:
        CONFIG._overrides.pop("gcs_external_storage", None)
        for p in (gcs, gcs2):
            if p is not None and p.poll() is None:
                p.kill()
        if raylet_proc is not None and raylet_proc.poll() is None:
            raylet_proc.terminate()
        srv.stop()
        try:
            ray_tpu_torch.shutdown()
        except Exception:
            pass


def test_kill_while_raylet_away_reaches_it_on_reregistration(monkeypatch):
    """A ray.kill that reaches a restarted GCS before the actor's raylet
    has re-registered finds no client to push the kill to: the GCS marks
    the actor DEAD at once, and when the raylet registers with the actor
    among its live ones, the GCS tells it to kill the worker then (else
    the worker holds its resources, a GPU in chip_smoke.py's GCS drill,
    for good).  The port's own fix; an in-process GCS, no sockets."""
    import asyncio

    from ray_tpu_torch._private import gcs_server
    from ray_tpu_torch._private.common import ActorInfo
    from ray_tpu_torch._private.ids import ActorID, JobID, NodeID

    pushes = []

    class NodeClient:  # the GCS's client to the raylet
        def __init__(self, address, peer_name=None):
            pass

        async def connect(self):
            pass

        async def push(self, method, payload):
            pushes.append((method, payload))

    class Conn:
        meta = {}

    monkeypatch.setattr(gcs_server.rpc, "AsyncRpcClient", NodeClient)
    loop = asyncio.new_event_loop()
    try:
        srv = gcs_server.GcsServer("127.0.0.1:0", {"session_dir": ""}, loop=loop)
        node_id, job_id = NodeID.from_random(), JobID.from_int(1)
        killed, kept = ActorID.of(job_id), ActorID.of(job_id)
        for aid in (killed, kept):
            srv.actors[aid] = ActorInfo(actor_id=aid, name=None, namespace="", class_name="A",
                                        state="ALIVE", node_id=node_id)
        loop.run_until_complete(
            srv.rpc_kill_actor({"actor_id": killed.binary(), "no_restart": True}, Conn()))
        assert srv.actors[killed].state == "DEAD" and pushes == []
        payload = {"node_id": node_id.binary(), "raylet_address": "unix:/nowhere",
                   "object_store_dir": "", "resources_total": {"CPU": 2.0, "GPU": 1.0},
                   "live_actors": [killed.binary(), kept.binary()]}
        loop.run_until_complete(srv.rpc_register_node(payload, Conn()))
        assert pushes == [("kill_actor", {"actor_id": killed.binary()})]
        assert srv.actors[kept].state == "ALIVE"
    finally:
        loop.close()


def test_gcs_client_retry_waits_for_the_reconnect(monkeypatch):
    """A call whose send fails on a GCS that just died can run before the
    dead connection's reader has closed it and started the reconnect: the
    driver's client then retried on the same dead connection and raised
    (a drill's new function failed during the GCS outage).  The retry now
    waits for the reconnect and lands on the new connection.  The port's
    own fix; fake connections, no sockets."""
    from ray_tpu_torch._private import rpc

    made = []

    class Conn:  # connection n: 0 dies on its first call, later ones answer
        def __init__(self, address, on_push=None, on_close=None, peer_name=""):
            self.on_close, self.n, self._closed = on_close, len(made), False
            made.append(self)

        def _reader_notices(self):
            self._closed = True
            self.on_close()

        def call(self, method, payload, timeout):
            if self.n == 0:  # the reader ends 0.2 s after the send fails
                self._reader = threading.Timer(0.2, self._reader_notices)
                self._reader.start()
                raise rpc.ConnectionLost("send failed: broken pipe")
            return (method, self.n)

    monkeypatch.setattr(rpc, "RpcClient", Conn)
    client = rpc.ReconnectingRpcClient("unix:/nowhere")
    assert client.call("kv_put") == ("kv_put", 1)
    client.close()


def test_dial_retries_a_hello_the_listener_dropped(monkeypatch):
    """A GCS killed while a client redials can accept the connection and
    drop it before the client's hello is sent: the send's BrokenPipeError
    escaped the dial and ended a worker's reconnect thread for good (its
    tasks then waited on a GCS it never reached again).  The dial now
    retries it.  The port's own fix; a fake socket."""
    from ray_tpu_torch._private import rpc

    sent = []

    class Sock:
        def __init__(self, *args):
            pass

        def connect(self, target):
            pass

        def sendall(self, data):
            if not sent:
                sent.append("dropped")
                raise BrokenPipeError(32, "Broken pipe")
            sent.append("hello")

        def close(self):
            pass

    monkeypatch.setattr(rpc.socket, "socket", Sock)
    client = rpc.RpcClient.__new__(rpc.RpcClient)  # the dial alone, no reader
    client.address, client.peer_name = "unix:/nowhere", ""
    assert isinstance(client._connect(), Sock)
    assert sent == ["dropped", "hello"]
