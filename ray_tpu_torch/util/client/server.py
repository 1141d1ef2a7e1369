"""Client server: an ordinary driver that executes API calls on behalf
of remote clients (reference: ray/util/client/server/server.py
RayletServicer — Schedule/Get/Put/Wait/Terminate + per-client refs).
"""

from __future__ import annotations

import logging
import threading
from collections import defaultdict
from typing import Any, Dict

from ray_tpu_torch._private import rpc, serialization
from ray_tpu_torch._private.ids import ActorID, ObjectID

logger = logging.getLogger(__name__)


class ClientServer:
    """Serves the client protocol; one instance per cluster, hosted in
    its own driver process (see server_main.py)."""

    def __init__(self, address: str, loop):
        from ray_tpu_torch._private.worker import get_global_worker

        self.worker = get_global_worker()
        self.loop = loop
        self.server = rpc.RpcServer(self, address, loop)
        self.server.on_disconnect = self._on_disconnect
        # Pinned refs per client connection: conn id -> {id bytes: ObjectRef}
        self.refs: Dict[int, Dict[bytes, Any]] = defaultdict(dict)
        self.actors: Dict[int, set] = defaultdict(set)
        self._lock = threading.Lock()

    async def start(self):
        await self.server.start()
        logger.info("client server listening on %s", self.server.address)

    async def _on_disconnect(self, conn):
        """Client went away: release everything it owned (reference:
        server.py release_all)."""
        with self._lock:
            refs = self.refs.pop(id(conn), {})
            actors = self.actors.pop(id(conn), set())
        refs.clear()  # ObjectRef __del__ drops the pins
        for actor_id in actors:
            try:
                self.worker.kill_actor(ActorID(actor_id), no_restart=True)
            except Exception:  # noqa: BLE001 — named/detached may be shared
                pass

    # -- helpers --------------------------------------------------------
    def _pin(self, conn, refs):
        with self._lock:
            table = self.refs[id(conn)]
            for r in refs:
                table[r.id.binary()] = r

    def _resolve_args(self, conn, packed):
        """Client arg packing: ("v", blob) inline values, ("ref", id)."""
        args = []
        with self._lock:
            table = self.refs[id(conn)]
        for kind, payload in packed:
            if kind == "v":
                args.append(serialization.deserialize(memoryview(payload))[1])
            else:
                ref = table.get(payload)
                if ref is None:
                    from ray_tpu_torch._private.object_ref import ObjectRef

                    ref = ObjectRef(ObjectID(payload), owned=False)
                args.append(ref)
        return args

    # -- protocol -------------------------------------------------------
    async def rpc_client_put(self, payload, conn):
        value = serialization.deserialize(memoryview(payload))[1]
        ref = self.worker.put(value)
        self._pin(conn, [ref])
        return ref.id.binary()

    async def rpc_client_get(self, payload, conn):
        ids, timeout = payload
        from ray_tpu_torch._private.object_ref import ObjectRef

        refs = [ObjectRef(ObjectID(i), owned=False) for i in ids]
        import asyncio

        # Worker.get blocks: keep the server loop responsive.
        values = await asyncio.get_event_loop().run_in_executor(
            None, lambda: self.worker.get(refs, timeout)
        )
        return [serialization.serialize_to_bytes(v) for v in values]

    async def rpc_client_wait(self, payload, conn):
        ids, num_returns, timeout = payload
        from ray_tpu_torch._private.object_ref import ObjectRef

        refs = [ObjectRef(ObjectID(i), owned=False) for i in ids]
        import asyncio

        ready, not_ready = await asyncio.get_event_loop().run_in_executor(
            None, lambda: self.worker.wait(refs, num_returns, timeout, True)
        )
        return ([r.id.binary() for r in ready], [r.id.binary() for r in not_ready])

    async def rpc_client_schedule(self, payload, conn):
        refs = self.worker.submit_task(
            payload["fn_blob"],
            payload["name"],
            tuple(self._resolve_args(conn, payload["args"])),
            {},
            payload["options"],
        )
        if not isinstance(refs, list):  # streaming unsupported over client
            raise ValueError("num_returns='streaming' is not supported over ray://")
        self._pin(conn, refs)
        return [r.id.binary() for r in refs]

    async def rpc_client_create_actor(self, payload, conn):
        actor_id = self.worker.create_actor(
            payload["cls_blob"],
            payload["name"],
            tuple(self._resolve_args(conn, payload["args"])),
            {},
            payload["options"],
        )
        with self._lock:
            if payload["options"].get("lifetime") != "detached":
                self.actors[id(conn)].add(actor_id.binary())
        return actor_id.binary()

    async def rpc_client_actor_call(self, payload, conn):
        refs = self.worker.submit_actor_task(
            ActorID(payload["actor_id"]),
            payload["method"],
            tuple(self._resolve_args(conn, payload["args"])),
            {},
            payload["options"],
        )
        if not isinstance(refs, list):
            raise ValueError("num_returns='streaming' is not supported over ray://")
        self._pin(conn, refs)
        return [r.id.binary() for r in refs]

    async def rpc_client_kill_actor(self, payload, conn):
        self.worker.kill_actor(ActorID(payload["actor_id"]), payload.get("no_restart", True))
        return True

    async def rpc_client_cancel(self, payload, conn):
        self.worker.cancel_task(ObjectID(payload["id"]), force=payload.get("force", False))
        return True

    async def rpc_client_get_named_actor(self, payload, conn):
        name, namespace = payload
        return self.worker.get_named_actor(name, namespace)

    async def push_client_release(self, payload, conn):
        with self._lock:
            table = self.refs.get(id(conn))
            if table:
                for i in payload:
                    table.pop(i, None)

    async def rpc_client_cluster_info(self, payload, conn):
        info = self.worker.gcs_client.call("get_cluster_info")
        return {"num_nodes": len(info["nodes"])}

    async def rpc_client_fetch_function(self, payload, conn):
        import asyncio

        from ray_tpu_torch._private.worker import FUNCTION_KV_NS

        # Class blobs can be MBs: keep the blocking KV get off the loop.
        return await asyncio.get_event_loop().run_in_executor(
            None, lambda: self.worker.gcs_client.call("kv_get", (FUNCTION_KV_NS, payload))
        )

    async def rpc_client_package_exists(self, payload, conn):
        import asyncio

        from ray_tpu_torch._private import runtime_env as runtime_env_mod

        key = payload[len(runtime_env_mod.URI_PREFIX):].encode()
        return await asyncio.get_event_loop().run_in_executor(
            None,
            lambda: bool(
                self.worker.gcs_client.call(
                    "kv_exists", (runtime_env_mod.KV_NS, key)
                )
            ),
        )

    async def rpc_client_upload_package(self, payload, conn):
        """Client-side-packaged runtime_env zip → the cluster's GCS KV
        (reference: ray client uploads working_dir from the remote
        driver's machine, not the server's)."""
        from ray_tpu_torch._private import runtime_env as runtime_env_mod

        uri, blob = payload
        import asyncio

        # A working_dir zip can be hundreds of MB: keep the blocking KV
        # put off the server loop so other clients' RPCs keep flowing.
        await asyncio.get_event_loop().run_in_executor(
            None,
            lambda: runtime_env_mod.finish_uploads(self.worker.gcs_client, [(uri, blob)]),
        )
        return True
