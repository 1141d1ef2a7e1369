"""Client-side worker shim (reference: util/client/worker.py Worker +
common.py Client* stubs).

Implements the slice of the Worker interface that the public API layer
(remote_function.py, actor.py, ray_tpu_torch.get/put/wait) calls, forwarding
every operation to the cluster's client server.  Because the API layer
only talks to `get_global_worker()`, installing a ClientWorker makes
`@ray_tpu_torch.remote`, actor handles, and ObjectRefs work unchanged from a
machine that is not part of the cluster.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private import rpc, serialization
from ray_tpu_torch._private.ids import ActorID, ObjectID
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch.actor import ActorHandle


class _ClientRefCounter:
    """Stands in for ReferenceCounter: batches releases to the server so
    dead client refs unpin their server-side objects."""

    def __init__(self, client: "ClientWorker"):
        self._client = client
        self._counts: Dict[ObjectID, int] = {}
        self._lock = threading.Lock()
        self._to_release: List[bytes] = []

    def add_owned(self, object_id: ObjectID):
        with self._lock:
            self._counts[object_id] = self._counts.get(object_id, 0) + 1

    def remove_owned(self, object_id: ObjectID):
        batch = None
        with self._lock:
            c = self._counts.get(object_id)
            if c is None:
                return
            if c <= 1:
                del self._counts[object_id]
                self._to_release.append(object_id.binary())
                if len(self._to_release) >= 100:
                    batch, self._to_release = self._to_release, []
            else:
                self._counts[object_id] = c - 1
        if batch:
            self._client._release(batch)

    def mark_escaped(self, object_id: ObjectID):
        pass  # server-side pins hold the object

    def flush(self):
        with self._lock:
            batch, self._to_release = self._to_release, []
        if batch:
            self._client._release(batch)


class ClientWorker:
    """mode="client" stand-in for the in-cluster Worker."""

    def __init__(self, address: str, namespace: Optional[str] = None,
                 runtime_env: Optional[dict] = None):
        self.mode = "client"
        self.connected = True
        self._rpc = rpc.RpcClient(address)
        self.reference_counter = _ClientRefCounter(self)
        self.namespace = namespace or "default"
        self.session_info: dict = {}
        self._env_cache: Dict[str, dict] = {}
        info = self._rpc.call("client_cluster_info", None, timeout=30)
        self._num_nodes = info["num_nodes"]
        # The job runtime_env is packaged on THIS machine (local
        # working_dir/py_modules zip from the client's filesystem, like
        # the reference Ray Client's upload-from-remote-driver) and the
        # packages are shipped to the cluster's GCS KV via the server.
        self.job_runtime_env = self._prepare_env(runtime_env)

    def _prepare_env(self, raw: Optional[dict]) -> Optional[dict]:
        """Normalize a runtime_env CLIENT-side: zip local dirs from the
        client filesystem, upload packages through the server, return the
        gcs://-only normalized env safe to evaluate anywhere."""
        import json as _json

        from ray_tpu_torch._private import runtime_env as runtime_env_mod

        if not raw:
            return None
        key = _json.dumps(raw, sort_keys=True, default=str)
        cached = self._env_cache.get(key)
        if cached is not None:
            return cached or None
        def _upload(uri, blob):
            # Content-addressed: skip shipping up to 200 MB over the WAN
            # when the cluster already holds this sha (reference client
            # checks package existence before upload).
            if not self._rpc.call("client_package_exists", uri, timeout=30):
                self._rpc.call("client_upload_package", (uri, blob), timeout=120)

        norm = runtime_env_mod.normalize_uploaded(raw, _upload)
        self._env_cache[key] = norm
        return norm or None

    # -- arg packing (values inline, refs by id) ------------------------
    def _pack_args(self, args: Tuple, kwargs: Dict) -> list:
        if kwargs:
            raise ValueError("kwargs are not supported over ray:// (pass positionally)")
        packed = []
        for a in args:
            if isinstance(a, ObjectRef):
                packed.append(("ref", a.id.binary()))
            else:
                packed.append(("v", serialization.serialize_to_bytes(a)))
        return packed

    def _refs(self, ids: List[bytes]) -> List[ObjectRef]:
        return [ObjectRef(ObjectID(i), owned=True) for i in ids]

    def _release(self, ids: List[bytes]):
        try:
            self._rpc.push("client_release", ids)
        except rpc.RpcError:
            pass

    # -- Worker interface ----------------------------------------------
    def put(self, value: Any) -> ObjectRef:
        oid = self._rpc.call("client_put", serialization.serialize_to_bytes(value))
        return ObjectRef(ObjectID(oid), owned=True)

    def get(self, refs: List[ObjectRef], timeout: Optional[float] = None) -> List[Any]:
        blobs = self._rpc.call(
            "client_get",
            ([r.id.binary() for r in refs], timeout),
            timeout=(timeout + 30) if timeout is not None else None,
        )
        return [serialization.deserialize(memoryview(b))[1] for b in blobs]

    def wait(self, refs, num_returns, timeout, fetch_local=True):
        ready_ids, not_ready_ids = self._rpc.call(
            "client_wait",
            ([r.id.binary() for r in refs], num_returns, timeout),
            timeout=(timeout + 30) if timeout is not None else None,
        )
        by_id = {r.id.binary(): r for r in refs}
        return [by_id[i] for i in ready_ids], [by_id[i] for i in not_ready_ids]

    def submit_task(self, fn_blob, name, args, kwargs, options: dict):
        if options.get("num_returns") == "streaming":
            raise ValueError("num_returns='streaming' is not supported over ray://")
        ids = self._rpc.call(
            "client_schedule",
            {
                "fn_blob": fn_blob,
                "name": name,
                "args": self._pack_args(args, kwargs),
                "options": _client_options(self, options),
            },
        )
        return self._refs(ids)

    def create_actor(self, cls_blob, class_name, args, kwargs, options: dict) -> ActorID:
        aid = self._rpc.call(
            "client_create_actor",
            {
                "cls_blob": cls_blob,
                "name": class_name,
                "args": self._pack_args(args, kwargs),
                "options": _client_options(self, options),
            },
        )
        return ActorID(aid)

    def submit_actor_task(self, actor_id, method_name, args, kwargs, options: dict):
        ids = self._rpc.call(
            "client_actor_call",
            {
                "actor_id": actor_id.binary(),
                "method": method_name,
                "args": self._pack_args(args, kwargs),
                # env + namespace are fixed at actor creation; plain
                # options keep the per-call hot path cheap.
                "options": _plain_options(options),
            },
        )
        return self._refs(ids)

    def kill_actor(self, actor_id, no_restart: bool = True):
        self._rpc.call("client_kill_actor", {"actor_id": actor_id.binary(), "no_restart": no_restart})

    def cancel_task(self, object_id, force: bool = False):
        self._rpc.call("client_cancel", {"id": object_id.binary(), "force": force})

    def fetch_function_blob(self, function_key: bytes) -> Optional[bytes]:
        """Registered function/class blob from the cluster's GCS (used by
        get_actor to rebuild a handle's method table client-side)."""
        return self._rpc.call("client_fetch_function", function_key)

    def get_named_actor(self, name, namespace):
        reply = self._rpc.call(
            "client_get_named_actor", (name, namespace or self.namespace)
        )
        if reply is None:
            raise ValueError(f"Failed to look up actor '{name}'")
        return reply

    def on_ref_serialized(self, object_id):
        pass  # pinned server-side

    def get_async(self, ref):  # pragma: no cover — parity stub
        raise NotImplementedError("await ref is not supported over ray://")

    def _check_connected(self):
        if not self.connected:
            raise RuntimeError("client disconnected")

    def disconnect(self):
        if not self.connected:
            return
        self.reference_counter.flush()
        self.connected = False
        try:
            self._rpc.close()
        except Exception:
            pass


def _plain_options(options: dict) -> dict:
    """Strip client-side-only / unserializable entries."""
    out = {}
    for k, v in options.items():
        if k in ("placement_group",) or k.startswith("_"):
            continue
        if k == "scheduling_strategy" and not isinstance(v, (str, type(None))):
            continue
        out[k] = v
    return out


def _client_options(worker: ClientWorker, options: dict) -> dict:
    """Resolve runtime_env and namespace on the CLIENT before shipping:
    local working_dir paths must mean the client's filesystem, and named
    actors must land in the client driver's namespace, not the client
    server's."""
    from ray_tpu_torch._private import runtime_env as runtime_env_mod

    out = _plain_options(options)
    task_env = worker._prepare_env(out.get("runtime_env"))
    merged = runtime_env_mod.merge(worker.job_runtime_env, task_env)
    if merged:
        out["runtime_env"] = merged
    else:
        out.pop("runtime_env", None)
    if not out.get("namespace"):  # .options() ships namespace=None
        out["namespace"] = worker.namespace
    return out


def connect(address: str, namespace: Optional[str] = None,
            runtime_env: Optional[dict] = None) -> ClientWorker:
    """Install a ClientWorker as the process-global worker.  `address`
    is "ray://host:port" (or a raw tcp:/unix: RPC address)."""
    from ray_tpu_torch._private import worker as worker_mod

    if address.startswith("ray://"):
        address = "tcp:" + address[len("ray://"):]
    client = ClientWorker(address, namespace=namespace, runtime_env=runtime_env)
    with worker_mod._worker_lock:
        worker_mod._global_worker = client
    return client
