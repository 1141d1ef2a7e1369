"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

A package of its own beside ``ray_tpu/``: it imports torch and numpy and
nothing of JAX or of ``ray_tpu``, keeping its own copy of what it needs.
Paths mirror ``ray_tpu/`` (``ray_tpu/models/gpt2.py`` is ported at
``ray_tpu_torch/models/gpt2.py``).  Every Pallas kernel of the reference
on a ported path becomes a hand-written Hopper kernel under
``ops/csrc/``, built with nvcc at first use.

Ported so far:

- the actor runtime on one node (this module's API: ``init``, ``remote``,
  ``get``, ``put``, ``wait``, ``kill``, ``get_actor``, ...; the GCS, the
  raylet, workers and the shared-memory object store), with ``GPU`` as a
  resource counted from the node's NVIDIA device files;
- the trainer on it: ``train.TorchTrainer`` over a ``torch.distributed``
  process group;
- serving: ``serve.llm.LLMEngine`` over GPT-2 with a paged KV cache, its
  prefill attention on the flash-attention forward kernel;
- the model families (``models/``) and their training steps,
  differentiable through the flash-attention kernels
  (``ops/flash_attention.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
The runtime itself never imports torch: device work happens in library
code (``train``, ``models``, ``ops``) inside worker processes.
"""

from __future__ import annotations

import atexit
import os
import threading
from typing import Any, List, Optional, Sequence, Union

from ray_tpu_torch import exceptions
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.ids import ActorID, JobID, NodeID, ObjectID, TaskID, WorkerID
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.streaming import ObjectRefGenerator
from ray_tpu_torch._private.worker import get_global_worker, global_worker_maybe
from ray_tpu_torch.actor import ActorClass, ActorHandle, method
from ray_tpu_torch.remote_function import RemoteFunction
from ray_tpu_torch.runtime_context import get_runtime_context

__version__ = "0.1.0"

__all__ = [
    "init",
    "shutdown",
    "is_initialized",
    "remote",
    "get",
    "put",
    "wait",
    "kill",
    "cancel",
    "get_actor",
    "method",
    "nodes",
    "cluster_resources",
    "available_resources",
    "get_runtime_context",
    "ObjectRef",
    "ObjectRefGenerator",
    "ActorHandle",
    "exceptions",
    "__version__",
]

_init_lock = threading.RLock()
_node_processes = None  # NodeProcesses if this driver started the cluster


def init(
    address: Optional[str] = None,
    *,
    num_cpus: Optional[int] = None,
    num_gpus: Optional[int] = None,
    resources: Optional[dict] = None,
    object_store_memory: Optional[int] = None,
    namespace: Optional[str] = None,
    ignore_reinit_error: bool = False,
    log_to_driver: bool = True,
    runtime_env: Optional[dict] = None,
    tenant: Optional[str] = None,
    priority: Optional[int] = None,
    _system_config: Optional[dict] = None,
    **kwargs,
):
    """Start a new cluster (or connect to an existing one) and connect this
    process as a driver (reference: python/ray/_private/worker.py:1270)."""
    global _node_processes
    from ray_tpu_torch._private import node as node_mod

    if address and address.startswith("ray://"):
        raise NotImplementedError(
            "ray_tpu_torch has no Ray Client (ray://) yet: util/client waits "
            "for ROADMAP Queue A item 6"
        )
    with _init_lock:
        worker = get_global_worker()
        if worker.connected:
            if ignore_reinit_error:
                return RayContext(worker)
            raise RuntimeError("ray_tpu_torch.init() called twice; pass ignore_reinit_error=True to ignore.")
        CONFIG.initialize(_system_config)
        if object_store_memory is not None:
            CONFIG._overrides["object_store_memory_cap"] = int(object_store_memory)
        CONFIG._overrides["log_to_driver"] = bool(log_to_driver)

        if address is None and os.environ.get("RAY_TPU_TORCH_ADDRESS"):
            address = os.environ["RAY_TPU_TORCH_ADDRESS"]
        if address == "auto":
            try:
                with open(node_mod.CLUSTER_ADDRESS_FILE) as f:
                    address = f.read().strip()
            except OSError:
                raise ConnectionError(
                    "address='auto' but no running cluster found: start one by "
                    "calling init() with no address."
                )

        if address is None:
            procs = node_mod.start_head(
                num_cpus=num_cpus, num_gpus=num_gpus, resources=resources
            )
            _node_processes = procs
            gcs_address = procs.gcs_address
            raylet_address = procs.raylet_address
        else:
            gcs_address = address
            raylet_address = node_mod.head_raylet_address(gcs_address)

        # Normalize the job-level runtime env before connecting (local
        # dirs become content-addressed gcs:// URIs); the packages are
        # uploaded right after the GCS connection exists, before any task
        # can be submitted (reference: runtime_env/working_dir.py
        # upload_package_if_needed).
        from ray_tpu_torch._private import runtime_env as _renv

        norm_env, _uploads = _renv.prepare(runtime_env)
        # Multi-tenant job plane: every job carries a tenant (isolation/
        # accounting domain) and a priority class.  The job-submission
        # plane (dashboard job manager) passes them via env so submitted
        # entrypoints inherit without code changes.
        if tenant is None:
            tenant = os.environ.get("RAY_TPU_TORCH_TENANT") or None
        if priority is None and os.environ.get("RAY_TPU_TORCH_PRIORITY"):
            try:
                priority = int(os.environ["RAY_TPU_TORCH_PRIORITY"])
            except ValueError:
                priority = None
        worker.connect_driver(
            gcs_address,
            raylet_address,
            namespace,
            {
                "namespace": namespace or "",
                "runtime_env": norm_env or {},
                "tenant": tenant or "default",
                # None = unset: the GCS applies the tenant's registered
                # default priority; an explicit value always wins.
                "priority": int(priority) if priority is not None else None,
            },
        )
        _renv.finish_uploads(worker.gcs_client, _uploads)
        worker.job_runtime_env = norm_env
        return RayContext(worker)


class RayContext:
    def __init__(self, worker):
        self._worker = worker
        self.address_info = {
            "gcs_address": worker.gcs_client.address if worker.gcs_client else None,
            "raylet_address": worker.raylet_client.address if worker.raylet_client else None,
            "node_id": worker.node_id.hex() if worker.node_id else None,
            "session_dir": worker.session_info.get("session_dir"),
            "webui_url": worker.session_info.get("dashboard_url"),
        }

    @property
    def dashboard_url(self):
        return self.address_info.get("webui_url")

    def __enter__(self):
        return self

    def __exit__(self, *a):
        shutdown()

    def __getitem__(self, key):
        return self.address_info[key]


def shutdown():
    global _node_processes
    with _init_lock:
        worker = global_worker_maybe()
        if worker is not None and worker.connected:
            worker.disconnect()
        if _node_processes is not None:
            _node_processes.terminate()
            _node_processes = None


atexit.register(shutdown)


def is_initialized() -> bool:
    w = global_worker_maybe()
    return w is not None and w.connected


def remote(*args, **kwargs):
    """@ray_tpu_torch.remote decorator for functions and classes
    (reference: python/ray/_private/worker.py:3330)."""

    def make(target):
        import inspect

        if inspect.isclass(target):
            return ActorClass(target, kwargs or None)
        return RemoteFunction(target, kwargs or None)

    if len(args) == 1 and not kwargs and callable(args[0]):
        return make(args[0])
    if args:
        raise TypeError("@remote takes keyword arguments only, e.g. @remote(num_cpus=2)")
    return make


def put(value: Any) -> ObjectRef:
    return get_global_worker().put(value)


def get(refs: Union[ObjectRef, Sequence[ObjectRef]], *, timeout: Optional[float] = None):
    worker = get_global_worker()
    if isinstance(refs, ObjectRef):
        return worker.get([refs], timeout)[0]
    from ray_tpu_torch.dag import CompiledDAGRef

    if isinstance(refs, CompiledDAGRef):
        return refs.get(timeout)  # None = wait forever, like ObjectRefs
    channel_get = getattr(refs, "__channel_get__", None)
    if channel_get is not None:
        # Dataplane futures (e.g. serve's ChannelFuture) resolve like
        # refs so await paths need no transport awareness.
        return channel_get(timeout)
    if not isinstance(refs, (list, tuple)):
        raise TypeError(f"ray_tpu_torch.get takes an ObjectRef or a list of them, got {type(refs)}")
    for r in refs:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"ray_tpu_torch.get list must contain only ObjectRefs, got {type(r)}")
    return worker.get(list(refs), timeout)


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: Optional[float] = None,
    fetch_local: bool = True,
):
    if isinstance(refs, ObjectRef):
        raise TypeError("ray_tpu_torch.wait takes a list of ObjectRefs")
    if num_returns <= 0 or num_returns > len(refs):
        raise ValueError(f"num_returns must be in [1, {len(refs)}]")
    return get_global_worker().wait(list(refs), num_returns, timeout, fetch_local)


def kill(actor: ActorHandle, *, no_restart: bool = True):
    if not isinstance(actor, ActorHandle):
        raise TypeError("ray_tpu_torch.kill() only works on actor handles; use cancel() for tasks")
    get_global_worker().kill_actor(actor._id, no_restart)


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = True):
    """Cancel the task that produces `ref` (reference: core_worker.cc
    CancelTask).  Queued tasks are dropped; a running task gets
    TaskCancelledError raised inside it (force=True kills its worker
    process instead).  Cancelled tasks are never retried; a task that
    already finished is unaffected.  `recursive` is accepted for API
    compatibility (child-task tracking is not implemented — children
    keep running)."""
    worker = get_global_worker()
    worker.cancel_task(ref.id, force=force)


def get_actor(name: str, namespace: Optional[str] = None) -> ActorHandle:
    from ray_tpu_torch.actor import get_actor_handle_from_spec

    worker = get_global_worker()
    reply = worker.get_named_actor(name, namespace)
    return get_actor_handle_from_spec(ActorID(reply["actor_id"]), reply["spec"])


def nodes() -> List[dict]:
    worker = get_global_worker()
    info = worker.gcs_client.call("get_cluster_info")
    out = []
    for n in info["nodes"].values():
        out.append(
            {
                "NodeID": NodeID(n["node_id"]).hex(),
                # DRAINING/SUSPECT/QUARANTINED nodes are still up (paying
                # out a notice or degraded-but-serving); State carries
                # the distinction.
                "Alive": n["state"] in ("ALIVE", "SUSPECT", "DRAINING", "QUARANTINED"),
                "State": n["state"],
                "DrainReason": n.get("drain_reason"),
                "Resources": n["resources_total"],
                "RayletAddress": n["raylet_address"],
                "IsHead": n.get("is_head", False),
                "Hostname": n.get("hostname", ""),
                "Labels": n.get("labels", {}),
            }
        )
    return out


def cluster_resources() -> dict:
    return get_global_worker().gcs_client.call("cluster_resources")


def available_resources() -> dict:
    return get_global_worker().gcs_client.call("available_resources")


# Lazy submodules: the libraries (torch imports) load on first access.
_LAZY_SUBMODULES = ("util", "train", "serve", "dag", "models", "ops", "air", "experimental", "data",
                    "tune", "rllib")


def __getattr__(name):
    if name in _LAZY_SUBMODULES:
        import importlib

        mod = importlib.import_module(f"ray_tpu_torch.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'ray_tpu_torch' has no attribute '{name}'")
