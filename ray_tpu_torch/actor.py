"""@ray_tpu_torch.remote on classes: ActorClass / ActorHandle / ActorMethod
(reference: python/ray/actor.py:602 ActorClass, :890 _remote, :1265
ActorHandle)."""

from __future__ import annotations

import inspect
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.ids import ActorID
from ray_tpu_torch._private.worker import get_global_worker

_DEFAULT_ACTOR_OPTIONS = dict(
    num_cpus=None,
    num_gpus=None,
    memory=None,
    resources=None,
    max_restarts=0,
    max_task_retries=0,
    max_concurrency=None,
    name=None,
    namespace=None,
    lifetime=None,
    scheduling_strategy=None,
    placement_group=None,
    placement_group_bundle_index=-1,
    runtime_env=None,
    # name -> max parallel calls; methods opt in via
    # @ray_tpu_torch.method(concurrency_group="name") (reference:
    # core_worker/concurrency_group_manager.h).
    concurrency_groups=None,
)


def method(**kwargs):
    """@ray_tpu_torch.method(num_returns=2, concurrency_group="io") decorator
    on actor methods."""

    def decorator(m):
        m.__ray_num_returns__ = kwargs.get("num_returns", 1)
        if kwargs.get("concurrency_group") is not None:
            m.__ray_concurrency_group__ = kwargs["concurrency_group"]
        return m

    return decorator


class ActorMethod:
    def __init__(
        self,
        handle: "ActorHandle",
        method_name: str,
        num_returns: int = 1,
        concurrency_group: Optional[str] = None,
    ):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns
        self._concurrency_group = concurrency_group

    def remote(self, *args, **kwargs):
        return self._handle._submit(
            self._method_name,
            args,
            kwargs,
            {
                "num_returns": self._num_returns,
                "concurrency_group": self._concurrency_group,
            },
        )

    def options(self, **opts):
        bound = ActorMethod(
            self._handle,
            self._method_name,
            opts.get("num_returns", self._num_returns),
            opts.get("concurrency_group", self._concurrency_group),
        )
        return bound

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor method '{self._method_name}' cannot be called directly; use .remote()."
        )


class ActorHandle:
    def __init__(self, actor_id: ActorID, method_meta: Dict[str, int], class_name: str = ""):
        self._actor_id = actor_id
        self._method_meta = method_meta
        self._class_name = class_name

    @property
    def _id(self) -> ActorID:
        return self._actor_id

    def __getattr__(self, name: str) -> ActorMethod:
        meta = self.__dict__.get("_method_meta") or {}
        if name == "__ray_call__":
            # Run an arbitrary function against the actor instance:
            # handle.__ray_call__.remote(lambda self, x: ..., x)
            return ActorMethod(self, "__ray_call__", 1)
        if name.startswith("_"):
            raise AttributeError(name)
        if name not in meta:
            raise AttributeError(f"Actor {self._class_name} has no method '{name}'")
        entry = meta[name]
        if isinstance(entry, tuple):
            return ActorMethod(self, name, entry[0], entry[1])
        return ActorMethod(self, name, entry)  # legacy int-only meta

    def _submit(self, method_name: str, args, kwargs, options: dict):
        worker = get_global_worker()
        refs = worker.submit_actor_task(self._actor_id, method_name, args, kwargs, options)
        num_returns = options.get("num_returns", 1)
        if num_returns == "streaming":
            return refs  # an ObjectRefGenerator
        if num_returns == 1:
            return refs[0]
        return refs

    def __ray_terminate__(self):
        return self._submit("__ray_terminate__", (), {}, {"num_returns": 1})

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()[:12]})"

    def __reduce__(self):
        return (_restore_handle, (self._actor_id.binary(), self._method_meta, self._class_name))

    def __hash__(self):
        return hash(self._actor_id)

    def __eq__(self, other):
        return isinstance(other, ActorHandle) and other._actor_id == self._actor_id


def _restore_handle(actor_id_bytes, method_meta, class_name):
    return ActorHandle(ActorID(actor_id_bytes), method_meta, class_name)


def _method_meta_for(cls) -> Dict[str, tuple]:
    """name -> (num_returns, concurrency_group)."""
    meta = {}
    for name, m in inspect.getmembers(cls, predicate=callable):
        if name.startswith("__") and name not in ("__call__",):
            continue
        meta[name] = (
            getattr(m, "__ray_num_returns__", 1),
            getattr(m, "__ray_concurrency_group__", None),
        )
    return meta


class ActorClass:
    def __init__(self, cls, options: Optional[Dict[str, Any]] = None):
        self._cls = cls
        self._options = dict(_DEFAULT_ACTOR_OPTIONS)
        if options:
            self._options.update(options)
        self._cls_blob: Optional[bytes] = None
        self.__name__ = cls.__name__
        self.__module__ = cls.__module__
        self.__qualname__ = cls.__qualname__
        self.__doc__ = cls.__doc__

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class '{self.__name__}' cannot be instantiated directly. "
            f"Use '{self.__name__}.remote()' instead."
        )

    def options(self, **options) -> "ActorClass":
        new = dict(self._options)
        new.update(options)
        ac = ActorClass(self._cls, new)
        ac._cls_blob = self._cls_blob
        return ac

    def _blob(self) -> bytes:
        if self._cls_blob is None:
            self._cls_blob = serialization.dumps_function(self._cls)
        return self._cls_blob

    def remote(self, *args, **kwargs) -> ActorHandle:
        worker = get_global_worker()
        opts = dict(self._options)
        if opts.get("max_concurrency") is None:
            # Async actors default to high concurrency like the reference.
            has_async = any(
                inspect.iscoroutinefunction(m)
                for _, m in inspect.getmembers(self._cls, inspect.isfunction)
            )
            opts["max_concurrency"] = 1000 if has_async else 1
        actor_id = worker.create_actor(
            self._blob(), f"{self._cls.__module__}.{self._cls.__qualname__}", args, kwargs, opts
        )
        return ActorHandle(actor_id, _method_meta_for(self._cls), self._cls.__name__)

    @property
    def bind(self):
        from ray_tpu_torch.dag import bind_actor_class

        return bind_actor_class(self)


def get_actor_handle_from_spec(actor_id: ActorID, spec) -> ActorHandle:
    """Rebuild a handle for ray_tpu_torch.get_actor: unpickle the registered class
    to discover its methods."""
    cls = serialization.loads_function(_fetch_blob(spec))
    return ActorHandle(actor_id, _method_meta_for(cls), cls.__name__)


def _fetch_blob(spec) -> bytes:
    from ray_tpu_torch._private.worker import FUNCTION_KV_NS, get_global_worker

    worker = get_global_worker()
    if getattr(worker, "mode", None) == "client":
        blob = worker.fetch_function_blob(spec.function_key)
    else:
        from ray_tpu_torch._private import retry as _retry
        from ray_tpu_torch._private import rpc as _rpc

        # Actor class blobs can be large: long per-attempt timeout, one
        # retry (worst case ~= the old single-call 120s budget).
        blob = _rpc.call_idempotent(
            worker.gcs_client, "kv_get", (FUNCTION_KV_NS, spec.function_key),
            timeout=60, policy=_retry.GCS_READ_BULK,
        )
    if blob is None:
        raise ValueError("actor class definition missing from GCS")
    return blob
