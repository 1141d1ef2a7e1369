"""Model multiplexing (reference: serve/multiplex.py _ModelMultiplexWrapper
+ serve/api.py @serve.multiplexed / get_multiplexed_model_id).

One replica hosts many models behind an LRU: the decorated async loader
is called at most once per model id per replica (concurrent requests for
the same id await one load), and the least-recently-used model is
evicted (with an optional ``__del__``) past max_num_models_per_replica.
Routers keep soft model→replica affinity so repeat requests for a model
land where it is already resident."""

from __future__ import annotations

import asyncio
import contextvars
import functools
import inspect
from collections import OrderedDict
from typing import Any, Callable, Optional

_model_id_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "serve_multiplexed_model_id", default=""
)


def get_multiplexed_model_id() -> str:
    """The model id of the CURRENT request (reference: serve/api.py
    get_multiplexed_model_id) — set by the replica before invoking the
    user callable when the caller used
    handle.options(multiplexed_model_id=...)."""
    return _model_id_ctx.get()


def _set_request_model_id(model_id: str):
    return _model_id_ctx.set(model_id or "")


class _ModelCache:
    """Per-replica LRU of loaded models with single-flight loads."""

    def __init__(self, loader: Callable, max_models: int):
        self._loader = loader
        self._max = max_models
        self._models: "OrderedDict[str, Any]" = OrderedDict()
        self._loads: dict = {}  # model_id -> asyncio.Future (in-flight)
        self._lock = asyncio.Lock()

    async def get(self, owner, model_id: str) -> Any:
        async with self._lock:
            if model_id in self._models:
                self._models.move_to_end(model_id)
                return self._models[model_id]
            fut = self._loads.get(model_id)
            if fut is None:
                fut = self._loads[model_id] = asyncio.get_event_loop().create_future()
                do_load = True
            else:
                do_load = False
        if not do_load:
            return await asyncio.shield(fut)
        try:
            result = self._loader(owner, model_id)
            if inspect.iscoroutine(result):
                result = await result
        except Exception as e:
            async with self._lock:
                self._loads.pop(model_id, None)
            fut.set_exception(e)
            raise
        async with self._lock:
            self._models[model_id] = result
            self._loads.pop(model_id, None)
            while len(self._models) > self._max:
                _evicted_id, evicted = self._models.popitem(last=False)
                # explicit unload hooks only — calling __del__ directly
                # would run the user's finalizer twice (again at GC)
                for hook in ("__serve_unload__", "close"):
                    fn = getattr(evicted, hook, None)
                    if callable(fn):
                        try:
                            fn()
                        except Exception:
                            pass
                        break
        fut.set_result(result)
        return result

    def loaded_ids(self):
        return list(self._models.keys())


def multiplexed(func: Optional[Callable] = None, *, max_num_models_per_replica: int = 3):
    """Decorator for a deployment's model-loader method::

        @serve.deployment
        class Model:
            @serve.multiplexed(max_num_models_per_replica=4)
            async def get_model(self, model_id: str):
                return load(model_id)

            async def __call__(self, payload):
                model = await self.get_model(serve.get_multiplexed_model_id())
                ...
    """

    def decorate(fn):
        cache_attr = f"__serve_multiplex_cache_{fn.__name__}"

        @functools.wraps(fn)
        async def wrapper(self, model_id: str):
            cache = getattr(self, cache_attr, None)
            if cache is None:
                cache = _ModelCache(fn, max_num_models_per_replica)
                setattr(self, cache_attr, cache)
            return await cache.get(self, model_id)

        wrapper.__serve_multiplexed__ = True
        wrapper._cache_attr = cache_attr
        return wrapper

    if func is not None:
        return decorate(func)
    return decorate
