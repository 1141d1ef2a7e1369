"""Replica actor (reference: serve/_private/replica.py): hosts one copy of
the user's deployment class/function; async so many requests interleave up
to max_ongoing_requests."""

from __future__ import annotations

import asyncio
import inspect
import time
from typing import Any, Dict, Optional


class Replica:
    def __init__(
        self,
        replica_id: str,
        deployment_name: str,
        serialized_init: tuple,  # (cls_or_fn, args, kwargs)
        user_config: Any = None,
        max_ongoing: int = 100,
    ):
        self.replica_id = replica_id
        self.deployment_name = deployment_name
        target, args, kwargs = serialized_init
        if inspect.isclass(target):
            self.callable = target(*args, **kwargs)
        else:
            self.callable = target
        self.max_ongoing = max_ongoing
        self._ongoing = 0
        self._total = 0
        self._sem = asyncio.Semaphore(max_ongoing)
        if user_config is not None:
            self.reconfigure(user_config)

    def reconfigure(self, user_config: Any):
        """(reference: user_config → replica reconfigure)"""
        fn = getattr(self.callable, "reconfigure", None)
        if fn is not None:
            fn(user_config)

    def _resolve_target(self, method: str):
        """Method dispatch shared by the one-shot and streaming paths."""
        target = self.callable if method == "__call__" else getattr(self.callable, method)
        if method == "__call__" and not callable(target):
            raise AttributeError(f"deployment {self.deployment_name} is not callable")
        if method == "__call__" and hasattr(self.callable, "__call__") and not inspect.isfunction(self.callable):
            target = self.callable.__call__
        return target

    async def handle_request(
        self, method: str, args: tuple, kwargs: dict,
        multiplexed_model_id: str = "", request_meta: Optional[dict] = None,
    ):
        from ray_tpu_torch.serve._private.request_context import _set_request_meta
        from ray_tpu_torch.serve.multiplex import _set_request_model_id

        async with self._sem:
            self._ongoing += 1
            self._total += 1
            _set_request_model_id(multiplexed_model_id)
            _set_request_meta(request_meta)
            try:
                result = self._resolve_target(method)(*args, **kwargs)
                if inspect.iscoroutine(result):
                    result = await result
                return result
            finally:
                self._ongoing -= 1

    async def handle_request_stream(
        self, method: str, args: tuple, kwargs: dict,
        multiplexed_model_id: str = "", request_meta: Optional[dict] = None,
    ):
        """Streaming requests (reference: replica.py handle_request_streaming
        — generator deployments yield response chunks).  Runs as an actor
        STREAMING method: each yielded item becomes one stream element on
        the caller's side (num_returns=\"streaming\")."""
        from ray_tpu_torch.serve._private.request_context import _set_request_meta
        from ray_tpu_torch.serve.multiplex import _set_request_model_id

        async with self._sem:
            self._ongoing += 1
            self._total += 1
            _set_request_model_id(multiplexed_model_id)
            _set_request_meta(request_meta)
            try:
                result = self._resolve_target(method)(*args, **kwargs)
                if inspect.iscoroutine(result):
                    result = await result
                if inspect.isasyncgen(result):
                    async for item in result:
                        yield item
                elif inspect.isgenerator(result) or isinstance(result, (list, tuple)):
                    for item in result:
                        yield item
                else:
                    yield result  # non-generator target: one-element stream
            finally:
                self._ongoing -= 1

    async def dataplane_attach(self, spec: dict) -> Dict[str, Any]:
        """Open this replica's channel-dataplane endpoint (one per
        router client): requests arrive over a persistent channel and
        fan into the SAME handle_request/handle_request_stream paths as
        RPC, so semaphores, stats and shed bounds are identical.  Must
        run on the actor loop (captures it for cross-thread dispatch);
        never blocks — socket accepts happen on the daemon rx thread."""
        from ray_tpu_torch.serve._private.dataplane import ReplicaDataplane

        dp = ReplicaDataplane(self, spec)
        self._dataplanes = getattr(self, "_dataplanes", [])
        self._dataplanes.append(dp)
        return {"ok": True, "req_port": dp.req_port}

    def queue_len(self) -> int:
        """Ongoing requests — the router's power-of-two-choices signal."""
        return self._ongoing

    def stats(self) -> Dict[str, Any]:
        """Replica load snapshot; doubles as the controller's health
        check and autoscaling feed.  A deployment exposing
        ``__serve_stats__`` contributes extra fields — ``queued`` (its
        internal queue depth, e.g. the LLM engine's waiting+running) is
        what queue-depth autoscaling keys on."""
        out = {"replica_id": self.replica_id, "ongoing": self._ongoing,
               "total": self._total, "queued": 0}
        hook = getattr(self.callable, "__serve_stats__", None)
        if callable(hook):
            try:
                extra = hook()
                if isinstance(extra, dict):
                    out.update(extra)
                    # a deployment-reported queue REPLACES ongoing as the
                    # load signal (an open stream sitting in a decode
                    # lane is both — adding would double count)
                    out["has_queue_hook"] = True
            except Exception:  # noqa: BLE001 — stats must not fail health checks
                pass
        return out

    def ping(self) -> Dict[str, Any]:
        """Liveness probe.  Returns placement identity so the controller
        can map this replica to its host node — the gray-failure ladder
        demotes replicas on SUSPECT/QUARANTINED nodes at the router."""
        try:
            from ray_tpu_torch.runtime_context import get_runtime_context

            return {"node_id": get_runtime_context().get_node_id()}
        except Exception:  # noqa: BLE001 — a probe must never fail on identity
            return {"node_id": ""}

    async def prepare_shutdown(self):
        """Graceful teardown: cancel @serve.batch worker tasks (they are
        pending tasks on this loop and would leak past actor kill) and
        run the deployment's async ``__serve_shutdown__`` hook (e.g. the
        LLM engine stops its step loop and frees every KV block)."""
        import inspect as _inspect

        for dp in getattr(self, "_dataplanes", []):
            try:
                dp.shutdown()
            except Exception:  # noqa: BLE001
                pass

        for name in dir(self.callable):
            if name.startswith("__"):
                continue
            try:
                attr = getattr(self.callable, name)
            except Exception:  # noqa: BLE001
                continue
            queues = getattr(attr, "_serve_batch_queues", None)
            if isinstance(queues, dict):
                for q in queues.values():
                    try:
                        q.shutdown()
                    except Exception:  # noqa: BLE001
                        pass
        hook = getattr(self.callable, "__serve_shutdown__", None)
        if callable(hook):
            try:
                result = hook()
                if _inspect.iscoroutine(result):
                    await result
            except Exception:  # noqa: BLE001
                pass
        return True
