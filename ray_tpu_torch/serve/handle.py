"""DeploymentHandle (reference: serve/handle.py): composable handle for
calling deployments from Python or other deployments."""

from __future__ import annotations

from typing import Any, Optional


class DeploymentResponse:
    """Future-like wrapper over the replica call (reference:
    serve/handle.py DeploymentResponse)."""

    def __init__(self, ref, router, replica_id: str):
        self._ref = ref
        self._router = router
        self._replica_id = replica_id
        self._resolved = False
        self._value = None

    def result(self, timeout: Optional[float] = None) -> Any:
        import ray_tpu_torch
        from ray_tpu_torch import exceptions

        if not self._resolved:
            try:
                # _ref is an ObjectRef (RPC path) or a dataplane
                # ChannelFuture — ray_tpu_torch.get resolves both.
                self._value = ray_tpu_torch.get(self._ref, timeout=timeout)
            except exceptions.ActorDiedError:
                # the replica died under this call: evict it from the
                # router so the caller's retry routes elsewhere at once
                self._router.evict(self._replica_id)
                raise
            finally:
                self._router.done(self._replica_id)
                self._resolved = True
        return self._value

    @property
    def object_ref(self):
        return self._ref


class DeploymentResponseGenerator:
    """Streaming response: iterate to receive each yielded item as it
    arrives (reference: serve/handle.py DeploymentResponseGenerator)."""

    def __init__(self, gen, router, replica_id: str):
        self._gen = gen
        self._router = router
        self._replica_id = replica_id
        self._done = False

    def _mark_done(self):
        if not self._done:
            self._done = True
            self._router.done(self._replica_id)

    def __iter__(self):
        import ray_tpu_torch
        from ray_tpu_torch import exceptions

        channel = getattr(self._gen, "_is_channel_stream", False)
        try:
            for item in self._gen:
                # dataplane streams yield values; the RPC streaming
                # plane yields per-item refs
                yield item if channel else ray_tpu_torch.get(item)
        except exceptions.ActorDiedError:
            self._router.evict(self._replica_id)
            raise
        finally:
            self._mark_done()

    def call_same_replica(self, method: str, *args) -> bool:
        """Fire-and-forget a method call on the SAME replica serving this
        stream (disconnect-cancel must reach the engine that owns the
        request — a load-balanced handle call could land on a peer).
        Bypasses router queue accounting (one transient control call);
        returns False when the replica already left the set."""
        actor = self._router.get_replica_actor(self._replica_id)
        if actor is None:
            return False
        actor.handle_request.remote(method, tuple(args), {})
        return True

    def try_next(self):
        """Non-blocking poll: the next yielded VALUE if one is ready,
        None otherwise; raises StopIteration at end of stream (or the
        deployment's error).  Lets one client thread multiplex thousands
        of open streams (the serve bench drives 1k+ this way) instead of
        blocking a thread per stream."""
        import ray_tpu_torch

        try:
            ref = self._gen.try_next()
        except BaseException:
            self._mark_done()
            raise
        if ref is None:
            return None
        if getattr(self._gen, "_is_channel_stream", False):
            return ref  # dataplane streams yield values directly
        return ray_tpu_torch.get(ref)

    def close(self):
        closer = getattr(self._gen, "close", None)
        if closer is not None and getattr(self._gen, "_is_channel_stream", False):
            try:
                closer()  # dataplane disconnect-cancel (frees engine KV)
            except Exception:  # noqa: BLE001
                pass
        self._mark_done()

    def __del__(self):
        # a never-iterated generator must still release its in-flight
        # slot, or the replica's queue estimate inflates forever and
        # pow-2 routing starves it
        try:
            self._mark_done()
        except Exception:
            pass


class _MethodCaller:
    def __init__(self, handle: "DeploymentHandle", method: str):
        self._handle = handle
        self._method = method

    def remote(self, *args, **kwargs):
        return self._handle._call(self._method, args, kwargs)


class DeploymentHandle:
    def __init__(self, deployment_name: str, controller=None,
                 multiplexed_model_id: str = "", stream: bool = False,
                 request_meta: Optional[dict] = None):
        self.deployment_name = deployment_name
        self._controller = controller
        self._router = None
        self._multiplexed_model_id = multiplexed_model_id
        self._stream = stream
        # per-request identity ({"tenant", "slo"}) threaded through the
        # router + dataplane frames to the replica's request context
        self._request_meta = dict(request_meta) if request_meta else None

    def _ensure_router(self):
        if self._router is None:
            from ray_tpu_torch.serve._private.controller import CONTROLLER_NAME
            from ray_tpu_torch.serve._private.router import get_or_create_router

            import ray_tpu_torch

            controller = self._controller or ray_tpu_torch.get_actor(CONTROLLER_NAME, "serve")
            self._controller = controller
            self._router = get_or_create_router(controller, self.deployment_name)
        return self._router

    def _call(self, method: str, args: tuple, kwargs: dict):
        router = self._ensure_router()
        if self._stream:
            gen, rid = router.route_stream(
                method, args, kwargs, self._multiplexed_model_id,
                request_meta=self._request_meta,
            )
            return DeploymentResponseGenerator(gen, router, rid)
        ref, rid = router.route(
            method, args, kwargs, self._multiplexed_model_id,
            request_meta=self._request_meta,
        )
        return DeploymentResponse(ref, router, rid)

    def remote(self, *args, **kwargs):
        return self._call("__call__", args, kwargs)

    def options(self, *, multiplexed_model_id: Optional[str] = None,
                stream: Optional[bool] = None,
                tenant: Optional[str] = None,
                slo_class: Optional[str] = None, **kwargs) -> "DeploymentHandle":
        """A derived handle with per-call options (reference:
        serve/handle.py options — multiplexed_model_id routes to a
        replica holding that model; stream=True makes remote() return a
        DeploymentResponseGenerator over the target's yields; tenant/
        slo_class stamp request identity for the engine's fair queue,
        quotas, and brownout — docs/serving.md).  The derived handle
        SHARES this handle's router so queue estimates and model
        affinity stay coherent."""
        if (multiplexed_model_id is None and stream is None
                and tenant is None and slo_class is None):
            return self
        meta = dict(self._request_meta or {})
        if tenant is not None:
            meta["tenant"] = tenant
        if slo_class is not None:
            meta["slo"] = slo_class
        h = DeploymentHandle(
            self.deployment_name,
            self._controller,
            multiplexed_model_id if multiplexed_model_id is not None
            else self._multiplexed_model_id,
            stream=self._stream if stream is None else stream,
            request_meta=meta or None,
        )
        h._router = self._ensure_router()
        return h

    def __getattr__(self, name: str) -> _MethodCaller:
        if name.startswith("_"):
            raise AttributeError(name)
        return _MethodCaller(self, name)

    def __reduce__(self):
        # handles cross process boundaries by name (the router
        # re-resolves); per-call options like the model id and request
        # identity must survive
        return (
            DeploymentHandle,
            (self.deployment_name, None, self._multiplexed_model_id,
             self._stream, self._request_meta),
        )
