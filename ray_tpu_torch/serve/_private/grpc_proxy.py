"""gRPC proxy actor (reference: serve/_private/proxy.py:538 gRPCProxy +
grpc_util.py).

The reference generates per-application protobuf services; here a
GENERIC handler serves any unary method of the form
``/ray_tpu.serve.UserDefinedService/<DeploymentName>`` with raw-bytes
request/response.  The wire contract deliberately avoids pickle — the
reference uses protobuf precisely so the proxy never deserializes
executable payloads from the network:

- request bytes parsed as JSON ``{"args": [...], "kwargs": {...}}``
  (or any JSON value, passed as the single positional argument);
  non-JSON bytes pass through untouched as one positional ``bytes`` arg
- response: ``bytes`` results pass through; anything else is
  JSON-encoded

Metadata keys: ``multiplexed_model_id`` (model routing) and ``method``
(non-__call__ dispatch).

TYPED services (reference: grpc proxy with generated servicers —
serve/_private/proxy.py:538 + config.grpc_options.grpc_servicer_functions):
pass ``grpc_servicer_functions=["my_pb2_grpc.add_MyServicer_to_server"]``
to serve.start/run.  Each function registers the user's protoc-generated
service on this proxy with a DYNAMIC servicer: every rpc method routes
to the deployment named by ``deployment`` metadata (method name = the
rpc name unless ``method`` metadata overrides), receives the
DESERIALIZED protobuf request message as its argument, and must return
the response message type — the generated (de)serializers enforce the
typed contract on both wire directions."""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Dict

logger = logging.getLogger(__name__)

# The reference's service name, kept: it is the wire contract gRPC
# clients call, like an HTTP route.
SERVICE_PREFIX = "/ray_tpu.serve.UserDefinedService/"


def _import_servicer_function(path: str):
    """'pkg.mod.add_XServicer_to_server' (or 'pkg.mod:attr') → callable."""
    import importlib

    if ":" in path:
        module_name, attr = path.split(":", 1)
    else:
        module_name, _, attr = path.rpartition(".")
    fn = getattr(importlib.import_module(module_name), attr)
    if not callable(fn):
        raise TypeError(f"{path} is not callable")
    return fn


class _DynamicServicer:
    """Stands in for the user's Servicer subclass: protoc's generated
    add_XServicer_to_server reads one attribute per rpc method; each
    lookup yields a proxy handler for that method name."""

    def __init__(self, proxy: "GrpcProxyActor"):
        self._proxy = proxy

    def __getattr__(self, rpc_method: str):
        if rpc_method.startswith("_"):
            raise AttributeError(rpc_method)
        return self._proxy._typed_handler(rpc_method)


class GrpcProxyActor:
    def __init__(self, port: int = 9000, host: str = "127.0.0.1",
                 servicer_functions: tuple = ()):
        self.port = port
        self.host = host
        self.servicer_functions = tuple(servicer_functions)
        self._handles: Dict[str, Any] = {}
        self._started = False
        from concurrent.futures import ThreadPoolExecutor

        # same rationale as the HTTP proxy: routing may block on cold
        # starts, so it runs in a dedicated pool
        self._route_pool = ThreadPoolExecutor(max_workers=32, thread_name_prefix="grpc-route")

    async def ready(self) -> bool:
        if not self._started:
            await self._start()
            self._started = True
        return True

    async def registered_servicers(self) -> tuple:
        return self.servicer_functions

    async def _start(self):
        import grpc

        import ray_tpu_torch
        from ray_tpu_torch.serve._private.controller import CONTROLLER_NAME

        self._controller = ray_tpu_torch.get_actor(CONTROLLER_NAME, "serve")
        proxy = self

        class _Generic(grpc.GenericRpcHandler):
            def service(self, handler_call_details):
                method = handler_call_details.method
                if not method.startswith(SERVICE_PREFIX):
                    return None
                deployment = method[len(SERVICE_PREFIX):]
                return grpc.unary_unary_rpc_method_handler(
                    proxy._make_handler(deployment)
                    # no (de)serializers: raw bytes on the wire
                )

        self._server = grpc.aio.server()
        self._server.add_generic_rpc_handlers((_Generic(),))
        # typed protoc-generated services (reference:
        # grpc_options.grpc_servicer_functions)
        for path in self.servicer_functions:
            add_fn = _import_servicer_function(path)
            add_fn(_DynamicServicer(self), self._server)
            logger.info("serve gRPC proxy registered typed service via %s", path)
        self._server.add_insecure_port(f"{self.host}:{self.port}")
        await self._server.start()
        logger.info("serve gRPC proxy listening on %s:%d", self.host, self.port)

    def _typed_handler(self, rpc_method: str):
        """Handler for one rpc of a TYPED service: request arrives as the
        deserialized protobuf message; the deployment must return the
        response message type (the generated serializer enforces it)."""

        from ray_tpu_torch.serve.handle import DeploymentHandle

        async def handler(request, context):
            import grpc as _grpc

            import ray_tpu_torch

            md = {k: v for k, v in (context.invocation_metadata() or ())}
            deployment = md.get("deployment") or md.get("application")
            if not deployment:
                await context.abort(
                    _grpc.StatusCode.INVALID_ARGUMENT,
                    "typed gRPC calls require 'deployment' metadata",
                )
                return None
            method = md.get("method", rpc_method)
            handle = self._handles.get(deployment)
            if handle is None:
                handle = DeploymentHandle(deployment, self._controller)
                self._handles[deployment] = handle
            model_id = md.get("multiplexed_model_id", "")
            if model_id:
                handle = handle.options(multiplexed_model_id=model_id)
            loop = asyncio.get_event_loop()
            response = None
            try:
                response = await loop.run_in_executor(
                    self._route_pool,
                    lambda: handle._call(method, (request,), {}),
                )
                return await loop.run_in_executor(
                    None, ray_tpu_torch.get, response.object_ref
                )
            except Exception as e:  # noqa: BLE001 — surfaced as gRPC status
                logger.exception("typed grpc request failed")
                await context.abort(_grpc.StatusCode.INTERNAL, str(e))
                return None
            finally:
                if response is not None:
                    response._router.done(response._replica_id)

        return handler

    def _make_handler(self, deployment: str):
        import json

        from ray_tpu_torch.serve.handle import DeploymentHandle

        def parse_request(request_bytes: bytes):
            try:
                payload = json.loads(request_bytes)
            except Exception:
                return (request_bytes,), {}  # opaque bytes: one positional arg
            if (
                isinstance(payload, dict)
                and set(payload) <= {"args", "kwargs"}
                and isinstance(payload.get("args", []), list)
                and isinstance(payload.get("kwargs", {}), dict)
            ):
                return tuple(payload.get("args", ())), dict(payload.get("kwargs", {}))
            return (payload,), {}

        async def handler(request_bytes: bytes, context) -> bytes:
            import grpc as _grpc

            import ray_tpu_torch

            md = {k: v for k, v in (context.invocation_metadata() or ())}
            model_id = md.get("multiplexed_model_id", "")
            method = md.get("method", "__call__")
            handle = self._handles.get(deployment)
            if handle is None:
                handle = DeploymentHandle(deployment, self._controller)
                self._handles[deployment] = handle
            if model_id:
                handle = handle.options(multiplexed_model_id=model_id)
            args, kwargs = parse_request(request_bytes)
            loop = asyncio.get_event_loop()
            response = None
            try:
                response = await loop.run_in_executor(
                    self._route_pool,
                    lambda: handle._call(method, args, kwargs),
                )
                result = await loop.run_in_executor(
                    None, ray_tpu_torch.get, response.object_ref
                )
            except Exception as e:  # noqa: BLE001 — surfaced as gRPC status
                logger.exception("grpc proxy request failed")
                await context.abort(_grpc.StatusCode.INTERNAL, str(e))
                return b""
            finally:
                if response is not None:
                    response._router.done(response._replica_id)
            if isinstance(result, (bytes, bytearray)):
                return bytes(result)
            return json.dumps(result).encode()

        return handler
