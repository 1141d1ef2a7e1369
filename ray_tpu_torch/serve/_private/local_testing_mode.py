"""Local testing mode (reference: serve/_private/local_testing_mode.py):
``serve.run(app, _local_testing_mode=True)`` executes the deployment
IN-PROCESS — no controller, no replica actors, no cluster — so unit
tests of deployment logic run in milliseconds.

The handle keeps the DeploymentHandle calling convention
(``handle.remote(...)/.result()``, method dispatch, and
``options(multiplexed_model_id=...)`` including the request-context
contextvar), so code under test doesn't special-case the mode."""

from __future__ import annotations

import asyncio
import inspect
import threading
from typing import Any, Dict, Optional


class _LocalResponse:
    """DeploymentResponse stand-in resolving a local call."""

    def __init__(self, run):
        self._run = run  # zero-arg callable executing the request
        self._done = False
        self._value = None
        self._error: Optional[BaseException] = None

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._done:
            try:
                self._value = self._run()
            except BaseException as e:  # noqa: BLE001 — re-raised to caller
                self._error = e
            self._done = True
        if self._error is not None:
            raise self._error
        return self._value


class _LocalMethodCaller:
    def __init__(self, handle: "LocalDeploymentHandle", method: str):
        self._handle = handle
        self._method = method

    def remote(self, *args, **kwargs) -> _LocalResponse:
        return self._handle._call(self._method, args, kwargs)


class LocalDeploymentHandle:
    """In-process handle over one instantiated deployment callable."""

    def __init__(self, target, init_args: tuple, init_kwargs: dict,
                 multiplexed_model_id: str = "", _instance=None):
        if _instance is not None:
            self._instance = _instance
        elif inspect.isclass(target):
            self._instance = target(*init_args, **init_kwargs)
        else:
            self._instance = target
        self._multiplexed_model_id = multiplexed_model_id
        # async deployments run on a private loop thread, mirroring the
        # replica's asyncio execution model
        self._loop = asyncio.new_event_loop()
        self._loop_thread = threading.Thread(
            target=self._loop.run_forever, daemon=True, name="serve-local"
        )
        self._loop_thread.start()

    def _call(self, method: str, args: tuple, kwargs: dict):
        from ray_tpu_torch.serve.multiplex import _set_request_model_id

        if method == "__call__":
            target = getattr(self._instance, "__call__", self._instance)
        else:
            target = getattr(self._instance, method, None)
        if target is None:
            raise AttributeError(f"deployment has no method {method!r}")
        model_id = self._multiplexed_model_id
        if getattr(self, "_stream", False):
            # streaming parity with the cluster path: iterate yields,
            # draining coroutines/async generators on the replica loop
            _set_request_model_id(model_id)
            out = target(*args, **kwargs)
            if inspect.iscoroutine(out):
                out = asyncio.run_coroutine_threadsafe(out, self._loop).result(60)
            if inspect.isasyncgen(out):
                async def drain(ag):
                    return [item async for item in ag]

                items = asyncio.run_coroutine_threadsafe(
                    drain(out), self._loop
                ).result(60)
                return iter(items)
            if inspect.isgenerator(out) or isinstance(out, (list, tuple)):
                return iter(out)
            return iter([out])

        def run():
            async def invoke():
                _set_request_model_id(model_id)
                out = target(*args, **kwargs)
                if inspect.iscoroutine(out):
                    out = await out
                return out

            fut = asyncio.run_coroutine_threadsafe(invoke(), self._loop)
            return fut.result(timeout=60)

        return _LocalResponse(run)

    def remote(self, *args, **kwargs) -> _LocalResponse:
        return self._call("__call__", args, kwargs)

    def options(self, *, multiplexed_model_id: Optional[str] = None,
                stream: Optional[bool] = None, **_):
        if multiplexed_model_id is None and stream is None:
            return self
        h = LocalDeploymentHandle.__new__(LocalDeploymentHandle)
        h._instance = self._instance
        h._multiplexed_model_id = (
            multiplexed_model_id
            if multiplexed_model_id is not None
            else self._multiplexed_model_id
        )
        h._stream = getattr(self, "_stream", False) if stream is None else stream
        h._loop = self._loop
        h._loop_thread = self._loop_thread
        return h

    def __getattr__(self, name: str) -> _LocalMethodCaller:
        if name.startswith("_"):
            raise AttributeError(name)
        return _LocalMethodCaller(self, name)


def run_local(app) -> LocalDeploymentHandle:
    """Build the Application's deployment graph in-process: nested
    Applications in bind args become LocalDeploymentHandles, mirroring
    the cluster path's handle substitution (api._deploy_graph) so graph
    apps behave identically in both modes."""
    from ray_tpu_torch.serve.api import Application

    def resolve(a):
        return run_local(a) if isinstance(a, Application) else a

    dep = app.deployment
    args = tuple(resolve(a) for a in app.init_args)
    kwargs = {k: resolve(v) for k, v in app.init_kwargs.items()}
    return LocalDeploymentHandle(dep._target, args, kwargs)
