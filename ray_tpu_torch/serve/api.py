"""Public Serve API (reference: serve/api.py — serve.run :492,
@serve.deployment decorator, serve.start, serve.shutdown)."""

from __future__ import annotations

import dataclasses
import inspect
import logging
from typing import Any, Callable, Dict, Optional, Union

from ray_tpu_torch.serve._private.common import AutoscalingConfig, DeploymentConfig
from ray_tpu_torch.serve._private.controller import CONTROLLER_NAME, ServeController
from ray_tpu_torch.serve.handle import DeploymentHandle

logger = logging.getLogger(__name__)

_started = False


class Application:
    """A deployment bound to init args (reference: Application =
    Deployment.bind()).  Init args may themselves be Applications —
    run() deploys the whole graph and passes DeploymentHandles in their
    place (reference: the deployment-graph bind pattern)."""

    def __init__(self, deployment: "Deployment", args: tuple, kwargs: dict):
        self.deployment = deployment
        self.init_args = args
        self.init_kwargs = kwargs


def walk_applications(app: "Application"):
    """Yield app and every Application nested in its bind args,
    dependencies first (deploy order)."""
    for a in list(app.init_args) + list(app.init_kwargs.values()):
        if isinstance(a, Application):
            yield from walk_applications(a)
    yield app


class Deployment:
    def __init__(self, target, config: DeploymentConfig):
        self._target = target
        self._config = config
        self.name = config.name

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)

    def options(self, **kwargs) -> "Deployment":
        cfg = dataclasses.replace(self._config)
        for k, v in kwargs.items():
            if k == "autoscaling_config" and isinstance(v, dict):
                v = AutoscalingConfig(**v)
            if not hasattr(cfg, k):
                raise ValueError(f"unknown deployment option {k!r}")
            setattr(cfg, k, v)
        return Deployment(self._target, cfg)


def deployment(
    _target=None,
    *,
    name: Optional[str] = None,
    num_replicas: int = 1,
    max_ongoing_requests: int = 100,
    max_queued_requests: int = -1,
    route_prefix: Optional[str] = None,
    autoscaling_config: Optional[Union[dict, AutoscalingConfig]] = None,
    ray_actor_options: Optional[dict] = None,
    version: str = "1",
    user_config: Any = None,
    tenant_quotas: Optional[dict] = None,
):
    """@serve.deployment decorator (reference: serve/api.py deployment)."""

    def wrap(target):
        if isinstance(autoscaling_config, dict):
            auto = AutoscalingConfig(**autoscaling_config)
        else:
            auto = autoscaling_config
        cfg = DeploymentConfig(
            name=name or target.__name__,
            num_replicas=num_replicas,
            max_ongoing_requests=max_ongoing_requests,
            max_queued_requests=max_queued_requests,
            route_prefix=route_prefix,
            autoscaling_config=auto,
            ray_actor_options=ray_actor_options or {},
            version=version,
            user_config=user_config,
            tenant_quotas=tenant_quotas or {},
        )
        return Deployment(target, cfg)

    if _target is not None:
        return wrap(_target)
    return wrap


def start(http_port: Optional[int] = None, grpc_port: Optional[int] = None,
          grpc_servicer_functions: Optional[list] = None) -> Any:
    """Start (or connect to) the Serve controller; optionally the HTTP
    and/or gRPC proxies (reference: serve.start + proxy bring-up).
    ``grpc_servicer_functions``: dotted paths of protoc-generated
    add_XServicer_to_server functions for TYPED gRPC services
    (reference: grpc_options.grpc_servicer_functions)."""
    global _started
    import ray_tpu_torch

    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init()
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME, "serve")
    except Exception:
        controller = ray_tpu_torch.remote(
            name=CONTROLLER_NAME,
            namespace="serve",
            num_cpus=0.1,
            max_concurrency=1000,
            lifetime="detached",
        )(ServeController).remote()
    _started = True
    if http_port is not None:
        _ensure_proxy(controller, http_port)
    if grpc_port is not None:
        _ensure_grpc_proxy(controller, grpc_port, grpc_servicer_functions or [])
    return controller


def _ensure_proxy(controller, port: int):
    import ray_tpu_torch

    from ray_tpu_torch.serve._private.proxy import ProxyActor

    name = "SERVE_PROXY"
    try:
        ray_tpu_torch.get_actor(name, "serve")
    except Exception:
        proxy = ray_tpu_torch.remote(
            name=name, namespace="serve", num_cpus=0.1, max_concurrency=1000
        )(ProxyActor).remote(port)
        ray_tpu_torch.get(proxy.ready.remote())


def _ensure_grpc_proxy(controller, port: int, servicer_functions=()):
    import ray_tpu_torch

    from ray_tpu_torch.serve._private.grpc_proxy import GrpcProxyActor

    name = "SERVE_GRPC_PROXY"
    try:
        proxy = ray_tpu_torch.get_actor(name, "serve")
    except Exception:
        proxy = ray_tpu_torch.remote(
            name=name, namespace="serve", num_cpus=0.1, max_concurrency=1000
        )(GrpcProxyActor).remote(port, servicer_functions=tuple(servicer_functions))
        ray_tpu_torch.get(proxy.ready.remote())
        return
    if servicer_functions:
        # gRPC can't register handlers after server start: requesting NEW
        # typed services against a live proxy must fail loudly, not serve
        # UNIMPLEMENTED (reference: grpc_options are start-time config)
        registered = set(ray_tpu_torch.get(proxy.registered_servicers.remote()))
        missing = [f for f in servicer_functions if f not in registered]
        if missing:
            raise ValueError(
                f"gRPC proxy is already running without typed service(s) "
                f"{missing}; grpc_servicer_functions must be passed when the "
                f"proxy FIRST starts — serve.shutdown() and re-run with them"
            )


def run(
    app: Union[Application, Deployment],
    *,
    name: str = "default",
    route_prefix: Optional[str] = None,
    http_port: Optional[int] = None,
    grpc_port: Optional[int] = None,
    grpc_servicer_functions: Optional[list] = None,
    _blocking: bool = False,
    _local_testing_mode: bool = False,
) -> DeploymentHandle:
    """Deploy an application and return a handle (reference:
    serve/api.py:492).  ``_local_testing_mode=True`` skips the cluster
    entirely: the deployment runs in-process behind a handle with the
    same calling convention (reference: local_testing_mode.py)."""
    import ray_tpu_torch
    import time

    if isinstance(app, Deployment):
        app = app.bind()
    if _local_testing_mode:
        from ray_tpu_torch.serve._private.local_testing_mode import run_local

        return run_local(app)
    controller = start(http_port=http_port, grpc_port=grpc_port,
                       grpc_servicer_functions=grpc_servicer_functions)
    ingress_name = _deploy_graph(controller, app, route_prefix=route_prefix)
    handle = DeploymentHandle(ingress_name, controller)
    # wait for at least one running replica of every deployment in the
    # app — one shared 60 s budget, jittered polls (retry.POLL).
    from ray_tpu_torch._private import retry

    bo = retry.POLL.start(deadline_s=60)
    for sub in walk_applications(app):
        name = sub.deployment._config.name
        while not ray_tpu_torch.get(controller.get_replicas.remote(name)):
            delay = bo.next_delay()
            if delay is None:
                raise TimeoutError(f"deployment {name} failed to start replicas")
            time.sleep(delay)
    return handle


def _deploy_graph(controller, app: Application, *, route_prefix: Optional[str],
                  ingress: bool = True) -> str:
    """Deploy app's dependency graph depth-first; nested Applications in
    bind args become DeploymentHandles (they pickle by name, the replica
    re-resolves its router).  Only the ingress (the root) gets a route.
    Returns the ingress deployment name."""
    import ray_tpu_torch

    def resolve(a):
        if isinstance(a, Application):
            return DeploymentHandle(
                _deploy_graph(controller, a, route_prefix=None, ingress=False)
            )
        return a

    args = tuple(resolve(a) for a in app.init_args)
    kwargs = {k: resolve(v) for k, v in app.init_kwargs.items()}
    dep = app.deployment
    cfg = dataclasses.replace(dep._config)
    if route_prefix is not None:
        cfg.route_prefix = route_prefix
    if cfg.route_prefix is None:
        # "" = explicitly unrouted: only the ingress defaults to an HTTP
        # route; internal deployments stay handle-only (the reference
        # exposes only the ingress)
        cfg.route_prefix = f"/{cfg.name}" if ingress else ""
    cfg_dict = dataclasses.asdict(cfg)
    init = (dep._target, args, kwargs)
    ray_tpu_torch.get(controller.deploy.remote(cfg_dict, init))
    return cfg.name


def deploy_config(schema) -> Dict[str, list]:
    """Apply a declarative config against the controller (reference:
    serve/scripts.py deploy → controller.apply_config; here the config
    drives the SAME deploy path as serve.run, so replica-count and
    version changes roll through long-poll pushes).

    Returns {app_name: [deployment names deployed]}.
    """
    from ray_tpu_torch.serve.schema import ServeDeploySchema, import_attr

    if isinstance(schema, dict):
        schema = ServeDeploySchema.from_dict(schema)
    http_port = schema.http_options.get("port")
    grpc_port = schema.grpc_options.get("port")
    controller = start(
        http_port=http_port, grpc_port=grpc_port,
        # accept the reference's key name and the short form
        grpc_servicer_functions=(
            schema.grpc_options.get("grpc_servicer_functions")
            or schema.grpc_options.get("servicer_functions")
        ),
    )
    import ray_tpu_torch

    statuses: Dict[str, list] = {}
    for app_schema in schema.applications:
        target = import_attr(app_schema.import_path)
        if isinstance(target, Deployment):
            target = target.bind()
        if not isinstance(target, Application):
            raise TypeError(
                f"{app_schema.import_path} resolved to {type(target).__name__}, "
                "expected Application or Deployment"
            )
        # non-default apps get name-prefixed deployments so two apps with
        # a same-named deployment class can't clobber each other
        # (reference: schema.py scopes deployment names per application)
        prefix = "" if app_schema.name == "default" else f"{app_schema.name}_"
        app = _apply_overrides(
            target, app_schema.deployment_overrides(), name_prefix=prefix
        )
        _deploy_graph(controller, app, route_prefix=app_schema.route_prefix)
        names = [sub.deployment._config.name for sub in walk_applications(app)]
        # wait for every deployment to reach its target — shared 60 s
        # budget per application, jittered polls (retry.POLL)
        import time

        from ray_tpu_torch._private import retry

        bo = retry.POLL.start(deadline_s=60)
        for name in names:
            while not ray_tpu_torch.get(controller.get_replicas.remote(name)):
                delay = bo.next_delay()
                if delay is None:
                    raise TimeoutError(
                        f"application {app_schema.name!r}: deployment "
                        f"{name!r} failed to start any replica within 60s"
                    )
                time.sleep(delay)
        statuses[app_schema.name] = names
    return statuses


def _apply_overrides(
    app: Application,
    overrides: Dict[str, Dict[str, Any]],
    name_prefix: str = "",
) -> Application:
    """Rebuild the app graph with per-deployment config overrides applied
    (reference: schema deployments[] merged over code defaults).
    Overrides are keyed by the UNPREFIXED name the config file uses."""

    def rebuild(a: Application) -> Application:
        args = tuple(rebuild(x) if isinstance(x, Application) else x for x in a.init_args)
        kwargs = {
            k: rebuild(v) if isinstance(v, Application) else v
            for k, v in a.init_kwargs.items()
        }
        dep = a.deployment
        ov = dict(overrides.get(dep._config.name) or {})
        if name_prefix:
            ov["name"] = name_prefix + dep._config.name
        if ov:
            dep = dep.options(**ov)
        return Application(dep, args, kwargs)

    return rebuild(app)


def get_deployment_handle(name: str) -> DeploymentHandle:
    return DeploymentHandle(name)


def status() -> Dict[str, Any]:
    import ray_tpu_torch

    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME, "serve")
    return ray_tpu_torch.get(controller.list_deployments.remote())


def delete(name: str):
    import ray_tpu_torch

    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME, "serve")
    ray_tpu_torch.get(controller.delete_deployment.remote(name))


def shutdown():
    global _started
    import ray_tpu_torch

    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME, "serve")
        ray_tpu_torch.get(controller.shutdown.remote(), timeout=30)
        ray_tpu_torch.kill(controller)
    except Exception:
        pass
    for proxy_name in ("SERVE_PROXY", "SERVE_GRPC_PROXY"):
        try:
            proxy = ray_tpu_torch.get_actor(proxy_name, "serve")
            ray_tpu_torch.kill(proxy)
        except Exception:
            pass
    from ray_tpu_torch.serve._private.router import shutdown_routers

    shutdown_routers()  # stop this process's long-poll threads
    _started = False
