"""Declarative Serve config schema (reference: python/ray/serve/schema.py —
ServeDeploySchema / ServeApplicationSchema / DeploymentSchema, 1,142 LoC
of pydantic models; here: typed dataclasses with the same shape, YAML or
JSON on the wire).

The config is the serialized desired state of a Serve cluster:

    applications:
      - name: default
        import_path: my_module:app      # an Application or Deployment
        route_prefix: /app
        deployments:                    # per-deployment OVERRIDES
          - name: Preprocess
            num_replicas: 2
    http_options:
      port: 8045

``serve build`` emits this from an importable app; ``serve deploy``
applies it against the controller (config-driven rolling updates flow
through the same deploy → long-poll push path as serve.run)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

# DeploymentConfig fields a config file may override (reference:
# schema.py DeploymentSchema fields)
_OVERRIDABLE = (
    "num_replicas",
    "max_ongoing_requests",
    "max_queued_requests",
    "route_prefix",
    "autoscaling_config",
    "user_config",
    "version",
    "ray_actor_options",
    "tenant_quotas",
)


@dataclass
class DeploymentSchema:
    """Per-deployment override block; None fields keep code defaults."""

    name: str
    num_replicas: Optional[int] = None
    max_ongoing_requests: Optional[int] = None
    max_queued_requests: Optional[int] = None
    route_prefix: Optional[str] = None
    autoscaling_config: Optional[dict] = None
    user_config: Any = None
    version: Optional[str] = None
    ray_actor_options: Optional[dict] = None
    tenant_quotas: Optional[dict] = None

    def overrides(self) -> Dict[str, Any]:
        out = {}
        for f in _OVERRIDABLE:
            v = getattr(self, f)
            if v is not None:
                out[f] = v
        return out


@dataclass
class ApplicationSchema:
    """One application: an import path plus deployment overrides
    (reference: schema.py ServeApplicationSchema)."""

    import_path: str
    name: str = "default"
    route_prefix: Optional[str] = None
    deployments: List[DeploymentSchema] = field(default_factory=list)

    def deployment_overrides(self) -> Dict[str, Dict[str, Any]]:
        return {d.name: d.overrides() for d in self.deployments}


@dataclass
class ServeDeploySchema:
    """The whole config file (reference: schema.py ServeDeploySchema)."""

    applications: List[ApplicationSchema] = field(default_factory=list)
    http_options: Dict[str, Any] = field(default_factory=dict)
    grpc_options: Dict[str, Any] = field(default_factory=dict)

    # -- wire format -----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ServeDeploySchema":
        apps = []
        for a in d.get("applications", []):
            deps = [
                DeploymentSchema(**dep) if isinstance(dep, dict) else dep
                for dep in a.get("deployments", [])
            ]
            apps.append(
                ApplicationSchema(
                    import_path=a["import_path"],
                    name=a.get("name", "default"),
                    route_prefix=a.get("route_prefix"),
                    deployments=deps,
                )
            )
        return cls(
            applications=apps,
            http_options=dict(d.get("http_options", {})),
            grpc_options=dict(d.get("grpc_options", {})),
        )

    def to_yaml(self, path: str) -> None:
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)

    @classmethod
    def from_file(cls, path: str) -> "ServeDeploySchema":
        """Load YAML or JSON by extension (reference: serve deploy
        accepts the config file path)."""
        import json

        with open(path) as f:
            text = f.read()
        if path.endswith(".json"):
            return cls.from_dict(json.loads(text))
        import yaml

        return cls.from_dict(yaml.safe_load(text))


def import_attr(import_path: str) -> Any:
    """'pkg.module:attr' → the attr (reference: ray._private.utils
    import_attr, the serve CLI's import mechanism)."""
    import importlib

    if ":" not in import_path:
        raise ValueError(
            f"import_path must look like 'module.submodule:attr', got {import_path!r}"
        )
    module_name, attr = import_path.split(":", 1)
    module = importlib.import_module(module_name)
    obj = module
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def build_app_schema(import_path: str, *, name: str = "default",
                     route_prefix: Optional[str] = None) -> ApplicationSchema:
    """``serve build``: import the app and emit a schema with every
    deployment's EFFECTIVE config spelled out, ready to edit and deploy
    (reference: serve/scripts.py build)."""
    from ray_tpu_torch.serve.api import Application, Deployment, walk_applications

    app = import_attr(import_path)
    if isinstance(app, Deployment):
        app = app.bind()
    if not isinstance(app, Application):
        raise TypeError(f"{import_path} is a {type(app).__name__}, not an Application")
    deps = []
    for sub in walk_applications(app):
        cfg = sub.deployment._config
        deps.append(
            DeploymentSchema(
                name=cfg.name,
                num_replicas=cfg.num_replicas,
                max_ongoing_requests=cfg.max_ongoing_requests,
                max_queued_requests=cfg.max_queued_requests,
                route_prefix=cfg.route_prefix,
                autoscaling_config=dataclasses.asdict(cfg.autoscaling_config)
                if cfg.autoscaling_config
                else None,
                user_config=cfg.user_config,
                version=cfg.version,
                ray_actor_options=cfg.ray_actor_options or None,
                tenant_quotas=cfg.tenant_quotas or None,
            )
        )
    return ApplicationSchema(
        import_path=import_path, name=name, route_prefix=route_prefix,
        deployments=deps,
    )
