"""Serve declarative config plane of the port: schema round-trips, serve
build, config-driven deploy of a multi-deployment app, replica-count
flips via re-deploy — copies of ``tests/test_serve_config.py`` over the
port's runtime (reference: python/ray/serve/schema.py +
serve/scripts.py; test model: serve/tests/test_config_files + test_cli).
``test_serve_build_writes_yaml`` writes the config through the schema
calls the CLI makes; ``test_cli_serve_build_writes_yaml`` runs the
port's CLI (``ray-tpu-torch serve build -o``).
"""

import sys
import textwrap
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch._private import retry
from ray_tpu_torch.serve.schema import (
    ApplicationSchema,
    DeploymentSchema,
    ServeDeploySchema,
    build_app_schema,
)


def _poll(deadline_s: float):
    """Yield once now, then after each backoff delay of the runtime's POLL
    policy until ``deadline_s`` has passed: ``for _ in _poll(30): ...``."""
    bo = retry.POLL.start(deadline_s=deadline_s)
    yield
    while (delay := bo.next_delay()) is not None:
        time.sleep(delay)
        yield


@pytest.fixture(scope="module")
def ray_cluster():
    """Module-scoped local cluster of the port (the conftest's fixture of
    this name starts the JAX package's)."""
    with pytest.MonkeyPatch.context() as mp:
        # The suite runs many clusters at once, the JAX package's among them:
        # no 2 GiB shm arena prefault per raylet, and no memory monitor,
        # which watches the whole machine and would kill this test's
        # workers for the others' memory.
        mp.setenv("RAY_TPU_TORCH_arena_prefault_bytes", "0")
        mp.setenv("RAY_TPU_TORCH_memory_monitor_enabled", "0")
        ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
        yield ray_tpu_torch
        ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def serve_cluster(ray_cluster):
    yield ray_cluster
    serve.shutdown()


APP_MODULE = textwrap.dedent(
    """
    from ray_tpu_torch import serve

    @serve.deployment(name="Preprocess")
    class Preprocess:
        def __call__(self, x):
            return x * 2

    @serve.deployment(name="Ingress")
    class Ingress:
        def __init__(self, pre):
            self.pre = pre

        def __call__(self, x):
            doubled = self.pre.remote(x).result()
            return doubled + 1

    app = Ingress.bind(Preprocess.bind())
    """
)


@pytest.fixture(scope="module")
def app_module(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_cfg_app")
    (d / "sc_torch_demo_app.py").write_text(APP_MODULE)
    sys.path.insert(0, str(d))
    yield "sc_torch_demo_app"
    sys.path.remove(str(d))


def test_schema_yaml_roundtrip(tmp_path):
    schema = ServeDeploySchema(
        applications=[
            ApplicationSchema(
                import_path="m:app",
                name="a1",
                route_prefix="/a1",
                deployments=[DeploymentSchema(name="D", num_replicas=3)],
            )
        ],
        http_options={"port": 8045},
    )
    path = str(tmp_path / "config.yaml")
    schema.to_yaml(path)
    loaded = ServeDeploySchema.from_file(path)
    assert loaded.applications[0].import_path == "m:app"
    assert loaded.applications[0].deployments[0].num_replicas == 3
    assert loaded.http_options["port"] == 8045
    # overrides() drops unset fields
    assert loaded.applications[0].deployments[0].overrides() == {"num_replicas": 3}


def test_serve_build_emits_all_deployments(app_module):
    schema = build_app_schema(f"{app_module}:app")
    names = {d.name for d in schema.deployments}
    assert names == {"Preprocess", "Ingress"}
    # effective defaults spelled out, ready for editing
    pre = next(d for d in schema.deployments if d.name == "Preprocess")
    assert pre.num_replicas == 1


def test_deploy_config_two_deployment_app_and_flip_replicas(
    serve_cluster, app_module, tmp_path
):
    """Deploy a 2-deployment app from a YAML, then flip replica counts
    via re-deploy."""
    config = ServeDeploySchema(
        applications=[
            ApplicationSchema(
                import_path=f"{app_module}:app",
                route_prefix="/demo",
                deployments=[DeploymentSchema(name="Preprocess", num_replicas=2)],
            )
        ]
    )
    path = str(tmp_path / "deploy.yaml")
    config.to_yaml(path)

    statuses = serve.deploy_config(ServeDeploySchema.from_file(path))
    assert set(statuses["default"]) == {"Preprocess", "Ingress"}

    st = serve.status()
    assert st["Preprocess"]["target"] == 2
    assert st["Ingress"]["target"] == 1

    # the composed graph actually serves: Ingress calls Preprocess
    handle = serve.get_deployment_handle("Ingress")
    assert handle.remote(21).result(timeout=10) == 43

    # flip replica counts via config re-deploy (rolling through the
    # same controller path; long-poll pushes the membership change)
    config.applications[0].deployments[0] = DeploymentSchema(
        name="Preprocess", num_replicas=1
    )
    serve.deploy_config(config)
    for _ in _poll(30):
        st = serve.status()
        if st["Preprocess"]["target"] == 1 and st["Preprocess"]["num_running"] == 1:
            break
    st = serve.status()
    assert st["Preprocess"]["target"] == 1, st
    # still serving after the scale-down
    assert handle.remote(5).result(timeout=10) == 11


def test_serve_build_writes_yaml(app_module, tmp_path):
    """What ``serve build <app> -o <file>`` writes (the reference CLI's
    ``cmd_serve_build``): one application schema per import path,
    dumped to YAML, which loads back with every deployment."""
    out = str(tmp_path / "built.yaml")
    ServeDeploySchema(
        applications=[build_app_schema(f"{app_module}:app", name="default")]
    ).to_yaml(out)
    schema = ServeDeploySchema.from_file(out)
    assert {d.name for d in schema.applications[0].deployments} == {
        "Preprocess",
        "Ingress",
    }


def test_cli_serve_build_writes_yaml(app_module, tmp_path):
    from ray_tpu_torch.scripts.cli import main

    out = str(tmp_path / "built.yaml")
    rc = main(["serve", "build", f"{app_module}:app", "-o", out])
    assert rc == 0
    schema = ServeDeploySchema.from_file(out)
    assert {d.name for d in schema.applications[0].deployments} == {
        "Preprocess",
        "Ingress",
    }
