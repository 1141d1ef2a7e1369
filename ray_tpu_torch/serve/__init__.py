"""ray_tpu_torch.serve — model serving (port of ``ray_tpu.serve``;
reference: python/ray/serve).

Controller actor reconciles deployments → replica actors; requests route
via power-of-two-choices over each replica's channel dataplane (actor
RPC where its attach fails, or with ``serve_channel_dataplane`` off); an
aiohttp proxy serves HTTP and a gRPC proxy gRPC; @serve.batch coalesces
requests into batches.  Importing this package imports no torch: the
controller and proxy processes never load it, and only a replica whose
deployment needs torch does.
"""

from ray_tpu_torch.serve._private.common import AutoscalingConfig, DeploymentConfig
from ray_tpu_torch.serve.api import (
    Application,
    Deployment,
    delete,
    deploy_config,
    deployment,
    get_deployment_handle,
    run,
    shutdown,
    start,
    status,
)
from ray_tpu_torch.serve.schema import (
    ApplicationSchema,
    DeploymentSchema,
    ServeDeploySchema,
    build_app_schema,
)
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.handle import (
    DeploymentHandle,
    DeploymentResponse,
    DeploymentResponseGenerator,
)
from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id, multiplexed
from ray_tpu_torch.serve._private.request_context import (
    get_request_slo,
    get_request_tenant,
)
from ray_tpu_torch.serve.exceptions import RequestShedError

__all__ = [
    "multiplexed",
    "get_multiplexed_model_id",
    "get_request_tenant",
    "get_request_slo",
    "deploy_config",
    "ServeDeploySchema",
    "ApplicationSchema",
    "DeploymentSchema",
    "build_app_schema",
    "deployment",
    "Deployment",
    "Application",
    "run",
    "start",
    "status",
    "delete",
    "shutdown",
    "get_deployment_handle",
    "DeploymentHandle",
    "DeploymentResponse",
    "DeploymentResponseGenerator",
    "AutoscalingConfig",
    "DeploymentConfig",
    "batch",
    "RequestShedError",
]
