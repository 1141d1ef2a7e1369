"""ray_tpu_torch.autoscaler — demand-driven cluster scaling (reference:
python/ray/autoscaler).  StandardAutoscaler reads pending resource
shapes from the GCS, bin-packs them onto node types, and drives a
pluggable NodeProvider; FakeMultiNodeProvider simulates nodes as local
raylet processes for tests.  Node types carry the port's accelerator
resource (e.g. {"CPU": 8, "GPU": 1}), so a pending task or actor that
asks for a GPU pulls up a node that has one.  GPUNodeProvider buys and
frees whole GPU slices: its nodes carry slice-topology resources (e.g.
{"GPU": 16, "GPU-h100-16-head": 1}), so a gang's demand for a slice's
head pulls up every host of one slice.

Port: the JAX package's TPU-slice names (``TPUNodeProvider``,
``MockTpuClient``, ``GceTpuClient``) have GPU counterparts here;
importing a TPU name raises an ImportError that names its counterpart."""

from ray_tpu_torch.autoscaler.autoscaler import Monitor, StandardAutoscaler
from ray_tpu_torch.autoscaler.gpu_node_provider import (
    GceGpuClient,
    GPUNodeProvider,
    MockGpuClient,
    slice_resources,
)
from ray_tpu_torch.autoscaler.node_provider import (
    TAG_NODE_KIND,
    TAG_NODE_STATUS,
    TAG_NODE_TYPE,
    FakeMultiNodeProvider,
    NodeProvider,
)
from ray_tpu_torch.autoscaler.resource_demand_scheduler import get_nodes_to_launch

__all__ = [
    "StandardAutoscaler",
    "Monitor",
    "NodeProvider",
    "FakeMultiNodeProvider",
    "GPUNodeProvider",
    "MockGpuClient",
    "GceGpuClient",
    "slice_resources",
    "get_nodes_to_launch",
    "TAG_NODE_KIND",
    "TAG_NODE_TYPE",
    "TAG_NODE_STATUS",
]

# the JAX package's TPU-slice names -> their counterparts here
_TPU_PROVIDER_NAMES = {
    "TPUNodeProvider": "GPUNodeProvider",
    "MockTpuClient": "MockGpuClient",
    "GceTpuClient": "GceGpuClient",
}


def __getattr__(name):
    if name in _TPU_PROVIDER_NAMES:
        raise ImportError(
            f"ray_tpu_torch.autoscaler has no {name}: the port's accelerator is the "
            f"GPU; use {_TPU_PROVIDER_NAMES[name]} (autoscaler/gpu_node_provider.py)"
        )
    raise AttributeError(f"module 'ray_tpu_torch.autoscaler' has no attribute {name!r}")
