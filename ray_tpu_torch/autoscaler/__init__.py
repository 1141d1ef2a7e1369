"""ray_tpu_torch.autoscaler — demand-driven cluster scaling (reference:
python/ray/autoscaler).  StandardAutoscaler reads pending resource
shapes from the GCS, bin-packs them onto node types, and drives a
pluggable NodeProvider; FakeMultiNodeProvider simulates nodes as local
raylet processes for tests.  Node types carry the port's accelerator
resource (e.g. {"CPU": 8, "GPU": 1}), so a pending task or actor that
asks for a GPU pulls up a node that has one.

Port: the TPU-slice provider (``TPUNodeProvider``, ``MockTpuClient``,
``GceTpuClient``, ``slice_resources``) needs live cloud APIs and is not
ported (ROADMAP Queue A item 7); importing one of those names raises."""

from ray_tpu_torch.autoscaler.autoscaler import Monitor, StandardAutoscaler
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
    "get_nodes_to_launch",
    "TAG_NODE_KIND",
    "TAG_NODE_TYPE",
    "TAG_NODE_STATUS",
]

_TPU_PROVIDER_NAMES = ("TPUNodeProvider", "MockTpuClient", "GceTpuClient", "slice_resources")


def __getattr__(name):
    if name in _TPU_PROVIDER_NAMES:
        raise ImportError(
            f"ray_tpu_torch.autoscaler has no {name}: the TPU-slice node provider "
            "needs live cloud APIs and is not ported (ROADMAP Queue A item 7)"
        )
    raise AttributeError(f"module 'ray_tpu_torch.autoscaler' has no attribute {name!r}")
