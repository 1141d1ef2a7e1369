from ray_tpu_torch.autoscaler.v2.instance_manager import Instance, InstanceManager
from ray_tpu_torch.autoscaler.v2.autoscaler import AutoscalerV2
from ray_tpu_torch.autoscaler.v2.sdk import request_cluster_resources

__all__ = ["Instance", "InstanceManager", "AutoscalerV2", "request_cluster_resources"]
