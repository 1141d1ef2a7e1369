"""ray_tpu_torch.parallel — mesh + sharding utilities for SPMD training
(port of ``ray_tpu/parallel``).

The reference places arrays on a ``jax.sharding.Mesh`` and lets XLA
insert the collectives; the port places tensors on a
``torch.distributed.device_mesh.DeviceMesh`` as DTensors and lets DTensor
dispatch insert them.  The SPMD pipeline (``parallel/pipeline.py``) waits
for ROADMAP Queue A item 4(e).
"""

from ray_tpu_torch.parallel.mesh import (
    MeshConfig,
    auto_mesh_shape,
    create_mesh,
    local_mesh,
)
from ray_tpu_torch.parallel.sharding import (
    ShardingRules,
    batch_spec,
    infer_param_spec,
    shard_tree,
    tree_shardings,
)

__all__ = [
    "MeshConfig",
    "auto_mesh_shape",
    "create_mesh",
    "local_mesh",
    "ShardingRules",
    "batch_spec",
    "infer_param_spec",
    "shard_tree",
    "tree_shardings",
]
