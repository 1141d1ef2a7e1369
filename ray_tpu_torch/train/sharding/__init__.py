"""ray_tpu_torch.train.sharding — the sharded training plane (port of
``ray_tpu/train/sharding``).

**GSPMD** (`rules.py`, `gspmd.py`, `checkpoint.py`): a
``ShardingConfig(mesh=("batch", "model"), partition_rules=[...])``
declares a 2-D device mesh over the worker group and regex partition
rules over flattened parameter paths.  ``GspmdPlan`` places the model's
parameters and the optimizer's moments as DTensors on a ``DeviceMesh``
with the rule layout and runs the step under DTensor dispatch, data
parallelism riding ``batch``; checkpoints save per shard and re-shard
onto a different mesh on elastic resize.

**MPMD** (`pipeline_plane.py`): ``PipelinePlane(program,
PipelineConfig(stages=S, microbatches=M))`` runs a model split into S
stage programs (``gpt2_pipeline_programs``) as S stage actors under 1F1B,
activations and their gradients moving stage to stage over the compiled
channels; a stage death restarts the whole pipeline from its last
checkpoint.
"""

from ray_tpu_torch.train.sharding.checkpoint import load_sharded, save_sharded
from ray_tpu_torch.train.sharding.gspmd import (
    GspmdPlan,
    build_mesh,
    build_plan,
    plan_from_context,
    set_train_state,
    train_state,
)
from ray_tpu_torch.train.sharding.pipeline_plane import (
    PipelineConfig,
    PipelinePlane,
    gpt2_pipeline_programs,
)
from ray_tpu_torch.train.sharding.rules import (
    ShardingConfig,
    UnmatchedParamError,
    gpt2_partition_rules,
    match_partition_rules,
)

__all__ = [
    "ShardingConfig",
    "UnmatchedParamError",
    "match_partition_rules",
    "gpt2_partition_rules",
    "GspmdPlan",
    "build_mesh",
    "build_plan",
    "plan_from_context",
    "train_state",
    "set_train_state",
    "save_sharded",
    "load_sharded",
    "PipelineConfig",
    "PipelinePlane",
    "gpt2_pipeline_programs",
]
