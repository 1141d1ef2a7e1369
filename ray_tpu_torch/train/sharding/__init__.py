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

The reference's MPMD half (``PipelineConfig``, ``PipelinePlane``,
``gpt2_pipeline_programs``: stage actor groups over the compiled-channel
dataplane) is not ported yet: those names raise ``NotImplementedError``.
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
]

_NOT_PORTED = ("PipelineConfig", "PipelinePlane", "gpt2_pipeline_programs")


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"ray_tpu_torch.train.sharding.{name}: the MPMD pipeline plane is not "
            f"ported yet (ROADMAP Queue A item 4(f))"
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
