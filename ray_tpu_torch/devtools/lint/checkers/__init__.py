"""Checker registry.  A checker is a module exposing ``name`` and either
``check(module)`` (per-file) or ``check_project(project)`` (whole-tree).
Add new checkers here and in docs/static_analysis.md."""

from ray_tpu_torch.devtools.lint.checkers import (
    blocking_handler,
    generation_key,
    import_cycle,
    lock_order,
    metrics_drift,
    retry_gate,
    rpc_contract,
    shared_state_race,
    thread_lifecycle,
    trace_orphan,
)

ALL_CHECKERS = [
    retry_gate,
    lock_order,
    thread_lifecycle,
    blocking_handler,
    metrics_drift,
    generation_key,
    import_cycle,
    trace_orphan,
    rpc_contract,
    shared_state_race,
]

CHECK_NAMES = [c.name for c in ALL_CHECKERS]
