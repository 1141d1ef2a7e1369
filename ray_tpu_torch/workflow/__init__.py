"""ray_tpu_torch.workflow — durable DAG execution (reference: python/ray/workflow
— workflow_executor.py:32 WorkflowExecutor, storage-backed step
checkpoints, resume via workflow_state_from_storage.py).

Each DAG node's output is checkpointed to storage as it completes; a
crashed/cancelled workflow resumes from the last completed step.

Checkpoints are keyed by a content hash of the DAG *structure* (each
node's type, target name, and parent positions); resuming a workflow_id
whose DAG no longer matches the stored structure raises instead of
silently mapping old checkpoints onto different steps.

Actor (ClassMethodNode) steps checkpoint BOTH their outputs and, after
each committed step, the actor's internal state via the actor's
get_state()/set_state() hooks (the Checkpointable pattern,
rllib/utils/checkpoints.py); a resume replays completed outputs from
storage, re-creates the actor, and restores its snapshot before the
first live step.  Actors without get_state() still replay outputs but
re-build internal state from __init__ (warned once).

Port: checkpoints (step outputs, actor snapshots, the final output) are
written through the runtime's own serialization, so a value holding a
CUDA tensor is stored, and reads back, as a CPU tensor, as it does over
the object store; the storage default is ``~/ray_tpu_torch_workflows``
(``RAY_TPU_TORCH_WORKFLOW_STORAGE``), never the JAX package's directory.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.dag import (
    ClassMethodNode,
    ClassNode,
    DAGNode,
    FunctionNode,
    InputNode,
    MultiOutputNode,
)

__all__ = ["init", "run", "run_async", "resume", "get_output", "get_status", "list_all", "delete"]

_storage_dir: Optional[str] = None


def _dump(value: Any, path: str) -> None:
    """Write ``value`` to ``path`` atomically (a temp file, then rename)."""
    from ray_tpu_torch._private import serialization

    with open(path + ".tmp", "wb") as f:
        f.write(serialization.serialize_to_bytes(value))
    os.replace(path + ".tmp", path)


def _load(path: str) -> Any:
    from ray_tpu_torch._private import serialization

    with open(path, "rb") as f:
        blob = bytearray(f.read())
    return serialization.deserialize(memoryview(blob))[1]


def init(storage: Optional[str] = None):
    global _storage_dir
    _storage_dir = storage or os.environ.get(
        "RAY_TPU_TORCH_WORKFLOW_STORAGE", os.path.expanduser("~/ray_tpu_torch_workflows")
    )
    os.makedirs(_storage_dir, exist_ok=True)


def _storage() -> str:
    if _storage_dir is None:
        init()
    return _storage_dir


def _wf_dir(workflow_id: str) -> str:
    d = os.path.join(_storage(), workflow_id)
    os.makedirs(d, exist_ok=True)
    return d


def _node_target_name(node: DAGNode) -> str:
    if isinstance(node, FunctionNode):
        return getattr(node._remote_fn, "_name", "")
    # InputAttributeNode: which input field it reads IS its identity.
    key = getattr(node, "_key", None)
    if key is not None:
        return f"{type(node).__name__}[{key!r}]"
    return getattr(node, "_method", "") or type(node).__name__


def _dag_structure(order: List[DAGNode]) -> List[dict]:
    """Per-node structural description: type, target, parent positions.
    uuids differ between processes, so parents are topo indices."""
    index = {n._stable_uuid: i for i, n in enumerate(order)}
    return [
        {
            "type": type(n).__name__,
            "target": _node_target_name(n),
            "parents": [index[c._stable_uuid] for c in n._children()],
        }
        for n in order
    ]


def _structure_hash(structure: List[dict]) -> str:
    return hashlib.sha1(json.dumps(structure, sort_keys=True).encode()).hexdigest()


def _step_key(node: DAGNode, topo_index: int, structure: List[dict]) -> str:
    """Stable step identity across runs: structure position + a hash of
    the node's own structural entry (type + target + parent positions)."""
    h = hashlib.sha1(json.dumps(structure[topo_index], sort_keys=True).encode())
    return f"step_{topo_index:04d}_{h.hexdigest()[:8]}"


class _WorkflowRun:
    def __init__(self, workflow_id: str, dag: DAGNode, input_val: Any,
                 is_resume: bool = False):
        self.workflow_id = workflow_id
        self.dag = dag
        self.input_val = input_val
        self.dir = _wf_dir(workflow_id)
        self.is_resume = is_resume

    def _meta_path(self):
        return os.path.join(self.dir, "workflow_meta.json")

    # -- actor-state checkpoints (reference: every workflow step is
    # checkpointed, workflow_executor.py:32; actor internals snapshot via
    # the user's get_state/set_state — the Checkpointable pattern
    # rllib/utils/checkpoints.py uses) -----------------------------------
    def _snapshot_actor_state(self, node: ClassMethodNode, cache, path: str, snapshot_ok):
        """Persist the actor's post-step state next to the step's output
        checkpoint (written before it — see execute() on crash ordering)."""
        import ray_tpu_torch

        class_node = node._bound_args[0]
        uuid = class_node._stable_uuid
        if snapshot_ok.get(uuid) is False:
            return
        actor = cache.get(uuid)
        if actor is None:
            return
        try:
            state = ray_tpu_torch.get(actor.get_state.remote())
            snapshot_ok[uuid] = True
        except Exception:
            if snapshot_ok.get(uuid):
                # get_state WORKED for earlier steps: this is a transient
                # failure, not a missing capability.  Swallowing it would
                # let output checkpoints advance past the last snapshot —
                # a resume would then restore stale state.  Fail the step
                # (its output is not yet checkpointed, so resume
                # re-executes it from the last good snapshot).
                raise
            import logging

            logging.getLogger(__name__).warning(
                "workflow %s: actor %s does not implement get_state(); its "
                "internal state will not survive resume (completed step "
                "OUTPUTS are still checkpointed and replayed)",
                self.workflow_id,
                type(class_node._actor_cls).__name__,
            )
            snapshot_ok[uuid] = False
            return
        _dump(state, path)

    def _restore_actor_state(self, node: ClassMethodNode, cache, latest_snapshot, restored):
        """Before the first live method step on an actor during a resume,
        load the snapshot of the newest output-checkpointed step."""
        import ray_tpu_torch

        uuid = node._bound_args[0]._stable_uuid
        if uuid in restored:
            return
        restored.add(uuid)
        path = latest_snapshot.get(uuid)
        if path is None:
            return
        state = _load(path)
        actor = cache.get(uuid)
        if actor is None:
            return
        try:
            ray_tpu_torch.get(actor.set_state.remote(state))
        except Exception as e:
            raise RuntimeError(
                f"workflow {self.workflow_id}: actor has a state snapshot at "
                f"{path} but set_state() failed — implement "
                f"set_state(state) to make actor steps resumable: {e}"
            ) from e

    def _write_meta(self, status: str):
        with open(self._meta_path(), "w") as f:
            json.dump({"status": status, "updated_at": time.time(), "workflow_id": self.workflow_id}, f)

    def execute(self) -> Any:
        import ray_tpu_torch

        # Validate structure BEFORE writing RUNNING status, so a refused
        # resume doesn't leave the stored status stuck at RUNNING.
        order = self.dag._topo()
        structure = _dag_structure(order)
        struct_path = os.path.join(self.dir, "dag_structure.json")
        if os.path.exists(struct_path):
            with open(struct_path) as f:
                stored = json.load(f)
            if _structure_hash(stored) != _structure_hash(structure):
                raise ValueError(
                    f"workflow {self.workflow_id!r} was stored with a different "
                    "DAG structure; refusing to resume with mismatched "
                    "checkpoints. Use a new workflow_id or delete() the old one."
                )
        else:
            with open(struct_path + ".tmp", "w") as f:
                json.dump(structure, f)
            os.replace(struct_path + ".tmp", struct_path)

        self._write_meta("RUNNING")
        # pickle the dag + input so resume() can rebuild them
        dag_blob_path = os.path.join(self.dir, "dag.pkl")
        if not os.path.exists(dag_blob_path):
            from ray_tpu_torch._private import serialization

            with open(dag_blob_path, "wb") as f:
                f.write(serialization.dumps_function((self.dag, self.input_val)))
        cache: Dict[str, Any] = {}
        ctx: dict = {"actors": {}}
        # actor-state checkpointing (reference: workflow checkpoints every
        # step, workflow_executor.py:32; RLlib's Checkpointable pattern).
        # Snapshots are PER METHOD STEP (ckpt + ".actor_state") and
        # written before the step's output checkpoint commits: a snapshot
        # is only ever consulted through its step's output file, so a
        # crash between the two writes leaves an orphan snapshot that is
        # never restored — no stale-state/fresh-output mismatch in either
        # direction.  While replaying cached steps we track the newest
        # output-checkpointed snapshot per actor; the first live step on
        # that actor restores it.
        latest_snapshot: Dict[str, str] = {}  # class uuid -> snapshot path
        restored: set = set()
        snapshot_ok: Dict[str, bool] = {}
        try:
            for i, node in enumerate(order):
                key = _step_key(node, i, structure)
                ckpt = os.path.join(self.dir, key + ".pkl")
                if not isinstance(node, ClassNode) and os.path.exists(ckpt):
                    cache[node._stable_uuid] = _load(ckpt)
                    if isinstance(node, ClassMethodNode):
                        snap = ckpt + ".actor_state"
                        if os.path.exists(snap):
                            latest_snapshot[node._bound_args[0]._stable_uuid] = snap
                    continue
                if isinstance(node, ClassMethodNode):
                    # first live method step on this actor after a resume:
                    # restore the state snapshotted alongside the last
                    # checkpointed method step
                    self._restore_actor_state(node, cache, latest_snapshot, restored)
                out = node._execute_one(cache, self.input_val, ctx)
                # resolve task outputs so the checkpoint stores values
                if isinstance(out, ray_tpu_torch.ObjectRef):
                    out = ray_tpu_torch.get(out)
                elif isinstance(out, list) and out and isinstance(out[0], ray_tpu_torch.ObjectRef):
                    out = ray_tpu_torch.get(out)
                cache[node._stable_uuid] = out
                if isinstance(node, ClassMethodNode):
                    # snapshot first: if get_state fails, this step has no
                    # output checkpoint and simply re-executes on resume
                    self._snapshot_actor_state(node, cache, ckpt + ".actor_state", snapshot_ok)
                if isinstance(node, (FunctionNode, MultiOutputNode, ClassMethodNode)):
                    _dump(out, ckpt)
            result = cache[self.dag._stable_uuid]
            _dump(result, os.path.join(self.dir, "output.pkl"))
            self._write_meta("SUCCESSFUL")
            return result
        except BaseException:
            self._write_meta("FAILED")
            raise


def run(dag: DAGNode, *, workflow_id: Optional[str] = None, input_val: Any = None) -> Any:
    """Execute a DAG durably; returns the final output (reference:
    workflow.run)."""
    workflow_id = workflow_id or f"wf_{int(time.time())}_{os.getpid()}"
    return _WorkflowRun(workflow_id, dag, input_val).execute()


def run_async(dag: DAGNode, *, workflow_id: Optional[str] = None, input_val: Any = None):
    """Run in a background task; returns an ObjectRef of the output."""
    import ray_tpu_torch

    workflow_id = workflow_id or f"wf_{int(time.time())}_{os.getpid()}"

    dag_input = (dag, input_val)

    @ray_tpu_torch.remote
    def _driver(blob_id):
        from ray_tpu_torch import workflow as wf

        d, iv = blob_id
        return wf.run(d, workflow_id=workflow_id, input_val=iv)

    return _driver.remote(dag_input)


def resume(workflow_id: str) -> Any:
    """Re-run a stored workflow; completed steps are skipped via their
    checkpoints (reference: workflow resume /
    workflow_state_from_storage.py)."""
    d = _wf_dir(workflow_id)
    out_path = os.path.join(d, "output.pkl")
    if os.path.exists(out_path):
        return _load(out_path)
    dag_blob = os.path.join(d, "dag.pkl")
    if not os.path.exists(dag_blob):
        raise ValueError(f"no stored workflow {workflow_id!r}")
    from ray_tpu_torch._private import serialization

    with open(dag_blob, "rb") as f:
        dag, input_val = serialization.loads_function(f.read())
    return _WorkflowRun(workflow_id, dag, input_val, is_resume=True).execute()


def get_output(workflow_id: str) -> Any:
    out_path = os.path.join(_wf_dir(workflow_id), "output.pkl")
    if not os.path.exists(out_path):
        raise ValueError(f"workflow {workflow_id!r} has no output (status: {get_status(workflow_id)})")
    return _load(out_path)


def get_status(workflow_id: str) -> str:
    meta = os.path.join(_wf_dir(workflow_id), "workflow_meta.json")
    if not os.path.exists(meta):
        return "NOT_FOUND"
    with open(meta) as f:
        return json.load(f)["status"]


def list_all() -> List[tuple]:
    out = []
    base = _storage()
    for wid in sorted(os.listdir(base)):
        meta = os.path.join(base, wid, "workflow_meta.json")
        if os.path.exists(meta):
            with open(meta) as f:
                out.append((wid, json.load(f)["status"]))
    return out


def delete(workflow_id: str):
    import shutil

    shutil.rmtree(os.path.join(_storage(), workflow_id), ignore_errors=True)
