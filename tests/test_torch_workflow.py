"""Durable workflows of the port: copies of the three workflow tests of
``tests/test_dag_workflow.py`` (run and output, resume after a failed
step, actor steps whose state is checkpointed and restored) over the
port's runtime, ``dag/`` and ``workflow/``; no JAX.

Reference test model: python/ray/workflow/tests/ (test_basic_workflows.py
resume-after-failure pattern).
"""

import os

import pytest

import ray_tpu_torch
from ray_tpu_torch.dag import InputNode


@pytest.fixture(scope="module")
def ray_cluster():
    """Module-scoped local cluster of the port (the conftest's fixture of
    this name starts the JAX package's)."""
    with pytest.MonkeyPatch.context() as mp:
        # many clusters share the machine under xdist: no 2 GiB arena
        # prefault, and no memory monitor killing this test's workers for
        # the others' memory
        mp.setenv("RAY_TPU_TORCH_arena_prefault_bytes", "0")
        mp.setenv("RAY_TPU_TORCH_memory_monitor_enabled", "0")
        ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
        yield ray_tpu_torch
        ray_tpu_torch.shutdown()


def test_workflow_run_and_output(ray_cluster, tmp_path):
    from ray_tpu_torch import workflow

    workflow.init(str(tmp_path))

    @ray_tpu_torch.remote
    def double(x):
        return 2 * x

    @ray_tpu_torch.remote
    def inc(x):
        return x + 1

    with InputNode() as inp:
        dag = inc.bind(double.bind(inp))
    out = workflow.run(dag, workflow_id="wf1", input_val=10)
    assert out == 21
    assert workflow.get_status("wf1") == "SUCCESSFUL"
    assert workflow.get_output("wf1") == 21
    assert ("wf1", "SUCCESSFUL") in workflow.list_all()


def test_workflow_resume_skips_completed_steps(ray_cluster, tmp_path):
    from ray_tpu_torch import workflow

    workflow.init(str(tmp_path))
    marker = str(tmp_path / "side_effects")

    @ray_tpu_torch.remote
    def step_a(x):
        with open(marker, "a") as f:
            f.write("a")
        return x + 1

    flag_file = str(tmp_path / "crash_once")

    @ray_tpu_torch.remote
    def flaky(x, flag=flag_file):
        if not os.path.exists(flag):
            open(flag, "w").close()
            raise RuntimeError("simulated crash")
        return x * 100

    with InputNode() as inp:
        dag = flaky.bind(step_a.bind(inp))
    with pytest.raises(Exception):
        workflow.run(dag, workflow_id="wf_resume", input_val=1)
    assert workflow.get_status("wf_resume") == "FAILED"
    # resume: step_a is checkpointed, only flaky re-runs
    out = workflow.resume("wf_resume")
    assert out == 200
    with open(marker) as f:
        assert f.read() == "a"  # step_a ran exactly once
    assert workflow.get_status("wf_resume") == "SUCCESSFUL"


def test_workflow_actor_steps_checkpoint_and_restore_state(ray_cluster, tmp_path):
    """Actor steps checkpoint outputs AND actor state (get_state/set_state):
    a resume replays completed actor-step outputs from storage and
    restores the actor's counter before the first live step — no
    re-execution of completed steps (reference: workflow_executor.py
    checkpoints every step)."""
    from ray_tpu_torch import workflow

    workflow.init(str(tmp_path))
    calls_marker = str(tmp_path / "accum_calls")

    @ray_tpu_torch.remote
    class Accumulator:
        def __init__(self):
            self.total = 0

        def add(self, x):
            with open(calls_marker, "a") as f:
                f.write("x")
            self.total += x
            return self.total

        def get_state(self):
            return {"total": self.total}

        def set_state(self, state):
            self.total = state["total"]

    flag_file = str(tmp_path / "crash_once_actor")

    @ray_tpu_torch.remote
    def flaky_gate(x, flag=flag_file):
        if not os.path.exists(flag):
            open(flag, "w").close()
            raise RuntimeError("simulated crash")
        return x

    acc = Accumulator.bind()
    with InputNode() as inp:
        first = acc.add.bind(inp)          # 0 + 7 = 7, checkpointed
        gated = flaky_gate.bind(first)     # crashes on first run
        dag = acc.add.bind(gated)          # resumed: needs total==7 restored

    with pytest.raises(Exception):
        workflow.run(dag, workflow_id="wf_actor", input_val=7)
    assert workflow.get_status("wf_actor") == "FAILED"

    out = workflow.resume("wf_actor")
    # 7 (replayed from checkpoint) + 7 on a RESTORED total of 7 → 14
    assert out == 14
    with open(calls_marker) as f:
        # first add ran once (original attempt); second add ran once
        # (after resume); the first add was NOT re-executed on resume
        assert f.read() == "xx"
    assert workflow.get_status("wf_actor") == "SUCCESSFUL"


def test_workflow_checkpoints_go_through_the_runtime_serialization(tmp_path):
    """Port: a checkpoint is written by the object store's serializer, so a
    tensor (and an array beside it) reads back with its values and dtype;
    a CUDA tensor would read back as a CPU tensor, as it does over the
    store."""
    import numpy as np
    import torch

    from ray_tpu_torch import workflow

    value = {"t": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
             "a": np.arange(4, dtype=np.int64), "n": 7}
    path = str(tmp_path / "step.pkl")
    workflow._dump(value, path)
    assert sorted(os.listdir(tmp_path)) == ["step.pkl"]  # no temp file left behind
    back = workflow._load(path)
    assert back["t"].dtype == torch.bfloat16 and back["t"].device.type == "cpu"
    assert torch.equal(back["t"], value["t"])
    assert np.array_equal(back["a"], value["a"]) and back["n"] == 7
