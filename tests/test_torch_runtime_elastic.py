"""The port's elastic training plane (model: the JAX package's
tests/test_elastic.py): a drain notice covering a rank shrinks the group
to the largest healthy size >= min_workers — survivors keep their actors,
training resumes from the drain checkpoint, nothing is charged to
FailureConfig.max_failures, and train.get_context().get_world_size() is
dynamic across the resize.  This file imports neither JAX nor the JAX
package.
"""

import os
import threading
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import train
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.train import Checkpoint, FailureConfig, RunConfig, ScalingConfig
from ray_tpu_torch.train.torch import TorchConfig, TorchTrainer


@pytest.fixture()
def elastic_cluster():
    """Head + N worker nodes."""
    created = []

    def make(head_args=None, nodes=()):
        c = Cluster(initialize_head=True, head_node_args=head_args or {"num_cpus": 1})
        handles = [c.add_node(**kw) for kw in nodes]
        c.wait_for_nodes()
        ray_tpu_torch.init(address=c.address)
        created.append(c)
        return c, handles

    with pytest.MonkeyPatch.context() as mp:
        # The suite runs many clusters at once, the JAX package's among them:
        # no 2 GiB shm arena prefault per raylet, and no memory monitor,
        # which watches the whole machine and would kill this test's
        # workers for the others' memory.
        mp.setenv("RAY_TPU_TORCH_arena_prefault_bytes", "0")
        mp.setenv("RAY_TPU_TORCH_memory_monitor_enabled", "0")
        yield make
        ray_tpu_torch.shutdown()
        for c in created:
            c.shutdown()


def _elastic_loop(config):
    """Deterministic elastic-aware loop: the 'loss' depends only on the
    step counter.  Checkpoints every step so resizes resume where they
    left off; per-rank progress files expose (node, step, world_size,
    generation) to the driver."""
    ctx = train.get_context()
    resume = train.get_checkpoint()
    start = resume.to_pytree()["step"] if resume is not None else 0
    node_id = ray_tpu_torch.get_runtime_context().get_node_id()
    for step in range(start + 1, config["total_steps"] + 1):
        time.sleep(config.get("step_s", 0.15))
        loss = 1.0 / step
        ckpt = None
        if ctx.get_world_rank() == 0 or ctx.drain_requested():
            ckpt = Checkpoint.from_pytree({"step": step})
        path = os.path.join(config["progress_dir"], f"rank_{ctx.get_world_rank()}")
        with open(path, "w") as f:
            f.write(f"{node_id} {step} {ctx.get_world_size()} {ctx.get_generation()}")
        train.report(
            {
                "step": step,
                "loss": loss,
                "world_size": ctx.get_world_size(),
                "generation": ctx.get_generation(),
            },
            checkpoint=ckpt,
        )


def _progress(progress_dir):
    """rank -> (node_id, step, world_size, generation) from the files."""
    out = {}
    try:
        for name in os.listdir(progress_dir):
            if not name.startswith("rank_"):
                continue
            with open(os.path.join(progress_dir, name)) as f:
                parts = f.read().split()
            if len(parts) == 4:
                out[int(name[5:])] = (parts[0], int(parts[1]), int(parts[2]), int(parts[3]))
    except OSError:
        pass
    return out


def _resize_event_count(direction):
    from ray_tpu_torch.util import metrics as metrics_mod

    total = 0.0
    for (name, tags), rec in metrics_mod._registry.items():
        if name == "train_resize_events_total" and ("direction", direction) in tuple(tags):
            total += rec.get("value", 0.0)
    return total


def test_scaling_config_elastic_validation():
    assert not ScalingConfig(num_workers=2).elastic
    assert not ScalingConfig(num_workers=2, min_workers=2).elastic
    assert ScalingConfig(num_workers=4, min_workers=2).elastic
    with pytest.raises(ValueError):
        ScalingConfig(num_workers=2, min_workers=3)
    with pytest.raises(ValueError):
        ScalingConfig(num_workers=2, min_workers=0)


def test_elastic_shrink_on_drain(elastic_cluster, tmp_path):
    """Tier-1 elastic smoke: a drain notice covering one of two ranks
    shrinks the group to 1 (>= min_workers), training completes from the
    drain checkpoint with max_failures=0 untouched, and the user loop
    observes the dynamic world size + bumped generation."""
    c, handles = elastic_cluster(
        head_args={"num_cpus": 1},
        nodes=[{"num_cpus": 2}, {"num_cpus": 2}],
    )
    worker = ray_tpu_torch._private.worker.get_global_worker()
    progress_dir = str(tmp_path / "progress")
    os.makedirs(progress_dir, exist_ok=True)
    total_steps = 20

    stop = threading.Event()
    drained = []

    def drainer():
        # Once rank 1 passes step 5, drain its node (a preemption notice).
        while not stop.is_set():
            prog = _progress(progress_dir)
            if 1 in prog and prog[1][1] >= 5:
                node_id = prog[1][0]
                worker.gcs_client.call(
                    "drain_node",
                    {
                        "node_id": bytes.fromhex(node_id),
                        "reason": "PREEMPTION",
                        "deadline_s": 60,
                    },
                )
                drained.append(node_id)
                return
            # graftlint: disable=retry-gate -- test-side progress poll; 0.1 s is the scan resolution of a drill bounded by the trainer's own run, not a retry delay
            time.sleep(0.1)

    t = threading.Thread(target=drainer, daemon=True)
    t.start()
    try:
        trainer = TorchTrainer(
            _elastic_loop,
            train_loop_config={"total_steps": total_steps, "progress_dir": progress_dir},
            torch_config=TorchConfig(distributed=False),
            scaling_config=ScalingConfig(
                num_workers=2, min_workers=1, resources_per_worker={"CPU": 2}
            ),
            run_config=RunConfig(
                name="elastic_shrink",
                storage_path=str(tmp_path),
                # ZERO budget: a charged restart would raise.
                failure_config=FailureConfig(max_failures=0),
            ),
        )
        result = trainer.fit()
    finally:
        stop.set()
        t.join(timeout=5)

    assert drained, "the drill never drained a node"
    assert result.metrics["step"] == total_steps
    assert result.metrics["loss"] == 1.0 / total_steps
    # The run finished SHRUNKEN: one rank, generation bumped past 0.
    assert result.metrics["world_size"] == 1
    assert result.metrics["generation"] >= 1
    assert _resize_event_count("shrink") >= 1
