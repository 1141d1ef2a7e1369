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
    """Head + N worker nodes, with optional per-node chaos env (the
    preemption rule must hit exactly one raylet)."""
    created = []

    def make(head_args=None, nodes=()):
        c = Cluster(initialize_head=True, head_node_args=head_args or {"num_cpus": 1})
        handles = []
        for kw in nodes:
            kw = dict(kw)
            node_env = kw.pop("node_env", {})
            with pytest.MonkeyPatch.context() as node_mp:
                for k, v in node_env.items():
                    node_mp.setenv(k, v)
                handles.append(c.add_node(**kw))
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
    from ray_tpu_torch._private.chaos import CHAOS

    CHAOS.reset()


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


def test_resize_resumes_from_a_committed_checkpoint(tmp_path):
    """The port's resize re-resolves its resume checkpoint after the
    survivors retire (``backend_executor._still_restorable``): one the
    retention sweep reclaimed meanwhile falls forward to the newest
    committed one of its chain; one that still verifies is kept."""
    import shutil

    from ray_tpu_torch.train import checkpoint_plane
    from ray_tpu_torch.train._internal.backend_executor import _still_restorable

    root = tmp_path / "run"
    paths = []
    for i in (1, 2, 3):
        src = Checkpoint.from_pytree({"step": i}, path=str(tmp_path / f"src{i}"))
        # graftlint: disable=generation-key -- the chain a resize resumes from, named as a session names it
        dest = str(root / f"checkpoint_g001_{i:06d}_rank0")
        checkpoint_plane.persist_dir(src.path, dest)
        paths.append(dest)
    kept = Checkpoint(paths[1])
    assert _still_restorable(kept) is kept
    shutil.rmtree(paths[1])  # the retention sweep reclaimed the chosen one
    moved = _still_restorable(Checkpoint(paths[1]))
    assert moved.path == paths[2] and moved.to_pytree() == {"step": 3}
    assert _still_restorable(None) is None


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


# ==========================================================================
# Chaos matrix (copies of the JAX package's tests/test_elastic.py drills)
# ==========================================================================


@pytest.mark.slow  # ~36 s preempt/shrink/grow acceptance: runs under `-m chaos`
@pytest.mark.chaos
def test_elastic_acceptance_preempt_shrink_grow(elastic_cluster, tmp_path):
    """The acceptance drill: num_workers=4, min_workers=2; a seeded
    ``preempt`` chaos action kills one rank's raylet mid-step ->
    checkpoint -> shrink to 3 -> training continues; a mock capacity
    return (new node) grows the group back to 4 at an epoch boundary;
    the final loss has parity with an uninterrupted run; zero charges
    against max_failures; resize events land in the metrics registry and
    resize spans are recorded."""
    shrink_before = _resize_event_count("shrink")
    grow_before = _resize_event_count("grow")

    c, handles = elastic_cluster(
        # 0-CPU head: all four ranks must land on worker nodes, so the
        # preempted node is guaranteed to host one.
        head_args={"num_cpus": 0},
        nodes=[
            {
                "num_cpus": 1,
                # ~15 s of ticks so training is well underway even on a
                # slow box, then an 8 s notice before the raylet
                # self-kills: the drain window in which checkpoint +
                # shrink must land.
                "node_env": {
                    "RAY_TPU_TORCH_testing_chaos_spec": "@raylet.tick:preempt:at=75:ms=8000",
                    "RAY_TPU_TORCH_testing_chaos_seed": "11",
                },
            },
            {"num_cpus": 1},
            {"num_cpus": 1},
            {"num_cpus": 1},
        ],
    )
    progress_dir = str(tmp_path / "progress")
    os.makedirs(progress_dir, exist_ok=True)
    total_steps = 80

    stop = threading.Event()
    grew = []

    def capacity_returner():
        # Mock capacity return: once any rank reports world_size 3 (the
        # shrink landed), add a replacement node.  No wait_for_nodes —
        # the executor's readiness ping gates the grow, and the cluster
        # may already be tearing down by the time the node registers.
        while not stop.is_set():
            prog = _progress(progress_dir)
            if any(p[2] == 3 for p in prog.values()):
                try:
                    grew.append(c.add_node(num_cpus=1))
                except Exception:
                    pass
                return
            # graftlint: disable=retry-gate -- test-side progress poll; 0.2 s is the scan resolution of a drill bounded by the trainer's own run, not a retry delay
            time.sleep(0.2)

    t = threading.Thread(target=capacity_returner, daemon=True)
    t.start()
    try:
        trainer = TorchTrainer(
            _elastic_loop,
            train_loop_config={
                "total_steps": total_steps,
                "progress_dir": progress_dir,
                "step_s": 0.25,
            },
            torch_config=TorchConfig(distributed=False),
            scaling_config=ScalingConfig(
                num_workers=4, min_workers=2, resources_per_worker={"CPU": 1}
            ),
            run_config=RunConfig(
                name="elastic_acceptance",
                storage_path=str(tmp_path),
                failure_config=FailureConfig(max_failures=0),
            ),
        )
        result = trainer.fit()
    finally:
        stop.set()
        t.join(timeout=5)

    # Parity: same final step and loss as an uninterrupted run.
    assert result.metrics["step"] == total_steps
    assert result.metrics["loss"] == 1.0 / total_steps
    # Shrink to 3 happened (observed by the loop itself), then the mock
    # capacity return grew the group back to 4.
    assert grew, "capacity return never triggered (no shrink to 3 observed)"
    assert result.metrics["world_size"] == 4, result.metrics
    assert result.metrics["generation"] >= 2  # >= one shrink + one grow
    assert _resize_event_count("shrink") >= shrink_before + 1
    assert _resize_event_count("grow") >= grow_before + 1
    # Resize spans recorded (state.timeline() merges these from the span
    # log; assert at the source to stay robust on slow CI flushes).
    from ray_tpu_torch.util import tracing

    names = [s.get("name") for s in tracing._finished_spans]
    assert "train.resize" in names


def _die_hard_loop(config):
    """Every rank dies hard (os._exit) at the configured step on the
    first attempt — below min_workers, so the elastic path must REFUSE to
    shrink and fall back to the charged whole-group restart.  The die
    decision is captured at LOOP ENTRY (before any rank can write the
    marker), so every first-attempt rank dies regardless of step skew."""
    ctx = train.get_context()
    marker = config["marker"]
    die = not os.path.exists(marker)
    for step in range(1, config["total_steps"] + 1):
        # graftlint: disable=retry-gate -- simulated train-step duration, not a retry delay
        time.sleep(0.1)
        if step == 3 and die:
            if ctx.get_world_rank() == 0:
                with open(marker, "w") as f:
                    f.write("died")
            os._exit(1)
        train.report({"step": step, "world_size": ctx.get_world_size()})


@pytest.mark.chaos
def test_elastic_shrink_refused_below_min_workers(elastic_cluster, tmp_path):
    """When the casualty count would take the group below min_workers,
    shrink is refused and the run falls back to the whole-group restart
    path — charged normally against max_failures."""
    from ray_tpu_torch.train.base_trainer import TrainingFailedError

    elastic_cluster(head_args={"num_cpus": 4})
    marker = str(tmp_path / "all_died")

    def make_trainer(max_failures):
        return TorchTrainer(
            _die_hard_loop,
            train_loop_config={"total_steps": 6, "marker": marker},
            torch_config=TorchConfig(distributed=False),
            scaling_config=ScalingConfig(
                num_workers=2, min_workers=1, resources_per_worker={"CPU": 1}
            ),
            run_config=RunConfig(
                name=f"elastic_refused_{max_failures}",
                storage_path=str(tmp_path),
                failure_config=FailureConfig(max_failures=max_failures),
            ),
        )

    # Budget of 1: the whole-group death charges ONE failure, the restart
    # completes at full size.
    result = make_trainer(1).fit()
    assert result.metrics["step"] == 6
    assert result.metrics["world_size"] == 2  # full-size restart, no shrink

    # Budget of 0: the same death is charged and the run fails — proof
    # the refused shrink did NOT silently eat the failure.
    os.remove(marker)
    with pytest.raises(TrainingFailedError):
        make_trainer(0).fit()
