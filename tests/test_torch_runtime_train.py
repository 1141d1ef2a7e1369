"""The port's trainer end to end on real worker processes (model: the
JAX package's tests/test_train.py trainer cases).

TorchTrainer forms one gloo process group across its workers on the CPU:
the multi-process cases run for real, each rank all-reducing its MLP
gradients over the group.  ``jax.process_count()`` in the originals reads
here as ``torch.distributed.get_world_size()``.  This file imports
neither JAX nor the JAX package, so it also runs where there is none.
"""

import os

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import train
from ray_tpu_torch.train import (
    Checkpoint,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.torch import TorchTrainer


@pytest.fixture(scope="module")
def ray_cluster():
    """Module-scoped local cluster of the port (the conftest's fixture of
    this name starts the JAX package's)."""
    with pytest.MonkeyPatch.context() as mp:
        # The suite runs many clusters at once, the JAX package's among them:
        # no 2 GiB shm arena prefault per raylet, and no memory monitor,
        # which watches the whole machine and would kill this test's
        # workers for the others' memory.
        mp.setenv("RAY_TPU_TORCH_arena_prefault_bytes", "0")
        mp.setenv("RAY_TPU_TORCH_memory_monitor_enabled", "0")
        ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
        yield ray_tpu_torch
        ray_tpu_torch.shutdown()


def _mlp_loop(config):
    import numpy as np
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import mlp

    torch.set_num_threads(1)
    ctx = train.get_context()
    assert ctx.get_world_size() == config["num_workers"]
    assert dist.get_world_size() == config["num_workers"]

    cfg = mlp.MLPConfig(in_dim=16, hidden=(32,), num_classes=4)
    model = mlp.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    resume = train.get_checkpoint()
    if resume is not None:
        model.load_state_dict(resume.to_pytree())
    opt = torch.optim.SGD(model.parameters(), lr=0.1)

    rng = np.random.default_rng(42)
    n_local = 8
    for epoch in range(config["epochs"]):
        x = torch.from_numpy(rng.standard_normal((n_local, 16)).astype(np.float32))
        y = (x.sum(dim=1) > 0).long()
        opt.zero_grad(set_to_none=True)
        loss = mlp.loss_fn(model, x, y)
        loss.backward()
        for p in model.parameters():  # data parallel: the mean gradient
            dist.all_reduce(p.grad)
            p.grad /= dist.get_world_size()
        opt.step()
        loss = loss.detach()
        dist.all_reduce(loss)
        loss_val = loss.item() / dist.get_world_size()
        ckpt = None
        if ctx.get_world_rank() == 0 and epoch == config["epochs"] - 1:
            ckpt = Checkpoint.from_pytree(model.state_dict())
        train.report({"loss": loss_val, "epoch": epoch}, checkpoint=ckpt)


@pytest.mark.parametrize("num_workers", [2])
def test_torch_trainer_distributed_mlp(ray_cluster, tmp_path, num_workers):
    trainer = TorchTrainer(
        _mlp_loop,
        train_loop_config={"epochs": 3, "num_workers": num_workers},
        scaling_config=ScalingConfig(num_workers=num_workers),
        run_config=RunConfig(name="mlp_test", storage_path=str(tmp_path)),
    )
    result = trainer.fit()
    assert result.metrics is not None
    assert result.metrics["epoch"] == 2
    assert np.isfinite(result.metrics["loss"])
    assert result.checkpoint is not None
    tree = result.checkpoint.to_pytree()
    assert "dense_0.weight" in tree
    assert tree["dense_0.weight"].device.type == "cpu"


def test_torch_trainer_resume_from_checkpoint(ray_cluster, tmp_path):
    trainer = TorchTrainer(
        _mlp_loop,
        train_loop_config={"epochs": 2, "num_workers": 2},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="mlp_resume_a", storage_path=str(tmp_path)),
    )
    r1 = trainer.fit()
    trainer2 = TorchTrainer(
        _mlp_loop,
        train_loop_config={"epochs": 1, "num_workers": 2},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="mlp_resume_b", storage_path=str(tmp_path)),
        resume_from_checkpoint=r1.checkpoint,
    )
    r2 = trainer2.fit()
    assert r2.metrics["loss"] <= r1.metrics["loss"] + 0.5  # continued, not reset


def test_trainer_restore_from_experiment_dir(ray_cluster, tmp_path):
    """Trainer.restore(path) rebuilds the trainer from the saved
    trainer.pkl and resumes from the latest checkpoint (reference:
    train/base_trainer.py:250)."""
    trainer = TorchTrainer(
        _mlp_loop,
        train_loop_config={"epochs": 2, "num_workers": 2},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="mlp_restore", storage_path=str(tmp_path)),
    )
    r1 = trainer.fit()
    exp_dir = os.path.join(str(tmp_path), "mlp_restore")
    assert TorchTrainer.can_restore(exp_dir)
    restored = TorchTrainer.restore(exp_dir)
    assert restored.resume_from_checkpoint is not None
    assert restored.train_loop_config["epochs"] == 2
    r2 = restored.fit()
    # Restored run continued from r1's params (loss did not reset).
    assert r2.metrics["loss"] <= r1.metrics["loss"] + 0.5
    # Overrides replace saved fields.
    restored2 = TorchTrainer.restore(exp_dir, train_loop_config={"epochs": 1, "num_workers": 2})
    assert restored2.train_loop_config["epochs"] == 1


def _flaky_loop(config):
    marker = config["marker"]
    if not os.path.exists(marker):
        with open(marker, "w") as f:
            f.write("x")
        raise RuntimeError("injected first-attempt failure")
    train.report({"ok": 1})


def test_failure_config_retries(ray_cluster, tmp_path):
    trainer = TorchTrainer(
        _flaky_loop,
        train_loop_config={"marker": str(tmp_path / "marker")},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(
            name="flaky", storage_path=str(tmp_path),
            failure_config=FailureConfig(max_failures=1),
        ),
    )
    result = trainer.fit()
    assert result.metrics == {"ok": 1}


def _kill_rank1_once_loop(config):
    """First attempt: rank 1 dies HARD (os._exit — no exception, no
    teardown, the signature of an OOM/SIGKILL/preempted-host death)
    mid-training, after the process group is up.  Second attempt:
    everyone trains to completion."""
    import torch.distributed as dist

    ctx = train.get_context()
    # The re-rendezvous proof: every attempt sees the FULL world again —
    # the world size comes from the process group, so a half-rebuilt
    # group would fail here.
    assert dist.get_world_size() == config["num_workers"]
    marker = config["marker"]
    if ctx.get_world_rank() == 1 and not os.path.exists(marker):
        with open(marker, "w") as f:
            f.write("killed")
        os._exit(1)
    train.report({"ok": 1, "procs": dist.get_world_size()})


@pytest.mark.slow  # whole-group restart drill: runs under `-m chaos`
@pytest.mark.chaos
def test_killed_worker_whole_mesh_restart(ray_cluster, tmp_path):
    """Recovery drill: a killed training worker triggers a clean WHOLE-
    group restart — the group is torn down, fresh workers are leased, and
    the process group re-forms at a new address — and the job
    completes."""
    marker = tmp_path / "rank1_killed"
    trainer = TorchTrainer(
        _kill_rank1_once_loop,
        train_loop_config={"marker": str(marker), "num_workers": 2},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(
            name="mesh_restart", storage_path=str(tmp_path),
            failure_config=FailureConfig(max_failures=1),
        ),
    )
    result = trainer.fit()
    assert result.metrics == {"ok": 1, "procs": 2}
    assert marker.exists(), "the fault was never injected"


def test_failure_without_retries_raises(ray_cluster, tmp_path):
    def always_fail(config):
        raise ValueError("nope")

    trainer = TorchTrainer(
        always_fail,
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="fail", storage_path=str(tmp_path)),
    )
    with pytest.raises(train.TrainingFailedError):
        trainer.fit()


def test_use_gpu_asks_each_worker_for_one_card():
    """ScalingConfig(use_gpu=True) gives each worker one card's GPU
    resource; the TPU placement fields are gone."""
    assert ScalingConfig(num_workers=2, use_gpu=True)._worker_resources() == {"GPU": 1.0}
    assert ScalingConfig(num_workers=2)._worker_resources() == {"CPU": 1.0}
    with pytest.raises(TypeError):
        ScalingConfig(use_tpu=True)


def test_session_finishes_only_after_its_last_checkpoint_lands(tmp_path, monkeypatch):
    """A loop whose last act is a report with a checkpoint: the async
    writer may still be persisting it when the loop returns, and the
    session reports the run finished only once it has landed (the
    driver's Result names that directory)."""
    import time

    from ray_tpu_torch.train import checkpoint_plane
    from ray_tpu_torch.train._internal import session as session_mod

    persist = checkpoint_plane.persist_dir

    def slow_persist(*args, **kwargs):
        time.sleep(0.5)
        return persist(*args, **kwargs)

    monkeypatch.setattr(checkpoint_plane, "persist_dir", slow_persist)

    def loop():
        train.report({"x": 1}, checkpoint=Checkpoint.from_pytree({"w": [1, 2]}))

    s = session_mod._TrainSession(loop, world_rank=0, local_rank=0, node_rank=0, world_size=1,
                                  local_world_size=1, experiment_name="e",
                                  storage_dir=str(tmp_path))
    s.start()
    report = s.next_report(timeout=30)
    assert report["kind"] == "report"
    assert s.next_report(timeout=30) == {"kind": "finished"}
    assert report["checkpoint"].to_pytree() == {"w": [1, 2]}
