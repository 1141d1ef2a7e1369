"""gpt2_loop's drain-aware option under a real drain, on the CPU: GPT-2
tiny trains inside TorchTrainer.fit() on one worker of a three-node
cluster; a drain notice for the rank's node makes the loop checkpoint the
step, the weights and AdamW's state, the trainer restarts the rank on the
other node from that checkpoint, and every step's loss equals an
unbroken run's.  ``chip_smoke.py``'s phase 24 drives the same path on the
card at GPT-2 small.  This file imports neither JAX nor the JAX package."""

import json
import os
import threading
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.train import FailureConfig, RunConfig, ScalingConfig
from ray_tpu_torch.train.torch import TorchTrainer
from ray_tpu_torch.train.torch.gpt2_loop import train_loop_per_worker

STEPS, PERIODIC, DRAIN_AT, LR = 8, 3, 5, 3e-4
CFG = {"size": "tiny", "dtype": "float32"}


@pytest.fixture()
def three_nodes():
    """A head with one CPU and two worker nodes of two: the rank lands on
    a worker node, and the other one takes it after the drain."""
    with pytest.MonkeyPatch.context() as mp:
        # The suite runs many clusters at once: no 2 GiB shm arena
        # prefault, and no memory monitor, which watches the whole machine.
        mp.setenv("RAY_TPU_TORCH_arena_prefault_bytes", "0")
        mp.setenv("RAY_TPU_TORCH_memory_monitor_enabled", "0")
        c = Cluster(initialize_head=True, head_node_args={"num_cpus": 1})
        for _ in range(2):
            c.add_node(num_cpus=2)
        c.wait_for_nodes()
        ray_tpu_torch.init(address=c.address)
        yield c
        ray_tpu_torch.shutdown()
        c.shutdown()


def _unbroken_losses(tokens):
    """The same steps in this process, from the same seed."""
    import torch

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train.torch.gpt2_loop import model_config

    cfg = model_config(CFG)
    model = gpt2.init_model(cfg, torch.Generator(device="cpu").manual_seed(0), device="cpu")
    step = gpt2.make_train_step(cfg, gpt2.make_adamw(model.parameters(), lr=LR))
    toks = torch.tensor(tokens)
    return [step(model, toks[:, :-1], toks[:, 1:]).item() for _ in range(STEPS)]


def test_drain_aware_fit_resumes_exactly_on_the_other_node(three_nodes, tmp_path):
    worker = ray_tpu_torch._private.worker.get_global_worker()
    tokens = np.random.default_rng(4).integers(0, 512, size=(2, 33))
    progress = str(tmp_path / "progress.jsonl")
    stop, drained = threading.Event(), []

    def drainer():
        # Once the loop reports step 5, drain the node hosting the rank.
        while not stop.is_set():
            try:
                with open(progress) as f:
                    last = json.loads(f.read().splitlines()[-1])
            except (OSError, ValueError, IndexError):
                last = None
            if last is not None and last["step"] >= DRAIN_AT:
                worker.gcs_client.call("drain_node", {
                    "node_id": bytes.fromhex(last["node_id"]), "reason": "PREEMPTION",
                    "deadline_s": 60})
                drained.append(last["node_id"])
                return
            # graftlint: disable=retry-gate -- test-side progress poll; 0.02 s is the scan resolution of a drill bounded by the trainer's own run, not a retry delay
            time.sleep(0.02)

    t = threading.Thread(target=drainer, daemon=True)
    t.start()
    try:
        result = TorchTrainer(
            train_loop_per_worker,
            train_loop_config={
                "cfg": CFG, "seed": 0, "tokens": tokens, "lr": LR, "steps": STEPS,
                "device": "cpu",
                "drain_aware": {"periodic_step": PERIODIC, "progress": progress,
                                "min_step_s": 0.5}},
            scaling_config=ScalingConfig(num_workers=1, resources_per_worker={"CPU": 2}),
            run_config=RunConfig(name="drain_aware", storage_path=str(tmp_path),
                                 failure_config=FailureConfig(max_failures=0)),
        ).fit()
    finally:
        stop.set()
        t.join(timeout=5)

    with open(progress) as f:
        records = [json.loads(line) for line in f.read().splitlines()]
    first = [r for r in records if r["resumed_from"] < 0]
    resumed = [r for r in records if r["resumed_from"] >= 0]
    assert drained, "the drill never drained a node"
    assert result.metrics["step"] == STEPS
    assert result.metrics["resumed_from"] >= DRAIN_AT
    assert [r["checkpoint"] for r in first if r.get("checkpoint")] == ["periodic", "drain"]
    assert [r["step"] for r in resumed] == list(range(result.metrics["resumed_from"] + 1,
                                                      STEPS + 1))
    assert {r["node_id"] for r in first} == {drained[0]}
    assert drained[0] not in {r["node_id"] for r in resumed}
    # weights, AdamW's moments and step count restored: every loss of both
    # attempts is the unbroken run's at that step
    want = _unbroken_losses(tokens)
    for r in records:
        assert abs(r["loss"] - want[r["step"] - 1]) <= 1e-5 * abs(want[r["step"] - 1]), (
            r["step"], r["loss"], want)
    # a CPU tensor runs each kernel's plain version, which counts no launch
    assert {tuple(r["launches"]) for r in records} == {(0, 0, 0)}
