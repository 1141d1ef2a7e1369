"""The port's MPMD pipeline plane (ray_tpu_torch/train/sharding/
pipeline_plane.py): copies of tests/test_pipeline_plane.py's tests.  Stage
actors over real compiled channels match the single-process loss to
fixed-seed parity, per-stage timing/bubble metrics surface, and a chaos
kill mid-epoch recovers by whole-pipeline checkpoint-restart.

The losses are held to the JAX package's single-process run
(``_reference_losses``) from the same initial weights, carried across by
models/convert.py, at the reference's abs 2e-5.  The stages compute on
``device="cpu"`` (the default is the card); the module has a cluster of its
own, with no shm arena prefault and no memory monitor (the suite runs many
clusters at once), and every plane a test drives runs under a deadline
(``test_torch_spmd.within``).
"""

import dataclasses
import functools
import glob
import os
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import ray_tpu_torch  # noqa: E402
import test_torch_spmd as torch_spmd  # noqa: E402
from ray_tpu.models import gpt2 as jgpt2  # noqa: E402
from ray_tpu_torch.models import gpt2  # noqa: E402
from ray_tpu_torch.models.convert import gpt2_state_dict_from_jax  # noqa: E402
from ray_tpu_torch.train.sharding import (  # noqa: E402
    PipelineConfig,
    PipelinePlane,
    gpt2_pipeline_programs,
)
from ray_tpu_torch.train.sharding.pipeline_plane import schedule_ops  # noqa: E402

torch.set_num_threads(2)

DEADLINE_S = 120.0
# a tiny step takes well under a second here: a stage that died (the
# suite runs near the box's memory) is found in this long, well inside
# the deadline, and the plane's restart replays to the same losses
STEP_TIMEOUT_S = 15.0


@pytest.fixture(scope="module")
def ray_cluster():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_TORCH_arena_prefault_bytes", "0")
        mp.setenv("RAY_TPU_TORCH_memory_monitor_enabled", "0")
        ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
        yield ray_tpu_torch
        ray_tpu_torch.shutdown()


def _jcfg():
    return jgpt2.GPT2Config(
        vocab_size=128, n_layer=2, n_head=2, d_model=32, max_seq_len=32,
        dtype=jnp.float32, remat=False,
    )


def _cfg():
    return gpt2.GPT2Config(
        vocab_size=128, n_layer=2, n_head=2, d_model=32, max_seq_len=32,
        dtype=torch.float32, remat=False,
    )


def _data(steps, batch=4, seq=17, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 128, (steps, batch, seq)).astype(np.int32)

    def data_fn(step):
        toks = data[step]
        return toks[:, :-1], toks[:, 1:]

    return data_fn


@functools.lru_cache(maxsize=1)
def _jax_params(seed=0):
    return jax.tree_util.tree_map(np.asarray, jgpt2.init_params(_jcfg(), jax.random.PRNGKey(seed)))


def _program(seed=0):
    """The port's stage programs starting from the JAX package's seed-``seed``
    weights (the init is the driver's: nothing of it is pickled)."""
    tree = gpt2_state_dict_from_jax(_jax_params(seed), _cfg())
    return dataclasses.replace(gpt2_pipeline_programs(_cfg(), n_stages=2, lr=1e-3, seed=seed),
                               init_params=functools.partial(dict, tree))


def _reference_losses(data_fn, steps, lr=1e-3, seed=0):
    cfg = _jcfg()
    params = jgpt2.init_params(cfg, jax.random.PRNGKey(seed))
    opt = jgpt2.make_adamw(lr)
    opt_state = opt.init(params)
    step_fn = jax.jit(jgpt2.make_train_step(cfg, opt))
    out = []
    for s in range(steps):
        toks, tgts = data_fn(s)
        params, opt_state, loss = step_fn(
            params, opt_state, jnp.asarray(toks), jnp.asarray(tgts)
        )
        out.append(float(loss))
    return out


def _plane(**kw):
    return PipelinePlane(_program(), PipelineConfig(stages=2, device="cpu", **kw))


def _run(plane, data_fn, steps):
    return torch_spmd.within(lambda: plane.run(data_fn, steps), DEADLINE_S)


# ---------------------------------------------------------------------------
# schedule unit tests (no cluster)


def test_schedule_ops_1f1b_shape():
    # stage 0 of 3, M=4: 2 warmup F, 2 (F,B) pairs, 2 cooldown B
    assert schedule_ops(0, 3, 4) == ["F", "F", "F", "B", "F", "B", "B", "B"]
    # last stage: pure alternation
    assert schedule_ops(2, 3, 4) == ["F", "B"] * 4
    for s in range(3):
        ops = schedule_ops(s, 3, 4)
        assert ops.count("F") == 4 and ops.count("B") == 4
    # degenerate M < warmup window
    assert schedule_ops(0, 4, 2) == ["F", "F", "B", "B"]


def test_pipeline_config_validation():
    with pytest.raises(ValueError, match="2 stages"):
        PipelineConfig(stages=1)
    with pytest.raises(ValueError, match="microbatches"):
        PipelineConfig(stages=2, microbatches=0)
    assert PipelineConfig().device == "cuda"  # the card unless asked


def test_gpt2_program_split_merge_roundtrip():
    cfg = _cfg()
    prog = gpt2_pipeline_programs(cfg, n_stages=2)
    params = prog.init_params()
    stages = [prog.split(params, s) for s in range(2)]
    assert "wte.weight" in stages[0] and "lm_head.weight" in stages[1]
    assert any(k.startswith("h_0.") for k in stages[0])
    assert any(k.startswith("h_1.") for k in stages[1])
    assert not any(k.startswith("h_1.") for k in stages[0])
    merged = prog.merge(stages)
    assert merged.keys() == params.keys()
    for k in params:
        assert torch.equal(merged[k], params[k])


def test_pipeline_durable_checkpoint_roundtrip_and_fallback(tmp_path):
    """PipelineConfig.checkpoint_dir makes the restart point DURABLE
    through the checkpoint plane: a fresh plane (driver restart) adopts
    the newest committed checkpoint, and a bit-flipped newest is skipped
    for the previous verified one — never adopted."""
    cfg = _cfg()
    prog = gpt2_pipeline_programs(cfg, n_stages=2, lr=1e-3, seed=0)
    pcfg = PipelineConfig(
        stages=2, microbatches=2, checkpoint_dir=str(tmp_path), device="cpu"
    )
    plane = PipelinePlane(prog, pcfg)
    params = prog.init_params()
    for step in (1, 2):
        plane._ckpt = (step, params, None)
        plane._persist_ckpt()
    # driver restart: a fresh plane resumes from the newest commit
    plane2 = PipelinePlane(gpt2_pipeline_programs(cfg, n_stages=2), pcfg)
    assert plane2._restore_durable_ckpt()
    assert plane2.steps_done == 2
    assert plane2._ckpt[1].keys() == params.keys()
    for k in params:
        np.testing.assert_array_equal(np.asarray(plane2._ckpt[1][k]), np.asarray(params[k]))
    # bit-rot the newest: the loader walks back to step 1, never adopts
    newest = os.path.join(str(tmp_path), "checkpoint_000002")
    sp = os.path.join(newest, "state.pkl")
    with open(sp, "r+b") as f:
        f.seek(os.path.getsize(sp) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))
    plane3 = PipelinePlane(gpt2_pipeline_programs(cfg, n_stages=2), pcfg)
    assert plane3._restore_durable_ckpt()
    assert plane3.steps_done == 1


def test_gpt2_program_rejects_indivisible_layers():
    cfg = _cfg()  # n_layer=2
    prog = gpt2_pipeline_programs(cfg, n_stages=3)
    with pytest.raises(ValueError, match="divisible"):
        prog.split(prog.init_params(), 0)


# ---------------------------------------------------------------------------
# cluster tests


@pytest.mark.parametrize("n_micro", [2, 4])
def test_pipeline_matches_single_process_loss(ray_cluster, n_micro):
    """Acceptance bar: an N-stage pipeline over real channels matches
    single-process loss to fixed-seed parity for M microbatches."""
    steps = 3
    data_fn = _data(steps)
    plane = _plane(microbatches=n_micro, step_timeout_s=STEP_TIMEOUT_S)
    try:
        losses = _run(plane, data_fn, steps)
        stats = plane.stage_stats()
    finally:
        plane.stop()
    ref = _reference_losses(data_fn, steps)
    assert losses == pytest.approx(ref, abs=2e-5)
    # per-stage timing + bubble metrics exist and are sane
    assert len(stats) == 2
    for s in stats:
        assert s["steps"] == steps
        assert s["microbatches"] == steps * n_micro
        assert s["busy_s"] > 0
        assert 0.0 <= s["bubble_fraction"] <= 1.0
        assert s["launches"] == [0, 0, 0]  # head dim 16: the plain path on the CPU


def test_pipeline_metrics_reach_cluster_state(ray_cluster):
    """pipeline_stage_seconds / pipeline_bubble_fraction surface through
    the GCS's metrics_get (what util.state.metrics() reads) — the
    profiling plane sees the stages."""
    from ray_tpu_torch._private import retry
    from ray_tpu_torch._private.worker import global_worker_maybe

    data_fn = _data(2)
    plane = _plane(microbatches=2, step_timeout_s=STEP_TIMEOUT_S)

    def _names():
        return {m.get("name") for m in global_worker_maybe().gcs_client.call("metrics_get", None)}

    try:
        _run(plane, data_fn, 2)
        # Stage actors stay alive here so their 2 s metric flusher ships
        # the series; only then tear the plane down.
        bo = retry.POLL.start(deadline_s=30.0)
        names = _names()
        while "pipeline_stage_seconds" not in names and (delay := bo.next_delay()) is not None:
            time.sleep(delay)
            names = _names()
    finally:
        plane.stop()
    assert "pipeline_stage_seconds" in names
    assert "pipeline_bubble_fraction" in names


def test_cuda_stage_without_a_card_raises(ray_cluster):
    """The stages compute on the card unless asked for the CPU: without
    one, the plane refuses before it places anything, and a stage asked
    for cuda refuses its state."""
    from ray_tpu_torch.train.sharding.pipeline_plane import PipelineStage

    assert not torch.cuda.is_available()
    plane = PipelinePlane(_program(), PipelineConfig(stages=2))
    with pytest.raises(RuntimeError, match="cuda"):
        plane.start()
    assert plane.actors == [] and plane._pg is None
    prog = _program()
    stage = PipelineStage.options(num_cpus=0.5).remote(
        0, 2, 2, prog.stage_apply[0], prog.optimizer, "cuda")
    try:
        with pytest.raises(Exception, match="torch.cuda.is_available"):
            ray_tpu_torch.get(stage.set_state.remote(prog.split(prog.init_params(), 0)),
                              timeout=DEADLINE_S)
    finally:
        ray_tpu_torch.kill(stage)


@pytest.mark.chaos
@pytest.mark.slow  # ~25 s kill/restart drill: runs under `-m chaos`
def test_pipeline_chaos_kill_recovers_with_parity(ray_cluster):
    """Chaos drill: kill one stage actor mid-epoch (past the last
    checkpoint).  The plane restarts the WHOLE pipeline from its
    checkpoint, replays the uncheckpointed steps, and lands on the same
    losses as an undisturbed run — and the recovery is a restart, never
    a silent skip (restarts == 1).  The kill path must also reap the
    stage-side shm ring dirs (tmpfs is RAM; stop_loop never ran)."""
    from ray_tpu_torch.experimental.channel import ring_base_dir

    steps = 5
    data_fn = _data(steps)
    rings_before = set(glob.glob(os.path.join(ring_base_dir(), "ray_tpu_torch_pp*")))

    def make_plane():
        return _plane(microbatches=2, step_timeout_s=8.0, checkpoint_every=2, max_restarts=1)

    plane = make_plane()
    try:
        clean = _run(plane, data_fn, steps)
    finally:
        plane.stop()

    plane = make_plane()
    try:
        part = _run(plane, data_fn, 3)  # checkpoint landed at step 2
        ray_tpu_torch.kill(plane.actors[1])  # step 3 is NOT checkpointed
        rest = _run(plane, data_fn, steps)  # recovers + replays 2..4
        chaos = [part[i] if i < 2 else rest[i] for i in range(steps)]
        assert plane.restarts == 1
    finally:
        plane.stop()
    assert chaos == pytest.approx(clean, abs=2e-5)
    assert clean == pytest.approx(_reference_losses(data_fn, steps), abs=2e-5)
    rings_after = set(glob.glob(os.path.join(ring_base_dir(), "ray_tpu_torch_pp*")))
    assert rings_after <= rings_before


@pytest.mark.chaos
@pytest.mark.slow  # ~10 s kill-past-budget drill: runs under `-m chaos`
def test_pipeline_restart_budget_exhausts_typed(ray_cluster):
    """Past max_restarts the failure propagates typed, not as a hang."""
    from ray_tpu_torch.train.sharding.pipeline_plane import StageFailedError

    data_fn = _data(4)
    plane = _plane(microbatches=2, step_timeout_s=4.0, max_restarts=0)
    try:
        _run(plane, data_fn, 1)
        ray_tpu_torch.kill(plane.actors[0])
        with pytest.raises(StageFailedError):
            _run(plane, data_fn, 2)
    finally:
        plane.stop()
