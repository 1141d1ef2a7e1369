"""The port's podracer plane on its own cluster, on the CPU: fragments over
compiled channels, IMPALA's per-fragment updates, the runner-kill drill,
the staleness bound, flow-control backpressure and the same-node weight
fan-out (copies of tests/test_rllib_podracer.py's tier-1 tests, learners
on ``cpu``), then the sebulba inference server, IMPALA's LearnerThread
pipeline without the plane and an APPO run.

No JAX here; one cluster for the module, and only tests that need it (the
suite's workers each start the module's cluster for the tests they take).
Every test runs under its own deadline (``within``, 120 s)."""

import time

import numpy as np
import pytest
import torch

import ray_tpu_torch

from test_torch_spmd import within

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ray_cluster():
    with pytest.MonkeyPatch.context() as mp:
        # no 2 GiB shm arena prefault per raylet, and no memory monitor
        # (it watches the whole machine the suite shares)
        mp.setenv("RAY_TPU_TORCH_arena_prefault_bytes", "0")
        mp.setenv("RAY_TPU_TORCH_memory_monitor_enabled", "0")
        ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
        yield ray_tpu_torch
        ray_tpu_torch.shutdown()


def _ppo_podracer_cfg(**overrides):
    from ray_tpu_torch.rllib import PPOConfig

    cfg = (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(
            num_env_runners=2, num_envs_per_env_runner=2, rollout_fragment_length=32
        )
        .podracer()
        .training(lr=3e-4, train_batch_size=128, minibatch_size=64, num_epochs=2,
                  model={"hidden": (8,)})
        .learners(device="cpu")
        .debugging(seed=1)
    )
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg


def _impala_cfg(cls_name="IMPALAConfig", podracer=True):
    import ray_tpu_torch.rllib as rllib

    cfg = (
        getattr(rllib, cls_name)()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2, num_envs_per_env_runner=2)
        .training(lr=5e-4, rollout_fragment_length=16, model={"hidden": (8,)})
        .learners(device="cpu")
        .debugging(seed=3)
    )
    return cfg.podracer() if podracer else cfg


def test_podracer_ppo_streams_over_channels(ray_cluster):
    """PPO trains off streamed fragments: channels attached (ring
    transport on one node), generations advance, GAE is computed by the
    learner (fragments carry raw columns)."""
    def run():
        algo = _ppo_podracer_cfg().build()
        try:
            out1 = algo.train()
            out2 = algo.train()
            plane = algo.env_runner_group
            kinds = [rs.traj.kind for rs in plane.streams if rs.alive]
            return out1, out2, kinds
        finally:
            algo.cleanup()

    out1, out2, kinds = within(run)
    assert out1["num_env_steps_sampled"] > 0
    assert out2["weight_generation"] > out1["weight_generation"]
    assert out2["fragments_received"] > 0
    assert kinds and all(k == "ring" for k in kinds)  # same-node runners ride shm rings
    assert np.isfinite(out2["total_loss"])


def test_podracer_impala_async_updates(ray_cluster):
    """IMPALA podracer: one V-trace update per fragment off the stream;
    sampling never waits on SGD."""
    def run():
        algo = _impala_cfg().build()
        try:
            steps, out = 0, None
            for _ in range(4):
                out = algo.train()
                steps += out["num_env_steps_sampled"]
            return steps, out
        finally:
            algo.cleanup()

    steps, out = within(run)
    assert steps > 0
    assert out["num_updates"] >= 4
    assert np.isfinite(out["total_loss"])


def test_podracer_chaos_runner_kill_mid_stream(ray_cluster):
    """Kill one env runner mid-stream: the learner keeps consuming the
    survivor's fragments (zero failed updates), and the replacement
    runner joins at the CURRENT weight generation."""
    def run():
        algo = _ppo_podracer_cfg().build()
        try:
            algo.train()
            plane = algo.env_runner_group
            drv = algo._podracer
            gen_at_kill = drv.generation
            ray_tpu_torch.kill(plane.streams[0].actor)
            time.sleep(1.0)  # the death report reaches the GCS actor table
            updates_before = drv.updates
            sampled = [algo.train()["num_env_steps_sampled"] for _ in range(3)]
            workers = set()
            deadline = time.monotonic() + 60
            while len(workers) < 2 and time.monotonic() < deadline:
                for frag in drv.collect(2):
                    workers.add(frag["worker"])
            return (sampled, drv.updates - updates_before, plane.runner_deaths,
                    plane.replacements, plane.streams[0].alive, plane.streams[0].last_gen,
                    gen_at_kill, workers)
        finally:
            algo.cleanup()

    sampled, updates, deaths, replacements, alive, last_gen, gen_at_kill, workers = within(run)
    assert all(s > 0 for s in sampled)
    assert updates == 3  # zero failed updates
    assert deaths >= 1 and replacements >= 1
    # the replacement joined at (or past) the generation current at
    # respawn time, never at the dead runner's stale generation
    assert alive and last_gen >= gen_at_kill
    assert workers == {1, 2}  # and its fragments flow


def test_podracer_staleness_bound_refreshes_runner(ray_cluster):
    """A runner more than max_weight_lag generations behind is refreshed
    BEFORE its fragments are consumed: over-stale fragments are dropped,
    the refresh pushes current weights, and the next consumed fragment
    is inside the bound."""
    def run():
        algo = _ppo_podracer_cfg(max_weight_lag=1).build()
        try:
            algo.train()
            plane = algo.env_runner_group
            drv = algo._podracer
            # the learner races ahead of the broadcast plane: generations
            # bump with publishes suppressed, so in-flight fragments go stale
            real_broadcast = plane.broadcast
            plane.broadcast = lambda *a, **k: None
            try:
                for _ in range(4):
                    drv.after_update()
            finally:
                plane.broadcast = real_broadcast
            dropped_before = drv.stale_dropped
            frags = drv.collect(2, timeout=60.0)
            return drv.stale_dropped - dropped_before, [drv.generation - f["gen"] for f in frags]
        finally:
            algo.cleanup()

    dropped, lags = within(run)
    assert dropped > 0  # stale fragments dropped, their runners refreshed
    assert all(lag <= 1 for lag in lags)


def test_podracer_backpressure_parks_never_drops(ray_cluster):
    """A slow learner parks runners via channel flow control: with a tiny
    ring and a bounded queue the runner stalls once the pipeline fills,
    and every fragment then arrives exactly once, in order (per-runner
    seq contiguous from 1)."""
    import gymnasium as gym

    from ray_tpu_torch.rllib import RLModuleSpec
    from ray_tpu_torch.rllib.core.stream import TrajectoryPlane

    def run():
        creator = lambda: gym.make("CartPole-v1")  # noqa: E731
        probe = creator()
        spec = RLModuleSpec.from_gym_env(probe, hidden=(8,))
        probe.close()
        plane = TrajectoryPlane(
            creator, spec, num_env_runners=1, num_envs_per_runner=2, fragment_length=16,
            seed=0, trajectory_queue_size=2,
            traj_capacity=48 * 1024,  # a few dozen fragments, then the park
        )
        weights = spec.build(torch.Generator().manual_seed(0)).get_weights()
        try:
            plane.start(weights, generation=1)
            time.sleep(2.5)  # nothing consumed: the pipeline fills and the runner parks
            # freeze production so the drain counts what the parked pipeline
            # held (ring records survive the writer's death)
            plane.restart_failed = False
            ray_tpu_torch.kill(plane.streams[0].actor)
            time.sleep(2.5)  # a graceful exit escalates to SIGKILL at 2 s
            seqs = []
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline and len(seqs) <= 200:
                frag = plane.get_fragment(timeout=0.5)
                if frag is None:
                    break
                seqs.append(frag["seq"])
            return seqs
        finally:
            plane.stop()

    seqs = within(run)
    # parked: a free-running runner makes hundreds of fragments in 2.5 s;
    # flow control bounded it to the pipeline (queue 2 + a 48 KiB ring)
    assert 2 <= len(seqs) <= 64, seqs
    assert seqs == list(range(1, len(seqs) + 1)), seqs  # never dropped, never reordered


def test_podracer_same_node_weight_fanout(ray_cluster):
    """Same-node anakin runners share ONE fan-out weight ring: a single
    broadcast write covers the whole cohort and generations keep
    advancing for every member."""
    def run():
        algo = _ppo_podracer_cfg().build()
        try:
            out1 = algo.train()
            plane = algo.env_runner_group
            cohort = [rs for rs in plane.streams if rs.fanout_index is not None]
            shared = plane._fanout is not None and all(rs.weights is plane._fanout for rs in cohort)
            out2 = algo.train()
            return (out1, out2, shared, sorted(rs.fanout_index for rs in cohort),
                    [rs.last_gen for rs in cohort])
        finally:
            algo.cleanup()

    out1, out2, shared, slots, gens = within(run)
    assert shared and slots == [0, 1]
    assert out2["weight_generation"] > out1["weight_generation"]
    assert all(g > 0 for g in gens)


@pytest.mark.chaos
@pytest.mark.slow  # a copy of the reference's slow drill (its replacement runner compiled cold)
def test_podracer_fanout_member_kill_replacement(ray_cluster):
    """A killed fan-out cohort member's replacement comes back on a
    DEDICATED ring (fan-out reader slots tombstone on eviction) while
    the survivor keeps streaming from the shared ring."""
    algo = _ppo_podracer_cfg().build()
    try:
        algo.train()
        plane = algo.env_runner_group
        cohort = [rs for rs in plane.streams if rs.fanout_index is not None]
        assert len(cohort) == 2
        # kill one cohort member: the replacement must NOT rejoin the
        # shared ring (its reader slot is evicted/tombstoned) — it gets
        # a dedicated weight channel and still receives broadcasts
        victim = cohort[0]
        ray_tpu_torch.kill(victim.actor)
        time.sleep(1.0)  # death report propagates to the GCS actor table
        for _ in range(3):
            algo.train()
        assert plane.replacements >= 1
        replaced = plane.streams[victim.index]
        assert replaced.alive
        assert replaced.fanout_index is None
        assert replaced.weights is not plane._fanout
        # fragments flow from both worker indices again (the reference's
        # generous deadline: its replacement runner paid a cold compile)
        workers = set()
        drv = algo._podracer
        deadline = time.monotonic() + 120
        while len(workers) < 2 and time.monotonic() < deadline:
            for frag in drv.collect(2):
                workers.add(frag["worker"])
        assert workers == {1, 2}
    finally:
        algo.cleanup()


def test_podracer_sebulba_inference_server(ray_cluster):
    """Sebulba split on the CPU: every runner's actions come from the
    shared continuous-batching inference server, and fragments carry the
    server's weight generation."""
    def run():
        cfg = _ppo_podracer_cfg(policy_mode="sebulba")
        cfg.rollout_fragment_length = 16
        cfg.train_batch_size = 64
        algo = cfg.build()
        try:
            handle = algo.env_runner_group.inference_handle
            outs = [algo.train() for _ in range(2)]
            server_gen = ray_tpu_torch.get(
                handle.__ray_call__.remote(lambda s: (s.generation, str(s.device))), timeout=30)
            return outs, server_gen, [rs.weights for rs in algo.env_runner_group.streams]
        finally:
            algo.cleanup()

    outs, (gen, device), weight_chans = within(run)
    assert outs[0]["num_env_steps_sampled"] > 0
    assert outs[1]["weight_generation"] >= 2 and gen == outs[1]["weight_generation"]
    assert device == "cpu"  # the learner's device
    assert all(w is None for w in weight_chans)  # weights go to the server, not the runners
    assert np.isfinite(outs[1]["total_loss"])


@pytest.mark.parametrize("cls_name", ["IMPALAConfig", "APPOConfig"])
def test_learner_thread_pipeline_without_the_plane(ray_cluster, cls_name):
    """IMPALA's and APPO's async pipeline over remote runners' sample():
    the learner thread drains the bounded queue and steps (APPO through
    its target policy), the driver broadcasts the weights, and the
    thread's metrics come back finite."""
    def run():
        algo = _impala_cfg(cls_name, podracer=False).build()
        try:
            outs = []
            deadline = time.monotonic() + 60
            while (not outs or outs[-1].get("num_env_steps_trained", 0) < 64) and (
                    time.monotonic() < deadline):
                outs.append(algo.train())
            lt = algo._learner_thread
            return outs, lt.batches_trained, lt.is_alive()
        finally:
            algo.cleanup()

    outs, batches, alive = within(run)
    assert alive and batches >= 2
    assert sum(o["num_env_steps_sampled"] for o in outs) > 0
    assert np.isfinite(outs[-1]["total_loss"]) and np.isfinite(outs[-1]["mean_rho"])
