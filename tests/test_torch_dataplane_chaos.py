"""Dataplane chaos drills of the port: copies of the serve, pipeline-plane,
podracer and compiled-DAG drills of ``tests/test_dataplane_chaos.py``.
The compiled-channel layer that
carries serve calls and token streams and compiled-DAG edges is drilled
with the seeded ``chan:<path-glob>:<action>`` chaos rules, and every
consumer must recover with TYPED errors and ZERO corrupted values
delivered to user code:

    consumer          corrupt_frame        torn_write (mid-frame    close / socket drop
                                           writer kill)
    serve dataplane   typed timeout,       typed timeout,           transparent RPC
                      replica skips        replica skips            fallback, exact result
    serve (replica    typed ActorDied,     (same CRC path as        —
    response side)    lazy re-attach       corrupt)
    pipeline plane    checkpoint-restart,  checkpoint-restart,      reattach/StageFailed
                      loss parity          loss parity              (kill drill: test_torch_pipeline_plane)
    podracer plane    edge retired, runner (same CRC path)          reattach, else respawn
                      respawned; a corrupt                          (kill drill:
                      weight snapshot is                            test_torch_rllib_podracer)
                      never adopted
    compiled DAG      graph fails CLOSED   transparent epoch        transparent epoch
                      (multiplicity        reattach + seq replay,   reattach + seq replay,
                      unknowable), typed   exact                    exact

Chaos specs ride env vars set BEFORE ``ray_tpu_torch.init`` so every
spawned worker process inherits the same seeded, replayable schedule.
"""

import os

import pytest

import ray_tpu_torch
from ray_tpu_torch import exceptions


@pytest.fixture()
def chaos_env():
    """Set a seeded chan:* chaos spec BEFORE cluster processes spawn;
    restore + deactivate after, whatever the test did."""
    saved = {}
    # many clusters share the machine under xdist: no 2 GiB arena
    # prefault, and no memory monitor killing this test's workers for the
    # others' memory
    for k, v in {"RAY_TPU_TORCH_arena_prefault_bytes": "0",
                 "RAY_TPU_TORCH_memory_monitor_enabled": "0"}.items():
        saved.setdefault(k, os.environ.get(k))
        os.environ[k] = v

    def set_spec(spec: str, seed: str = "7") -> None:
        for k, v in {
            "RAY_TPU_TORCH_testing_chaos_spec": spec,
            "RAY_TPU_TORCH_testing_chaos_seed": seed,
        }.items():
            saved.setdefault(k, os.environ.get(k))
            os.environ[k] = v
        from ray_tpu_torch._private.chaos import CHAOS

        CHAOS.reset()

    yield set_spec
    try:
        ray_tpu_torch.shutdown()
    except Exception:  # noqa: BLE001 — test may have shut down already
        pass
    for k, old in saved.items():
        if old is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = old
    from ray_tpu_torch._private.chaos import CHAOS

    CHAOS.reset()


def test_serve_dataplane_corrupt_torn_close_request_frames(chaos_env):
    """Router-side faults on the request ring: a corrupted frame and a
    torn (mid-write-killed) frame are consumed by the replica's CRC
    check and surface to the caller as typed GetTimeoutError — never a
    wrong value, never a wedged dataplane; a chaos close of the ring
    falls back to the RPC path with the EXACT result.  Streams keep
    working afterwards."""
    chaos_env(
        "chan:*ray_tpu_torch_serve_*/req:corrupt_frame:at=3,"
        "chan:*ray_tpu_torch_serve_*/req:torn_write:at=6,"
        "chan:*ray_tpu_torch_serve_*/req:close:at=9"
    )
    ray_tpu_torch.init(num_cpus=4)
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve._private.dataplane import ChannelClient
    from ray_tpu_torch.serve._private.router import _routers

    @serve.deployment(name="ReqDrill")
    class ReqDrill:
        def __call__(self, payload):
            return {"echo": payload}

        def tokens(self, n):
            for i in range(n):
                yield {"tok": i}

    try:
        h = serve.run(ReqDrill.bind(), name="req_drill")
        assert h.remote(0).result(timeout=30) == {"echo": 0}
        router = _routers[h.deployment_name]
        assert any(
            isinstance(v, ChannelClient) for v in router._dataplanes.values()
        ), "drill is vacuous: dataplane never attached"
        exact, typed = 0, 0
        for i in range(1, 12):
            try:
                assert h.remote(i).result(timeout=4.0) == {"echo": i}
                exact += 1
            except exceptions.GetTimeoutError:
                typed += 1  # the corrupted/torn request, consumed replica-side
        # corrupt + torn lost exactly their own frame each; the chaos
        # close fell back to RPC with the exact result (no user error)
        assert typed == 2 and exact == 9
        # the plane is healthy again: calls and streams exact
        assert h.remote("after").result(timeout=30) == {"echo": "after"}
        assert list(h.options(stream=True).tokens.remote(5)) == [
            {"tok": i} for i in range(5)
        ]
    finally:
        serve.shutdown()


def test_serve_dataplane_corrupt_response_frame_typed_and_reattaches(chaos_env):
    """Replica-side fault: one corrupted RESPONSE frame kills the
    router's demux (a response's request id is unknowable, so waiters
    would hang) — the affected call gets the typed ActorDiedError, the
    dataplane is evicted, and the next call re-attaches and is exact.
    Zero corrupted payloads ever reach user code."""
    chaos_env("chan:*ray_tpu_torch_serve_*/resp:corrupt_frame:at=2")
    ray_tpu_torch.init(num_cpus=4)
    from ray_tpu_torch import serve

    @serve.deployment(name="RespDrill")
    class RespDrill:
        def __call__(self, payload):
            return {"echo": payload}

    try:
        h = serve.run(RespDrill.bind(), name="resp_drill")
        outcomes = []
        for i in range(6):
            try:
                r = h.remote(i).result(timeout=30)
                assert r == {"echo": i}, r  # exact or typed — never wrong
                outcomes.append("ok")
            except exceptions.ActorDiedError:
                outcomes.append("died")
        assert outcomes.count("died") == 1  # exactly the corrupted frame
        assert outcomes[0] == "ok" and outcomes[-1] == "ok"
    finally:
        serve.shutdown()


@pytest.mark.slow  # ~30 s restart-parity drill; dataplane chaos smoke covers it
def test_pipeline_plane_corrupt_and_torn_frames_restart_with_parity(chaos_env):
    """Driver-side faults on the pipeline's tgt edge: one corrupted
    frame and one torn (mid-write-killed) frame each surface in the
    reading stage as the typed ChannelCorruptionError, the plane
    restarts from its checkpoint (restarts == 2, one per fault), and
    the final losses match the undisturbed single-process reference —
    a corrupted microbatch can NEVER silently poison a training step."""
    pytest.importorskip("jax")
    import test_torch_spmd as torch_spmd
    from test_torch_pipeline_plane import _data, _program, _reference_losses

    from ray_tpu_torch.train.sharding import PipelineConfig, PipelinePlane

    # tgt_in is written ONLY by the driver, so the schedule is exactly
    # two faults (per-process ordinals; stage respawns can't re-fire it)
    chaos_env(
        "chan:*ray_tpu_torch_pp_*/tgt_in:corrupt_frame:at=3,"
        "chan:*ray_tpu_torch_pp_*/tgt_in:torn_write:at=7"
    )
    ray_tpu_torch.init(num_cpus=4)
    steps = 5
    data_fn = _data(steps)
    ref = _reference_losses(data_fn, steps)
    plane = PipelinePlane(
        _program(),
        PipelineConfig(
            stages=2, microbatches=2, step_timeout_s=5.0,
            checkpoint_every=2, max_restarts=4, device="cpu",
        ),
    )
    try:
        losses = torch_spmd.within(lambda: plane.run(data_fn, steps), 120.0)
        assert plane.restarts == 2  # one checkpoint-restart per fault
        assert losses == pytest.approx(ref, abs=2e-5)
    finally:
        plane.stop()


@pytest.mark.slow  # ~20 s respawn drill; dataplane chaos smoke covers the path
def test_podracer_stream_corruption_retires_edge_and_respawns(chaos_env):
    """Runner-side fault: a corrupted trajectory fragment is caught by
    the intake's CRC check (typed, counted), the edge is retired and the
    runner respawned at the current generation; a corrupted weight
    broadcast is never adopted (the runner keeps its previous snapshot).
    Training proceeds through the churn with finite losses and zero
    garbage fragments (per-runner seq contiguity is asserted inside the
    plane)."""
    import time

    import numpy as np
    import test_torch_spmd as torch_spmd
    from test_torch_rllib_podracer import _ppo_podracer_cfg

    chaos_env(
        "chan:*ray_tpu_torch_rllib_*/traj:corrupt_frame:at=6,"
        "chan:*ray_tpu_torch_rllib_*/weights:corrupt_frame:at=2"
    )
    ray_tpu_torch.init(num_cpus=4)

    def run():
        algo = _ppo_podracer_cfg().build()
        try:
            outs = [algo.train() for _ in range(4)]
            plane = algo.env_runner_group
            deadline = time.monotonic() + 60
            while plane.replacements < 1 and time.monotonic() < deadline:
                algo.train()
            last = algo.train()
            return (outs, last, plane.runner_deaths, plane.replacements,
                    sum(rs.alive for rs in plane.streams))
        finally:
            algo.cleanup()

    outs, last, deaths, replacements, alive = torch_spmd.within(run, 120.0)
    for out in outs:
        assert out["num_env_steps_sampled"] > 0
        assert np.isfinite(out["total_loss"])
    # at least one runner hit its corrupted fragment, was retired typed
    # (never delivered) and replaced at the live generation
    assert deaths >= 1 and replacements >= 1 and alive >= 1
    assert np.isfinite(last["total_loss"])


def test_dag_socket_torn_and_drop_reattach_exact(chaos_env):
    """Cross-raylet compiled-DAG edges under mid-frame connection cuts
    (torn_write) and abrupt socket drops (close), on BOTH the driver's
    input edge and the remote actor's result edge: the writer re-dials
    its peer's listener with the pairing token at a bumped epoch and
    replays unacked frames, the reader re-accepts via the shared
    reattach() helper — every execution's result is EXACT, nothing is
    lost, duplicated, or reordered."""
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.dag import InputNode

    chaos_env(
        "chan:socket:*:torn_write:at=3,"
        "chan:socket:*:close:at=8"
    )
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 4})
    c.add_node(num_cpus=2, resources={"edge": 4})
    c.wait_for_nodes()
    ray_tpu_torch.init(address=c.address)

    @ray_tpu_torch.remote(resources={"edge": 0.1})
    class Far:
        def step(self, x):
            return x * 2 + 1

    try:
        far = Far.bind()
        with InputNode() as inp:
            dag = far.step.bind(inp)
        compiled = dag.experimental_compile(max_inflight=4)
        assert compiled._channels_on
        assert "socket" in {d["kind"] for d in compiled._descs.values()}
        try:
            # per-process write ordinals: the driver's input writes hit
            # torn at 3 and close at 8; the actor's result writes hit
            # the same ordinals in ITS process — four faults total, all
            # healed by epoch reattach + seq replay, zero lost results
            for i in range(20):
                assert ray_tpu_torch.get(compiled.execute(i), timeout=30) == i * 2 + 1
            # the faults really fired and really reattached: both
            # driver-side endpoints lived through at least one epoch bump
            epochs = [compiled._driver_in[0][0].epoch, compiled._driver_out[0].epoch]
            assert max(epochs) >= 2, epochs
        finally:
            compiled.teardown()
    finally:
        ray_tpu_torch.shutdown()
        c.shutdown()


def test_dag_ring_frame_corruption_fails_closed_never_wrong(chaos_env):
    """Frame corruption on compiled-DAG ring edges FAILS CLOSED: a
    corrupted frame's multiplicity is unknowable (it may have been a
    TAG_BATCH of K executions), so delivering any fixed number of error
    values would desync the per-edge FIFO and hand later executions'
    results to the wrong refs.  Every get() up to the fault is exact;
    the fault and everything after it raises TYPED (corruption or
    closed) — zero wrong values, and teardown still works."""
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.experimental.channel import (
        ChannelClosed,
        ChannelCorruptionError,
        ChannelTimeout,
    )

    # per-process ordinals: the driver's input writes hit at=5; the
    # actor's result writes hit at=5 in ITS process — the first fault
    # to land fail-closes the graph, whichever side it is
    chaos_env("chan:*ray_tpu_torch_dag_*:corrupt_frame:at=5")
    ray_tpu_torch.init(num_cpus=4)

    @ray_tpu_torch.remote
    class Echo:
        def step(self, x):
            return x + 100

    echo = Echo.bind()
    with InputNode() as inp:
        dag = echo.step.bind(inp)
    compiled = dag.experimental_compile(max_inflight=4)
    assert compiled._channels_on
    try:
        exact, typed = 0, 0
        for i in range(10):
            try:
                assert ray_tpu_torch.get(compiled.execute(i), timeout=15) == i + 100
                exact += 1
            except (ChannelCorruptionError, ChannelClosed, ChannelTimeout):
                typed += 1
        assert typed >= 1, "chaos never fired — drill is vacuous"
        assert exact >= 3  # the executions before the fault were exact
        # the graph stays fail-closed: no later get can mis-associate
        with pytest.raises((ChannelCorruptionError, ChannelClosed, ChannelTimeout)):
            ray_tpu_torch.get(compiled.execute(99), timeout=5)
    finally:
        compiled.teardown()
