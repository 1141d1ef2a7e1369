"""Podracer trajectory plane: env-runner actors stream fixed-shape
trajectory fragments over compiled-DAG channels into the learner
(PAPERS.md "Podracer architectures for scalable Reinforcement
Learning" — the sebulba actor/learner split; RLAX demonstrates the same
streaming-into-a-sharded-learner shape at LLM scale).

The synchronous plane pays one actor RPC round-trip per rollout
(`sample() → get() → update()`, runners idle while the learner
updates).  Here neither side ever waits on the other:

  runner ──traj ring/socket──▶ intake thread ──queue──▶ learner loop
     ▲                                                      │
     └────────── weight ring/socket (gen-tagged) ◀──────────┘

* One **trajectory channel** per runner (runner writes, learner reads):
  mmap ring same-node, persistent socket cross-raylet — the serve
  dataplane's placement rule, no object-store items on the hot path.
  Ring flow control IS the backpressure: a slow learner parks runners
  in `write_value` (fragments are never dropped or reordered).
* One **weight channel** per runner (learner writes, runner reads):
  generation-tagged snapshots published with `try_write_value` so a
  slow runner can never stall the learner; runners drain to the newest
  snapshot between fragments (bounded off-policy staleness — the
  elastic plane's generation idea applied to policy weights).
* A daemon **intake thread** drains every trajectory channel into one
  bounded queue (`rllib_trajectory_queue_depth`); the learner loop pops
  fragments and folds them into one update on the learner's device.
* Runner death is detected by its streaming call's ObjectRef resolving;
  `maintain()` closes the dead edge and (optionally) spawns a
  replacement that joins at the *current* weight generation.

Fragments and weights cross the channels as numpy (a fragment's columns,
the learner's ``{name: ndarray}`` weights): the wire would send a torch
tensor through its pickle fallback.  Ring directories are named
``ray_tpu_torch_rllib_*``, beside the port's other planes' rings.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ray_tpu_torch.experimental.channel import (
    Channel,
    ChannelClosed,
    ChannelCorruptionError,
    ChannelTimeout,
    FanoutChannel,
    SocketListener,
    dial,
    node_hosts,
    reattach,
    ring_base_dir,
)

logger = logging.getLogger(__name__)

# Fragment payload keys (wire-encoded dict of numpy columns + scalars).
FRAG_SEQ = "seq"
FRAG_GEN = "gen"
FRAG_WORKER = "worker"
FRAG_COLS = "cols"
FRAG_LAST_VALUES = "last_values"
FRAG_EPISODE_RETURNS = "episode_returns"
FRAG_EPISODE_LENS = "episode_lens"
FRAG_ENV_STEPS = "env_steps"


def _estimate_fragment_bytes(
    env_creator, module_spec, fragment_length: int, num_envs: int
) -> int:
    """Estimate of one wire-encoded fragment from the env's ACTUAL obs
    dtype (uint8 image obs are 1/4 the float32 guess — over-sizing the
    ring quadruples the in-flight pipeline and therefore the weight lag
    every buffered fragment carries when the learner is the bottleneck).
    The obs column dominates; the six scalar columns ride along."""
    obs_nbytes = None
    try:
        probe = env_creator()
        space = getattr(probe, "observation_space", None)
        if space is not None and getattr(space, "shape", None):
            obs_nbytes = int(np.prod(space.shape)) * np.dtype(space.dtype).itemsize
        probe.close()
    except Exception:  # noqa: BLE001 — fall back to the spec-based guess
        pass
    if obs_nbytes is None:
        obs_elems = (
            int(np.prod(module_spec.obs_shape))
            if module_spec.obs_shape
            else module_spec.observation_dim
        )
        obs_nbytes = obs_elems * 4
    per_step = obs_nbytes + 64
    return fragment_length * num_envs * per_step + (64 << 10)


class _RunnerStream:
    """Learner-side view of one runner edge: actor handle + channels."""

    def __init__(self, index: int):
        self.index = index  # stable slot (worker_index = index + 1)
        self.actor = None
        self.traj = None  # read endpoint
        self.weights = None  # write endpoint (anakin mode only)
        self.stream_ref = None
        self.alive = False
        self.last_gen = 0  # newest generation written to this runner
        self.ring_dir: Optional[str] = None
        # Slot in the shared same-node weight fan-out ring (None =
        # dedicated weight channel).  Replacements always get dedicated
        # rings: an evicted fan-out slot is tombstoned permanently.
        self.fanout_index: Optional[int] = None


class TrajectoryPlane:
    """Owns the env-runner actors and their channel edges; duck-types
    the EnvRunnerGroup surface the Algorithm driver touches
    (`sync_weights`, `aggregate_metrics`, `stop`)."""

    def __init__(
        self,
        env_creator: Callable[[], Any],
        module_spec,
        *,
        num_env_runners: int = 2,
        num_envs_per_runner: int = 4,
        fragment_length: int = 64,
        seed: int = 0,
        num_cpus_per_runner: float = 1,
        restart_failed: bool = True,
        policy_mode: str = "anakin",
        inference_handle=None,
        trajectory_queue_size: int = 8,
        env_to_module=None,
        module_to_env=None,
        explore: bool = True,
        traj_capacity: Optional[int] = None,
    ):
        import ray_tpu_torch

        assert policy_mode in ("anakin", "sebulba"), policy_mode
        self._ray = ray_tpu_torch
        self.env_creator = env_creator
        self.module_spec = module_spec
        self.num_env_runners = max(1, num_env_runners)
        self.num_envs = num_envs_per_runner
        self.fragment_length = fragment_length
        self.seed = seed
        self.policy_mode = policy_mode
        self.inference_handle = inference_handle
        self.restart_failed = restart_failed
        self.explore = explore
        self._make_runner_args = dict(
            env_creator=env_creator,
            module_spec=module_spec,
            num_envs=num_envs_per_runner,
            rollout_fragment_length=fragment_length,
            compute_advantages=False,
            seed=seed,
            inference_backend="cpu",
            env_to_module=env_to_module,
            module_to_env=module_to_env,
            mask_autoreset=False,  # fixed shapes: LOSS_MASK marks resets
        )
        from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner

        # No auto-restart: a restarted actor would come back without its
        # channel endpoints; maintain() spawns proper replacements.
        self._remote_cls = ray_tpu_torch.remote(
            num_cpus=num_cpus_per_runner, max_restarts=0
        )(SingleAgentEnvRunner)
        self.streams: List[_RunnerStream] = [
            _RunnerStream(i) for i in range(self.num_env_runners)
        ]
        self.queue: "queue.Queue" = queue.Queue(maxsize=max(2, trajectory_queue_size))
        self._traj_capacity = 0
        self._traj_capacity_override = traj_capacity
        self._weight_capacity = 0
        self._started = False
        self._closing = False
        # Same-node weight broadcast fan-out: N
        # same-node anakin runners share ONE 1-to-N shm ring — one
        # snapshot write per broadcast instead of N ring copies.
        self._fanout: Optional[FanoutChannel] = None
        self._fanout_path: Optional[str] = None
        self._fanout_dir: Optional[str] = None
        self._intake: Optional[threading.Thread] = None
        self._episode_returns: List[float] = []
        self._episode_lens: List[int] = []
        self._env_steps_received = 0
        self.fragments_received = 0
        self.runner_deaths = 0
        self.replacements = 0

    # -- lifecycle ------------------------------------------------------
    def start(self, weights, generation: int = 1) -> None:
        """Spawn runners, attach channels, seed weights, fire streams."""
        if self._started:
            return
        from ray_tpu_torch._private.config import CONFIG

        wbytes = _weights_nbytes(weights)
        self._weight_capacity = max(1 << 20, 4 * (wbytes + (64 << 10)))
        frag_bytes = _estimate_fragment_bytes(
            self.env_creator, self.module_spec, self.fragment_length, self.num_envs
        )
        # ~2 fragments per ring, NOT a big byte floor: the ring is the
        # runner's share of the bounded pipeline, and every buffered
        # fragment ages one weight generation per learner update — a
        # deep ring converts directly into staleness (and wasted drops)
        # whenever the learner is the bottleneck.  The config floor
        # guards against estimate error, no more.
        floor = int(getattr(CONFIG, "rllib_stream_min_buffer_kb", 256)) << 10
        self._traj_capacity = self._traj_capacity_override or max(
            floor, 2 * frag_bytes + (64 << 10)
        )
        if self.policy_mode == "sebulba" and self.inference_handle is not None:
            # the server must hold weights BEFORE any runner's first step
            self._ray.get(
                self.inference_handle.set_weights.remote(weights, generation),
                timeout=60,
            )
        # Create every actor first so placement is known before wiring:
        # same-node anakin runners (2+) share ONE weight fan-out ring.
        for rs in self.streams:
            rs.actor = self._remote_cls.remote(
                worker_index=rs.index + 1, **self._make_runner_args
            )
        nodes = {rs.index: self._resolve_node(rs) for rs in self.streams}
        if self.policy_mode == "anakin":
            my_node = self._my_node()
            cohort = [rs for rs in self.streams if nodes[rs.index] == my_node]
            if len(cohort) >= 2:
                self._create_fanout(cohort)
        for rs in self.streams:
            self._wire(rs, nodes[rs.index], weights, generation)
        if self._fanout is not None:
            # One ring write seeds the whole cohort (every reader was
            # registered by its stream_attach above, so nothing races).
            self._fanout.write_value((generation, weights))
        self._intake = threading.Thread(
            target=self._intake_loop, daemon=True, name="rllib-traj-intake"
        )
        self._intake.start()
        self._started = True

    def _create_fanout(self, cohort: List[_RunnerStream]) -> None:
        d = os.path.join(
            ring_base_dir(), f"ray_tpu_torch_rllib_fo_{uuid.uuid4().hex[:12]}"
        )
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, "weights_fanout")
        self._fanout = FanoutChannel(
            path, n_readers=len(cohort),
            max_size=self._weight_capacity, create=True,
        )
        self._fanout_path = path
        self._fanout_dir = d
        for i, rs in enumerate(cohort):
            rs.fanout_index = i

    def _drop_fanout(self) -> None:
        """Retire the shared fan-out ring (every reader evicted): the
        cohort's survivors respawn on dedicated rings via maintain()."""
        f, self._fanout = self._fanout, None
        self._fanout_path = None
        for rs in self.streams:
            if rs.fanout_index is not None:
                rs.fanout_index = None
                if rs.weights is f:
                    rs.weights = None
        if f is not None:
            try:
                f.close()
            except Exception:  # noqa: BLE001
                pass
            try:
                f.unlink()
            except Exception:  # noqa: BLE001
                pass
        if self._fanout_dir:
            import shutil

            shutil.rmtree(self._fanout_dir, ignore_errors=True)
            self._fanout_dir = None

    def _spawn(self, rs: _RunnerStream, weights, generation: int) -> None:
        """(Re)create one runner on slot ``rs`` and wire its edges; the
        runner joins at the CURRENT weight generation.  Replacements
        always get dedicated channels — a fan-out slot tombstones on
        eviction, so a respawned runner can never rejoin one."""
        rs.actor = self._remote_cls.remote(
            worker_index=rs.index + 1, **self._make_runner_args
        )
        rs.fanout_index = None
        self._wire(rs, self._resolve_node(rs), weights, generation)

    def _wire(self, rs: _RunnerStream, runner_node: str, weights,
              generation: int) -> None:
        self._attach(rs, runner_node)
        # run_stream FIRST: it performs the weight-listener accept on
        # the cross-node path and blocks in _drain_weights for the first
        # snapshot — writing a large snapshot before any reader exists
        # would fill the un-accepted socket's kernel buffers and stall.
        rs.stream_ref = rs.actor.run_stream.remote(
            self.fragment_length, self.explore
        )
        if self.policy_mode == "anakin" and rs.fanout_index is None:
            rs.weights.write_value((generation, weights))
        rs.last_gen = generation
        rs.alive = True

    def _my_node(self) -> str:
        from ray_tpu_torch._private.worker import get_global_worker

        worker = get_global_worker()
        return worker.node_id.hex() if worker.node_id is not None else ""

    def _resolve_node(self, rs: _RunnerStream) -> str:
        import ray_tpu_torch
        from ray_tpu_torch._private.ids import ActorID, NodeID
        from ray_tpu_torch._private.worker import get_global_worker

        worker = get_global_worker()
        runner_node = None
        deadline = time.monotonic() + 30.0
        while runner_node is None and time.monotonic() < deadline:
            for a in worker.gcs_client.call("list_actors", None):
                if ActorID(a["actor_id"]) == rs.actor._actor_id and a.get("node_id"):
                    runner_node = NodeID(a["node_id"]).hex()
                    break
            if runner_node is None:
                ray_tpu_torch.get(rs.actor.ping.remote(), timeout=30)
        if runner_node is None:
            raise RuntimeError(f"env runner {rs.index} has no node")
        return runner_node

    def _attach(self, rs: _RunnerStream, runner_node: str) -> None:
        """Build the channel edges to one runner.  Placement picks the
        transport exactly like compiled DAGs / the serve dataplane:
        same node → shm rings, cross node → persistent sockets.  A
        fan-out cohort member reads weights from the SHARED ring (its
        reader slot) instead of a dedicated one."""
        import ray_tpu_torch
        from ray_tpu_torch._private.worker import get_global_worker

        worker = get_global_worker()
        my_node = worker.node_id.hex() if worker.node_id is not None else ""

        want_weights = self.policy_mode == "anakin"
        if runner_node == my_node:
            d = os.path.join(ring_base_dir(), f"ray_tpu_torch_rllib_{uuid.uuid4().hex[:12]}")
            os.makedirs(d, exist_ok=True)
            traj_path = os.path.join(d, "traj")
            w_path = os.path.join(d, "weights")
            use_fanout = rs.fanout_index is not None and self._fanout is not None
            Channel.create_file(traj_path, self._traj_capacity)
            if want_weights and not use_fanout:
                Channel.create_file(w_path, self._weight_capacity)
            spec = {
                "kind": "ring",
                "traj_path": traj_path,
                "w_path": w_path if want_weights and not use_fanout else None,
                "w_fanout_path": self._fanout_path if use_fanout else None,
                "w_fanout_index": rs.fanout_index if use_fanout else None,
                "inference": self.inference_handle,
            }
            ray_tpu_torch.get(rs.actor.stream_attach.remote(spec), timeout=30)
            rs.traj = Channel(traj_path)
            if use_fanout:
                rs.weights = self._fanout  # shared write endpoint
            else:
                rs.weights = Channel(w_path) if want_weights else None
            rs.ring_dir = d
            # tmpfs must not outlive an abandoned/killed learner (mirror
            # the serve-attach and compiled-DAG ring-dir finalizers)
            import shutil
            import weakref

            rs._ring_finalizer = weakref.finalize(
                rs, shutil.rmtree, d, ignore_errors=True
            )
        else:
            hosts = node_hosts(worker)
            listener = SocketListener()
            spec = {
                "kind": "socket",
                "traj_addr": (hosts.get(my_node, "127.0.0.1"), listener.port),
                "want_weights": want_weights,
                "inference": self.inference_handle,
            }
            try:
                reply = ray_tpu_torch.get(rs.actor.stream_attach.remote(spec), timeout=30)
                rs.traj = listener.accept("read", timeout=30.0)
            except Exception:
                listener.close()
                raise
            rs.weights = (
                dial((hosts.get(runner_node, "127.0.0.1"), reply["w_port"]), "write")
                if want_weights
                else None
            )
            rs.ring_dir = None

    # -- intake ---------------------------------------------------------
    def _intake_loop(self) -> None:
        """Round-robin drain of every live trajectory channel into the
        bounded queue.  A full queue stops the drain → rings fill →
        runners park in write_value: the whole backpressure chain is
        flow control, never drops."""
        from ray_tpu_torch._private import telemetry
        from ray_tpu_torch.util import tracing

        spins = 0
        while not self._closing:
            progressed = False
            for rs in self.streams:
                if not rs.alive or rs.traj is None:
                    continue
                try:
                    if not rs.traj.pending():
                        continue
                    _tag, frag, tctx = rs.traj.read_value_traced(timeout=10.0)
                except ChannelCorruptionError:
                    # The fragment is gone and per-runner seqs must stay
                    # contiguous: retire the edge (typed, counted) and
                    # let maintain() respawn the runner at the current
                    # generation.  No corrupted fragment ever reaches
                    # the learner.
                    if not self._closing:
                        logger.warning(
                            "trajectory frame from runner %d failed "
                            "integrity validation; retiring the edge",
                            rs.index + 1,
                        )
                        rs.alive = False
                    continue
                except ChannelClosed:
                    # Connection-level death: one shared reattach (the
                    # runner's writer re-dials on its next fragment)
                    # before the heavy respawn path.
                    if not self._closing and not reattach(rs.traj, timeout=2.0):
                        rs.alive = False  # maintain() reclaims + respawns
                    continue
                except ChannelTimeout:
                    if not self._closing:
                        rs.alive = False  # maintain() reclaims + respawns
                    continue
                except Exception:  # noqa: BLE001 — a BUG, not runner churn
                    if not self._closing:
                        logger.exception(
                            "intake error on runner %d edge", rs.index + 1
                        )
                        rs.alive = False
                    continue
                progressed = True
                t_in = time.time()
                while not self._closing:
                    try:
                        self.queue.put(frag, timeout=0.2)
                        break
                    except queue.Full:
                        telemetry.set_rllib_queue_depth(self.queue.qsize())
                telemetry.set_rllib_queue_depth(self.queue.qsize())
                if tctx is not None:
                    # Traced fragment: record the intake hop (read → learner
                    # queue) as a child of the channel.read span, so runner
                    # traces stay connected through the learner.
                    tracing.record_span(
                        "rllib.intake",
                        t_in,
                        time.time(),
                        {"runner": rs.index + 1},
                        context=(tctx[0], tracing.new_span_id(), tctx[1]),
                    )
            if progressed:
                spins = 0
            else:
                spins += 1
                time.sleep(min(0.002, 0.0001 * spins))

    # -- learner-side API ----------------------------------------------
    def get_fragment(self, timeout: Optional[float] = 10.0) -> Optional[dict]:
        """Pop one fragment (None on timeout); folds the fragment's
        episode stats into the plane's aggregate metrics."""
        from ray_tpu_torch._private import telemetry

        try:
            frag = self.queue.get(timeout=timeout)
        except queue.Empty:
            return None
        if frag is None:  # stop() sentinel
            return None
        telemetry.set_rllib_queue_depth(self.queue.qsize())
        self.fragments_received += 1
        self._env_steps_received += int(frag.get(FRAG_ENV_STEPS, 0))
        self._episode_returns.extend(frag.get(FRAG_EPISODE_RETURNS) or [])
        self._episode_lens.extend(frag.get(FRAG_EPISODE_LENS) or [])
        return frag

    def broadcast(self, weights, generation: int) -> None:
        """Publish a generation-tagged snapshot to every live runner
        without ever blocking on a slow one (try-write; the runner
        drains to the newest snapshot, so a skipped write just means
        the next one carries a later generation)."""
        if self.policy_mode == "sebulba" and self.inference_handle is not None:
            self._ray.get(
                self.inference_handle.set_weights.remote(weights, generation),
                timeout=30,
            )
            for rs in self.streams:
                rs.last_gen = generation
            return
        if self._fanout is not None:
            cohort = [
                rs for rs in self.streams
                if rs.fanout_index is not None and rs.alive
            ]
            if cohort:
                try:
                    # ONE snapshot write covers the whole cohort.  The
                    # short timeout emulates try-write: a parked reader
                    # just means the next broadcast carries a later
                    # generation (and a blocked write probes for dead
                    # readers, so a SIGKILLed one gets evicted rather
                    # than wedging the learner).
                    self._fanout.write_value(
                        (generation, weights), timeout=0.05
                    )
                    for rs in cohort:
                        rs.last_gen = generation
                except ChannelTimeout:
                    pass
                except (ChannelClosed, Exception):  # noqa: BLE001
                    # every reader evicted: the broadcast has no
                    # audience — retire the ring; maintain() respawns
                    # the cohort on dedicated channels
                    for rs in cohort:
                        rs.alive = False
                    self._drop_fanout()
        for rs in self.streams:
            if not rs.alive or rs.weights is None or rs.fanout_index is not None:
                continue
            try:
                if rs.weights.try_write_value((generation, weights)):
                    rs.last_gen = generation
            except (ChannelClosed, Exception):  # noqa: BLE001
                rs.alive = False

    def refresh(self, worker_index: int, weights, generation: int) -> None:
        """Staleness remediation: push the current snapshot at one
        runner (blocking is fine here — a stale runner's ring has free
        space by construction: it consumed its backlog to fall behind)."""
        for rs in self.streams:
            if rs.index + 1 == worker_index and rs.alive and rs.weights is not None:
                try:
                    rs.weights.write_value((generation, weights), timeout=5.0)
                    if rs.fanout_index is not None:
                        # the shared ring delivered to the whole cohort
                        for peer in self.streams:
                            if peer.alive and peer.fanout_index is not None:
                                peer.last_gen = generation
                    else:
                        rs.last_gen = generation
                except ChannelTimeout:
                    pass  # runner parked mid-fragment; next broadcast covers it
                except (ChannelClosed, Exception):  # noqa: BLE001
                    if rs.fanout_index is not None:
                        for peer in self.streams:
                            if peer.fanout_index is not None:
                                peer.alive = False
                        self._drop_fanout()
                    else:
                        rs.alive = False

    def maintain(self, weights_fn: Callable[[], Any], generation: int) -> int:
        """Detect dead runners (GCS actor state DEAD, or intake marked
        the edge dead) and spawn replacements joining at the current
        generation.  ``weights_fn`` is called lazily — only a respawn
        needs a host snapshot.  One GCS view covers every runner; the
        probe is throttled to ~2 Hz so the steady-state learner loop
        pays nothing.  Driver-thread only."""
        if self._closing:
            return 0
        states: Dict[Any, str] = {}
        now = time.monotonic()
        if now - getattr(self, "_last_actor_probe", 0.0) >= 0.5:
            self._last_actor_probe = now
            try:
                from ray_tpu_torch._private.ids import ActorID
                from ray_tpu_torch._private.worker import get_global_worker

                for a in get_global_worker().gcs_client.call("list_actors", None):
                    states[ActorID(a["actor_id"])] = a["state"]
            except Exception:  # noqa: BLE001 — next probe retries
                states = {}
        replaced = 0
        for rs in self.streams:
            ended = (
                rs.actor is not None
                and states.get(rs.actor._actor_id) == "DEAD"
            )
            if rs.alive and not ended:
                continue
            if rs.actor is not None:
                # first observation of this death: reclaim the edge
                self.runner_deaths += 1
                self._close_stream(rs)
            if self.restart_failed and not self._closing:
                try:
                    self._spawn(rs, weights_fn(), generation)
                    replaced += 1
                    self.replacements += 1
                    logger.warning(
                        "env runner %d replaced (joins at generation %d)",
                        rs.index + 1,
                        generation,
                    )
                except Exception:  # noqa: BLE001 — next maintain() retries
                    logger.exception("env runner %d respawn failed", rs.index + 1)
        return replaced

    def _close_stream(self, rs: _RunnerStream) -> None:
        rs.alive = False
        for chan in (rs.traj, rs.weights):
            try:
                # The shared fan-out ring outlives any one cohort
                # member: the dead member's reader slot is evicted by
                # the next blocked broadcast, the ring itself closes
                # only in stop()/_drop_fanout().
                if chan is not None and chan is not self._fanout:
                    chan.close()
            except Exception:  # noqa: BLE001
                pass
        rs.traj = rs.weights = None
        rs.fanout_index = None
        if rs.ring_dir:
            import shutil

            shutil.rmtree(rs.ring_dir, ignore_errors=True)
            rs.ring_dir = None
        if rs.stream_ref is not None:
            # Closing the channels unblocks run_stream (ChannelClosed);
            # joining it here keeps teardown quiet — the kill below is
            # then a no-op for a cleanly-exited actor.
            try:
                self._ray.get(rs.stream_ref, timeout=3)
            except Exception:  # noqa: BLE001 — died mid-stream (chaos path)
                pass
        if rs.actor is not None:
            try:
                self._ray.kill(rs.actor)
            except Exception:  # noqa: BLE001
                pass
            rs.actor = None
        rs.stream_ref = None

    # -- EnvRunnerGroup duck surface ------------------------------------
    def sync_weights(self, weights) -> None:
        """Checkpoint-restore path parity with EnvRunnerGroup: a blocking
        broadcast is fine off the hot loop."""
        gen = max((rs.last_gen for rs in self.streams), default=0) + 1
        self.broadcast(weights, gen)

    def aggregate_metrics(self) -> Dict[str, Any]:
        returns = self._episode_returns[-100:]
        lens = self._episode_lens[-100:]
        return {
            "num_episodes": len(self._episode_returns),
            "episode_return_mean": float(np.mean(returns)) if returns else None,
            "episode_len_mean": float(np.mean(lens)) if lens else None,
        }

    def stop(self) -> None:
        self._closing = True
        for rs in self.streams:
            self._close_stream(rs)
        self._drop_fanout()
        if self.inference_handle is not None:
            try:
                self._ray.kill(self.inference_handle)
            except Exception:  # noqa: BLE001
                pass
        # unblock any consumer parked in queue.get
        try:
            self.queue.put_nowait(None)
        except queue.Full:
            pass


def _weights_nbytes(weights) -> int:
    """Bytes of the learner's ``get_weights()``: {name: ndarray}."""
    return sum(int(np.asarray(v).nbytes) for v in weights.values())


class PodracerDriver:
    """Learner-loop half of the podracer split: consumes fragments under
    the staleness bound, drives the fused update cadence, and publishes
    generation-tagged weights.

    Off-policy contract: a fragment whose generation lags the learner by
    more than ``max_weight_lag`` is NOT consumed — its runner is
    refreshed (current weights pushed to its channel) and the fragment
    dropped, so no update ever trains on data older than the bound."""

    def __init__(
        self,
        plane: TrajectoryPlane,
        learner_group,
        *,
        max_weight_lag: int = 4,
        broadcast_interval: int = 1,
    ):
        self.plane = plane
        self.learner_group = learner_group
        self.max_weight_lag = max(0, int(max_weight_lag))
        self.broadcast_interval = max(1, int(broadcast_interval))
        self.generation = 0
        self.updates = 0
        self.stale_dropped = 0
        self.env_steps_consumed = 0
        self._idle_s = 0.0
        self._busy_since = time.monotonic()

    def ensure_started(self) -> None:
        if not self.plane._started:
            self.generation = 1
            self.plane.start(self.learner_group.get_weights(), self.generation)

    def collect(self, num_fragments: int, timeout: float = 120.0) -> List[dict]:
        """Block until ``num_fragments`` fragments pass the staleness
        bound (a FIXED count keeps the fused update's (K, T, N) shapes
        static → one compiled program); records learner idle time
        (`rllib_learner_idle_fraction`) while waiting."""
        from ray_tpu_torch._private import telemetry

        self.ensure_started()
        out: List[dict] = []
        deadline = time.monotonic() + timeout
        while len(out) < num_fragments:
            t0 = time.monotonic()
            frag = self.plane.get_fragment(timeout=min(2.0, max(0.05, deadline - t0)))
            self._idle_s += time.monotonic() - t0
            if frag is None:
                self.plane.maintain(self.learner_group.get_weights, self.generation)
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"only {len(out)}/{num_fragments} trajectory fragments "
                        f"within {timeout}s "
                        f"({sum(rs.alive for rs in self.plane.streams)} live runners)"
                    )
                continue
            lag = self.generation - int(frag.get(FRAG_GEN, 0))
            telemetry.observe_rllib_weight_lag(lag)
            if lag > self.max_weight_lag:
                # Refresh-before-consume: the runner gets current weights
                # and this over-stale fragment never reaches the update.
                self.stale_dropped += 1
                self.plane.refresh(
                    int(frag.get(FRAG_WORKER, 0)),
                    self.learner_group.get_weights(),
                    self.generation,
                )
                continue
            out.append(frag)
            self.env_steps_consumed += int(frag.get(FRAG_ENV_STEPS, 0))
        return out

    def pending_fragments(self) -> int:
        """Fragments already buffered learner-side (the IMPALA-style
        loop drains these without blocking)."""
        return self.plane.queue.qsize()

    def after_update(self) -> None:
        """Bump the generation and publish on the configured cadence;
        never blocks on a slow runner (try-writes)."""
        from ray_tpu_torch._private import telemetry

        self.updates += 1
        self.generation += 1
        if self.updates % self.broadcast_interval == 0:
            self.plane.broadcast(self.learner_group.get_weights(), self.generation)
        self.plane.maintain(self.learner_group.get_weights, self.generation)
        now = time.monotonic()
        window = now - self._busy_since
        if window > 0:
            telemetry.set_rllib_learner_idle(min(1.0, self._idle_s / window))
        self._busy_since = now
        self._idle_s = 0.0

    def metrics(self) -> Dict[str, Any]:
        return {
            "weight_generation": self.generation,
            "num_updates": self.updates,
            "stale_fragments_dropped": self.stale_dropped,
            "fragments_received": self.plane.fragments_received,
            "trajectory_queue_depth": self.plane.queue.qsize(),
            "runner_deaths": self.plane.runner_deaths,
            "runner_replacements": self.plane.replacements,
        }
