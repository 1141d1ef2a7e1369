"""IMPALA (reference: rllib/algorithms/impala/impala.py + the learner
queue threads in rllib/execution/learner_thread.py): asynchronous
actor-learner — env runners sample against slightly-stale policies;
the learner corrects off-policy-ness with V-trace.

A bounded learner queue and a dedicated learner thread decouple sampling
from SGD.  The driver thread keeps the sample pipeline full and
broadcasts weights; the learner thread drains the queue and steps the
learner on its device.  A slow update therefore never stalls rollouts —
the queue absorbs them (and applies backpressure when full).

V-trace's reversed scan over time is a reversed loop over T on ``[T, B]``
tensors, run without autograd: its targets carry no gradient (the
reference's ``stop_gradient``).  Only ``logp`` (through the policy loss),
``values`` (through the value loss) and the entropy carry one."""

from __future__ import annotations

import logging
import queue
import threading
from typing import Any, Dict, Optional

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import Learner
from ray_tpu_torch.rllib.utils.sample_batch import (
    ACTIONS,
    LOGP,
    LOSS_MASK,
    OBS,
    REWARDS,
    TERMINATEDS,
    TRUNCATEDS,
)

logger = logging.getLogger(__name__)


class IMPALAConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 5e-4
        self.vtrace_clip_rho = 1.0
        self.vtrace_clip_c = 1.0
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.rollout_fragment_length = 50
        self.num_env_runners = 2
        self.max_requests_in_flight = 2
        self.broadcast_interval = 1  # learner steps between weight pushes
        self.learner_queue_size = 16
        self.learner_queue_timeout_s = 30.0
        # Podracer staleness: IMPALA bumps the generation once per
        # FRAGMENT (not per train batch like PPO), so a pipelined queue
        # alone puts consumed fragments several generations back —
        # V-trace's rho/c clipping exists to correct exactly that.  A
        # tight bound here would discard most of a healthy pipeline.
        self.max_weight_lag = 16

    @property
    def algo_class(self):
        return IMPALA


def vtrace_discounts_and_mask(batch, gamma: float):
    """Per-row discounts + loss mask for a flat time-sequence batch of
    tensors.

    Both terminations AND truncations cut the bootstrap chain — the
    reference bootstraps truncations with the final obs's value, but in
    the flat fixed-shape layout cutting (slightly pessimistic at time
    limits) is what keeps garbage from crossing episode boundaries.
    Rows kept only for shape stability (autoreset rows, LOSS_MASK=0)
    contribute nothing to the losses."""
    import torch

    done = batch[TERMINATEDS].float()
    if TRUNCATEDS in batch:
        done = torch.maximum(done, batch[TRUNCATEDS].float())
    discounts = gamma * (1.0 - done)
    mask = batch[LOSS_MASK] if LOSS_MASK in batch else torch.ones_like(discounts)
    return discounts, mask


def vtrace_returns(logp, behaviour_logp, values, rewards, discounts,
                   rho_clip: float, c_clip: float, bootstrap_value=None):
    """V-trace targets (Espeholt et al. 2018, eqs. 1-2) over time-major
    tensors (time first; any trailing batch axes), by a reversed loop over
    time.  ``bootstrap_value`` is the value of the observation after the
    last row (the streaming fragment path carries it; the flat path
    approximates with the last row's value).  Returns (vs, pg_advantages,
    rhos): ``vs`` and ``pg_advantages`` carry no gradient, ``rhos`` keeps
    the graph of ``logp`` (it feeds only a metric)."""
    import torch

    rhos = torch.exp(logp - behaviour_logp)
    with torch.no_grad():
        clipped_rho = torch.clamp(rhos, max=rho_clip)
        clipped_c = torch.clamp(rhos, max=c_clip)
        v = values.detach()
        boot = v[-1:] if bootstrap_value is None else bootstrap_value.detach()[None]
        next_v = torch.cat([v[1:], boot], dim=0)
        deltas = clipped_rho * (rewards + discounts * next_v - v)
        acc = torch.zeros_like(v[0])
        vs_minus_v = torch.empty_like(v)
        for t in range(rewards.shape[0] - 1, -1, -1):
            acc = deltas[t] + discounts[t] * clipped_c[t] * acc
            vs_minus_v[t] = acc
        vs = v + vs_minus_v
        next_vs = torch.cat([vs[1:], boot], dim=0)
        pg_adv = clipped_rho * (rewards + discounts * next_vs - v)
    return vs, pg_adv, rhos


class IMPALALearner(Learner):
    """V-trace actor-critic loss."""

    preserve_time_order = True  # the loss scans the row axis as time

    def _vtrace_loss(self, logp, entropy, values, behaviour_logp, rewards, discounts, mask,
                     bootstrap_value=None):
        cfg = self.config
        vs, pg_adv, rhos = vtrace_returns(
            logp, behaviour_logp, values, rewards, discounts,
            cfg.get("vtrace_clip_rho", 1.0), cfg.get("vtrace_clip_c", 1.0),
            bootstrap_value=bootstrap_value,
        )
        denom = mask.sum() + 1e-8
        pi_loss = -((logp * pg_adv) * mask).sum() / denom
        vf_loss = 0.5 * (((values - vs) ** 2) * mask).sum() / denom
        ent = (entropy * mask).sum() / denom
        total = pi_loss + cfg.get("vf_loss_coeff", 0.5) * vf_loss - cfg.get("entropy_coeff", 0.01) * ent
        return total, {"policy_loss": pi_loss.detach(), "vf_loss": vf_loss.detach(),
                       "entropy": ent.detach(), "mean_rho": rhos.detach().mean()}

    def compute_loss(self, batch: Dict[str, Any]):
        logp, entropy, values = self.module.forward_train(batch[OBS], batch[ACTIONS])
        discounts, mask = vtrace_discounts_and_mask(batch, self.config.get("gamma", 0.99))
        return self._vtrace_loss(logp, entropy, values, batch[LOGP], batch[REWARDS],
                                 discounts, mask)

    def fragment_loss(self, cols: Dict[str, Any], last_values):
        """Streaming-fragment V-trace on time-major [T, B] columns, with
        the runner-carried bootstrap value for the T+1-th observation
        (the flat path had to approximate it with the last row).  The
        net sees flat [T*B] rows; the temporal loop runs on [T, B]."""
        import torch

        obs, actions = cols[OBS], cols[ACTIONS]
        T, B = actions.shape[0], actions.shape[1]
        logp, entropy, values = self.module.forward_train(
            obs.reshape((T * B,) + tuple(obs.shape[2:])), actions.reshape(T * B))
        done = torch.maximum(cols[TERMINATEDS].float(), cols[TRUNCATEDS].float())
        discounts = self.config.get("gamma", 0.99) * (1.0 - done)
        mask = cols[LOSS_MASK] if LOSS_MASK in cols else torch.ones_like(discounts)
        return self._vtrace_loss(logp.reshape(T, B), entropy.reshape(T, B), values.reshape(T, B),
                                 cols[LOGP], cols[REWARDS], discounts, mask,
                                 bootstrap_value=last_values)


class LearnerThread(threading.Thread):
    """Bounded-queue learner thread (reference:
    rllib/execution/learner_thread.py LearnerThread).  The driver feeds
    batches with put(); this thread drains and steps the learner.  The
    weight snapshot used by broadcasts is read by the driver — never
    taken on this thread — and the learner hands out only whole
    generations (``Learner.get_weights`` takes its weight lock, which
    each optimizer step holds)."""

    def __init__(self, learner_group, maxsize: int = 16):
        super().__init__(daemon=True, name="impala-learner")
        self.learner_group = learner_group
        self.inqueue: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self.metrics: Dict[str, float] = {}
        self.steps_trained = 0
        self.batches_trained = 0
        self.stopped = False
        self._error: Optional[BaseException] = None

    def put(self, batch, timeout: float) -> bool:
        """Backpressure point: blocks up to timeout when SGD lags."""
        try:
            self.inqueue.put(batch, timeout=timeout)
            return True
        except queue.Full:
            return False

    def run(self):
        while not self.stopped:
            try:
                batch = self.inqueue.get(timeout=0.2)
            except queue.Empty:
                continue
            if batch is None:
                break
            try:
                self.metrics = self.learner_group.update_from_batch(batch)
                self.steps_trained += batch.count
                self.batches_trained += 1
            except BaseException as e:  # noqa: BLE001 — surfaced to the driver by check_error
                self._error = e
                self.stopped = True

    def check_error(self):
        if self._error is not None:
            raise self._error

    def stop(self):
        self.stopped = True
        try:
            self.inqueue.put_nowait(None)
        except queue.Full:
            pass


class IMPALA(Algorithm):
    config_class = IMPALAConfig
    learner_class = IMPALALearner
    # keep fixed batch shapes for the time-scan loss (see env_runner)
    mask_autoreset_rows = False

    def _needs_advantages(self) -> bool:
        return False  # V-trace replaces GAE

    def _learner_config(self) -> Dict[str, Any]:
        cfg = self.algo_config
        out = super()._learner_config()
        out.update(
            vtrace_clip_rho=cfg.vtrace_clip_rho,
            vtrace_clip_c=cfg.vtrace_clip_c,
            vf_loss_coeff=cfg.vf_loss_coeff,
            entropy_coeff=cfg.entropy_coeff,
        )
        return out

    def setup(self, config: Dict[str, Any]):
        super().setup(config)
        self._in_flight: Dict[Any, int] = {}  # sample ObjectRef -> runner idx
        self._learner_thread: Optional[LearnerThread] = None
        self._broadcast_at = 0  # batches_trained when weights were last pushed

    def _ensure_learner_thread(self) -> LearnerThread:
        if self._learner_thread is None:
            self._learner_thread = LearnerThread(
                self.learner_group, maxsize=self.algo_config.learner_queue_size
            )
            self._learner_thread.start()
        return self._learner_thread

    def _podracer_step(self) -> Dict[str, Any]:
        """Podracer IMPALA: runners stream fragments continuously over
        channels; this loop consumes at least one and then drains
        whatever is already buffered — one time-major V-trace update per
        fragment, weights published generation-tagged on the broadcast
        cadence.  Rollouts never wait on SGD; SGD never waits on a
        rollout round-trip."""
        drv = self._podracer
        frags = list(drv.collect(1))
        while drv.pending_fragments() > 0 and len(frags) < 8:
            try:
                frags.extend(drv.collect(1, timeout=2.0))
            except TimeoutError:
                break
        metrics: Dict[str, Any] = {}
        steps = 0
        for frag in frags:
            metrics = self.learner_group.update_from_fragments([frag])
            drv.after_update()
            steps += int(frag["env_steps"])
        self._timesteps_total += steps
        out = dict(metrics)
        out["num_env_steps_sampled"] = steps
        out["num_env_steps_trained"] = drv.env_steps_consumed
        out.update(drv.metrics())
        return out

    def training_step(self) -> Dict[str, Any]:
        """Async pipeline: the driver keeps max_requests_in_flight
        sample() calls outstanding per runner and feeds arrivals to the
        learner thread; SGD and sampling overlap fully (reference:
        impala.py training_step + learner_thread.py)."""
        import ray_tpu_torch

        cfg = self.algo_config
        if cfg.podracer_enabled:
            return self._podracer_step()
        group = self.env_runner_group
        if group.local_runner is not None:
            # degenerate sync mode
            batch = group.sample(cfg.rollout_fragment_length)
            metrics = self.learner_group.update_from_batch(batch)
            group.sync_weights(self.learner_group.get_weights())
            self._timesteps_total += batch.count
            metrics["num_env_steps_sampled"] = batch.count
            return metrics

        lt = self._ensure_learner_thread()
        lt.check_error()

        # fill the pipeline
        for i, runner in enumerate(group.runners):
            outstanding = sum(1 for v in self._in_flight.values() if v == i)
            for _ in range(cfg.max_requests_in_flight - outstanding):
                self._in_flight[runner.sample.remote(cfg.rollout_fragment_length)] = i

        ready, _ = ray_tpu_torch.wait(list(self._in_flight), num_returns=1, timeout=30.0)
        steps = 0
        for ref in ready:
            i = self._in_flight.pop(ref)
            try:
                batch = ray_tpu_torch.get(ref)
            except Exception as e:  # noqa: BLE001
                logger.warning("impala: lost sample from runner %d: %s", i, e)
                continue
            # hand to the learner thread; sampling continues regardless
            if not lt.put(batch, timeout=cfg.learner_queue_timeout_s):
                logger.warning("impala: learner queue full for %.0fs, dropping batch",
                               cfg.learner_queue_timeout_s)
            else:
                steps += batch.count
            # immediately re-request from this runner
            self._in_flight[group.runners[i].sample.remote(cfg.rollout_fragment_length)] = i

        # weight broadcast off the learner thread's critical path
        if lt.batches_trained - self._broadcast_at >= cfg.broadcast_interval:
            group.sync_weights(self.learner_group.get_weights())
            self._broadcast_at = lt.batches_trained

        self._timesteps_total += steps
        metrics = dict(lt.metrics)
        metrics["num_env_steps_sampled"] = steps
        metrics["num_env_steps_trained"] = lt.steps_trained
        metrics["learner_queue_size"] = lt.inqueue.qsize()
        return metrics

    def cleanup(self):
        if self._learner_thread is not None:
            self._learner_thread.stop()
        super().cleanup()

    stop = cleanup
