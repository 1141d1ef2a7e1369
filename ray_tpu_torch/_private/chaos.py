"""Deterministic fault-injection plane.

Every comm plane in the system — driver/worker -> GCS, driver/worker ->
raylet, submitter -> leased worker (direct), raylet -> raylet (object
manager) — dispatches through rpc.RpcServer, and that dispatch consults
this module.  One composable spec therefore injects faults into all four
planes at once (reference: src/ray/rpc/rpc_chaos.h, generalized from
"drop first N" to a seeded, replayable schedule).

Spec grammar (``testing_chaos_spec``, via ``_system_config`` or the
``RAY_TPU_TORCH_testing_chaos_spec`` env var every spawned cluster process
inherits)::

    rule[,rule...]
    rule    := pattern:action[:key=value]...
    pattern := fnmatch glob over the RPC method name ("submit_task",
               "store_*", "*"), a pubsub channel ("pubsub:nodes",
               "pubsub:actors" — one decision per published message), a
               process fault point ("@worker.exec", "@raylet.tick",
               "@gcs.tick"), or a directional link
               ("net:<src-glob>-><dst-glob>" — see below)
    action  := drop_req | drop_rep | delay_req | delay_rep | dup_req |
               kill | preempt
    keys    := n=<max firings, -1 unlimited; default 1>
               p=<firing probability per match; default 1.0>
               ms=<delay milliseconds; for preempt: the advance-notice
                  window before the process kill; default 50>
               after=<skip the first K matches; default 0>
               at=<fire exactly on the K-th match; shorthand for
                  after=K-1:n=1>
               start=<seconds after rule parse before the rule arms;
                  default 0>
               for=<seconds the rule stays armed once started; absent =
                  forever.  start/for are WALL-CLOCK windows — they
                  trade ordinal-replay determinism for time-shaped
                  faults, which is how a spawn-time spec expresses "hold
                  this partition for 20 s, then heal" or a flapping link
                  (several staggered cut windows on one pattern)>

Examples::

    submit_task:dup_req:n=1            # duplicate the first submit
    store_get:delay_req:ms=200:p=0.5:n=-1   # half of all gets +200ms
    request_worker_lease:drop_rep:n=2  # eat the first two lease grants
    @worker.exec:kill:at=3             # worker dies on its 3rd task
    pubsub:nodes:drop_req:n=1          # eat one nodes-channel publish
    @raylet.tick:preempt:at=5:ms=3000  # on its 5th report tick the
                                       # raylet receives a 3 s preemption
                                       # notice (drain), then dies
    net:raylet*->gcs:cut               # asymmetric partition: every
                                       # frame traveling raylet->GCS is
                                       # blackholed (GCS->raylet flows)
    net:*->node2:flaky:p=0.3           # 30% of frames INTO node2 lost
    net:node1->node2:slow:ms=500       # sustained half-second one-way
                                       # delay (the gray-failure model)
    net:raylet*->gcs:cut:for=20        # the partition heals after 20 s
    net:node2->gcs:cut:start=5:for=3   # one flap window: the link cuts
                                       # at t+5 and recovers at t+8

Link-level rules (``net:<src-glob>-><dst-glob>:{cut|flaky|slow}``)
match the *direction of travel* of one frame: ``src`` is the sending
process's net identity (``net_name()`` — the ``chaos_net_name`` config
if set, else a role default like "gcs"/"raylet-<id8>"), ``dst`` is the
receiver's.  They are consulted at the rpc.py transport send paths
(requests, replies, pushes, dials) and at the SocketChannel dial/frame
paths (where ``dst`` is ``addr:<host>:<port>`` — an RPC-plane
partition leaves the compiled dataplane connected unless a rule targets
it).  ``cut`` blackholes every matching frame (default ``n=-1``);
``flaky`` drops each with seeded probability ``p`` (default 0.5);
``slow`` adds ``ms`` of one-way delay per frame.  An asymmetric
partition is one rule; a full partition is the two directed rules.

Determinism: every rule owns a ``random.Random`` seeded from
(``testing_chaos_seed``, rule index) and its own match counter, so a
rule's fire/skip verdict depends only on the ordinal of the match —
never on cross-method interleaving or wall-clock.  The same seed + spec
replays the identical fault schedule; the schedule is logged (bounded)
and hashable via ``schedule_digest()`` for drills to assert on.

The legacy ``testing_rpc_failure`` spec ("method:kind:count", kind in
req|rep) keeps working: it is folded into the rule table as
``method:drop_<kind>:n=count``.
"""

from __future__ import annotations

import fnmatch
import hashlib
import random
import threading
from typing import List, NamedTuple, Optional, Tuple

from ray_tpu_torch._private.config import CONFIG

_ACTIONS = ("drop_req", "drop_rep", "delay_req", "delay_rep", "dup_req", "kill",
            "preempt",
            # channel-level dataplane faults (pattern "chan:<path-glob>",
            # consulted in the write paths of experimental/channel.py)
            "drop_frame", "delay_frame", "corrupt_frame", "torn_write",
            "close",
            # checkpoint-write fault (pattern "ckpt:<phase-glob>",
            # consulted in train/checkpoint_plane.py; kill/torn_write
            # are shared with the families above)
            "bit_flip",
            # directional link faults (pattern "net:<src>-><dst>",
            # consulted at rpc.py send/dial paths and SocketChannel
            # dial/frame paths)
            "cut", "flaky", "slow")

# The dataplane subset of _ACTIONS: rules carrying one of these only
# ever match channel writes (decide() skips them and they skip RPCs).
_CHANNEL_ACTIONS = ("drop_frame", "delay_frame", "corrupt_frame",
                    "torn_write", "close")

# The checkpoint-plane subset: matched only by decide_ckpt() against
# "ckpt:<phase-glob>" patterns (phases: shard, precommit, manifest).
# kill = SIGKILL mid-phase; torn_write = truncated bytes published under
# the final name; bit_flip = one byte of a committed shard flipped.
_CKPT_ACTIONS = ("kill", "torn_write", "bit_flip")

# The link-level subset: matched only by decide_net() against
# "net:<src-glob>-><dst-glob>" patterns.  cut = blackhole (sustained by
# default: n=-1 unless given); flaky = seeded p-drop per frame (p
# defaults to 0.5); slow = sustained one-way delay (ms key).
_NET_ACTIONS = ("cut", "flaky", "slow")

# Bound on the in-memory schedule log; fired entries past this are
# counted but not stored.
_MAX_SCHEDULE = 20_000


class Decision(NamedTuple):
    drop: bool
    delay_s: float
    dup: bool

    @property
    def clean(self) -> bool:
        return not self.drop and not self.dup and self.delay_s <= 0


_CLEAN = Decision(False, 0.0, False)


class ChannelDecision(NamedTuple):
    """Fault verdict for one channel frame write (experimental/channel.py
    consults this at every ``write``/``write_value`` when the plane is
    active).  ``corrupt`` flips payload bytes after the CRC trailer is
    computed (the reader's CRC check must catch it); ``torn`` publishes
    a half-written record (ring) or cuts the connection mid-frame
    (socket) — the SIGKILLed-writer model; ``close`` closes the channel
    out from under both peers (ring: closed flag; socket: abrupt TCP
    close, no poison — the transient-drop model the reattach path
    recovers from)."""

    drop: bool
    delay_s: float
    corrupt: bool
    torn: bool
    close: bool

    @property
    def clean(self) -> bool:
        return not (self.drop or self.corrupt or self.torn or self.close
                    or self.delay_s > 0)


_CHAN_CLEAN = ChannelDecision(False, 0.0, False, False, False)


class CkptDecision(NamedTuple):
    """Fault verdict for one checkpoint-write phase (consulted by
    train/checkpoint_plane.py at phases ``shard``/``precommit``/
    ``manifest``).  ``kill`` dies with os._exit mid-phase (the SIGKILL
    model — no unwind, no atexit); ``torn`` publishes truncated bytes
    under the final name (the storage-tear model the manifest CRC must
    catch at restore); ``bit_flip`` flips one byte of an
    already-committed shard (the bit-rot model)."""

    kill: bool
    torn: bool
    bit_flip: bool

    @property
    def clean(self) -> bool:
        return not (self.kill or self.torn or self.bit_flip)


_CKPT_CLEAN = CkptDecision(False, False, False)


class NetDecision(NamedTuple):
    """Fault verdict for one frame traveling a directed link.  ``drop``
    models a blackhole (the frame vanishes on the wire: calls time out,
    pushes disappear, channel sends surface a connection error and take
    the reattach path); ``delay_s`` models sustained one-way latency —
    the gray-failure signal the suspicion scorer must read as SUSPECT,
    never as a clean death."""

    drop: bool
    delay_s: float

    @property
    def clean(self) -> bool:
        return not self.drop and self.delay_s <= 0


_NET_CLEAN = NetDecision(False, 0.0)

# This process's identity on chaos links.  ``chaos_net_name`` (env-
# propagated to spawned processes, so every process on a drilled "node"
# shares the host-granularity name) wins; else the role the process
# registered at startup ("gcs", "raylet-<id8>", "driver", "worker");
# else a pid-stable fallback.
_net_role = ""


def set_net_role(role: str) -> None:
    """Record this process's default link identity (startup, once)."""
    global _net_role
    _net_role = role


def net_name() -> str:
    """This process's identity for ``net:`` rule matching."""
    name = CONFIG.chaos_net_name
    if name:
        return name
    if _net_role:
        return _net_role
    import os

    return f"proc-{os.getpid()}"


class _Rule:
    __slots__ = ("index", "pattern", "action", "n", "p", "delay_s", "after",
                 "start_s", "for_s", "t0", "matches", "fired", "rng")

    def __init__(self, index: int, pattern: str, action: str, n: int,
                 p: float, delay_s: float, after: int, seed: int,
                 start_s: float = 0.0, for_s: Optional[float] = None):
        self.index = index
        self.pattern = pattern
        self.action = action
        self.n = n
        self.p = p
        self.delay_s = delay_s
        self.after = after
        # Wall-clock arming window (start=/for= keys), anchored at rule
        # parse — i.e. the process's first chaos consultation, which for
        # spawned cluster processes is effectively process start.
        self.start_s = start_s
        self.for_s = for_s
        import time as _time

        self.t0 = _time.monotonic()
        self.matches = 0
        self.fired = 0
        # Per-rule stream: verdicts depend only on this rule's match
        # ordinal, so schedules replay regardless of how other methods
        # interleave between matches.  seed < 0 = genuinely unseeded
        # (fresh entropy per rule), matching retry._shared_rng.
        if seed >= 0:
            self.rng = random.Random(seed * 1_000_003 + index)
        else:
            self.rng = random.Random()

    def evaluate(self) -> bool:
        """One match of this rule's pattern: fire or skip (deterministic
        in the match ordinal, except the optional start/for wall-clock
        arming window — a disarmed match consumes no counters and no RNG
        draw, so the in-window schedule still replays)."""
        if self.start_s > 0 or self.for_s is not None:
            import time as _time

            dt = _time.monotonic() - self.t0
            if dt < self.start_s:
                return False
            if self.for_s is not None and dt > self.start_s + self.for_s:
                return False
        self.matches += 1
        if self.matches <= self.after:
            return False
        if 0 <= self.n <= self.fired:
            return False
        if self.p < 1.0 and self.rng.random() >= self.p:
            return False
        self.fired += 1
        return True


def _parse_rule(index: int, text: str, seed: int) -> _Rule:
    parts = text.strip().split(":")
    if len(parts) < 2:
        raise ValueError(f"chaos rule needs pattern:action, got {text!r}")
    # Patterns may themselves contain ":" (pubsub channels like
    # "pubsub:nodes"): the action is the first segment that names one,
    # everything before it is the pattern.
    action_idx = next((i for i, p in enumerate(parts) if p in _ACTIONS), -1)
    if action_idx < 1:
        raise ValueError(f"unknown chaos action in {text!r} "
                         f"(one of {', '.join(_ACTIONS)})")
    pattern, action = ":".join(parts[:action_idx]), parts[action_idx]
    kv = {}
    for part in parts[action_idx + 1:]:
        k, _, v = part.partition("=")
        kv[k] = v
    if action in _NET_ACTIONS:
        # Link rules are sustained by nature: a partition holds until
        # the spec changes, so n defaults to unlimited, and flaky drops
        # half its frames unless told otherwise.
        if not pattern.startswith("net:") or "->" not in pattern:
            raise ValueError(
                f"{action} needs a net:<src>-><dst> pattern, got {text!r}")
        n_default, p_default = -1, (0.5 if action == "flaky" else 1.0)
    else:
        n_default, p_default = 1, 1.0
    n = int(kv.get("n", n_default))
    p = float(kv.get("p", p_default))
    delay_s = float(kv.get("ms", 50)) / 1000.0
    after = int(kv.get("after", 0))
    if "at" in kv:
        after = int(kv["at"]) - 1
        n = 1
    start_s = float(kv.get("start", 0.0))
    for_s = float(kv["for"]) if "for" in kv else None
    return _Rule(index, pattern, action, n, p, delay_s, after, seed,
                 start_s=start_s, for_s=for_s)


class ChaosPlane:
    """Process-wide fault scheduler; a no-op (one dict lookup per
    dispatch is avoided entirely via the `active` fast path) unless a
    spec is configured."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rules: List[_Rule] = []
        self._parsed_for: Optional[Tuple[str, str, int]] = None
        self.schedule: List[str] = []
        self.schedule_len = 0
        self._active = False
        self._last_check = 0.0
        # Bumped by reset(): per-frame dataplane callers cache `active`
        # keyed on this so their no-chaos fast path is one int compare,
        # not a time.monotonic() throttle check per frame.
        self.rev = 0
        # True only when the parsed spec contains chan:* rules — an
        # RPC-only drill must not make every dataplane frame write take
        # the plane lock and scan the rule list just to skip it.
        self.has_channel_rules = False
        # Same fast-path flag for the checkpoint plane's ckpt:* family.
        self.has_ckpt_rules = False
        # And for the link-level net:* family (rpc send paths + channel
        # dials consult per frame).
        self.has_net_rules = False

    # ------------------------------------------------------------------
    def _ensure(self):
        # Config revalidation is throttled: the active fast path on a
        # production dispatch is one monotonic read + a float compare,
        # not three CONFIG lookups per message.  Spec changes (tests)
        # are picked up within 200 ms, or instantly via reset().
        import time

        now = time.monotonic()
        if self._parsed_for is not None and now - self._last_check < 0.2:
            return
        self._last_check = now
        spec = CONFIG.testing_chaos_spec
        legacy = CONFIG.testing_rpc_failure
        seed = int(CONFIG.testing_chaos_seed)
        key = (spec, legacy, seed)
        if key == self._parsed_for:
            return
        with self._lock:
            if key == self._parsed_for:
                return
            try:
                rules: List[_Rule] = []
                if spec:
                    for part in spec.split(","):
                        if part.strip():
                            rules.append(_parse_rule(len(rules), part, seed))
                if legacy:
                    # "method:kind:count" -> method:drop_<kind>:n=count
                    for part in legacy.split(","):
                        m, kind, count = part.split(":")
                        rules.append(_parse_rule(
                            len(rules), f"{m}:drop_{kind}:n={count}", seed))
            except ValueError:
                # A malformed spec must not detonate on every dispatch —
                # this is consulted from the RPC hot path and service
                # loops.  Log once, disable the plane, and remember the
                # bad key so the error doesn't re-raise forever.
                import logging

                logging.getLogger(__name__).exception(
                    "invalid chaos spec %r / %r — fault injection disabled",
                    spec, legacy,
                )
                rules = []
            self._rules = rules
            self._active = bool(rules)
            self.has_channel_rules = any(
                r.action in _CHANNEL_ACTIONS for r in rules
            )
            self.has_ckpt_rules = any(
                r.pattern.startswith("ckpt:") and r.action in _CKPT_ACTIONS
                for r in rules
            )
            self.has_net_rules = any(
                r.action in _NET_ACTIONS for r in rules
            )
            self.schedule = []
            self.schedule_len = 0
            self._parsed_for = key
            # a spec picked up from the env mid-process (no reset())
            # must also invalidate the dataplane's rev-keyed cache
            self.rev += 1

    @property
    def active(self) -> bool:
        self._ensure()
        return self._active

    def reset(self):
        """Drop parsed state so counters/schedule restart (tests)."""
        with self._lock:
            self._parsed_for = None
            self._last_check = 0.0
            self.rev += 1

    # ------------------------------------------------------------------
    def _log(self, rule: _Rule, verdict: str):
        entry = f"{rule.index}:{rule.pattern}:{rule.action}#{rule.matches}:{verdict}"
        self.schedule_len += 1
        if len(self.schedule) < _MAX_SCHEDULE:
            self.schedule.append(entry)

    def decide(self, method: str, kind: str) -> Decision:
        """Fault decision for one delivery of `method` (kind: "req" for
        a request/push arriving at a server, "rep" for its reply)."""
        if not self.active:
            return _CLEAN
        drop = dup = False
        delay_s = 0.0
        fired_rules = []
        with self._lock:
            for rule in self._rules:
                if rule.action in ("kill", "preempt") or not rule.action.endswith(kind):
                    continue
                if not fnmatch.fnmatchcase(method, rule.pattern):
                    continue
                fired = rule.evaluate()
                self._log(rule, "fire" if fired else "skip")
                if not fired:
                    continue
                fired_rules.append(rule)
                if rule.action.startswith("drop"):
                    drop = True
                elif rule.action.startswith("delay"):
                    delay_s += rule.delay_s
                elif rule.action == "dup_req":
                    dup = True
        for rule in fired_rules:  # outside the lock: metric writes lock too
            _count_injection(rule)
        if not drop and not dup and delay_s <= 0:
            return _CLEAN
        return Decision(drop, delay_s, dup)

    def should_drop(self, method: str, kind: str) -> bool:
        """Legacy hook-compatible view (reference: rpc_chaos.h)."""
        return self.decide(method, kind).drop

    def decide_channel(self, path: str) -> ChannelDecision:
        """Fault decision for one frame written to the channel at
        ``path`` (ring file path, ``socket:<peer>``, or a fan-out
        path).  Rules match with pattern ``chan:<path-glob>`` and one of
        the ``_CHANNEL_ACTIONS``; verdicts are deterministic in each
        rule's match ordinal exactly like the RPC rules, so a seeded
        dataplane fault schedule replays."""
        if not self.active or not self.has_channel_rules:
            return _CHAN_CLEAN
        drop = corrupt = torn = close = False
        delay_s = 0.0
        fired_rules = []
        with self._lock:
            for rule in self._rules:
                if rule.action not in _CHANNEL_ACTIONS:
                    continue
                if not rule.pattern.startswith("chan:"):
                    continue
                if not fnmatch.fnmatchcase(path, rule.pattern[5:]):
                    continue
                fired = rule.evaluate()
                self._log(rule, "fire" if fired else "skip")
                if not fired:
                    continue
                fired_rules.append(rule)
                if rule.action == "drop_frame":
                    drop = True
                elif rule.action == "delay_frame":
                    delay_s += rule.delay_s
                elif rule.action == "corrupt_frame":
                    corrupt = True
                elif rule.action == "torn_write":
                    torn = True
                else:  # close
                    close = True
        for rule in fired_rules:  # outside the lock: metric writes lock too
            _count_injection(rule)
        if not fired_rules:
            return _CHAN_CLEAN
        return ChannelDecision(drop, delay_s, corrupt, torn, close)

    def decide_ckpt(self, phase: str) -> CkptDecision:
        """Fault decision for one checkpoint-write phase (``shard``,
        ``precommit``, ``manifest``).  Rules match with pattern
        ``ckpt:<phase-glob>`` and one of the ``_CKPT_ACTIONS``; verdicts
        are deterministic in each rule's match ordinal, so a seeded
        kill-at-every-phase drill matrix replays exactly."""
        if not self.active or not self.has_ckpt_rules:
            return _CKPT_CLEAN
        kill = torn = bit_flip = False
        fired_rules = []
        with self._lock:
            for rule in self._rules:
                if rule.action not in _CKPT_ACTIONS:
                    continue
                if not rule.pattern.startswith("ckpt:"):
                    continue
                if not fnmatch.fnmatchcase(phase, rule.pattern[5:]):
                    continue
                fired = rule.evaluate()
                self._log(rule, "fire" if fired else "skip")
                if not fired:
                    continue
                fired_rules.append(rule)
                if rule.action == "kill":
                    kill = True
                elif rule.action == "torn_write":
                    torn = True
                else:  # bit_flip
                    bit_flip = True
        for rule in fired_rules:  # outside the lock: metric writes lock too
            _count_injection(rule)
        if not fired_rules:
            return _CKPT_CLEAN
        return CkptDecision(kill, torn, bit_flip)

    def decide_net(self, src: str, dst: str) -> NetDecision:
        """Fault decision for one frame traveling the directed link
        ``src -> dst``.  Rules match with pattern
        ``net:<src-glob>-><dst-glob>`` and one of ``_NET_ACTIONS``; both
        globs must match their endpoint.  Verdicts are deterministic in
        each rule's match ordinal (seeded ``flaky`` schedules replay),
        and directionality is real: ``net:a->b:cut`` blackholes a→b
        while b→a keeps flowing — the asymmetric-partition model."""
        if not self.active or not self.has_net_rules:
            return _NET_CLEAN
        drop = False
        delay_s = 0.0
        fired_rules = []
        with self._lock:
            for rule in self._rules:
                if rule.action not in _NET_ACTIONS:
                    continue
                src_glob, _, dst_glob = rule.pattern[4:].partition("->")
                if not fnmatch.fnmatchcase(src, src_glob):
                    continue
                if not fnmatch.fnmatchcase(dst, dst_glob):
                    continue
                fired = rule.evaluate()
                self._log(rule, "fire" if fired else "skip")
                if not fired:
                    continue
                fired_rules.append(rule)
                if rule.action == "slow":
                    delay_s += rule.delay_s
                else:  # cut, flaky
                    drop = True
        for rule in fired_rules:  # outside the lock: metric writes lock too
            _count_injection(rule)
        if not fired_rules:
            return _NET_CLEAN
        return NetDecision(drop, delay_s)

    # ------------------------------------------------------------------
    def maybe_kill(self, point: str) -> bool:
        """Process fault points ("worker.exec", "raylet.tick",
        "gcs.tick"): True when a kill rule fires for this ordinal.  The
        caller performs the death (os._exit) so the plane stays testable."""
        if not self.active:
            return False
        target = "@" + point
        with self._lock:
            for rule in self._rules:
                if rule.action != "kill":
                    continue
                if not fnmatch.fnmatchcase(target, rule.pattern):
                    continue
                if rule.evaluate():
                    self._log(rule, "kill")
                    _count_injection(rule)
                    return True
                self._log(rule, "skip")
        return False

    def maybe_preempt(self, point: str) -> Optional[float]:
        """Preemption fault for process fault points ("raylet.tick"):
        when a ``preempt`` rule fires for this ordinal, return the
        advance-notice window in seconds (the rule's ``ms`` key).  The
        caller models the preemption — deliver a drain notice to the
        GCS, then die at the deadline — so the whole drain plane is
        drillable and seed-replayable."""
        if not self.active:
            return None
        target = "@" + point
        with self._lock:
            for rule in self._rules:
                if rule.action != "preempt":
                    continue
                if not fnmatch.fnmatchcase(target, rule.pattern):
                    continue
                if rule.evaluate():
                    self._log(rule, "preempt")
                    _count_injection(rule)
                    return rule.delay_s
                self._log(rule, "skip")
        return None

    # ------------------------------------------------------------------
    def schedule_digest(self) -> str:
        with self._lock:
            blob = "\n".join(self.schedule).encode()
        return hashlib.sha256(blob).hexdigest()

    def schedule_snapshot(self) -> List[str]:
        with self._lock:
            return list(self.schedule)

    def stats(self) -> dict:
        """Per-rule injection accounting for the dashboard /api/chaos
        endpoint: the active spec plus each rule's match/fire counters
        (this process's view; the dashboard merges GCS + raylets)."""
        self._ensure()
        with self._lock:
            rules = [
                {
                    "index": r.index,
                    "pattern": r.pattern,
                    "action": r.action,
                    "n": r.n,
                    "p": r.p,
                    "delay_ms": round(r.delay_s * 1000, 3),
                    "after": r.after,
                    "start_s": r.start_s,
                    "for_s": r.for_s,
                    "matches": r.matches,
                    "fired": r.fired,
                }
                for r in self._rules
            ]
            schedule_len = self.schedule_len
        return {
            "active": bool(rules),
            "spec": CONFIG.testing_chaos_spec,
            "legacy_spec": CONFIG.testing_rpc_failure,
            "seed": int(CONFIG.testing_chaos_seed),
            "rules": rules,
            "schedule_len": schedule_len,
        }


def _count_injection(rule: _Rule) -> None:
    try:
        from ray_tpu_torch._private import telemetry

        telemetry.count_chaos(rule.pattern, rule.action)
        if rule.action in _NET_ACTIONS:
            telemetry.count_chaos_net(rule.pattern, rule.action)
    except Exception:
        pass


CHAOS = ChaosPlane()
