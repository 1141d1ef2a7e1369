"""Direct worker-to-worker task submission + actor-task ordering tests on
the port (a copy of the JAX package's tests/test_direct.py; it imports
neither JAX nor the JAX package).

Reference test model: python/ray/tests/test_basic.py (chained deps),
core_worker/transport tests for sequential_actor_submit_queue ordering.
"""

import threading
import time

import pytest

import ray_tpu_torch


@pytest.fixture(scope="module")
def ray_cluster():
    """Module-scoped local cluster of the port (the conftest's fixture of
    this name starts the JAX package's).  The suite runs many clusters at
    once: no 2 GiB shm arena prefault, and no memory monitor, which
    watches the whole machine."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_TORCH_arena_prefault_bytes", "0")
        mp.setenv("RAY_TPU_TORCH_memory_monitor_enabled", "0")
        ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
        yield ray_tpu_torch
        ray_tpu_torch.shutdown()


def test_chained_temporary_ref(ray_cluster):
    """Regression: `g.remote(f.remote(x))` drops the inner ref immediately;
    the in-flight direct result must still be promoted for the consumer
    (an earlier bug: ReferenceCounter.remove_owned freed the memory-store
    pending/promote state of escaped refs)."""

    @ray_tpu_torch.remote
    def plus_one(x):
        return x + 1

    @ray_tpu_torch.remote
    def times_two(x):
        return x * 2

    for _ in range(3):
        assert ray_tpu_torch.get(times_two.remote(plus_one.remote(5)), timeout=60) == 12


def test_direct_inline_error_propagates(ray_cluster):
    @ray_tpu_torch.remote
    def boom():
        raise ValueError("direct boom")

    with pytest.raises(ValueError, match="direct boom"):
        ray_tpu_torch.get(boom.remote(), timeout=60)


def test_direct_result_used_after_delay(ray_cluster):
    """A memory-store result passed as an arg later (after arrival) is
    inlined into the consumer's spec."""

    @ray_tpu_torch.remote
    def make():
        return {"k": 41}

    @ray_tpu_torch.remote
    def use(d):
        return d["k"] + 1

    ref = make.remote()
    ray_tpu_torch.get(ref, timeout=60)  # ensure it arrived inline
    assert ray_tpu_torch.get(use.remote(ref), timeout=60) == 42


def test_leases_returned_when_idle(ray_cluster):
    """Leased workers go back to the raylet's idle pool after the idle
    timeout, freeing their resources."""
    from ray_tpu_torch._private.worker import get_global_worker

    @ray_tpu_torch.remote
    def f():
        return 1

    ray_tpu_torch.get([f.remote() for _ in range(20)], timeout=60)
    w = get_global_worker()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        stats = w.raylet_client.call("node_stats")
        if stats["resources_available"].get("CPU") == stats["resources_total"].get("CPU"):
            break
        # graftlint: disable=retry-gate -- test-side condition poll/pacing: the fixed interval is the scan resolution of an assertion with its own deadline, not a retry delay
        time.sleep(0.25)
    else:
        pytest.fail(f"lease resources never returned: {stats['resources_available']}")


def test_actor_order_two_submitting_threads(ray_cluster):
    """Per-caller actor-task ordering: calls from one caller process
    execute in sequence-number order even when two threads submit
    concurrently (reference: sequential_actor_submit_queue.h)."""

    @ray_tpu_torch.remote
    class Recorder:
        def __init__(self):
            self.seen = []

        def add(self, tag, i):
            self.seen.append((tag, i))
            return len(self.seen)

        def dump(self):
            return self.seen

    rec = Recorder.remote()
    ray_tpu_torch.get(rec.add.remote("warm", 0), timeout=60)

    errors = []

    def submit(tag):
        try:
            refs = [rec.add.remote(tag, i) for i in range(40)]
            ray_tpu_torch.get(refs, timeout=120)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    # graftlint: disable=thread-lifecycle -- the two submitter threads are joined right below (the linter does not follow the list)
    threads = [threading.Thread(target=submit, args=(t,)) for t in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    seen = ray_tpu_torch.get(rec.dump.remote(), timeout=60)
    per_tag = {"a": [], "b": []}
    for tag, i in seen:
        if tag in per_tag:
            per_tag[tag].append(i)
    # Each thread's calls must have executed in its own submission order.
    assert per_tag["a"] == sorted(per_tag["a"]), per_tag["a"]
    assert per_tag["b"] == sorted(per_tag["b"]), per_tag["b"]
    assert len(per_tag["a"]) == len(per_tag["b"]) == 40


def test_admit_buffers_out_of_order_sequences():
    """Receiver-side unit test: admission starts at sequence 1 per
    (caller, incarnation); early arrivals are held until the gap fills,
    duplicates and stale-incarnation specs are dropped."""
    from ray_tpu_torch._private.common import TaskSpec
    from ray_tpu_torch._private.ids import ActorID, JobID, TaskID, WorkerID
    from ray_tpu_torch._private.worker import Worker

    w = Worker.__new__(Worker)  # no connection needed for admission logic
    import queue as queue_mod

    w._admit_lock = threading.Lock()
    w._actor_expected = {}
    w._actor_buffer = {}
    w._actor_caller_inc = {}
    w._exec_queue = queue_mod.Queue()

    job = JobID.from_random()
    actor = ActorID.of(job)
    caller = WorkerID.from_random()

    def spec(seq, inc=0):
        return TaskSpec(
            task_id=TaskID.of(actor),
            job_id=job,
            name=f"m{seq}",
            function_key=b"",
            args=[],
            num_returns=1,
            resources=None,
            is_actor_task=True,
            actor_id=actor,
            sequence_number=seq,
            actor_incarnation=inc,
            owner_worker_id=caller,
        )

    def drain():
        out = []
        while not w._exec_queue.empty():
            s, _ = w._exec_queue.get_nowait()
            out.append(s.sequence_number)
        return out

    # Arrival order 2, 4, 1, 3 — nothing admits until 1 shows up; then all
    # flow contiguously.  A duplicate redelivery of 2 is dropped.
    w._admit_actor_task(spec(2), None)
    w._admit_actor_task(spec(4), None)
    assert drain() == []
    w._admit_actor_task(spec(1), None)
    w._admit_actor_task(spec(3), None)
    w._admit_actor_task(spec(2), None)  # duplicate redelivery: dropped
    assert drain() == [1, 2, 3, 4]

    # New incarnation resets admission to 1; stale incarnation 0 drops.
    w._admit_actor_task(spec(1, inc=1), None)
    w._admit_actor_task(spec(5, inc=0), None)  # stale: dropped
    assert drain() == [1]


def test_actor_restart_resets_sequencing(ray_cluster):
    """After an actor restart the new worker has fresh receiver state; the
    caller must renumber so calls keep executing (incarnation reset)."""

    @ray_tpu_torch.remote(max_restarts=1)
    class Flaky:
        def __init__(self):
            self.calls = 0

        def ping(self, i):
            self.calls += 1
            return i

        def die(self):
            import os

            os._exit(1)

    a = Flaky.remote()
    assert ray_tpu_torch.get([a.ping.remote(i) for i in range(5)], timeout=60) == list(range(5))
    a.die.remote()
    _finish_flaky_restart(a)


def test_actor_retry_preserves_order_across_crash(ray_cluster, tmp_path):
    """Induced redelivery: the actor's worker dies mid-stream with calls
    in flight; with max_task_retries=-1 every call completes and each
    incarnation executes its calls in submission order (reference:
    sequential_actor_submit_queue.h + actor_task_submitter retry path).
    Completed-but-unacknowledged calls MAY re-execute on the new
    incarnation — retriable actor tasks are at-least-once, as in the
    reference — but never out of order within an incarnation.  Execution
    is observed through a file because the crash wipes instance state."""
    log = str(tmp_path / "calls.log")
    marker = str(tmp_path / "died")

    @ray_tpu_torch.remote(max_restarts=1, max_task_retries=-1)
    class Crashy:
        def log(self, path, marker, i):
            import os as _os

            if i == 7 and not _os.path.exists(marker):
                open(marker, "w").write("x")
                _os._exit(1)  # dies BEFORE logging: the call must be retried
            with open(path, "a") as f:
                f.write(f"{i}\n")
            return i

    a = Crashy.remote()
    refs = [a.log.remote(log, marker, i) for i in range(15)]
    assert ray_tpu_torch.get(refs, timeout=120) == list(range(15))
    lines = [int(x) for x in open(log).read().split()]
    # The log is two strictly-increasing runs (one per incarnation): the
    # pre-crash run, then the post-restart run that finishes the stream.
    runs = [[lines[0]]] if lines else []
    for x in lines[1:]:
        (runs[-1].append(x) if x > runs[-1][-1] else runs.append([x]))
    assert len(runs) <= 2, f"interleaved execution: {lines}"
    assert runs[-1][-1] == 14
    assert set(lines) == set(range(15)), lines
    # No duplicates within one incarnation.
    for run in runs:
        assert len(run) == len(set(run))


def _finish_flaky_restart(a):
    # Wait for the restart, then keep calling — must not hang or misorder.
    deadline = time.monotonic() + 60
    while True:
        try:
            assert ray_tpu_torch.get(a.ping.remote(100), timeout=10) == 100
            break
        except Exception:
            if time.monotonic() > deadline:
                raise
            # graftlint: disable=retry-gate -- test-side condition poll/pacing: the fixed interval is the scan resolution of an assertion with its own deadline, not a retry delay
            time.sleep(0.5)
    assert ray_tpu_torch.get([a.ping.remote(i) for i in range(3)], timeout=60) == [0, 1, 2]
