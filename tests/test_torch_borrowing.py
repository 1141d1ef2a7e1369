"""Borrowing-lite eager free on the port (a copy of the JAX package's
tests/test_borrowing.py; it imports neither JAX nor the JAX package;
reference: core_worker/reference_count.h:64).

A ref passed as a direct-path task arg registers a borrow; when the task
completes and the owner's local refs are gone, the object frees
immediately — it must NOT linger until job-end GC.
"""

import gc
import time

import numpy as np
import pytest

import ray_tpu_torch


@pytest.fixture(scope="module", autouse=True)
def ray():
    with pytest.MonkeyPatch.context() as mp:
        # The suite runs many clusters at once: no shm arena prefault, and
        # no memory monitor, which watches the whole machine.
        mp.setenv("RAY_TPU_TORCH_arena_prefault_bytes", "0")
        mp.setenv("RAY_TPU_TORCH_memory_monitor_enabled", "0")
        ray_tpu_torch.init(
            num_cpus=4,
            object_store_memory=80 * 1024 * 1024,
            ignore_reinit_error=True,
        )
        yield ray_tpu_torch
        ray_tpu_torch.shutdown()


@pytest.fixture
def ray_start_regular():
    """The port's counterpart of the conftest's fixture of that name
    (which starts the JAX package's cluster): init with
    ignore_reinit_error, shutdown after the test."""
    ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _store_stats():
    w = ray_tpu_torch.get_global_worker()
    return w.raylet_client.call("store_stats", None)


def _stored_bytes():
    s = _store_stats()
    for k in ("bytes_in_use", "used_bytes", "bytes_used", "size"):
        if k in s:
            return s[k]
    raise AssertionError(f"no usage key in {s}")


def test_arg_freed_after_task_completes():
    @ray_tpu_torch.remote
    def consume(a):
        return float(a.sum())

    before = _stored_bytes()
    ref = ray_tpu_torch.put(np.ones(2_000_000))  # 16 MB
    assert ray_tpu_torch.get(consume.remote(ref), timeout=60) == 2_000_000.0
    del ref
    gc.collect()
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        if _stored_bytes() <= before + 1_000_000:
            return
        # graftlint: disable=retry-gate -- test-side condition poll/pacing: the fixed interval is the scan resolution of an assertion with its own deadline, not a retry delay
        time.sleep(0.2)
    raise AssertionError(
        f"arg not freed after borrow returned: {_stored_bytes()} > {before}"
    )


def test_arg_kept_while_task_inflight():
    """Dropping the local ref while the consumer still runs must NOT free
    the argument out from under it."""

    @ray_tpu_torch.remote
    def slow_consume(a):
        time.sleep(2.0)
        return float(a.sum())

    ref = ray_tpu_torch.put(np.ones(1_000_000))
    fut = slow_consume.remote(ref)
    del ref
    gc.collect()
    assert ray_tpu_torch.get(fut, timeout=60) == 1_000_000.0


def test_freed_object_reads_as_lost_not_never_sealed():
    """A freed id stays in the GCS sealed-ever set so it reads as LOST
    (recoverable via lineage), not never-sealed (which would hang pulls
    and break lineage recovery of dependents whose args were eagerly
    freed)."""
    w = ray_tpu_torch.get_global_worker()
    ref = ray_tpu_torch.put(np.ones(1_000_000))
    oid = ref.id.binary()
    # Sealed and located: not lost.
    assert w.gcs_client.call("object_lost_check", oid) is False
    del ref
    gc.collect()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if w.gcs_client.call("object_lost_check", oid):
            return  # freed → "lost" (owner-recoverable), NOT "never sealed"
        # graftlint: disable=retry-gate -- test-side condition poll/pacing: the fixed interval is the scan resolution of an assertion with its own deadline, not a retry delay
        time.sleep(0.2)
    raise AssertionError("freed object still reads as never-sealed in the GCS")


def test_data_streams_many_times_store_capacity():
    """A Data job streaming ~10x the object-store
    capacity completes with stable store usage and (near) zero spilling,
    because consumed blocks free as their borrows return."""
    import ray_tpu_torch.data as rd

    spilled_before = _store_stats().get("num_spilled", 0)
    # 64 blocks x ~12.8 MB = ~800 MB through an 80 MB store.
    n_rows = 800
    ds = rd.range_tensor(n_rows, shape=(2000,), parallelism=64).map_batches(
        lambda b: {"data": b["data"] * 2.0}, batch_format="numpy"
    )
    total_rows = 0
    for batch in ds.iter_batches(batch_size=50, prefetch_batches=1):
        total_rows += len(batch["data"])
    assert total_rows == n_rows
    spilled_after = _store_stats().get("num_spilled", 0)
    # Eager free keeps the working set bounded: allow a handful of spills
    # for scheduling jitter, not the ~10x overflow.
    assert spilled_after - spilled_before < 16, (
        f"spilled {spilled_after - spilled_before} objects — blocks are "
        f"not being freed eagerly"
    )


def test_refcounter_survives_gc_in_critical_section(ray_start_regular):
    """Regression: ObjectRef.__del__ used to take the ReferenceCounter
    lock directly; a cyclic-GC pass firing inside an allocating
    statement of add_owned() (same thread, same non-reentrant lock)
    deadlocked the whole process — intermittently, under memory
    pressure.  __del__ now enqueues to a lock-free deque.  This test
    forces constant GC passes over ref cycles; before the fix it hung
    within a few iterations."""
    import gc

    import ray_tpu_torch

    @ray_tpu_torch.remote
    def produce(x):
        return [x] * 20

    old = gc.get_threshold()
    gc.set_threshold(25, 2, 2)
    try:
        for i in range(60):
            class _Holder:
                pass

            h = _Holder()
            h.refs = [produce.remote(i) for _ in range(6)]
            h.me = h  # cycle: only the GC can reclaim these refs
            assert ray_tpu_torch.get(list(h.refs))[0][0] == i
            del h
    finally:
        gc.set_threshold(*old)
