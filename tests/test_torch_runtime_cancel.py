"""ray_tpu_torch.cancel (reference: core_worker.cc CancelTask semantics)."""

import time

import pytest

import ray_tpu_torch


@pytest.fixture(scope="module", autouse=True)
def ray():
    with pytest.MonkeyPatch.context() as mp:
        # The suite runs many clusters at once, the JAX package's among them:
        # no 2 GiB shm arena prefault per raylet, and no memory monitor,
        # which watches the whole machine and would kill this test's
        # workers for the others' memory.
        mp.setenv("RAY_TPU_TORCH_arena_prefault_bytes", "0")
        mp.setenv("RAY_TPU_TORCH_memory_monitor_enabled", "0")
        ray_tpu_torch.init(num_cpus=2, ignore_reinit_error=True)
        yield ray_tpu_torch
        ray_tpu_torch.shutdown()


def test_cancel_running_task():
    """Cancelling a task genuinely blocked in a C-level call (time.sleep)
    must interrupt it promptly — the signal path, not just the
    queued-drop path."""

    @ray_tpu_torch.remote
    def warm():
        import os as _os

        return _os.getpid()

    ray_tpu_torch.get(warm.remote(), timeout=60)  # worker exists before submit

    started = time.monotonic()

    @ray_tpu_torch.remote
    def sleeper():
        time.sleep(60)
        return "never"

    ref = sleeper.remote()
    time.sleep(2.0)  # well into the sleep on the warmed worker
    t0 = time.monotonic()
    ray_tpu_torch.cancel(ref)
    with pytest.raises(ray_tpu_torch.exceptions.TaskCancelledError):
        ray_tpu_torch.get(ref, timeout=30)
    assert time.monotonic() - t0 < 10  # interrupted, not waited out
    assert time.monotonic() - started < 40


def test_cancel_queued_task():
    @ray_tpu_torch.remote(num_cpus=1)
    def busy():
        time.sleep(8)
        return "done"

    # Fill both CPUs, then queue one more and cancel it before it runs.
    running = [busy.remote() for _ in range(2)]
    queued = busy.remote()
    time.sleep(0.5)
    ray_tpu_torch.cancel(queued)
    with pytest.raises(ray_tpu_torch.exceptions.TaskCancelledError):
        ray_tpu_torch.get(queued, timeout=30)
    assert ray_tpu_torch.get(running, timeout=60) == ["done", "done"]


def test_cancel_force_kills_worker_no_retry():
    @ray_tpu_torch.remote(max_retries=5)
    def stubborn():
        # Holds the GIL in C so the async-exception never lands: only
        # force (SIGKILL-level) cancellation can stop it.
        import numpy as np

        x = 1.0
        for _ in range(100):
            x += float(np.ones(20_000_000).sum())  # long C-level loops
        return x

    ref = stubborn.remote()
    time.sleep(1.0)
    ray_tpu_torch.cancel(ref, force=True)
    with pytest.raises(ray_tpu_torch.exceptions.TaskCancelledError):
        ray_tpu_torch.get(ref, timeout=60)


def test_cancel_finished_task_is_noop():
    @ray_tpu_torch.remote
    def quick():
        return 41

    ref = quick.remote()
    assert ray_tpu_torch.get(ref, timeout=30) == 41
    ray_tpu_torch.cancel(ref)  # must not raise or corrupt the value
    assert ray_tpu_torch.get(ref, timeout=30) == 41


def test_cancel_async_actor_task():
    """Cancelling a running coroutine cancels exactly that asyncio task;
    the actor keeps serving other calls."""

    @ray_tpu_torch.remote
    class A:
        async def stuck(self):
            import asyncio

            await asyncio.sleep(60)
            return "never"

        async def ping(self):
            return "pong"

    a = A.remote()
    assert ray_tpu_torch.get(a.ping.remote(), timeout=30) == "pong"
    ref = a.stuck.remote()
    time.sleep(0.5)
    ray_tpu_torch.cancel(ref)
    with pytest.raises(ray_tpu_torch.exceptions.TaskCancelledError):
        ray_tpu_torch.get(ref, timeout=30)
    # The actor (and its loop) survived the cancel.
    assert ray_tpu_torch.get(a.ping.remote(), timeout=30) == "pong"
    ray_tpu_torch.kill(a)


def test_concurrency_groups_sync_actor():
    """Methods in a concurrency group run in parallel up to the group
    limit; ungrouped methods stay serialized on the default pool
    (reference: core_worker/concurrency_group_manager.h)."""

    @ray_tpu_torch.remote(concurrency_groups={"io": 3})
    class Worker:
        def __init__(self):
            import threading as th

            self.live = 0
            self.peak = 0
            self.lock = th.Lock()

        @ray_tpu_torch.method(concurrency_group="io")
        def io_call(self):
            with self.lock:
                self.live += 1
                self.peak = max(self.peak, self.live)
            time.sleep(0.5)
            with self.lock:
                self.live -= 1
            return "io"

        def peak_seen(self):
            return self.peak

    w = Worker.remote()
    refs = [w.io_call.remote() for _ in range(6)]
    assert ray_tpu_torch.get(refs, timeout=60) == ["io"] * 6
    peak = ray_tpu_torch.get(w.peak_seen.remote(), timeout=30)
    assert 2 <= peak <= 3, peak  # parallel, but never above the cap
    ray_tpu_torch.kill(w)


def test_concurrency_groups_async_actor():
    @ray_tpu_torch.remote(concurrency_groups={"limited": 2})
    class AsyncWorker:
        def __init__(self):
            self.live = 0
            self.peak = 0

        @ray_tpu_torch.method(concurrency_group="limited")
        async def call(self):
            import asyncio

            self.live += 1
            self.peak = max(self.peak, self.live)
            await asyncio.sleep(0.4)
            self.live -= 1
            return "ok"

        async def peak_seen(self):
            return self.peak

    a = AsyncWorker.remote()
    refs = [a.call.remote() for _ in range(6)]
    assert ray_tpu_torch.get(refs, timeout=60) == ["ok"] * 6
    assert ray_tpu_torch.get(a.peak_seen.remote(), timeout=30) == 2
    ray_tpu_torch.kill(a)
