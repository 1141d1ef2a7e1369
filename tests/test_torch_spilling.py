"""Object spilling on the port (a copy of the JAX package's
tests/test_spilling.py; it imports neither JAX nor the JAX package):
memory pressure moves LRU objects to disk and reads
serve from the spill files (reference: _private/external_storage.py
FileSystemStorage + raylet/local_object_manager.h SpillObjects)."""

import os

import numpy as np
import pytest


@pytest.fixture
def small_store_cluster(monkeypatch):
    # Cap the store far below the workload so puts force spilling.
    monkeypatch.setenv("RAY_TPU_TORCH_object_store_memory_cap", str(48 * 1024 * 1024))
    # The suite runs many clusters at once: no shm arena prefault, and no
    # memory monitor, which watches the whole machine.
    monkeypatch.setenv("RAY_TPU_TORCH_arena_prefault_bytes", "0")
    monkeypatch.setenv("RAY_TPU_TORCH_memory_monitor_enabled", "0")
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=2)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _poll_stat(raylet, key, deadline_s=30.0):
    """Condition-poll a store stat until it goes positive.  Spilling runs
    in the background (off-loop IO racing eviction), so on a loaded box
    the counter lags the puts — poll instead of asserting a snapshot."""
    import time

    deadline = time.monotonic() + deadline_s
    stats = raylet.call("store_stats", None)
    while stats[key] <= 0 and time.monotonic() < deadline:
        # graftlint: disable=retry-gate -- test-side condition poll/pacing: the fixed interval is the scan resolution of an assertion with its own deadline, not a retry delay
        time.sleep(0.1)
        stats = raylet.call("store_stats", None)
    return stats


def test_put_beyond_capacity_roundtrips_via_spill(small_store_cluster):
    ray_tpu_torch = small_store_cluster
    arrays = [np.full(2_000_000, i, dtype=np.float64) for i in range(8)]  # 8 x 16MB
    refs = [ray_tpu_torch.put(a) for a in arrays]
    # 128MB of puts into a 48MB store: earlier objects must have spilled
    # (eventually — the spill IO is background work).
    w = ray_tpu_torch._private.worker.get_global_worker()
    stats = _poll_stat(w.store._raylet, "num_spilled")
    assert stats["num_spilled"] > 0, stats
    # Every object is still readable (spilled ones serve from disk).
    for i, ref in enumerate(refs):
        out = ray_tpu_torch.get(ref, timeout=120)
        assert out[0] == i and out[-1] == i and out.shape == (2_000_000,)
    stats = _poll_stat(w.store._raylet, "num_restored")
    assert stats["num_restored"] > 0, stats


def test_task_returns_spill_and_restore(small_store_cluster):
    ray_tpu_torch = small_store_cluster

    @ray_tpu_torch.remote
    def make(i):
        return np.full(2_000_000, i, dtype=np.float64)  # 16MB

    refs = [make.remote(i) for i in range(8)]
    outs = ray_tpu_torch.get(refs, timeout=120)
    for i, out in enumerate(outs):
        assert out[0] == i and out[-1] == i


def test_background_watermark_spilling(small_store_cluster):
    """Crossing the high watermark triggers spilling in the BACKGROUND
    (off-loop IO), without any further allocation forcing it."""
    import time

    ray_tpu_torch = small_store_cluster
    w = ray_tpu_torch._private.worker.get_global_worker()
    # ~42MB into a 48MB store: above the 0.8 watermark (38.4MB), but no
    # allocation pressure afterwards.
    refs = [ray_tpu_torch.put(np.full(1_700_000, i, dtype=np.float64)) for i in range(3)]
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        stats = w.store._raylet.call("store_stats", None)
        if stats["num_spilled"] > 0 and stats["used_bytes"] <= 0.65 * stats["capacity_bytes"]:
            break
        # graftlint: disable=retry-gate -- test-side condition poll/pacing: the fixed interval is the scan resolution of an assertion with its own deadline, not a retry delay
        time.sleep(0.2)
    else:
        raise AssertionError(f"background spill never engaged: {stats}")
    # Spilled objects still read back correctly.
    for i, r in enumerate(refs):
        assert float(ray_tpu_torch.get(r)[0]) == float(i)
