"""Core API tests (model: reference python/ray/tests/test_basic.py)."""

import numpy as np
import pytest

import ray_tpu_torch


@pytest.fixture(scope="module")
def ray_cluster():
    """Module-scoped local cluster of the port (the conftest's fixture of
    this name starts the JAX package's)."""
    with pytest.MonkeyPatch.context() as mp:
        # The suite runs many clusters at once, the JAX package's among them:
        # no 2 GiB shm arena prefault per raylet, and no memory monitor,
        # which watches the whole machine and would kill this test's
        # workers for the others' memory.
        mp.setenv("RAY_TPU_TORCH_arena_prefault_bytes", "0")
        mp.setenv("RAY_TPU_TORCH_memory_monitor_enabled", "0")
        ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
        yield ray_tpu_torch
        ray_tpu_torch.shutdown()


@pytest.fixture
def ray_start_regular():
    with pytest.MonkeyPatch.context() as mp:
        # The suite runs many clusters at once, the JAX package's among them:
        # no 2 GiB shm arena prefault per raylet, and no memory monitor,
        # which watches the whole machine and would kill this test's
        # workers for the others' memory.
        mp.setenv("RAY_TPU_TORCH_arena_prefault_bytes", "0")
        mp.setenv("RAY_TPU_TORCH_memory_monitor_enabled", "0")
        ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
        yield ray_tpu_torch
        ray_tpu_torch.shutdown()


def test_put_get_small(ray_cluster):
    ref = ray_tpu_torch.put({"a": 1, "b": [1, 2, 3]})
    assert ray_tpu_torch.get(ref) == {"a": 1, "b": [1, 2, 3]}


def test_put_get_large_numpy(ray_cluster):
    arr = np.arange(1_000_000, dtype=np.float32)
    ref = ray_tpu_torch.put(arr)
    out = ray_tpu_torch.get(ref)
    np.testing.assert_array_equal(arr, out)
    # Zero-copy: the result must be backed by the shared-memory mapping.
    assert not out.flags["OWNDATA"]


def test_simple_task(ray_cluster):
    @ray_tpu_torch.remote
    def f(x):
        return x + 1

    assert ray_tpu_torch.get(f.remote(1)) == 2


def test_task_with_ref_arg(ray_cluster):
    @ray_tpu_torch.remote
    def f(x):
        return x * 2

    r1 = f.remote(10)
    r2 = f.remote(r1)
    assert ray_tpu_torch.get(r2) == 40


def test_task_large_arg_roundtrip(ray_cluster):
    arr = np.ones((512, 512), dtype=np.float32)

    @ray_tpu_torch.remote
    def total(a):
        return float(a.sum())

    assert ray_tpu_torch.get(total.remote(arr)) == float(arr.sum())


def test_multiple_returns(ray_cluster):
    @ray_tpu_torch.remote(num_returns=2)
    def two():
        return 1, 2

    a, b = two.remote()
    assert ray_tpu_torch.get(a) == 1
    assert ray_tpu_torch.get(b) == 2


def test_task_error_propagation(ray_cluster):
    @ray_tpu_torch.remote
    def boom():
        raise ValueError("kaboom")

    with pytest.raises(ValueError, match="kaboom"):
        ray_tpu_torch.get(boom.remote())


def test_wait(ray_cluster):
    import time

    @ray_tpu_torch.remote
    def fast():
        return "fast"

    @ray_tpu_torch.remote
    def slow():
        time.sleep(5)
        return "slow"

    f, s = fast.remote(), slow.remote()
    ready, not_ready = ray_tpu_torch.wait([f, s], num_returns=1, timeout=4)
    assert ready == [f]
    assert not_ready == [s]


def test_nested_tasks(ray_cluster):
    @ray_tpu_torch.remote
    def inner(x):
        return x + 1

    @ray_tpu_torch.remote
    def outer(x):
        return ray_tpu_torch.get(inner.remote(x)) + 10

    assert ray_tpu_torch.get(outer.remote(1)) == 12


def test_options_override(ray_cluster):
    @ray_tpu_torch.remote
    def f():
        return ray_tpu_torch.get_runtime_context().get_assigned_resources()

    res = ray_tpu_torch.get(f.options(num_cpus=2).remote())
    assert res.get("CPU") == 2


def test_cluster_resources(ray_cluster):
    total = ray_tpu_torch.cluster_resources()
    assert total.get("CPU") == 4.0
    assert len(ray_tpu_torch.nodes()) == 1


class TestActors:
    def test_actor_basic(self, ray_cluster):
        @ray_tpu_torch.remote
        class Counter:
            def __init__(self, start=0):
                self.n = start

            def incr(self, by=1):
                self.n += by
                return self.n

            def value(self):
                return self.n

        c = Counter.remote(10)
        assert ray_tpu_torch.get(c.incr.remote()) == 11
        assert ray_tpu_torch.get(c.incr.remote(5)) == 16
        assert ray_tpu_torch.get(c.value.remote()) == 16

    def test_actor_ordering(self, ray_cluster):
        @ray_tpu_torch.remote
        class Seq:
            def __init__(self):
                self.log = []

            def add(self, x):
                self.log.append(x)
                return len(self.log)

            def get_log(self):
                return self.log

        s = Seq.remote()
        for i in range(20):
            s.add.remote(i)
        assert ray_tpu_torch.get(s.get_log.remote()) == list(range(20))

    def test_named_actor(self, ray_cluster):
        @ray_tpu_torch.remote
        class Store:
            def __init__(self):
                self.d = {}

            def set(self, k, v):
                self.d[k] = v

            def get(self, k):
                return self.d.get(k)

        Store.options(name="kvstore").remote()
        h = ray_tpu_torch.get_actor("kvstore")
        ray_tpu_torch.get(h.set.remote("x", 42))
        assert ray_tpu_torch.get(h.get.remote("x")) == 42
        assert "kvstore" in ray_tpu_torch.util.list_named_actors()
        rows = ray_tpu_torch.util.list_named_actors(all_namespaces=True)
        assert any(r["name"] == "kvstore" for r in rows)
        ray_tpu_torch.kill(h)

    def test_actor_error(self, ray_cluster):
        @ray_tpu_torch.remote
        class Bad:
            def fail(self):
                raise RuntimeError("actor error")

        b = Bad.remote()
        with pytest.raises(RuntimeError, match="actor error"):
            ray_tpu_torch.get(b.fail.remote())

    def test_actor_kill(self, ray_cluster):
        @ray_tpu_torch.remote
        class A:
            def ping(self):
                return "pong"

        a = A.remote()
        assert ray_tpu_torch.get(a.ping.remote()) == "pong"
        ray_tpu_torch.kill(a)
        import time

        time.sleep(1.0)
        with pytest.raises(ray_tpu_torch.exceptions.RayActorError):
            ray_tpu_torch.get(a.ping.remote(), timeout=10)

    def test_actor_handle_pass(self, ray_cluster):
        @ray_tpu_torch.remote
        class Counter:
            def __init__(self):
                self.n = 0

            def incr(self):
                self.n += 1
                return self.n

        @ray_tpu_torch.remote
        def bump(counter):
            return ray_tpu_torch.get(counter.incr.remote())

        c = Counter.remote()
        assert ray_tpu_torch.get(bump.remote(c)) == 1
        assert ray_tpu_torch.get(c.incr.remote()) == 2


def test_worker_logs_stream_to_driver(ray_start_regular, capfd):
    """Worker prints reach the driver's stderr with worker prefixes
    (reference: log_monitor.py -> pubsub -> driver printing)."""
    import time

    ray_tpu_torch = ray_start_regular

    @ray_tpu_torch.remote
    def shout():
        print("HELLO-LOG-STREAM-42")
        return 1

    assert ray_tpu_torch.get(shout.remote(), timeout=60) == 1
    deadline = time.monotonic() + 10
    seen = ""
    while time.monotonic() < deadline:
        out, err = capfd.readouterr()
        seen += err + out
        if "HELLO-LOG-STREAM-42" in seen:
            break
        # graftlint: disable=retry-gate -- deadline-bounded assertion poll; 0.3 s is the scan resolution, not a retry delay
        time.sleep(0.3)
    assert "HELLO-LOG-STREAM-42" in seen
    assert "pid=" in seen
