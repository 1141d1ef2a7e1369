"""The DAG API and compiled graphs of the port: copies of the DAG tests of
``tests/test_dag_workflow.py`` (its three workflow tests wait for
``workflow/``) and of ``tests/test_dag_multinode.py``, over the port's
runtime, channels and ``dag/``.

One driver per process: the single-node tests and the two-raylet tests
each run in a class whose cluster lives as long as the class.

Reference test model: python/ray/dag/tests/.
"""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.dag import InputNode, MultiOutputNode


@pytest.fixture(scope="class")
def port_env():
    with pytest.MonkeyPatch.context() as mp:
        # many clusters share the machine under xdist: no 2 GiB arena
        # prefault, and no memory monitor killing this test's workers for
        # the others' memory
        mp.setenv("RAY_TPU_TORCH_arena_prefault_bytes", "0")
        mp.setenv("RAY_TPU_TORCH_memory_monitor_enabled", "0")
        yield


@pytest.fixture(scope="class")
def ray_cluster(port_env):
    """A local cluster of the port (the conftest's fixture of this name
    starts the JAX package's)."""
    ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@pytest.fixture(scope="class")
def cluster(port_env):
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 4})
    c.add_node(num_cpus=2, resources={"edge": 4})
    c.wait_for_nodes()
    ray_tpu_torch.init(address=c.address)
    yield c
    ray_tpu_torch.shutdown()
    c.shutdown()


@ray_tpu_torch.remote
class Stage:
    def __init__(self, inc):
        self.inc = inc
        self.count = 0

    def step(self, x):
        self.count += 1
        return x + self.inc


def _kinds(compiled):
    return {d["kind"] for d in compiled._descs.values()}


class TestDag:
    """The DAG tests of test_dag_workflow.py."""

    def test_function_dag(self, ray_cluster):
        @ray_tpu_torch.remote
        def plus_one(x):
            return x + 1

        @ray_tpu_torch.remote
        def times_two(x):
            return x * 2

        with InputNode() as inp:
            dag = times_two.bind(plus_one.bind(inp))
        ref = dag.execute(5)
        assert ray_tpu_torch.get(ref) == 12

    def test_dag_multi_output_and_input_attr(self, ray_cluster):
        @ray_tpu_torch.remote
        def add(a, b):
            return a + b

        @ray_tpu_torch.remote
        def neg(a):
            return -a

        with InputNode() as inp:
            s = add.bind(inp["a"], inp["b"])
            dag = MultiOutputNode([s, neg.bind(s)])
        refs = dag.execute({"a": 3, "b": 4})
        assert ray_tpu_torch.get(refs) == [7, -7]

    def test_actor_dag(self, ray_cluster):
        @ray_tpu_torch.remote
        class Accumulator:
            def __init__(self, start):
                self.total = start

            def add(self, x):
                self.total += x
                return self.total

        with InputNode() as inp:
            acc = Accumulator.bind(100)
            dag = acc.add.bind(inp)
        assert ray_tpu_torch.get(dag.execute(5)) == 105

    def test_compiled_dag_reuses_actors(self, ray_cluster):
        import os

        @ray_tpu_torch.remote
        class Stage:
            def __init__(self):
                self.pid = os.getpid()
                self.calls = 0

            def work(self, x):
                self.calls += 1
                return (x + 1, self.pid, self.calls)

        with InputNode() as inp:
            stage = Stage.bind()
            dag = stage.work.bind(inp)
        compiled = dag.experimental_compile()
        out1 = ray_tpu_torch.get(compiled.execute(1))
        out2 = ray_tpu_torch.get(compiled.execute(10))
        assert out1[0] == 2 and out2[0] == 11
        assert out1[1] == out2[1]  # same actor process
        assert out2[2] == 2  # state persisted across executions
        compiled.teardown()

    def test_compiled_dag_throughput(self, ray_cluster):
        """Compiled execution must beat per-call DAG walking + actor restarts
        (reference claim: compiled graphs bypass scheduler overhead)."""

        @ray_tpu_torch.remote
        class Echo:
            def echo(self, x):
                return x

        with InputNode() as inp:
            dag = Echo.bind().echo.bind(inp)
        compiled = dag.experimental_compile()
        ray_tpu_torch.get(compiled.execute(0))  # warm
        t0 = time.time()
        n = 50
        for i in range(n):
            ray_tpu_torch.get(compiled.execute(i))
        dt = time.time() - t0
        compiled.teardown()
        assert dt / n < 0.1, f"compiled DAG round-trip too slow: {dt / n * 1000:.1f} ms"

    def test_compiled_dag_execute_many_exact(self, ray_cluster):
        """execute_many batches K executions into one channel write per
        edge; results come back per-ref, exact, in order — including through
        a multi-actor pipeline and a multi-output fan-out."""

        @ray_tpu_torch.remote
        class Stage:
            def inc(self, x):
                return x + 1

            def double(self, x):
                return x * 2

        with InputNode() as inp:
            a = Stage.bind()
            b = Stage.bind()
            mid = a.inc.bind(inp)
            dag = MultiOutputNode([b.double.bind(mid), mid])
        compiled = dag.experimental_compile(max_inflight=64)
        try:
            assert compiled._channels_on
            refs = compiled.execute_many(list(range(16)))
            assert len(refs) == 16
            for i, ref in enumerate(refs):
                assert ray_tpu_torch.get(ref) == [(i + 1) * 2, i + 1]
            # interleaves with single executes on the same channels
            r1 = compiled.execute(100)
            many = compiled.execute_many([200, 300])
            assert ray_tpu_torch.get(r1) == [202, 101]
            assert ray_tpu_torch.get(many[0]) == [402, 201]
            assert ray_tpu_torch.get(many[1]) == [602, 301]
        finally:
            compiled.teardown()

    def test_compiled_dag_execute_many_per_entry_errors(self, ray_cluster):
        """One failing entry in a batch errors ONLY its own ref; the other
        entries of the same batched frame still resolve."""

        @ray_tpu_torch.remote
        class Divider:
            def div(self, x):
                return 10 // x

        with InputNode() as inp:
            dag = Divider.bind().div.bind(inp)
        compiled = dag.experimental_compile(max_inflight=16)
        try:
            refs = compiled.execute_many([5, 0, 2])
            assert ray_tpu_torch.get(refs[0]) == 2
            with pytest.raises(ZeroDivisionError):
                ray_tpu_torch.get(refs[1])
            assert ray_tpu_torch.get(refs[2]) == 5
            # the DAG stays usable after the per-entry error
            assert ray_tpu_torch.get(compiled.execute(10)) == 1
        finally:
            compiled.teardown()

    def test_execute_many_inflight_bound_and_fallbacks(self, ray_cluster):
        """The driver-side in-flight cap counts K batched executions; and
        graphs with input-independent source nodes take the sequential
        fallback (their single frames would desync batched edges)."""

        @ray_tpu_torch.remote
        class Echo:
            def echo(self, x):
                return x

        with InputNode() as inp:
            dag = Echo.bind().echo.bind(inp)
        compiled = dag.experimental_compile(max_inflight=4)
        try:
            with pytest.raises(RuntimeError, match="max_inflight"):
                compiled.execute_many(list(range(8)))
            refs = compiled.execute_many([1, 2])
            assert [ray_tpu_torch.get(r) for r in refs] == [1, 2]
        finally:
            compiled.teardown()

        @ray_tpu_torch.remote
        def seed():
            return 7

        @ray_tpu_torch.remote
        def add(a, b):
            return a + b

        with InputNode() as inp:
            dag2 = add.bind(seed.bind(), inp)
        compiled2 = dag2.experimental_compile(max_inflight=16)
        try:
            assert compiled2._has_const_sources
            refs = compiled2.execute_many([1, 2, 3])  # sequential fallback
            assert [ray_tpu_torch.get(r) for r in refs] == [8, 9, 10]
        finally:
            compiled2.teardown()


class TestDagMultinode:
    """test_dag_multinode.py: compiled DAGs spanning two raylets.  Two
    raylets on one machine count as two hosts for transport selection
    (node identity, not hostname) — exactly the topology Cluster builds."""

    def test_cross_host_pipeline_exact_results(self, cluster):
        """driver -> A(head) -> B(worker node) -> driver: the A->B edge and
        both driver edges to B are sockets; results are exact and ordered."""
        a = Stage.bind(1)
        b = Stage.options(resources={"edge": 0.1}).bind(10)
        with InputNode() as inp:
            dag = b.step.bind(a.step.bind(inp))
        compiled = dag.experimental_compile(max_inflight=8)
        assert compiled._channels_on
        assert "socket" in _kinds(compiled)  # really crossed a raylet
        refs = [compiled.execute(i) for i in range(6)]
        assert [ray_tpu_torch.get(r) for r in refs] == [i + 11 for i in range(6)]
        # steady-state exactness under sustained load (ring + socket mixed)
        for i in range(25):
            assert ray_tpu_torch.get(compiled.execute(i)) == i + 11
        stats = compiled.stats()
        assert {c["kind"] for c in stats["output_channels"]} <= {"ring", "socket"}
        compiled.teardown()

    def test_cross_host_fanout_multi_output(self, cluster):
        """Fan-out to actors on BOTH nodes from one input; fan-in order
        preserved by MultiOutputNode."""
        local = Stage.bind(100)
        remote = Stage.options(resources={"edge": 0.1}).bind(1000)
        with InputNode() as inp:
            dag = MultiOutputNode([local.step.bind(inp), remote.step.bind(inp)])
        compiled = dag.experimental_compile()
        assert "socket" in _kinds(compiled)
        assert ray_tpu_torch.get(compiled.execute(5)) == [105, 1005]
        assert ray_tpu_torch.get(compiled.execute(7)) == [107, 1007]
        compiled.teardown()

    def test_cross_host_error_propagates_and_dag_survives(self, cluster):
        @ray_tpu_torch.remote(resources={"edge": 0.1})
        class Fragile:
            def f(self, x):
                if x < 0:
                    raise ValueError("negative!")
                return x * 2

        with InputNode() as inp:
            dag = Fragile.bind().f.bind(inp)
        compiled = dag.experimental_compile()
        assert "socket" in _kinds(compiled)
        assert ray_tpu_torch.get(compiled.execute(4)) == 8
        with pytest.raises(ValueError):
            ray_tpu_torch.get(compiled.execute(-1))
        assert ray_tpu_torch.get(compiled.execute(5)) == 10  # edge still live
        compiled.teardown()

    def test_cross_host_roundtrip_latency_sane(self, cluster):
        """A socket edge round-trip must stay far under the task path's
        multi-ms floor (loose bound: CI boxes swing 2-5x)."""

        @ray_tpu_torch.remote(resources={"edge": 0.1})
        class Echo:
            def echo(self, x):
                return x

        with InputNode() as inp:
            dag = Echo.bind().echo.bind(inp)
        compiled = dag.experimental_compile()
        assert "socket" in _kinds(compiled)
        ray_tpu_torch.get(compiled.execute(0))  # warm
        lat = []
        for i in range(50):
            t0 = time.perf_counter()
            assert ray_tpu_torch.get(compiled.execute(i)) == i
            lat.append(time.perf_counter() - t0)
        lat.sort()
        p50 = lat[len(lat) // 2]
        assert p50 < 0.05, f"socket round-trip p50 {p50 * 1e3:.2f} ms"
        compiled.teardown()
