"""Collective group tests (reference:
python/ray/util/collective/tests/) — CPU backend between real actors."""

import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.util import collective


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


@ray_tpu_torch.remote
class Member:
    def __init__(self, rank, world):
        self.rank = rank
        self.world = world

    def join(self, group="default"):
        collective.init_collective_group(self.world, self.rank, backend="cpu", group_name=group)
        return True

    def do_allreduce(self, group="default"):
        arr = np.full(4, float(self.rank + 1), np.float32)
        return collective.allreduce(arr, group_name=group)

    def do_big_allreduce(self, group="default"):
        arr = np.full(500_000, float(self.rank + 1), np.float32)  # ring path
        out = collective.allreduce(arr, group_name=group)
        return float(out[0]), float(out[-1])

    def do_broadcast(self, group="default"):
        arr = np.arange(3, dtype=np.float32) if self.rank == 0 else np.zeros(3, np.float32)
        return collective.broadcast(arr, src_rank=0, group_name=group)

    def do_allgather(self, group="default"):
        return collective.allgather(np.full(2, float(self.rank), np.float32), group_name=group)

    def do_barrier(self, group="default"):
        collective.barrier(group_name=group)
        return True


@pytest.fixture(scope="module")
def members(ray_cluster):
    world = 3
    actors = [Member.remote(r, world) for r in range(world)]
    ray_tpu_torch.get([a.join.remote("g1") for a in actors])
    yield actors


def test_allreduce(members):
    outs = ray_tpu_torch.get([a.do_allreduce.remote("g1") for a in members])
    for out in outs:
        np.testing.assert_array_equal(out, np.full(4, 6.0, np.float32))  # 1+2+3


def test_ring_allreduce_large(members):
    outs = ray_tpu_torch.get([a.do_big_allreduce.remote("g1") for a in members])
    for first, last in outs:
        assert first == 6.0 and last == 6.0


def test_broadcast(members):
    outs = ray_tpu_torch.get([a.do_broadcast.remote("g1") for a in members])
    for out in outs:
        np.testing.assert_array_equal(out, np.arange(3, dtype=np.float32))


def test_allgather(members):
    outs = ray_tpu_torch.get([a.do_allgather.remote("g1") for a in members])
    for out in outs:
        assert len(out) == 3
        for r, piece in enumerate(out):
            np.testing.assert_array_equal(piece, np.full(2, float(r), np.float32))


def test_barrier(members):
    assert all(ray_tpu_torch.get([a.do_barrier.remote("g1") for a in members]))


def test_declarative_create(ray_cluster):
    actors = [Member.remote(r, 2) for r in range(2)]
    collective.create_collective_group(actors, 2, [0, 1], backend="cpu", group_name="g2")
    outs = ray_tpu_torch.get([a.do_allreduce.remote("g2") for a in actors])
    for out in outs:
        np.testing.assert_array_equal(out, np.full(4, 3.0, np.float32))


# ==========================================================================
# Generation-tagged rendezvous: elastic destroy+recreate under a
# generation bump; typed rendezvous timeout; straggler invalidation.
# ==========================================================================


class _FakeKV:
    """In-process stand-in for the GCS KV (unit tests need no cluster)."""

    def __init__(self):
        self.d = {}

    def __call__(self, method, payload):
        if method == "kv_put":
            ns, key, value, overwrite = payload
            if not overwrite and (ns, bytes(key)) in self.d:
                return False
            self.d[(ns, bytes(key))] = value
            return True
        if method == "kv_get":
            ns, key = payload
            return self.d.get((ns, bytes(key)))
        if method == "kv_put_max":
            ns, key, value = payload
            try:
                cur = int((self.d.get((ns, bytes(key))) or b"").decode() or -1)
            except ValueError:
                cur = -1
            new = max(cur, int(value))
            self.d[(ns, bytes(key))] = str(new).encode()
            return new
        if method == "kv_del":
            ns, key = payload
            return self.d.pop((ns, bytes(key)), None) is not None
        if method == "kv_keys":
            ns, prefix = payload
            return [k for (n, k) in self.d if n == ns and k.startswith(bytes(prefix))]
        raise AssertionError(f"unexpected kv method {method}")


def test_rendezvous_timeout_names_missing_ranks():
    """Satellite bugfix: the rendezvous poll rides the unified retry
    policy under a deadline budget and raises a TYPED error naming every
    rank that never joined (not a bare TimeoutError for the first)."""
    from ray_tpu_torch.util.collective.cpu_group import CPUCollectiveGroup
    from ray_tpu_torch.util.collective import RendezvousTimeoutError

    kv = _FakeKV()
    with pytest.raises(RendezvousTimeoutError) as ei:
        CPUCollectiveGroup(3, 0, "gt_timeout", kv, rendezvous_timeout_s=0.5)
    assert ei.value.missing_ranks == [1, 2]
    assert ei.value.group_name == "gt_timeout"
    assert "1, 2" in str(ei.value) or "[1, 2]" in str(ei.value)


def test_generation_keys_and_stale_join_rejected():
    """Rendezvous keys are generation-scoped and a member joining at a
    superseded generation fails immediately with GroupInvalidatedError."""
    from ray_tpu_torch.util.collective.cpu_group import (
        KV_NS,
        CPUCollectiveGroup,
        GroupInvalidatedError,
    )

    kv = _FakeKV()
    g = CPUCollectiveGroup(1, 0, "gt_gen", kv, generation=2)
    # Address published under the generation-scoped key + marker written.
    assert (KV_NS, b"gt_gen/gen2/0") in kv.d
    assert kv.d[(KV_NS, b"gt_gen/gen")] == b"2"
    assert g.current_generation() == 2
    g.destroy()

    # The marker has advanced: a gen-1 straggler cannot even rendezvous.
    with pytest.raises(GroupInvalidatedError) as ei:
        CPUCollectiveGroup(1, 0, "gt_gen", kv, generation=1)
    assert ei.value.current_generation == 2


def test_manager_destroy_recreate_under_generation_bump(ray_cluster):
    """GroupManager: re-init at a HIGHER generation atomically replaces
    the local group; same/lower generation is refused."""
    from ray_tpu_torch.util.collective import collective as coll

    assert collective.init_collective_group(1, 0, group_name="g_bump", generation=0)
    g0 = coll._manager.get("g_bump")
    with pytest.raises(ValueError, match="strictly higher generation"):
        collective.init_collective_group(1, 0, group_name="g_bump", generation=0)
    assert collective.init_collective_group(1, 0, group_name="g_bump", generation=1)
    g1 = coll._manager.get("g_bump")
    assert g1 is not g0 and g1.generation == 1
    assert g0._closed  # old mesh torn down, not leaked
    assert collective.get_collective_group_generation("g_bump") == 1
    collective.destroy_collective_group("g_bump")


def test_invalidate_reaps_stale_rendezvous_keys(ray_cluster):
    """invalidate_collective_group bumps the marker and deletes the
    superseded generations' rendezvous keys from the GCS KV."""
    worker = ray_tpu_torch._private.worker.get_global_worker()
    assert collective.init_collective_group(1, 0, group_name="g_reap", generation=0)
    new_gen = collective.invalidate_collective_group("g_reap")
    assert new_gen == 1
    assert collective.get_collective_group_generation("g_reap") == 1
    keys = worker.gcs_client.call("kv_keys", ("collective", b"g_reap/"))
    assert all(k == b"g_reap/gen" for k in keys), keys


@ray_tpu_torch.remote
class GenMember:
    def __init__(self, rank, world):
        self.rank = rank
        self.world = world

    def join(self, group, generation=0, world=None, rank=None):
        collective.init_collective_group(
            self.world if world is None else world,
            self.rank if rank is None else rank,
            backend="cpu", group_name=group, generation=generation,
        )
        return True

    def blocking_allreduce(self, group):
        """Runs a collective that will block on its peer; returns how it
        ended instead of raising (typed across the actor boundary)."""
        try:
            collective.allreduce(np.ones(4, np.float32), group_name=group)
            return "completed"
        except collective.GroupInvalidatedError:
            return "invalidated"
        except Exception as e:  # noqa: BLE001
            return f"other:{type(e).__name__}"


def test_old_generation_straggler_gets_invalidated(ray_cluster):
    """The elastic teardown drill: while a straggler is blocked inside a
    collective of generation 0, the group is invalidated and re-formed;
    the straggler gets a clean GroupInvalidatedError — NOT a hang in a
    TCP mesh that will never complete."""
    a, b = GenMember.remote(0, 2), GenMember.remote(1, 2)
    ray_tpu_torch.get([x.join.remote("g_strag", 0) for x in (a, b)])
    # Warm-up: one full allreduce establishes the TCP pair, so the
    # straggler below blocks in recv() on a LIVE socket (the hang mode).
    outs = ray_tpu_torch.get(
        [x.blocking_allreduce.remote("g_strag") for x in (a, b)], timeout=60
    )
    assert outs == ["completed", "completed"]
    # b's star-allreduce sends its chunk to rank 0 and then blocks
    # waiting for the reduced result, which never comes (a does not run
    # the collective).
    pending = b.blocking_allreduce.remote("g_strag")
    time.sleep(0.5)
    # Elastic resize: driver bumps the generation, survivor a re-joins as
    # a world of 1 at generation 1 (its local gen-0 mesh is destroyed —
    # the destroy closes the socket b is blocked on).
    new_gen = collective.invalidate_collective_group("g_strag")
    assert new_gen == 1
    # Survivor re-forms as a world of ONE at the new generation.
    ray_tpu_torch.get(a.join.remote("g_strag", new_gen, 1, 0), timeout=30)
    # The straggler surfaces the typed invalidation (bounded wait: the
    # whole point is that this does NOT hang).
    assert ray_tpu_torch.get(pending, timeout=30) == "invalidated"
