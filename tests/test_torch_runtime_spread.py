"""The port's SPREAD placement of tasks (``_private/raylet.py``
``_spread_decision``): a round-robin over the node and its peers the task
fits, those with the resources free first.  The hybrid policy, which the
JAX package's raylet also applies to SPREAD, keeps a burst of tasks on the
submitting node while its view still shows it free, so
``tests/test_torch_multinode.py::test_spread_scheduling`` found every task
of a burst on one node.  This file imports neither JAX nor the JAX
package."""

from ray_tpu_torch._private.common import ResourceSet
from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch._private.raylet import Raylet


def _raylet(total, available, peers):
    """A Raylet with only what ``_spread_decision`` reads: its node id, its
    resources and its view of the peers ({address: (available, total)})."""
    r = Raylet.__new__(Raylet)
    r.node_id = NodeID.from_random()
    r.resources_total = ResourceSet.of(total)
    r.resources_available = ResourceSet.of(available)
    r.cluster_view = {
        NodeID.from_random().binary(): {"raylet_address": addr, "available": avail, "total": tot}
        for addr, (avail, tot) in peers.items()
    }
    r._spread_next = 0
    return r


def test_spread_alternates_over_nodes_with_free_resources():
    r = _raylet({"CPU": 2}, {"CPU": 2}, {"peer": ({"CPU": 2}, {"CPU": 2})})
    picks = [r._spread_decision(ResourceSet.of({"CPU": 1})) for _ in range(4)]
    # a burst of four: two stay here (None), two go to the peer
    assert sorted(picks, key=str) == [None, None, "peer", "peer"]
    assert picks[0] != picks[1]


def test_spread_prefers_free_nodes_then_feasible_ones():
    busy_here = _raylet({"CPU": 2}, {}, {"a": ({"CPU": 1}, {"CPU": 2}),
                                         "b": ({}, {"CPU": 2})})
    # only peer a has a CPU free now: every pick goes there
    assert {busy_here._spread_decision(ResourceSet.of({"CPU": 1})) for _ in range(3)} == {"a"}
    full = _raylet({"CPU": 2}, {}, {"a": ({}, {"CPU": 2})})
    # nothing free anywhere: round-robin over the nodes the task fits at all
    assert {full._spread_decision(ResourceSet.of({"CPU": 1})) for _ in range(2)} == {None, "a"}


def test_spread_skips_nodes_the_task_cannot_fit():
    r = _raylet({"CPU": 2}, {"CPU": 2}, {"gpu": ({"CPU": 2, "GPU": 1}, {"CPU": 2, "GPU": 1})})
    assert {r._spread_decision(ResourceSet.of({"GPU": 1})) for _ in range(3)} == {"gpu"}
    alone = _raylet({"CPU": 2}, {"CPU": 2}, {})
    assert alone._spread_decision(ResourceSet.of({"GPU": 1})) is None
