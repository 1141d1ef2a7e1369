"""Every typed exception must survive a pickle round trip intact.

Exceptions are the one payload that crosses EVERY boundary — RPC replies,
channel frames, object-store blobs — and default ``BaseException``
pickling replays ``cls(*args)`` where args is the *formatted message*.
For any exception whose ``__init__`` signature is not ``(message)``,
that replay corrupts fields (task_id becomes the message string) or
re-wraps the message on every hop ("X failed:\nX failed:\n...").  These
tests pin type, message, and structured fields across one AND two round
trips (the second catches drift the first can mask).
"""

import pickle

import pytest

from ray_tpu_torch import exceptions


def _roundtrip(e, times=2):
    for _ in range(times):
        e = pickle.loads(pickle.dumps(e))
    return e


def _cloudpickle():
    import cloudpickle

    return cloudpickle


_PICKLERS = [
    (pickle.dumps, pickle.loads),
    (_cloudpickle().dumps, _cloudpickle().loads),
]


# Every public exception class with representative constructor args.
CASES = [
    exceptions.RayError("boom"),
    exceptions.RayTaskError("f", "Traceback: ValueError: boom\n", ValueError("boom")),
    exceptions.RayActorError("actor gone", actor_id=b"\x01" * 8),
    exceptions.ActorDiedError("died hard", actor_id=b"\x02" * 8),
    exceptions.ActorUnavailableError("away", actor_id=b"\x03" * 8),
    exceptions.WorkerCrashedError("sigkill"),
    exceptions.ObjectLostError(b"\x04" * 8, "copy evicted"),
    exceptions.ObjectReconstructionFailedError(b"\x05" * 8, "lineage exhausted"),
    exceptions.OwnerDiedError(b"\x06" * 8, "owner fell over"),
    exceptions.GetTimeoutError("deadline"),
    exceptions.TaskCancelledError(b"\x07" * 8),
    exceptions.RuntimeEnvSetupError("pip exploded"),
    exceptions.NodeDiedError("node gone"),
    exceptions.NodeFencedError("stale write", node_id=b"\x08" * 8, incarnation=41),
    exceptions.RaySystemError("internal"),
    exceptions.OutOfMemoryError("oom"),
    exceptions.PlacementGroupSchedulingError("infeasible"),
    exceptions.QuotaExceededError("over quota and parked-full"),
]


@pytest.mark.parametrize("exc", CASES, ids=lambda e: type(e).__name__)
def test_roundtrip_preserves_type_and_message(exc):
    got = _roundtrip(exc)
    assert type(got) is type(exc)
    assert str(got) == str(exc)
    assert isinstance(got, exceptions.RayError)


def test_ray_task_error_fields_survive():
    cause = ValueError("boom")
    e = exceptions.RayTaskError("trainer.step", "Traceback (most recent call last):\n...", cause)
    got = _roundtrip(e)
    assert got.function_name == "trainer.step"
    assert got.traceback_str == e.traceback_str
    assert type(got.cause) is ValueError and str(got.cause) == "boom"
    # The message must not grow a second "failed:" frame per hop.
    assert str(got).count("failed:") == 1


def test_as_instanceof_cause_is_catchable_after_roundtrip():
    # The derived class is dynamic (unreachable by module attribute), so
    # __reduce__ ships the fields and re-derives on load — plain pickle
    # must work: the RPC layer and user code both use it on caught errors.
    e = exceptions.RayTaskError.from_exception(KeyError("missing"), "lookup")
    derived = e.as_instanceof_cause()
    for dumps, loads in _PICKLERS:
        got = loads(dumps(derived))
        assert isinstance(got, exceptions.RayTaskError)
        assert isinstance(got, KeyError)
        assert got.function_name == "lookup"
        assert type(got.cause) is KeyError
        assert str(got) == str(derived)
        # A second hop must neither fail nor re-frame the message.
        again = loads(dumps(got))
        assert isinstance(again, KeyError) and str(again) == str(derived)


def test_actor_error_keeps_actor_id():
    for cls in (
        exceptions.RayActorError,
        exceptions.ActorDiedError,
        exceptions.ActorUnavailableError,
    ):
        got = _roundtrip(cls("gone", actor_id=b"\xaa" * 8))
        assert type(got) is cls
        assert got.actor_id == b"\xaa" * 8
        assert str(got) == "gone"


def test_object_lost_keeps_object_id():
    for cls in (
        exceptions.ObjectLostError,
        exceptions.ObjectReconstructionFailedError,
        exceptions.OwnerDiedError,
    ):
        got = _roundtrip(cls(b"\xbb" * 8, "gone"))
        assert type(got) is cls
        assert got.object_id == b"\xbb" * 8
        assert str(got) == "gone"
    # Default-message path must not nest "Object Object ... was lost".
    got = _roundtrip(exceptions.ObjectLostError(b"\xcc" * 8))
    assert got.object_id == b"\xcc" * 8
    assert str(got).count("was lost") == 1


def test_task_cancelled_keeps_task_id():
    got = _roundtrip(exceptions.TaskCancelledError(b"\xdd" * 8))
    assert got.task_id == b"\xdd" * 8
    assert str(got).count("was cancelled") == 1


def test_node_fenced_keeps_incarnation():
    got = _roundtrip(exceptions.NodeFencedError("stale", node_id=b"\xee" * 8, incarnation=7))
    assert got.node_id == b"\xee" * 8
    assert got.incarnation == 7


def test_get_timeout_still_a_timeout():
    got = _roundtrip(exceptions.GetTimeoutError("t"))
    assert isinstance(got, TimeoutError)
