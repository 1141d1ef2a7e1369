"""Public exception types (reference: python/ray/exceptions.py)."""

from __future__ import annotations

import traceback


class RayError(Exception):
    """Base for all ray_tpu_torch errors."""


def _rebuild_task_error(cls, function_name, traceback_str, cause, args):
    # Constructor-free rebuild: as_instanceof_cause's derived classes
    # override __init__ with a no-op (the cause class may demand
    # arbitrary constructor args), so replaying __init__ here would
    # either corrupt fields or raise TypeError.
    e = cls.__new__(cls)
    e.function_name = function_name
    e.traceback_str = traceback_str
    e.cause = cause
    e.args = args
    return e


def _rebuild_derived_task_error(function_name, traceback_str, cause, args):
    # The as_instanceof_cause classes are minted at runtime, so plain
    # pickle cannot find them by name; re-derive from the cause instead.
    e = RayTaskError(function_name, traceback_str, cause).as_instanceof_cause()
    e.args = args
    return e


class RayTaskError(RayError):
    """A task raised; re-raised at `ray.get` on the caller.

    Wraps the original exception with the remote traceback (reference:
    python/ray/exceptions.py RayTaskError.as_instanceof_cause)."""

    def __init__(self, function_name: str = "", traceback_str: str = "", cause: BaseException = None):
        self.function_name = function_name
        self.traceback_str = traceback_str
        self.cause = cause
        super().__init__(f"{function_name} failed:\n{traceback_str}")

    def __reduce__(self):
        # Default exception pickling replays cls(*args) with args = the
        # FORMATTED message, which __init__ would shove into
        # function_name and wrap again — every RPC hop doubles the
        # "failed:" framing.  Rebuild from the real fields; __dict__
        # rides along as state so subclass attributes survive.
        cls = type(self)
        import sys

        mod = sys.modules.get(cls.__module__)
        if getattr(mod, cls.__qualname__, None) is not cls:
            # An as_instanceof_cause dynamic class: unreachable by name,
            # so ship the fields and re-derive on load.
            return (
                _rebuild_derived_task_error,
                (self.function_name, self.traceback_str, self.cause, self.args),
                self.__dict__,
            )
        return (
            _rebuild_task_error,
            (cls, self.function_name, self.traceback_str, self.cause, self.args),
            self.__dict__,
        )

    @classmethod
    def from_exception(cls, e: BaseException, function_name: str) -> "RayTaskError":
        return cls(function_name, traceback.format_exc(), e)

    def as_instanceof_cause(self):
        """Return an exception that is also an instance of the cause's class
        so `except UserError` works across the task boundary."""
        cause = self.cause
        if cause is None or isinstance(cause, RayError):
            return self
        cls = type(cause)
        try:
            # __init__/__reduce__ must tolerate pickle round-trips: the
            # dynamic class is serialized by value, and exception reduce
            # calls cls(*args).
            derived = type(
                "RayTaskError(" + cls.__name__ + ")",
                (RayTaskError, cls),
                {"__init__": lambda s, *a, **k: None},
            )()
            derived.function_name = self.function_name
            derived.traceback_str = self.traceback_str
            derived.cause = cause
            derived.args = (f"{self.function_name} failed:\n{self.traceback_str}",)
            return derived
        except TypeError:
            return self


class RayActorError(RayError):
    """The actor died before or during this method call."""

    def __init__(self, message: str = "The actor died unexpectedly.", actor_id=None):
        self.actor_id = actor_id
        super().__init__(message)

    def __reduce__(self):
        # args only carries the message; replaying it would drop
        # actor_id on the far side of the RPC wire.
        return (type(self), (str(self), self.actor_id))


class ActorDiedError(RayActorError):
    pass


class ActorUnavailableError(RayActorError):
    pass


class WorkerCrashedError(RayError):
    """The worker process executing the task died (e.g. SIGKILL/OOM)."""


class ObjectLostError(RayError):
    def __init__(self, object_id=None, message=None):
        self.object_id = object_id
        super().__init__(message or f"Object {object_id} was lost (evicted or node died).")

    def __reduce__(self):
        # Default pickling replays cls(message): the message lands in
        # object_id and gets re-wrapped, drifting on every hop.
        return (type(self), (self.object_id, str(self)))


class ObjectReconstructionFailedError(ObjectLostError):
    pass


class OwnerDiedError(ObjectLostError):
    pass


class GetTimeoutError(RayError, TimeoutError):
    pass


class TaskCancelledError(RayError):
    def __init__(self, task_id=None):
        self.task_id = task_id
        super().__init__(f"Task {task_id} was cancelled.")

    def __reduce__(self):
        # Default pickling replays cls(message), turning task_id into
        # the formatted message string.
        return (type(self), (self.task_id,))


class RuntimeEnvSetupError(RayError):
    pass


class NodeDiedError(RayError):
    pass


class NodeFencedError(RayError):
    """A raylet-originated write carried a stale (node_id, incarnation).

    The GCS stamps an incarnation at every node registration; after it
    declares an incarnation dead, writes still carrying it (a zombie
    raylet on the far side of a healed partition) are rejected with this
    error and counted (``node_fence_rejections_total``) — a fenced
    lease confirmation can never admit work, and a fenced object
    location report can never resurrect a freed copy.  The raylet reacts
    by tearing down its workers, reaping its channel shm, and
    re-registering as a fresh incarnation."""

    def __init__(self, message: str = "node incarnation fenced",
                 node_id=None, incarnation: int = -1):
        self.node_id = node_id
        self.incarnation = incarnation
        super().__init__(message)

    def __reduce__(self):
        # Default exception pickling only replays args[0]; the fenced
        # raylet needs node_id/incarnation intact across the RPC wire.
        return (type(self), (str(self), self.node_id, self.incarnation))


class RaySystemError(RayError):
    pass


class OutOfMemoryError(RayError):
    pass


class PlacementGroupSchedulingError(RayError):
    pass


class QuotaExceededError(RayError):
    """A tenant is over its registered resource quota AND its parked
    admission queue is full (tenant_max_parked) — the backpressure
    surface of the multi-tenant job plane.  Under the cap, over-quota
    requests park instead of raising."""

