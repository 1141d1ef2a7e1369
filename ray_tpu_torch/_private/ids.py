"""Binary entity IDs with embedded lineage.

Mirrors the reference ID specification (reference:
src/ray/design_docs/id_specification.md) — JobID (4B) is embedded in
ActorID (16B), ActorID in TaskID (24B), TaskID in ObjectID (28B) — so that
ownership and lineage can be recovered from the bytes alone, without a
directory lookup.  The implementation is new: plain Python bytes with
cached hashing, designed so IDs can cross process boundaries as raw bytes
and live as dict keys on the scheduler hot path.
"""

from __future__ import annotations

import os
import struct

JOB_ID_SIZE = 4
ACTOR_ID_SIZE = 16
TASK_ID_SIZE = 24
OBJECT_ID_SIZE = 28
NODE_ID_SIZE = 16
WORKER_ID_SIZE = 16
PLACEMENT_GROUP_ID_SIZE = 16

# Unique-part sizes
ACTOR_ID_UNIQUE = ACTOR_ID_SIZE - JOB_ID_SIZE
TASK_ID_UNIQUE = TASK_ID_SIZE - ACTOR_ID_SIZE


class BaseID:
    SIZE = 0
    __slots__ = ("_bytes", "_hash")

    def __init__(self, id_bytes: bytes):
        if len(id_bytes) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got {len(id_bytes)}"
            )
        self._bytes = bytes(id_bytes)
        self._hash = hash(self._bytes)

    @classmethod
    def from_random(cls):
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def nil(cls):
        return cls(b"\xff" * cls.SIZE)

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def is_nil(self) -> bool:
        return self._bytes == b"\xff" * self.SIZE

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __lt__(self, other):
        return self._bytes < other._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    SIZE = JOB_ID_SIZE

    @classmethod
    def from_int(cls, value: int) -> "JobID":
        return cls(struct.pack(">I", value))

    def int_value(self) -> int:
        return struct.unpack(">I", self._bytes)[0]


class NodeID(BaseID):
    SIZE = NODE_ID_SIZE


class WorkerID(BaseID):
    SIZE = WORKER_ID_SIZE


class PlacementGroupID(BaseID):
    SIZE = PLACEMENT_GROUP_ID_SIZE


class ActorID(BaseID):
    """16 bytes: 12 unique + 4 job id (suffix)."""

    SIZE = ACTOR_ID_SIZE

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(os.urandom(ACTOR_ID_UNIQUE) + job_id.binary())

    @classmethod
    def nil_of(cls, job_id: JobID) -> "ActorID":
        """The nil actor id scoped to a job — used by non-actor tasks."""
        return cls(b"\xff" * ACTOR_ID_UNIQUE + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._bytes[ACTOR_ID_UNIQUE:])


class TaskID(BaseID):
    """24 bytes: 8 unique + 16 actor id (suffix)."""

    SIZE = TASK_ID_SIZE

    @classmethod
    def of(cls, actor_id: ActorID) -> "TaskID":
        return cls(os.urandom(TASK_ID_UNIQUE) + actor_id.binary())

    @classmethod
    def for_driver(cls, job_id: JobID) -> "TaskID":
        return cls(b"\x00" * TASK_ID_UNIQUE + ActorID.nil_of(job_id).binary())

    def actor_id(self) -> ActorID:
        return ActorID(self._bytes[TASK_ID_UNIQUE:])

    def job_id(self) -> JobID:
        return self.actor_id().job_id()


class ObjectID(BaseID):
    """28 bytes: 24 task id + 4 return-index (big endian).

    The creating task is recoverable from the id — this is what makes
    lineage reconstruction possible without a metadata service.
    """

    SIZE = OBJECT_ID_SIZE

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + struct.pack(">I", index))

    @classmethod
    def from_random(cls):
        # Random "put" objects get a random fake task id with index 0xFFFFFFFF
        # so they are never confused with task returns.
        return cls(os.urandom(TASK_ID_SIZE) + b"\xff\xff\xff\xff")

    @classmethod
    def for_put(cls, job_id: "JobID") -> "ObjectID":
        """ray.put object: random unique part but the owner's job embedded,
        so per-job GC can reclaim it from the bytes alone."""
        fake_task = os.urandom(TASK_ID_UNIQUE) + os.urandom(ACTOR_ID_UNIQUE) + job_id.binary()
        return cls(fake_task + b"\xff\xff\xff\xff")

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[:TASK_ID_SIZE])

    def return_index(self) -> int:
        return struct.unpack(">I", self._bytes[TASK_ID_SIZE:])[0]

    def is_task_return(self) -> bool:
        return self.return_index() != 0xFFFFFFFF

    def job_id(self) -> JobID:
        return self.task_id().job_id()


ObjectRefID = ObjectID  # alias
