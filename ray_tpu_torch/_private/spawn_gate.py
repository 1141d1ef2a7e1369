"""Host-wide worker-spawn gate.

Raylets cap concurrently-STARTING workers so a creation burst doesn't
fork more interpreters than the machine can register within the lease
window.  The cap must be per-HOST, not per-raylet: test topologies pack
tens of raylets onto one box, and N raylets × a per-raylet cap is
exactly the fork storm the cap exists to prevent — while a single
raylet's population of 4 actors must NOT be serialized on a big cap.

Implementation: a directory of slot files shared by every raylet of the
session (same machine); holding slot i = holding an exclusive flock on
file i.  Locks die with the process, so a crashed raylet can never leak
a slot."""

from __future__ import annotations

import fcntl
import os
from typing import Optional


def default_slots() -> int:
    # generous enough that small actor populations start concurrently,
    # bounded enough that bursts register within their deadlines even on
    # single-core boxes (interpreter start is CPU-bound: more than ~4
    # concurrent starts per core just stretches everyone's registration)
    return max(4, 2 * (os.cpu_count() or 1))


class HostSpawnGate:
    def __init__(self, gate_dir: str, slots: Optional[int] = None):
        self.dir = gate_dir
        self.slots = slots or default_slots()
        os.makedirs(gate_dir, exist_ok=True)

    def try_acquire(self) -> Optional[int]:
        """A free slot's fd, or None when the host is saturated."""
        for i in range(self.slots):
            path = os.path.join(self.dir, f"slot-{i}")
            fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o600)
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                return fd
            except OSError:
                os.close(fd)
        return None

    @staticmethod
    def release(token: int) -> None:
        try:
            fcntl.flock(token, fcntl.LOCK_UN)
        finally:
            os.close(token)
