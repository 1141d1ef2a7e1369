"""Pluggable GCS snapshot persistence (reference:
src/ray/gcs/store_client/redis_store_client.h:106 — the reference's GCS
persists its tables to an external Redis so head-node loss is
recoverable; in_memory_store_client.h is the non-persistent default).

Backends:
  * FileSnapshotStore — session-dir pickle (the default; dies with the
    head node's disk, survives GCS process restarts).
  * RedisSnapshotStore — any Redis-protocol server, spoken directly
    (RESP2 over TCP, ~60 lines; the redis package is not in this image
    and is not needed for SET/GET/PING/AUTH).  State survives full head
    NODE loss: a new head started with the same external address
    restores every durable table.

Selection: ``gcs_external_storage`` config URI —
    ""                                  -> file (default)
    "redis://[:password@]host:port[/key]" -> Redis
    "file:///abs/path"                  -> explicit file location
      (an NFS/shared mount gives file-based head-loss recovery too)
"""

from __future__ import annotations

import logging
import os
import socket
from typing import Optional
from urllib.parse import urlparse

logger = logging.getLogger(__name__)


class SnapshotStore:
    def save(self, blob: bytes) -> None:
        raise NotImplementedError

    def load(self) -> Optional[bytes]:
        raise NotImplementedError

    def describe(self) -> str:
        return type(self).__name__


class FileSnapshotStore(SnapshotStore):
    def __init__(self, path: str):
        self.path = path

    def save(self, blob: bytes) -> None:
        tmp = self.path + ".w"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, self.path)

    def load(self) -> Optional[bytes]:
        try:
            with open(self.path, "rb") as f:
                return f.read()
        except OSError:
            return None

    def describe(self) -> str:
        return f"file:{self.path}"


class RedisSnapshotStore(SnapshotStore):
    """Binary-safe RESP2 client for SET/GET on one key.

    Connections are per-operation: the snapshot cadence is seconds, and
    a dropped external-store link must never leave the GCS holding a
    wedged socket."""

    def __init__(self, host: str, port: int, key: str = "ray_tpu_torch:gcs_snapshot",
                 password: Optional[str] = None, timeout_s: float = 10.0):
        self.host = host
        self.port = port
        self.key = key.encode()
        self.password = password
        self.timeout_s = timeout_s

    # -- RESP wire -------------------------------------------------------
    @staticmethod
    def _encode(*args: bytes) -> bytes:
        out = [b"*%d\r\n" % len(args)]
        for a in args:
            out.append(b"$%d\r\n%s\r\n" % (len(a), a))
        return b"".join(out)

    @staticmethod
    def _read_line(f) -> bytes:
        line = f.readline()
        if not line.endswith(b"\r\n"):
            raise ConnectionError("short read from redis")
        return line[:-2]

    def _read_reply(self, f):
        line = self._read_line(f)
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest
        if kind == b"-":
            raise RuntimeError(f"redis error: {rest.decode(errors='replace')}")
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n == -1:
                return None
            data = f.read(n + 2)
            if len(data) != n + 2:
                raise ConnectionError("short bulk read from redis")
            return data[:-2]
        if kind == b"*":
            return [self._read_reply(f) for _ in range(int(rest))]
        raise ValueError(f"unexpected RESP reply {line!r}")

    def _command(self, *args: bytes):
        with socket.create_connection((self.host, self.port), timeout=self.timeout_s) as s:
            f = s.makefile("rb")
            if self.password:
                s.sendall(self._encode(b"AUTH", self.password.encode()))
                self._read_reply(f)
            s.sendall(self._encode(*args))
            return self._read_reply(f)

    # -- SnapshotStore ---------------------------------------------------
    def save(self, blob: bytes) -> None:
        reply = self._command(b"SET", self.key, blob)
        if reply not in (b"OK",):
            raise RuntimeError(f"redis SET failed: {reply!r}")

    def load(self) -> Optional[bytes]:
        return self._command(b"GET", self.key)

    def ping(self) -> bool:
        try:
            return self._command(b"PING") == b"PONG"
        except Exception:
            return False

    def describe(self) -> str:
        return f"redis://{self.host}:{self.port}/{self.key.decode()}"


def make_snapshot_store(external_uri: str, session_dir: Optional[str]) -> Optional[SnapshotStore]:
    """Resolve the configured snapshot backend; None disables persistence."""
    if external_uri:
        u = urlparse(external_uri)
        if u.scheme == "redis":
            key = (u.path or "").lstrip("/") or "ray_tpu_torch:gcs_snapshot"
            return RedisSnapshotStore(
                u.hostname or "127.0.0.1", u.port or 6379, key,
                password=u.password,
            )
        if u.scheme == "file":
            return FileSnapshotStore(u.path)
        raise ValueError(
            f"unsupported gcs_external_storage {external_uri!r} "
            "(expected redis://host:port[/key] or file:///path)"
        )
    if session_dir:
        return FileSnapshotStore(os.path.join(session_dir, "gcs_snapshot.pkl"))
    return None
