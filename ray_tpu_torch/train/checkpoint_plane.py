"""Durable checkpoint plane: snapshot-commit, verified restore, retention.

Every recovery path (elastic shrink/grow, preemption checkpoint-and-
shrink, pipeline restart, Tune resume) bottoms out in checkpoint
directories.  This module gives them one commit protocol with the same
treatment the dataplane got in the self-healing PR: typed errors, chaos
drills, and a happy path that costs nothing.

**Commit protocol.**  Every file is written to ``.<name>.tmp`` + fsync +
rename, then a manifest (shard list, per-shard CRC32 — the same zlib
checksum the channel wire format trails every frame with — plus caller
metadata) commits the checkpoint with one ``os.replace``.  A directory
without a parseable manifest is by definition uncommitted garbage: the
restore path never adopts it and retention GC reclaims it.

**Async writes.**  :class:`AsyncCheckpointWriter` runs serialize + CRC +
write + commit on a bounded background thread (one write in flight).
``submit`` back-pressures — it parks until the previous write lands,
never drops — and a failed async write surfaces as a typed
:class:`CheckpointWriteError` on the NEXT submit/wait, never silently.

**Verified restore.**  :func:`verify_checkpoint` validates the manifest
and every shard CRC before anything is adopted; a corrupt / partial /
uncommitted checkpoint raises :class:`CheckpointCorruptionError` and
:func:`resolve_restore` walks back through the retained chain until a
verified checkpoint loads (``checkpoint_restore_fallbacks_total``).

**Chaos.**  The write path consults the ``ckpt:<phase>`` chaos rule
family (phases ``shard``, ``precommit``, ``manifest``; actions ``kill``,
``torn_write``, ``bit_flip``) so SIGKILL-at-any-phase and bit-rot drills
are seeded and replayable (docs/failure_semantics.md).
"""

from __future__ import annotations

import json
import os
import threading
import zlib
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

MANIFEST_NAME = "MANIFEST.json"
_MANIFEST_VERSION = 1

# Name shape shared by every checkpoint producer: the train session
# (checkpoint_[gGGG_]NNNNNN_rankR), tune (checkpoint_NNNNNN) and the
# pipeline plane (checkpoint_NNNNNN).  Newest-first ordering is by
# (generation, index).
import re

_CKPT_NAME = re.compile(r"checkpoint_(?:g(\d+)_)?(\d+)(?:_rank(\d+))?$")


class CheckpointWriteError(RuntimeError):
    """A checkpoint write failed to reach its committed state.  For
    async writes this is raised on the NEXT report/submit (the failure
    is held, never lost); the checkpoint that failed was never committed
    so restore can never adopt it."""


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint failed integrity validation (missing/garbage
    manifest, missing shard, shard CRC32 mismatch).  The checkpoint is
    never adopted; the restore path walks back to the previous committed
    one."""


# ---------------------------------------------------------------------------
# chaos consultation (ckpt:<phase> rule family)


def _chaos_decide(phase: str):
    """Fault verdict for one checkpoint-write phase (None on the
    no-chaos fast path).  The checkpoint path is cold relative to the
    dataplane, so the plain plane call (one flag check when inactive)
    is fine here."""
    try:
        from ray_tpu_torch._private.chaos import CHAOS

        cd = CHAOS.decide_ckpt(phase)
        return None if cd.clean else cd
    except Exception:  # noqa: BLE001 — chaos must never break real saves
        return None


def _chaos_kill() -> None:
    """The SIGKILL model: no atexit, no flush, no unwind."""
    os._exit(137)


# ---------------------------------------------------------------------------
# commit protocol


def _fsync_dir(path: str) -> None:
    """Make a rename durable (no-op where directories can't be opened)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def write_file_atomic(dirpath: str, name: str, data: bytes) -> int:
    """Write ``data`` as ``dirpath/name`` via tmp + fsync + rename and
    return the CRC32 of the INTENDED bytes.  A crash at any point leaves
    either the old file or a ``.tmp`` orphan — never a plausible partial
    file under the final name (the ``save_sharded``-mid-SIGKILL bug).

    Chaos phase ``shard``: ``kill`` dies mid-tmp-write, ``torn_write``
    publishes a truncated file under the final name (the storage-tear
    model the manifest CRC must catch), ``bit_flip`` flips one committed
    byte (the bit-rot model)."""
    os.makedirs(dirpath, exist_ok=True)
    final = os.path.join(dirpath, name)
    tmp = os.path.join(dirpath, f".{os.path.basename(name)}.tmp")
    cd = _chaos_decide("shard")
    payload = data
    if cd is not None and cd.torn:
        payload = data[: max(1, len(data) // 2)]
    with open(tmp, "wb") as f:
        if cd is not None and cd.kill:
            f.write(data[: max(1, len(data) // 2)])
            f.flush()
            _chaos_kill()
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)
    _fsync_dir(dirpath)
    if cd is not None and cd.bit_flip and os.path.getsize(final):
        with open(final, "r+b") as f:
            f.seek(os.path.getsize(final) // 2)
            b = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([b[0] ^ 0xFF]))
    return zlib.crc32(data) & 0xFFFFFFFF


def commit_manifest(
    path: str, shards: Dict[str, Dict[str, int]], meta: Optional[Dict[str, Any]] = None
) -> None:
    """Commit the checkpoint at ``path``: one ``os.replace`` of the
    manifest carrying the shard list + per-shard CRC32s.  Everything
    before this rename is garbage; everything after it is durable.

    Chaos phases: ``precommit`` (kill between the last shard rename and
    the manifest write — the uncommitted-debris drill) and ``manifest``
    (kill mid-manifest-write / ``torn_write`` publishes a truncated,
    unparseable manifest)."""
    cd = _chaos_decide("precommit")
    if cd is not None and cd.kill:
        _chaos_kill()
    manifest = {
        "version": _MANIFEST_VERSION,
        "shards": shards,
        "meta": dict(meta or {}),
    }
    data = json.dumps(manifest, sort_keys=True).encode()
    cdm = _chaos_decide("manifest")
    tmp = os.path.join(path, f".{MANIFEST_NAME}.tmp")
    with open(tmp, "wb") as f:
        if cdm is not None and cdm.kill:
            f.write(data[: max(1, len(data) // 2)])
            f.flush()
            _chaos_kill()
        f.write(data[: max(1, len(data) // 2)] if cdm is not None and cdm.torn else data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(path, MANIFEST_NAME))
    _fsync_dir(path)
    try:
        from ray_tpu_torch._private import telemetry

        telemetry.count_checkpoint_commit("committed")
    except Exception:  # noqa: BLE001
        pass


def _iter_files(root: str) -> Iterable[str]:
    """Relative paths of every regular file under ``root`` (sorted),
    excluding the manifest and tmp residue."""
    out: List[str] = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for fn in filenames:
            rel = os.path.relpath(os.path.join(dirpath, fn), root)
            base = os.path.basename(rel)
            if base == MANIFEST_NAME:
                continue
            if base.startswith(".") and base.endswith(".tmp"):
                continue
            out.append(rel)
    return sorted(out)


def persist_dir(
    src: str,
    dest: str,
    *,
    meta: Optional[Dict[str, Any]] = None,
    mode: str = "sync",
) -> str:
    """The full snapshot-commit: copy every file of ``src`` into
    ``dest`` through the atomic path, then commit the manifest.  Returns
    ``dest``.  ``mode`` only labels ``checkpoint_write_seconds`` (sync =
    the train step stalled for this; async = a background writer paid
    it)."""
    import time

    t0 = time.monotonic()
    try:
        os.makedirs(dest, exist_ok=True)
        shards: Dict[str, Dict[str, int]] = {}
        for rel in _iter_files(src):
            with open(os.path.join(src, rel), "rb") as f:
                data = f.read()
            subdir = os.path.join(dest, os.path.dirname(rel)) if os.path.dirname(rel) else dest
            crc = write_file_atomic(subdir, os.path.basename(rel), data)
            shards[rel.replace(os.sep, "/")] = {"crc": crc, "bytes": len(data)}
        commit_manifest(dest, shards, meta)
    except BaseException:
        try:
            from ray_tpu_torch._private import telemetry

            telemetry.count_checkpoint_commit("failed")
        except Exception:  # noqa: BLE001
            pass
        raise
    try:
        from ray_tpu_torch._private import telemetry

        telemetry.observe_checkpoint_write(mode, time.monotonic() - t0)
    except Exception:  # noqa: BLE001
        pass
    return dest


def commit_directory(path: str, meta: Optional[Dict[str, Any]] = None) -> None:
    """In-place commit: CRC every file already under ``path`` (written
    atomically by the caller, e.g. ``save_sharded``) and publish the
    manifest.  Single-writer directories only — files appearing after
    the scan are NOT covered."""
    shards: Dict[str, Dict[str, int]] = {}
    for rel in _iter_files(path):
        full = os.path.join(path, rel)
        crc = 0
        size = 0
        with open(full, "rb") as f:
            while True:
                chunk = f.read(1 << 20)
                if not chunk:
                    break
                crc = zlib.crc32(chunk, crc)
                size += len(chunk)
        shards[rel.replace(os.sep, "/")] = {"crc": crc & 0xFFFFFFFF, "bytes": size}
    commit_manifest(path, shards, meta)


# ---------------------------------------------------------------------------
# verification + restore fallback


def load_manifest(path: str) -> Optional[Dict[str, Any]]:
    """The committed manifest at ``path``; None when absent (uncommitted
    directory); :class:`CheckpointCorruptionError` when present but
    unparseable (torn manifest)."""
    mp = os.path.join(path, MANIFEST_NAME)
    if not os.path.exists(mp):
        return None
    try:
        with open(mp, "rb") as f:
            manifest = json.loads(f.read().decode())
        if not isinstance(manifest, dict) or "shards" not in manifest:
            raise ValueError("manifest missing shard table")
        return manifest
    except (ValueError, UnicodeDecodeError) as e:
        raise CheckpointCorruptionError(
            f"checkpoint {path}: torn/garbage manifest ({e})"
        ) from e


def is_committed(path: str) -> bool:
    try:
        return load_manifest(path) is not None
    except CheckpointCorruptionError:
        return False


def verify_checkpoint(path: str) -> Dict[str, Any]:
    """Validate manifest + every shard CRC32; returns the manifest.
    Raises :class:`CheckpointCorruptionError` on an uncommitted
    directory, a missing shard, a size mismatch or a CRC mismatch —
    nothing here is ever adopted by a restore."""
    if not os.path.isdir(path):
        raise CheckpointCorruptionError(f"checkpoint {path}: not a directory")
    manifest = load_manifest(path)
    if manifest is None:
        raise CheckpointCorruptionError(
            f"checkpoint {path}: no committed manifest (uncommitted debris)"
        )
    for rel, rec in manifest["shards"].items():
        full = os.path.join(path, *rel.split("/"))
        if not os.path.exists(full):
            raise CheckpointCorruptionError(
                f"checkpoint {path}: shard {rel} missing"
            )
        crc = 0
        size = 0
        with open(full, "rb") as f:
            while True:
                chunk = f.read(1 << 20)
                if not chunk:
                    break
                crc = zlib.crc32(chunk, crc)
                size += len(chunk)
        if size != int(rec.get("bytes", size)):
            raise CheckpointCorruptionError(
                f"checkpoint {path}: shard {rel} truncated "
                f"({size} != {rec['bytes']} bytes)"
            )
        if (crc & 0xFFFFFFFF) != int(rec["crc"]):
            raise CheckpointCorruptionError(
                f"checkpoint {path}: shard {rel} failed CRC32 validation"
            )
    return manifest


def _name_key(name: str) -> Optional[Tuple[int, int]]:
    m = _CKPT_NAME.match(name)
    if not m:
        return None
    return (int(m.group(1) or 0), int(m.group(2)))


def candidate_checkpoints(root: str, *, rank: Optional[int] = None) -> List[str]:
    """Checkpoint directories under ``root``, newest first by
    (generation, index).  ``rank`` filters to one rank's directories
    (unsuffixed names always qualify)."""
    if not root or not os.path.isdir(root):
        return []
    out: List[Tuple[Tuple[int, int], str]] = []
    for entry in os.listdir(root):
        m = _CKPT_NAME.match(entry)
        if not m:
            continue
        if rank is not None and m.group(3) is not None and int(m.group(3)) != rank:
            continue
        full = os.path.join(root, entry)
        if os.path.isdir(full):
            out.append(((int(m.group(1) or 0), int(m.group(2))), full))
    out.sort(key=lambda kv: kv[0], reverse=True)
    return [p for _, p in out]


def resolve_restore(
    preferred: Optional[str] = None,
    root: Optional[str] = None,
    *,
    rank: Optional[int] = None,
) -> Optional[str]:
    """THE restore loader every consumer goes through (elastic restart,
    pipeline restart, Tune resume): return the newest checkpoint that
    passes :func:`verify_checkpoint`, trying ``preferred`` first and
    then walking the retained chain under ``root`` newest → oldest.
    Every rejected candidate counts ``checkpoint_restore_fallbacks_total``.

    Returns None when there are no candidates at all.  Raises
    :class:`CheckpointCorruptionError` when candidates exist but none
    verifies — silent adoption of garbage is the one outcome this plane
    exists to prevent.  Pre-plane checkpoints (no manifest anywhere in
    the chain) fall back to newest-as-is for compatibility."""
    import logging

    logger = logging.getLogger(__name__)
    chain: List[str] = []
    if preferred:
        chain.append(os.path.abspath(preferred))
    for cand in candidate_checkpoints(root, rank=rank) if root else []:
        if os.path.abspath(cand) not in chain:
            chain.append(os.path.abspath(cand))
    if not chain:
        return None
    fallbacks = 0
    errors: List[str] = []
    any_committed = False
    try:
        for cand in chain:
            try:
                verify_checkpoint(cand)
            except CheckpointCorruptionError as e:
                try:
                    any_committed = any_committed or load_manifest(cand) is not None
                except CheckpointCorruptionError:
                    any_committed = True  # torn manifest = a commit was attempted
                fallbacks += 1
                errors.append(str(e))
                logger.warning("restore skipping %s: %s", cand, e)
                continue
            if fallbacks:
                logger.warning(
                    "restore fell back %d checkpoint(s) to %s", fallbacks, cand
                )
            return cand
        if not any_committed:
            # Legacy chain (written before the commit protocol existed):
            # newest-as-is, preserving pre-plane behavior.
            logger.warning(
                "no committed checkpoint under %s; adopting %s unverified "
                "(pre-commit-protocol checkpoint)", root, chain[0]
            )
            return chain[0]
        raise CheckpointCorruptionError(
            "no checkpoint in the retained chain passed verification: "
            + "; ".join(errors)
        )
    finally:
        if fallbacks:
            try:
                from ray_tpu_torch._private import telemetry

                telemetry.count_checkpoint_restore_fallback(fallbacks)
            except Exception:  # noqa: BLE001
                pass


# ---------------------------------------------------------------------------
# retention GC


def gc_checkpoints(
    root: str,
    *,
    keep: Optional[int] = None,
    pinned: Sequence[str] = (),
    grace_s: Optional[float] = None,
) -> int:
    """Retention sweep of ``root``: keep the newest ``keep`` committed
    checkpoint groups (a group = every rank's directory of one
    (generation, index)) plus anything ``pinned``; reclaim older
    committed ones and uncommitted debris older than ``grace_s`` (the
    grace window protects concurrent in-flight writers, exactly like the
    shm sweeper's registered-PID check protects live rings).  Returns
    the number of directories removed (``checkpoint_gc_reclaimed_total``)."""
    import shutil
    import time

    from ray_tpu_torch._private.config import CONFIG

    if keep is None:
        keep = int(CONFIG.train_checkpoint_keep)
    if grace_s is None:
        grace_s = float(CONFIG.train_checkpoint_gc_grace_s)
    if not root or not os.path.isdir(root):
        return 0
    pinned_abs = {os.path.abspath(p) for p in pinned if p}
    committed_keys: List[Tuple[int, int]] = []
    entries: List[Tuple[Tuple[int, int], str, bool]] = []
    now = time.time()
    for entry in os.listdir(root):
        key = _name_key(entry)
        if key is None:
            continue
        full = os.path.join(root, entry)
        if not os.path.isdir(full):
            continue
        committed = is_committed(full)
        entries.append((key, full, committed))
        if committed:
            committed_keys.append(key)
    live_keys = set(sorted(set(committed_keys), reverse=True)[: max(0, keep)])
    reclaimed = 0
    for key, full, committed in entries:
        if os.path.abspath(full) in pinned_abs:
            continue
        if committed:
            if key in live_keys:
                continue
        else:
            # Uncommitted: debris only once past the grace window — a
            # background writer may be mid-commit right now.
            try:
                age = now - os.path.getmtime(full)
            except OSError:
                continue
            if age < grace_s:
                continue
        shutil.rmtree(full, ignore_errors=True)
        if not os.path.exists(full):
            reclaimed += 1
    if reclaimed:
        try:
            from ray_tpu_torch._private import telemetry

            telemetry.count_checkpoint_gc_reclaimed(reclaimed)
        except Exception:  # noqa: BLE001
            pass
    return reclaimed


# ---------------------------------------------------------------------------
# async writer


class AsyncCheckpointWriter:
    """Bounded background checkpoint writer: ONE write in flight.

    ``submit(fn)`` parks until the previous write completes (the
    back-pressure contract: a checkpoint is delayed, never dropped) and
    raises :class:`CheckpointWriteError` if that previous write failed —
    a failed async write always surfaces on the next report, it is never
    lost.  ``wait()`` is the synchronous flush the drain/preempt path
    uses before a shrink."""

    def __init__(self, name: str = "ckpt-writer"):
        self._name = name
        self._lock = threading.Lock()
        self._job = None
        self._job_ready = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._closed = False

    @property
    def busy(self) -> bool:
        return not self._idle.is_set()

    def _ensure_thread(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=self._name
        )
        self._thread.start()

    def _run(self) -> None:
        while True:
            self._job_ready.wait()
            with self._lock:
                job = self._job
                self._job = None
                self._job_ready.clear()
            if job is None:  # close() sentinel
                return
            try:
                job()
            except BaseException as e:  # noqa: BLE001 — held for the next submit
                with self._lock:
                    self._error = e
            finally:
                self._idle.set()

    def _raise_pending(self) -> None:
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise CheckpointWriteError(
                f"previous async checkpoint write failed: {err!r}"
            ) from err

    def submit(self, fn) -> None:
        """Queue one write.  Blocks (back-pressure) while the previous
        write is in flight; raises the previous write's failure as
        :class:`CheckpointWriteError` instead of queueing on top of it."""
        if self._closed:
            raise CheckpointWriteError("checkpoint writer is closed")
        self._ensure_thread()
        self._idle.wait()
        self._raise_pending()
        with self._lock:
            self._job = fn
            self._idle.clear()
            self._job_ready.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Synchronous flush: block until the in-flight write (if any)
        completes; raises a held :class:`CheckpointWriteError`.  Returns
        False only on timeout."""
        ok = self._idle.wait(timeout)
        if ok:
            self._raise_pending()
        return ok

    def close(self, timeout: float = 30.0) -> None:
        """Flush and stop the thread (errors from the last write are
        swallowed — the owner is shutting down)."""
        self._closed = True
        self._idle.wait(timeout)
        with self._lock:
            self._error = None
            self._job = None
            self._job_ready.set()  # wake the thread into the sentinel
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=timeout)
