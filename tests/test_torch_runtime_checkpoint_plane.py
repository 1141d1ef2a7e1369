"""Durable checkpoint plane drills, against the port: the
snapshot-commit protocol, verified restore with last-good fallback, the
bounded async writer, retention GC, and the seeded ``ckpt:<phase>``
SIGKILL matrix.

The core invariant every test here enforces from a different angle:
**a checkpoint either verifies completely or is never adopted.**  A
writer killed at ANY phase (mid-shard, pre-commit, mid-manifest), a
bit-flipped shard, a torn manifest — all of them restart training from
the last COMMITTED checkpoint, never from plausible garbage.

Chaos drills ride the same seeded ``ckpt:<phase>:<action>`` rule family
as the dataplane's ``chan:`` rules (see chaos.py): per-rule ordinal
streams make every schedule replayable from (spec, seed) alone.
"""

import json
import os
import subprocess
import sys
import threading
import time

import pytest

from ray_tpu_torch.train import checkpoint_plane as cp
from ray_tpu_torch.train.checkpoint_plane import (
    AsyncCheckpointWriter,
    CheckpointCorruptionError,
    CheckpointWriteError,
    MANIFEST_NAME,
)


# ---------------------------------------------------------------------------
# helpers


def _make_src(tmp_path, payloads=None):
    src = tmp_path / "src"
    src.mkdir(exist_ok=True)
    for name, data in (payloads or {"weights.bin": b"w" * 4096, "opt.bin": b"o" * 512}).items():
        (src / name).write_bytes(data)
    return str(src)


def _commit_chain(tmp_path, root_name="exp", n=3, start=1):
    """n committed checkpoints checkpoint_00000{start..} under root."""
    root = tmp_path / root_name
    root.mkdir(exist_ok=True)
    dests = []
    for i in range(start, start + n):
        src = _make_src(tmp_path, {"state.bin": f"step-{i}".encode() * 100})
        dest = str(root / f"checkpoint_{i:06d}")
        cp.persist_dir(src, dest, meta={"idx": i}, mode="sync")
        dests.append(dest)
    return str(root), dests


def _flip_byte(path):
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))


def _counter_value(name):
    from ray_tpu_torch.util import metrics as metrics_mod

    rec = metrics_mod._registry.get((name, ()))
    return rec["value"] if rec else 0.0


@pytest.fixture()
def ckpt_chaos():
    """Seeded ckpt:* chaos spec for in-process write-path drills;
    restores the environment and the plane afterwards."""
    saved = {}

    def set_spec(spec, seed="11"):
        for k, v in {
            "RAY_TPU_TORCH_testing_chaos_spec": spec,
            "RAY_TPU_TORCH_testing_chaos_seed": seed,
        }.items():
            saved.setdefault(k, os.environ.get(k))
            os.environ[k] = v
        from ray_tpu_torch._private.chaos import CHAOS

        CHAOS.reset()

    yield set_spec
    for k, old in saved.items():
        if old is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = old
    from ray_tpu_torch._private.chaos import CHAOS

    CHAOS.reset()


# ---------------------------------------------------------------------------
# commit protocol


def test_snapshot_commit_verifies_and_leaves_no_residue(tmp_path):
    """persist_dir publishes every file atomically + a CRC manifest;
    the result verifies, round-trips its metadata, and leaves zero .tmp
    residue."""
    src = _make_src(tmp_path)
    dest = str(tmp_path / "exp" / "checkpoint_000001")
    out = cp.persist_dir(src, dest, meta={"experiment": "e", "idx": 1}, mode="sync")
    assert out == dest
    manifest = cp.verify_checkpoint(dest)
    assert manifest["meta"]["experiment"] == "e"
    assert set(manifest["shards"]) == {"weights.bin", "opt.bin"}
    assert manifest["shards"]["weights.bin"]["bytes"] == 4096
    assert not [f for f in os.listdir(dest) if f.endswith(".tmp")]
    assert cp.is_committed(dest)
    # byte-identical copy
    with open(os.path.join(dest, "weights.bin"), "rb") as f:
        assert f.read() == b"w" * 4096


def test_write_file_atomic_returns_intended_crc(tmp_path):
    import zlib

    data = b"payload" * 99
    crc = cp.write_file_atomic(str(tmp_path), "shard.bin", data)
    assert crc == zlib.crc32(data) & 0xFFFFFFFF
    assert (tmp_path / "shard.bin").read_bytes() == data


def test_uncommitted_dir_is_never_verified(tmp_path):
    d = tmp_path / "checkpoint_000005"
    d.mkdir()
    (d / "weights.bin").write_bytes(b"plausible")
    with pytest.raises(CheckpointCorruptionError, match="uncommitted"):
        cp.verify_checkpoint(str(d))
    assert not cp.is_committed(str(d))


def test_torn_manifest_is_corruption_not_a_checkpoint(tmp_path):
    root, dests = _commit_chain(tmp_path, n=1)
    mp = os.path.join(dests[0], MANIFEST_NAME)
    data = open(mp, "rb").read()
    with open(mp, "wb") as f:
        f.write(data[: len(data) // 2])  # storage tear
    with pytest.raises(CheckpointCorruptionError, match="manifest"):
        cp.load_manifest(dests[0])
    assert not cp.is_committed(dests[0])


# ---------------------------------------------------------------------------
# verified restore + fallback chain


def test_restore_fallback_walks_to_last_good_and_counts(tmp_path):
    """The fallback chain: K committed-but-bit-flipped, K-1
    bit-flipped too, K-2 good → restore skips two (counted in
    checkpoint_restore_fallbacks_total) and adopts K-2."""
    root, dests = _commit_chain(tmp_path, n=3)  # 1, 2, 3
    _flip_byte(os.path.join(dests[2], "state.bin"))  # K
    _flip_byte(os.path.join(dests[1], "state.bin"))  # K-1
    before = _counter_value("checkpoint_restore_fallbacks_total")
    got = cp.resolve_restore(root=root)
    assert got == dests[0]  # K-2 adopted
    assert _counter_value("checkpoint_restore_fallbacks_total") == before + 2
    # and the survivors actually verify
    cp.verify_checkpoint(got)


def test_restore_prefers_preferred_then_falls_back(tmp_path):
    root, dests = _commit_chain(tmp_path, n=2)
    # preferred (the resume request) is corrupt → chain under root wins
    _flip_byte(os.path.join(dests[1], "state.bin"))
    got = cp.resolve_restore(preferred=dests[1], root=root)
    assert got == dests[0]


def test_restore_never_adopts_uncommitted_over_committed(tmp_path):
    root, dests = _commit_chain(tmp_path, n=1)
    debris = os.path.join(root, "checkpoint_000009")
    os.makedirs(debris)
    with open(os.path.join(debris, "state.bin"), "wb") as f:
        f.write(b"newer but never committed")
    got = cp.resolve_restore(root=root)
    assert got == dests[0]


def test_restore_all_corrupt_raises_never_adopts(tmp_path):
    root, dests = _commit_chain(tmp_path, n=2)
    for d in dests:
        _flip_byte(os.path.join(d, "state.bin"))
    with pytest.raises(CheckpointCorruptionError, match="no checkpoint"):
        cp.resolve_restore(root=root)


def test_restore_legacy_chain_without_manifests(tmp_path):
    """Pre-plane checkpoints (no manifest anywhere, no commit ever
    attempted) load newest-as-is for compatibility."""
    root = tmp_path / "legacy"
    root.mkdir()
    for i in (1, 2):
        d = root / f"checkpoint_{i:06d}"
        d.mkdir()
        (d / "state.bin").write_bytes(b"old-world")
    assert cp.resolve_restore(root=str(root)) == str(root / "checkpoint_000002")


def test_restore_orders_by_generation_then_index(tmp_path):
    root = tmp_path / "exp"
    root.mkdir()
    # Build the name the way the session does (the canonical format the
    # plane's _CKPT_NAME regex parses): generation-prefixed + rank-suffixed.
    # graftlint: disable=generation-key -- this test drills the parser of that very format
    gen_name = f"checkpoint_g{1:03d}_{2:06d}_rank{0}"
    names = ["checkpoint_000009", gen_name]
    for n in names:
        src = _make_src(tmp_path, {"s.bin": n.encode()})
        cp.persist_dir(src, str(root / n), mode="sync")
    # generation 1 outranks a higher plain index of generation 0
    assert cp.resolve_restore(root=str(root), rank=0) == str(root / gen_name)
    cands = cp.candidate_checkpoints(str(root), rank=1)
    assert cands == [str(root / "checkpoint_000009")]  # rank filter


# ---------------------------------------------------------------------------
# retention GC


def test_gc_keeps_newest_k_and_pinned(tmp_path):
    root, dests = _commit_chain(tmp_path, n=5)
    before = _counter_value("checkpoint_gc_reclaimed_total")
    n = cp.gc_checkpoints(root, keep=2, pinned=[dests[0]], grace_s=9999)
    left = sorted(os.listdir(root))
    assert n == 2
    assert left == ["checkpoint_000001", "checkpoint_000004", "checkpoint_000005"]
    assert _counter_value("checkpoint_gc_reclaimed_total") == before + 2


def test_gc_debris_respects_grace_window(tmp_path):
    root, dests = _commit_chain(tmp_path, n=1)
    young = os.path.join(root, "checkpoint_000007")
    old = os.path.join(root, "checkpoint_000008")
    for d in (young, old):
        os.makedirs(d)
        with open(os.path.join(d, "x"), "wb") as f:
            f.write(b"partial")
    os.utime(old, (time.time() - 3600, time.time() - 3600))
    n = cp.gc_checkpoints(root, keep=3, grace_s=600)
    # the old debris is reclaimed; the in-flight-looking young one and
    # the committed checkpoint survive
    assert n == 1
    assert sorted(os.listdir(root)) == ["checkpoint_000001", "checkpoint_000007"]


# ---------------------------------------------------------------------------
# async writer: backpressure + deferred typed error


def test_async_writer_backpressures_never_drops():
    w = AsyncCheckpointWriter(name="t-ckpt-writer")
    try:
        order = []
        gate = threading.Event()

        def slow():
            gate.wait(5.0)
            order.append("first")

        w.submit(slow)
        assert w.busy
        t0 = time.monotonic()
        threading.Timer(0.25, gate.set).start()
        w.submit(lambda: order.append("second"))  # parks until slow() lands
        waited = time.monotonic() - t0
        assert waited >= 0.2  # genuinely blocked, not dropped
        assert order[0] == "first"
        assert w.wait(timeout=5.0)
        assert order == ["first", "second"]
    finally:
        w.close()


def test_async_writer_surfaces_failure_on_next_submit():
    w = AsyncCheckpointWriter(name="t-ckpt-writer-err")
    try:
        w.submit(lambda: (_ for _ in ()).throw(OSError("disk full")))
        # the NEXT submit parks until the failing write lands, then
        # raises its held failure instead of queueing on top of it
        with pytest.raises(CheckpointWriteError, match="disk full"):
            w.submit(lambda: None)
        # the error is consumed once; the writer is usable again
        done = threading.Event()
        w.submit(done.set)
        assert done.wait(5.0)
        w.wait(timeout=5.0)
    finally:
        w.close()


def test_async_writer_wait_raises_held_error():
    w = AsyncCheckpointWriter(name="t-ckpt-writer-wait")
    try:
        w.submit(lambda: (_ for _ in ()).throw(ValueError("boom")))
        # wait() blocks until the failing write lands, then raises it
        with pytest.raises(CheckpointWriteError, match="boom"):
            w.wait(timeout=10.0)
    finally:
        w.close()


def test_async_writer_close_is_clean_and_final():
    w = AsyncCheckpointWriter(name="t-ckpt-writer-close")
    w.submit(lambda: None)
    w.close(timeout=5.0)
    assert not (w._thread and w._thread.is_alive())
    with pytest.raises(CheckpointWriteError, match="closed"):
        w.submit(lambda: None)
    w.close()  # idempotent


# ---------------------------------------------------------------------------
# chaos: torn writes and bit rot (in-process, seeded)


def test_chaos_torn_shard_is_caught_by_verify(tmp_path, ckpt_chaos):
    """A torn shard write (truncated file under the final name — the
    no-commit-protocol failure model) commits a manifest whose CRC can
    never match: restore falls back to the previous checkpoint."""
    root, dests = _commit_chain(tmp_path, n=1)
    ckpt_chaos("ckpt:shard:torn_write:at=1")
    src = _make_src(tmp_path, {"state.bin": b"torn-target" * 200})
    dest = os.path.join(root, "checkpoint_000002")
    cp.persist_dir(src, dest, mode="sync")  # commits, but shard is torn
    with pytest.raises(CheckpointCorruptionError):
        cp.verify_checkpoint(dest)
    assert cp.resolve_restore(root=root) == dests[0]


def test_chaos_bit_flip_never_adopted(tmp_path, ckpt_chaos):
    """Seeded bit rot on a committed shard: verification rejects it and
    the loader walks back — the bit-flipped checkpoint is NEVER adopted
    (zero corrupted restores)."""
    root, dests = _commit_chain(tmp_path, n=1)
    ckpt_chaos("ckpt:shard:bit_flip:at=1")
    src = _make_src(tmp_path, {"state.bin": b"rot-target" * 300})
    dest = os.path.join(root, "checkpoint_000002")
    cp.persist_dir(src, dest, mode="sync")
    with pytest.raises(CheckpointCorruptionError, match="CRC32"):
        cp.verify_checkpoint(dest)
    assert cp.resolve_restore(root=root) == dests[0]


def test_chaos_torn_manifest_falls_back(tmp_path, ckpt_chaos):
    root, dests = _commit_chain(tmp_path, n=1)
    ckpt_chaos("ckpt:manifest:torn_write:at=1")
    src = _make_src(tmp_path, {"state.bin": b"x" * 100})
    dest = os.path.join(root, "checkpoint_000002")
    cp.persist_dir(src, dest, mode="sync")
    assert not cp.is_committed(dest)  # torn manifest = uncommitted
    assert cp.resolve_restore(root=root) == dests[0]


# ---------------------------------------------------------------------------
# chaos: the SIGKILL phase matrix (subprocess — real os._exit(137))

_CHILD = r"""
import os, sys
from ray_tpu_torch.train import checkpoint_plane as cp
src, dest = sys.argv[1], sys.argv[2]
cp.persist_dir(src, dest, meta={"idx": 2}, mode="sync")
"""


def _run_kill_child(tmp_path, phase, root):
    src = _make_src(tmp_path, {"state.bin": b"victim" * 500})
    dest = os.path.join(root, "checkpoint_000002")
    env = dict(os.environ)
    env["RAY_TPU_TORCH_testing_chaos_spec"] = f"ckpt:{phase}:kill:at=1"
    env["RAY_TPU_TORCH_testing_chaos_seed"] = "11"
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, src, dest],
        env=env, capture_output=True, timeout=120,
    )
    return proc, dest


@pytest.mark.chaos
@pytest.mark.parametrize("phase", ["shard", "precommit", "manifest"])
def test_chaos_sigkill_at_every_phase_restarts_to_last_committed(
    tmp_path, phase
):
    """THE tentpole drill: a writer SIGKILLed mid-shard, between the
    last shard and the manifest, or mid-manifest-write leaves a
    checkpoint that is never committed and never adopted — restore
    lands on the previous committed checkpoint at every phase."""
    root, dests = _commit_chain(tmp_path, n=1)
    proc, dest = _run_kill_child(tmp_path, phase, root)
    assert proc.returncode == 137, proc.stderr.decode()
    # killed-mid-write directory is uncommitted (or torn) — never valid
    assert not cp.is_committed(dest)
    with pytest.raises(CheckpointCorruptionError):
        cp.verify_checkpoint(dest)
    # the one loader everything uses falls back to last committed
    assert cp.resolve_restore(root=root) == dests[0]
    # ... and retention GC reclaims the debris once past the grace window
    os.utime(dest, (time.time() - 3600, time.time() - 3600))
    assert cp.gc_checkpoints(root, keep=3, grace_s=60) == 1
    assert not os.path.exists(dest)
    # rerun the same write without chaos: the path itself is sound
    src2 = _make_src(tmp_path, {"state.bin": b"clean" * 500})
    cp.persist_dir(src2, dest, mode="sync")
    assert cp.resolve_restore(root=root) == dest


@pytest.mark.slow
@pytest.mark.chaos
def test_chaos_kill_restart_loss_parity(tmp_path):
    """Kill-restart loss parity: a training loop SIGKILLed mid-write
    restarts from the last committed checkpoint and reaches EXACTLY the
    state of a never-killed run (state here is a deterministic fold, so
    parity is byte-exact)."""
    script = r"""
import json, os, sys
from ray_tpu_torch.train import checkpoint_plane as cp
root = sys.argv[1]; steps = int(sys.argv[2])
state, start = 0, 0
got = cp.resolve_restore(root=root)
if got:
    with open(os.path.join(got, "state.json")) as f:
        d = json.load(f)
    state, start = d["state"], d["step"] + 1
for step in range(start, steps):
    state = (state * 31 + step) % 1000003
    src = os.path.join(root, "_stage")
    os.makedirs(src, exist_ok=True)
    with open(os.path.join(src, "state.json"), "w") as f:
        json.dump({"state": state, "step": step}, f)
    cp.persist_dir(src, os.path.join(root, f"checkpoint_{step:06d}"), mode="sync")
    cp.gc_checkpoints(root, keep=3, grace_s=9999)
print(state)
"""
    def run(root, chaos_spec=None):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env.pop("RAY_TPU_TORCH_testing_chaos_spec", None)
        if chaos_spec:
            env["RAY_TPU_TORCH_testing_chaos_spec"] = chaos_spec
            env["RAY_TPU_TORCH_testing_chaos_seed"] = "11"
        return subprocess.run(
            [sys.executable, "-c", script, root, "8"],
            env=env, capture_output=True, timeout=180,
        )

    clean_root = str(tmp_path / "clean"); os.makedirs(clean_root)
    chaos_root = str(tmp_path / "chaos"); os.makedirs(chaos_root)
    ref = run(clean_root)
    assert ref.returncode == 0, ref.stderr.decode()
    # kill on the 5th shard write, then on the next run's 2nd precommit
    p1 = run(chaos_root, "ckpt:shard:kill:at=5")
    assert p1.returncode == 137
    p2 = run(chaos_root, "ckpt:precommit:kill:at=2")
    assert p2.returncode == 137
    p3 = run(chaos_root)  # final run to completion
    assert p3.returncode == 0, p3.stderr.decode()
    assert p3.stdout.strip() == ref.stdout.strip()  # exact parity
