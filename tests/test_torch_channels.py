"""Compiled-DAG zero-copy channels of the port (reference:
experimental_mutable_object_manager.h:48, shared_memory_channel.py,
per-actor schedules compiled_dag_node.py:1639) — copies of
``tests/test_channels.py`` over the port's runtime, channels and
``dag/``."""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.dag import InputNode, MultiOutputNode
from ray_tpu_torch.experimental.channel import Channel, ChannelClosed, ChannelTimeout


@pytest.fixture(scope="module", autouse=True)
def ray():
    """Module-scoped local cluster of the port (the conftest's fixtures
    start the JAX package's)."""
    with pytest.MonkeyPatch.context() as mp:
        # many clusters share the machine under xdist: no 2 GiB arena
        # prefault, and no memory monitor killing this test's workers for
        # the others' memory
        mp.setenv("RAY_TPU_TORCH_arena_prefault_bytes", "0")
        mp.setenv("RAY_TPU_TORCH_memory_monitor_enabled", "0")
        ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
        yield ray_tpu_torch
        ray_tpu_torch.shutdown()


# ---------------------------------------------------------------------------
# Channel primitive


def test_channel_roundtrip(tmp_path):
    p = str(tmp_path / "c1")
    Channel.create_file(p, 1024)
    w, r = Channel(p), Channel(p)
    w.write(b"hello")
    assert r.read() == b"hello"
    w.write(b"world")
    assert r.read() == b"world"


def test_channel_multiple_inflight(tmp_path):
    """The ring holds many messages at once (pipelined executions)."""
    p = str(tmp_path / "c1b")
    Channel.create_file(p, 4096)
    w, r = Channel(p), Channel(p)
    for i in range(10):
        w.write(f"msg{i}".encode(), timeout=1)
    assert [r.read() for _ in range(10)] == [f"msg{i}".encode() for i in range(10)]


def test_channel_flow_control(tmp_path):
    p = str(tmp_path / "c2")
    Channel.create_file(p, 1024)
    w, r = Channel(p), Channel(p)
    w.write(b"x" * 700)
    with pytest.raises(ChannelTimeout):
        w.write(b"y" * 700, timeout=0.3)  # ring full, reader hasn't consumed
    assert r.read() == b"x" * 700
    w.write(b"y" * 700, timeout=5)
    assert r.read() == b"y" * 700


def test_channel_poison(tmp_path):
    p = str(tmp_path / "c3")
    Channel.create_file(p, 1024)
    w, r = Channel(p), Channel(p)
    w.close()
    with pytest.raises(ChannelClosed):
        r.read(timeout=5)


def test_channel_drains_before_close(tmp_path):
    """close() is drain-then-close: buffered messages stay readable,
    the reader sees ChannelClosed only after consuming the backlog."""
    p = str(tmp_path / "c4")
    Channel.create_file(p, 1024)
    w, r = Channel(p), Channel(p)
    w.write(b"last words")
    w.close()
    assert r.read(timeout=5) == b"last words"
    with pytest.raises(ChannelClosed):
        r.read(timeout=5)


# ---------------------------------------------------------------------------
# Compiled DAG over channels


def test_compiled_pipeline_two_actors():
    """A 2-actor pipeline: data flows A -> B entirely over channels,
    state persists, and results come back in submission order."""

    @ray_tpu_torch.remote
    class Stage:
        def __init__(self, inc):
            self.inc = inc
            self.count = 0

        def step(self, x):
            self.count += 1
            return x + self.inc

        def calls(self):
            return self.count

    a, b = Stage.bind(1), Stage.bind(10)
    with InputNode() as inp:
        dag = b.step.bind(a.step.bind(inp))
    compiled = dag.experimental_compile(max_inflight=8)
    assert compiled._channels_on  # really on the channel plane
    refs = [compiled.execute(i) for i in range(5)]
    assert [ray_tpu_torch.get(r) for r in refs] == [i + 11 for i in range(5)]
    compiled.teardown()


def test_compiled_multi_output_fan():
    @ray_tpu_torch.remote
    class Math:
        def double(self, x):
            return x * 2

        def square(self, x):
            return x * x

    m1, m2 = Math.bind(), Math.bind()
    with InputNode() as inp:
        dag = MultiOutputNode([m1.double.bind(inp), m2.square.bind(inp)])
    compiled = dag.experimental_compile()
    assert compiled._channels_on
    assert ray_tpu_torch.get(compiled.execute(6)) == [12, 36]
    assert ray_tpu_torch.get(compiled.execute(3)) == [6, 9]
    compiled.teardown()


def test_compiled_channel_throughput_beats_task_path():
    """The channel plane must clearly beat per-call task submission on a
    tiny-payload pipeline (that's its reason to exist)."""

    @ray_tpu_torch.remote
    class Echo:
        def echo(self, x):
            return x

    with InputNode() as inp:
        dag = Echo.bind().echo.bind(inp)
    compiled = dag.experimental_compile()
    assert compiled._channels_on
    ray_tpu_torch.get(compiled.execute(0))  # warm
    n = 200
    t0 = time.monotonic()
    for i in range(n):
        ray_tpu_torch.get(compiled.execute(i))
    chan_rate = n / (time.monotonic() - t0)
    compiled.teardown()

    actor = Echo.remote()
    ray_tpu_torch.get(actor.echo.remote(0))
    t0 = time.monotonic()
    for i in range(n):
        ray_tpu_torch.get(actor.echo.remote(i))
    task_rate = n / (time.monotonic() - t0)
    ray_tpu_torch.kill(actor)
    assert chan_rate > task_rate * 1.5, (chan_rate, task_rate)


def test_compiled_teardown_unblocks_actors():
    @ray_tpu_torch.remote
    class S:
        def f(self, x):
            return x

    with InputNode() as inp:
        dag = S.bind().f.bind(inp)
    compiled = dag.experimental_compile()
    assert ray_tpu_torch.get(compiled.execute(1)) == 1
    compiled.teardown()  # must not hang


def test_compiled_error_propagates_and_dag_survives():
    """An actor-method exception flows to the driver's get as the
    original error, and the DAG keeps working afterwards."""

    @ray_tpu_torch.remote
    class Fragile:
        def f(self, x):
            if x < 0:
                raise ValueError("negative!")
            return x * 2

    with InputNode() as inp:
        dag = Fragile.bind().f.bind(inp)
    compiled = dag.experimental_compile()
    assert ray_tpu_torch.get(compiled.execute(4)) == 8
    with pytest.raises(ValueError):
        ray_tpu_torch.get(compiled.execute(-1))
    assert ray_tpu_torch.get(compiled.execute(5)) == 10  # still alive
    compiled.teardown()


def test_compiled_inflight_cap():
    @ray_tpu_torch.remote
    class Slow:
        def f(self, x):
            time.sleep(0.3)
            return x

    with InputNode() as inp:
        dag = Slow.bind().f.bind(inp)
    compiled = dag.experimental_compile(max_inflight=2)
    r1 = compiled.execute(1)
    compiled.execute(2)
    with pytest.raises(RuntimeError, match="in flight"):
        compiled.execute(3)
    assert ray_tpu_torch.get(r1) == 1
    compiled.teardown()


def test_compiled_teardown_cleans_tmpfs():
    import os

    @ray_tpu_torch.remote
    class S:
        def f(self, x):
            return x

    with InputNode() as inp:
        dag = S.bind().f.bind(inp)
    compiled = dag.experimental_compile()
    chan_dir = compiled._chan_dir
    assert os.path.isdir(chan_dir)
    ray_tpu_torch.get(compiled.execute(1))
    compiled.teardown()
    assert not os.path.exists(chan_dir)  # tmpfs reclaimed


def test_function_node_compiles_to_executor_loop():
    """Driver-side FunctionNodes ride the channel plane too: each one is
    hosted by a resident _FnExecutor actor instead of taking the
    per-call task path."""

    @ray_tpu_torch.remote
    def plain(x):
        return x + 1

    @ray_tpu_torch.remote
    def double(x):
        return x * 2

    with InputNode() as inp:
        dag = double.bind(plain.bind(inp))
    compiled = dag.experimental_compile()
    assert compiled._channels_on  # no task-path fallback anymore
    assert [ray_tpu_torch.get(compiled.execute(i)) for i in range(4)] == [2, 4, 6, 8]
    compiled.teardown()


def test_mixed_function_and_actor_graph_compiles():
    """A FunctionNode feeding an actor method (and vice versa) is one
    compiled graph spanning executor + user actors."""

    @ray_tpu_torch.remote
    def pre(x):
        return x + 1

    @ray_tpu_torch.remote
    class Scale:
        def __init__(self, k):
            self.k = k

        def mul(self, x):
            return x * self.k

    @ray_tpu_torch.remote
    def post(x):
        return x - 3

    with InputNode() as inp:
        dag = post.bind(Scale.bind(10).mul.bind(pre.bind(inp)))
    compiled = dag.experimental_compile()
    assert compiled._channels_on
    assert ray_tpu_torch.get(compiled.execute(4)) == 47  # (4+1)*10-3
    assert ray_tpu_torch.get(compiled.execute(0)) == 7
    compiled.teardown()


def test_kwargs_fall_back_to_task_path():
    """Graphs outside the op schedule's vocabulary still execute via the
    per-node task path."""

    @ray_tpu_torch.remote
    def f(x, k=1):
        return x + k

    with InputNode() as inp:
        dag = f.bind(inp, k=5)
    compiled = dag.experimental_compile()
    assert not compiled._channels_on
    assert ray_tpu_torch.get(compiled.execute(10)) == 15
    compiled.teardown()


# ---------------------------------------------------------------------------
# Channel edge cases (ring + socket + wire format)


def test_ring_wraparound_under_sustained_load(tmp_path):
    """Thousands of variable-size messages through a small ring: the
    write position wraps the region many times and every payload
    survives byte-exact (wrap markers + implicit tail skips)."""
    import threading

    p = str(tmp_path / "wrap")
    Channel.create_file(p, 4096)
    w, r = Channel(p), Channel(p)
    n = 1500
    payloads = [bytes([i % 251]) * (1 + (i * 37) % 900) for i in range(n)]
    errs = []

    def writer():
        try:
            for pl in payloads:
                w.write(pl, timeout=30)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    for i in range(n):
        assert r.read(timeout=30) == payloads[i], f"payload {i} corrupted"
    t.join(10)
    assert not errs
    assert w.stats["writes"] == n and r.stats["reads"] == n
    assert w._get(0) > 4096  # really wrapped (wbytes past capacity)


def test_ring_value_wraparound_mixed_types(tmp_path):
    """write_value/read_value across wrap boundaries with every
    fast-path type mixed (encode-in-place must handle tail-bounded
    windows by wrapping, reader must skip markers)."""
    import numpy as np

    p = str(tmp_path / "wrapv")
    Channel.create_file(p, 2048)
    w, r = Channel(p), Channel(p)
    vals = []
    for i in range(300):
        vals.append(
            [i, float(i), f"s{i}" * (i % 20), {"k": i}, np.arange(i % 40)][i % 5]
        )
    import threading

    t = threading.Thread(
        target=lambda: [w.write_value(v, timeout=30) for v in vals], daemon=True
    )
    t.start()
    for i, expect in enumerate(vals):
        tag, got = r.read_value(timeout=30)
        assert tag == 0
        if isinstance(expect, np.ndarray):
            assert (got == expect).all()
        else:
            assert got == expect, i
    t.join(10)


def test_payload_larger_than_ring_is_typed_error_not_hang(tmp_path):
    from ray_tpu_torch.experimental.channel import ChannelCapacityError

    p = str(tmp_path / "cap")
    Channel.create_file(p, 1024)
    w, r = Channel(p), Channel(p)
    with pytest.raises(ChannelCapacityError):
        w.write(b"x" * 5000, timeout=5)
    with pytest.raises(ChannelCapacityError):
        w.write_value(b"x" * 5000, timeout=5)
    # the ring stays coherent after the refused writes
    w.write_value({"ok": 1})
    assert r.read_value() == (0, {"ok": 1})


def test_reader_timeout_vs_writer_death_detection(tmp_path):
    """Ring: a silent writer is indistinguishable from a dead one —
    reads raise ChannelTimeout.  Socket: writer death is detected
    immediately as ChannelClosed (EOF), no timeout burned."""
    import threading

    from ray_tpu_torch.experimental.channel import SocketListener, dial

    # ring: timeout (peer alive but silent)
    p = str(tmp_path / "silent")
    Channel.create_file(p, 1024)
    r = Channel(p)
    t0 = time.monotonic()
    with pytest.raises(ChannelTimeout):
        r.read(timeout=0.3)
    assert time.monotonic() - t0 >= 0.25

    # socket: death -> ChannelClosed well before any read timeout
    lst = SocketListener()
    out = {}

    def reader():
        ch = lst.accept("read", timeout=5)
        out["first"] = ch.read_value(timeout=5)
        t1 = time.monotonic()
        try:
            ch.read_value(timeout=30)
        except ChannelClosed:
            out["death_latency"] = time.monotonic() - t1

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    wch = dial(("127.0.0.1", lst.port), "write", timeout=5)
    wch.write_value("alive")
    time.sleep(0.2)
    wch._sock.close()  # simulate writer process death: RST/EOF, no poison
    t.join(10)
    assert out["first"] == (0, "alive")
    assert out["death_latency"] < 5.0  # detected, not timed out at 30s


def test_socket_rogue_dial_never_pairs(tmp_path):
    """The single-writer contract under the reattach-capable listener:
    a second (unauthenticated) dial during a healthy pairing is never
    paired — it gets no handshake reply, its frames never reach the
    consumer, and its writes fail typed (flow-control timeout) instead
    of corrupting the stream.  The legit edge is unaffected."""
    import threading

    from ray_tpu_torch.experimental.channel import SocketListener, dial

    lst = SocketListener()
    got = {}

    def reader():
        ch = lst.accept("read", timeout=5)
        got["v1"] = ch.read_value(timeout=5)
        got["v2"] = ch.read_value(timeout=10)
        got["chan"] = ch

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    w = dial(("127.0.0.1", lst.port), "write", timeout=5)
    w.write_value(123)
    # A rogue dial connects at the TCP level (backlog) but is never
    # handshaken: its first write times out waiting for a pairing reply
    # that will never come — no rogue frame ever reaches the consumer.
    rogue = dial(("127.0.0.1", lst.port), "write", timeout=5)
    with pytest.raises((ChannelTimeout, ChannelClosed)):
        rogue.write_value("evil", timeout=0.5)
    w.write_value(456)
    t.join(10)
    assert got["v1"] == (0, 123) and got["v2"] == (0, 456)
    rogue.close()
    w.close()
    got["chan"].close()


def test_socket_epoch_reattach_resumes_unacked(tmp_path):
    """Transient TCP drop: the writer re-dials with the pairing token
    at a bumped epoch and replays unacked frames; the reader re-accepts
    via the shared reattach() helper.  Every frame arrives exactly once
    in order — no loss, no duplicates."""
    import threading

    from ray_tpu_torch.experimental.channel import SocketListener, dial, reattach

    lst = SocketListener()
    out = {"vals": []}

    def reader():
        ch = lst.accept("read", timeout=5)
        out["chan"] = ch
        while len(out["vals"]) < 8:
            try:
                out["vals"].append(ch.read_value(timeout=10)[1])
            except ChannelClosed:
                assert reattach(ch, timeout=5)

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    w = dial(("127.0.0.1", lst.port), "write", timeout=5)
    for i in range(4):
        w.write_value(i)
    time.sleep(0.3)
    w._sock.close()  # transient connection loss, both peers alive
    for i in range(4, 8):
        w.write_value(i)  # transparent writer-side reattach
    t.join(10)
    assert out["vals"] == list(range(8)), out["vals"]
    assert w.epoch == 2 and out["chan"].epoch == 2
    w.close()
    out["chan"].close()


def test_socket_reattach_rejects_bad_token_and_stale_epoch(tmp_path):
    """Reconnects without the pairing token (or at a non-advancing
    epoch) are rejected at the handshake: the listener closes the
    connection and keeps waiting for the authentic peer."""
    import socket as pysocket
    import threading

    from ray_tpu_torch.experimental.channel import (
        _HELLO,
        _MAGIC,
        _REPLY,
        SocketListener,
        dial,
        reattach,
    )

    lst = SocketListener()
    out = {}

    def reader():
        ch = lst.accept("read", timeout=5)
        out["first"] = ch.read_value(timeout=5)
        try:
            ch.read_value(timeout=10)
        except ChannelClosed:
            out["reattached"] = reattach(ch, timeout=5)
            out["second"] = ch.read_value(timeout=5)

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    w = dial(("127.0.0.1", lst.port), "write", timeout=5)
    w.write_value("a")
    time.sleep(0.3)
    w._sock.close()
    time.sleep(0.1)
    # Forged reconnects: wrong token at a bumped epoch, then the right
    # token at a stale epoch.  Neither may pair.
    for hello in (
        _HELLO.pack(_MAGIC, 99, b"\x00" * 16, 0),
        _HELLO.pack(_MAGIC, 1, lst.token, 0),
    ):
        s = pysocket.create_connection(("127.0.0.1", lst.port), timeout=2)
        s.sendall(hello)
        s.settimeout(2)
        assert s.recv(_REPLY.size) == b""  # closed without a reply
        s.close()
    # The authentic writer still reattaches fine afterwards.
    w.write_value("b")
    t.join(10)
    assert out["first"] == (0, "a")
    assert out.get("reattached") is True
    assert out.get("second") == (0, "b")
    w.close()


def test_ring_crc_corruption_is_typed_and_skipped(tmp_path):
    """A bit flip in a published record raises ChannelCorruptionError
    (never a garbage value); the garbage record is consumed so later
    records still flow."""
    from ray_tpu_torch.experimental import channel as cm
    from ray_tpu_torch.experimental.channel import ChannelCorruptionError

    p = str(tmp_path / "crc")
    Channel.create_file(p, 2048)
    w, r = Channel(p), Channel(p)
    w.write(b"good-1")
    w.write_value({"k": "evil"})
    w.write(b"good-3")
    # flip one payload byte of the SECOND record (first record occupies
    # 8 + align8(6 + 4) = 24 bytes)
    w._mm[cm.HEADER + 24 + 8] ^= 0xFF
    assert r.read(timeout=2) == b"good-1"
    with pytest.raises(ChannelCorruptionError) as ei:
        r.read_value(timeout=2)
    assert ei.value.advanced  # garbage consumed: skip-and-continue is safe
    assert r.read(timeout=2) == b"good-3"
    assert r.stats["corruptions"] == 1


def test_ring_torn_record_length_is_typed_not_garbage(tmp_path):
    """A torn/garbage length header (SIGKILLed writer mid-publish, shm
    corruption) raises typed instead of hanging or mis-framing."""
    import struct as pystruct

    from ray_tpu_torch.experimental import channel as cm
    from ray_tpu_torch.experimental.channel import ChannelCorruptionError

    p = str(tmp_path / "torn")
    Channel.create_file(p, 1024)
    w, r = Channel(p), Channel(p)
    # Forge a published record whose length field is garbage.
    pystruct.Struct("<Q").pack_into(w._mm, cm.HEADER, 0x7878787878787878)
    pystruct.Struct("<Q").pack_into(w._mm, cm._WOFF, 64)  # "published"
    with pytest.raises(ChannelCorruptionError) as ei:
        r.read(timeout=2)
    # the framing itself is broken: the reader CANNOT advance past it,
    # and consumers must run heavy recovery instead of retrying
    assert ei.value.advanced is False


def test_channel_chaos_actions_inject_and_replay(tmp_path):
    """chan:<glob> chaos rules fire on channel writes: corrupt_frame is
    caught by CRC, torn_write by the trailer, drop_frame vanishes, and
    the seeded schedule replays deterministically."""
    import os

    from ray_tpu_torch._private.chaos import CHAOS, ChaosPlane
    from ray_tpu_torch.experimental.channel import ChannelCorruptionError

    saved = {
        k: os.environ.get(k)
        for k in ("RAY_TPU_TORCH_testing_chaos_spec", "RAY_TPU_TORCH_testing_chaos_seed")
    }
    try:
        os.environ["RAY_TPU_TORCH_testing_chaos_spec"] = (
            "chan:*chaosring*:corrupt_frame:at=2,"
            "chan:*chaosring*:torn_write:at=4,"
            "chan:*chaosring*:drop_frame:at=6"
        )
        os.environ["RAY_TPU_TORCH_testing_chaos_seed"] = "11"
        CHAOS.reset()
        p = str(tmp_path / "chaosring")
        Channel.create_file(p, 8192)
        w, r = Channel(p), Channel(p)
        for i in range(7):
            w.write_value(i)
        got, corrupt = [], 0
        while len(got) + corrupt < 6:  # frame 6 was dropped entirely
            try:
                got.append(r.read_value(timeout=2)[1])
            except ChannelCorruptionError:
                corrupt += 1
        assert got == [0, 2, 4, 6] and corrupt == 2  # frames 1,3 corrupted/torn
        with pytest.raises(ChannelTimeout):
            r.read_value(timeout=0.3)  # frame 5 (at=6) really dropped
        # seed replay: the same seed + spec produces the same schedule
        def run_schedule(seed):
            plane = ChaosPlane()
            os.environ["RAY_TPU_TORCH_testing_chaos_seed"] = str(seed)
            os.environ["RAY_TPU_TORCH_testing_chaos_spec"] = (
                "chan:*x*:corrupt_frame:p=0.5:n=-1"
            )
            plane.reset()
            verdicts = [plane.decide_channel("/x/ring").corrupt for _ in range(40)]
            return verdicts, plane.schedule_digest()

        v1, d1 = run_schedule(123)
        v2, d2 = run_schedule(123)
        v3, d3 = run_schedule(321)
        assert v1 == v2 and d1 == d2
        assert v3 != v1  # a different seed reshuffles the schedule
    finally:
        for k, old in saved.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old
        CHAOS.reset()


def test_channel_default_timeout_config_knob(tmp_path):
    """Channel read/write default timeouts route through ONE config
    knob (channel_default_timeout_s) instead of per-call-site 30.0s."""
    import os

    p = str(tmp_path / "deft")
    Channel.create_file(p, 1024)
    r = Channel(p)
    os.environ["RAY_TPU_TORCH_channel_default_timeout_s"] = "0.3"
    try:
        t0 = time.monotonic()
        with pytest.raises(ChannelTimeout):
            r.read()  # no per-call timeout: the knob governs
        assert time.monotonic() - t0 < 5.0
    finally:
        os.environ.pop("RAY_TPU_TORCH_channel_default_timeout_s", None)


def test_orphan_shm_sweeper(tmp_path):
    """Directories whose registered owner PIDs are ALL dead are
    reclaimed; live or unregistered dirs are never touched."""
    import os

    from ray_tpu_torch.experimental.channel import sweep_orphan_ring_dirs

    base = str(tmp_path)
    dead = os.path.join(base, "ray_tpu_torch_dag_dead")
    os.makedirs(dead)
    with open(os.path.join(dead, "c1"), "wb") as f:
        f.write(b"\x00" * 256)
    with open(os.path.join(dead, "c2"), "wb") as f:
        f.write(b"\x00" * 256)
    with open(os.path.join(dead, ".pids"), "w") as f:
        f.write("4194300\n4194301\n")  # near pid_max: dead
    live = os.path.join(base, "ray_tpu_torch_serve_live")
    os.makedirs(live)
    with open(os.path.join(live, "req"), "wb") as f:
        f.write(b"\x00" * 256)
    with open(os.path.join(live, ".pids"), "w") as f:
        f.write(f"{os.getpid()}\n")
    unregistered = os.path.join(base, "ray_tpu_torch_pp_new")
    os.makedirs(unregistered)
    assert sweep_orphan_ring_dirs(base=base, grace_s=0.0) == 2
    assert not os.path.exists(dead)
    assert os.path.exists(live) and os.path.exists(unregistered)
    # grace window: a fresh dir with dead pids is left alone
    fresh = os.path.join(base, "ray_tpu_torch_rllib_fresh")
    os.makedirs(fresh)
    with open(os.path.join(fresh, ".pids"), "w") as f:
        f.write("4194300\n")
    assert sweep_orphan_ring_dirs(base=base, grace_s=3600.0) == 0
    assert os.path.exists(fresh)


def test_fanout_dead_reader_evicted_unblocks_writer(tmp_path):
    """A SIGKILLed fan-out reader (dead registered PID, stale cursor)
    no longer wedges the writer: its cursor is evicted (metric-counted)
    and the broadcast proceeds for the survivors.  The evicted slot
    fails typed if it ever reads again."""
    import struct as pystruct

    from ray_tpu_torch.experimental.channel import (
        ChannelClosed as CC,
        FanoutChannel,
        FanoutReader,
    )

    p = str(tmp_path / "fev")
    ch = FanoutChannel(p, 2, max_size=1 << 13, create=True)
    r0, r1 = FanoutReader(p, 0), FanoutReader(p, 1)
    ch.write(b"seed")
    assert r0.read(timeout=5) == b"seed"
    assert r1.read(timeout=5) == b"seed"
    # model r1's death: its registered pid is replaced by a dead one
    pystruct.Struct("<Q").pack_into(ch._mm, ch._pid_off(1), 4194300)
    payload = b"x" * 3000
    for _ in range(10):  # would wedge forever bounded by r1's cursor
        ch.write(payload, timeout=5)
        assert r0.read(timeout=5) == payload
    assert ch.stats["evictions"] == 1
    with pytest.raises(CC, match="evicted"):
        r1.read(timeout=1)
    # all readers dead -> typed close, not a silent write into the void
    pystruct.Struct("<Q").pack_into(ch._mm, ch._pid_off(0), 4194301)
    with pytest.raises(CC):
        for _ in range(20):
            ch.write(payload, timeout=5)


def test_socket_poison_close_vs_flow_control(tmp_path):
    """Orderly close drains buffered frames first (like the ring), and
    the unacked window applies backpressure per CONSUMED message."""
    import threading

    from ray_tpu_torch.experimental.channel import SocketChannel, SocketListener, dial

    lst = SocketListener()
    res = {}

    def reader():
        ch = lst.accept("read", timeout=5)
        time.sleep(0.4)  # let the writer fill its window
        vals = []
        try:
            while True:
                vals.append(ch.read_value(timeout=5)[1])
        except ChannelClosed:
            res["vals"] = vals

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    w = dial(("127.0.0.1", lst.port), "write", timeout=5)
    for i in range(w._window):
        w.write_value(i, timeout=5)
    # window full + reader asleep: the next write must block
    with pytest.raises(ChannelTimeout):
        w.write_value(99, timeout=0.15)
    w.close()  # poison after the buffered frames
    t.join(10)
    assert res["vals"] == list(range(w._window))


def test_wire_roundtrip_property():
    """Property-style round-trip over the full fast-path type lattice +
    pickle fallback: decode(encode(v)) == v with types preserved."""
    import numpy as np

    from ray_tpu_torch._private import wire

    cases = [
        None, True, False, 0, 1, -1, 2**62, -(2**62), 2**100, -(2**100),
        0.0, -1.5, float("inf"), 3.141592653589793,
        b"", b"\x00\xff" * 100, "", "ascii", "unicodé ☃", "x" * 10_000,
        (), (1,), (1, "two", 3.0, None, True), ((1, 2), (3, (4, 5))),
        [], [1, 2, 3], [[1], [2.0], ["3"]],
        {}, {"a": 1}, {"nested": {"k": [1, 2, {"deep": "v"}]}},
        {1: "int-key", "mixed": (1, b"b")},
        # fallback territory
        set([1, 2, 3]), frozenset("ab"), complex(1, 2), range(5),
        {"deep": {"deep": {"deep": {"deep": {"deep": 1}}}}},  # depth > 4
        tuple(range(100)),  # > MAX_ELEMS
        Exception("boom"),
    ]
    for v in cases:
        tag, out = wire.decode(memoryview(wire.encode(v, tag=1)))
        assert tag == 1
        if isinstance(v, Exception):
            assert type(out) is type(v) and out.args == v.args
        elif isinstance(v, float) and v != v:
            assert out != out
        else:
            assert out == v and type(out) is type(v), v
    # numpy arrays: dtype/shape/content exact, zero-dim and F-order too
    arrs = [
        np.arange(12, dtype=np.float32).reshape(3, 4),
        np.array(7, dtype=np.int8),
        np.zeros((0, 3), dtype=np.float64),
        np.asfortranarray(np.arange(6).reshape(2, 3)),
        np.array([True, False]),
        np.arange(4, dtype=np.complex128),
    ]
    for a in arrs:
        tag, out = wire.decode(memoryview(wire.encode(a)))
        assert tag == 0 and out.dtype == a.dtype and out.shape == a.shape
        assert (out == a).all()
    # NaN array content
    tag, out = wire.decode(memoryview(wire.encode(np.array([float("nan")]))))
    assert np.isnan(out).all()


def test_wire_error_tag_roundtrip():
    """TAG_ERROR + RayTaskError (the loop's error envelope) survives the
    wire through the pickle fallback."""
    from ray_tpu_torch import exceptions
    from ray_tpu_torch._private import serialization, wire

    try:
        raise ValueError("original")
    except ValueError as e:
        err = exceptions.RayTaskError.from_exception(e, "compiled_dag.m")
    tag, out = wire.decode(memoryview(wire.encode(err, tag=serialization.TAG_ERROR)))
    assert tag == serialization.TAG_ERROR
    with pytest.raises(ValueError, match="original"):
        raise out.as_instanceof_cause()


# ---------------------------------------------------------------------------
# Shared-memory fan-out (one writer, N same-node readers)


def test_fanout_every_reader_sees_every_message_once(tmp_path):
    from ray_tpu_torch.experimental.channel import FanoutChannel, FanoutReader

    p = str(tmp_path / "f1")
    ch = FanoutChannel(p, 3, max_size=1 << 16, create=True)
    readers = [FanoutReader(p, i) for i in range(3)]
    import numpy as np

    for k in range(5):
        ch.write_value({"k": k, "arr": np.arange(4) + k})
    for r in readers:
        for k in range(5):
            _tag, v = r.read_value(timeout=5)
            assert v["k"] == k
            assert int(v["arr"][0]) == k
        assert not r.pending()
    assert ch.stats["writes"] == 5  # one write serves all three readers
    ch.close()
    for r in readers:
        r.close()


def test_fanout_flow_control_bounded_by_slowest_reader(tmp_path):
    """The writer's free space is min over reader cursors: two fast
    readers can't unblock a ring the slow third still holds."""
    from ray_tpu_torch.experimental.channel import (
        ChannelTimeout as CT,
        FanoutChannel,
        FanoutReader,
    )

    p = str(tmp_path / "f2")
    ch = FanoutChannel(p, 3, max_size=1 << 14, create=True)
    readers = [FanoutReader(p, i) for i in range(3)]
    payload = b"x" * 3000
    wrote = 0
    with pytest.raises(CT):
        for _ in range(50):
            ch.write(payload, timeout=0.2)
            wrote += 1
    assert 0 < wrote < 50
    for r in readers[:2]:
        for _ in range(wrote):
            r.read(timeout=5)
    with pytest.raises(CT):  # slowest reader still pins the ring
        ch.write(payload, timeout=0.2)
    for _ in range(wrote):
        readers[2].read(timeout=5)
    ch.write(payload, timeout=5)  # now it fits
    for r in readers:
        assert r.read(timeout=5) == payload
        r.close()
    ch.close()


def test_fanout_wraps_and_drains_before_close(tmp_path):
    from ray_tpu_torch.experimental.channel import (
        ChannelClosed as CC,
        FanoutChannel,
        FanoutReader,
    )

    p = str(tmp_path / "f3")
    ch = FanoutChannel(p, 2, max_size=1 << 12, create=True)
    readers = [FanoutReader(p, i) for i in range(2)]
    # force several wraps while readers keep pace
    for k in range(40):
        ch.write(bytes([k]) * 900, timeout=5)
        for r in readers:
            assert r.read(timeout=5) == bytes([k]) * 900
    ch.write(b"final")
    ch.close()
    for r in readers:
        assert r.read(timeout=5) == b"final"  # backlog drains first
        with pytest.raises(CC):
            r.read(timeout=1)
        r.close()


def test_fanout_capacity_and_index_validation(tmp_path):
    from ray_tpu_torch.experimental.channel import (
        ChannelCapacityError,
        FanoutChannel,
        FanoutReader,
    )

    p = str(tmp_path / "f4")
    ch = FanoutChannel(p, 2, max_size=1 << 12, create=True)
    with pytest.raises(ChannelCapacityError):
        ch.write(b"x" * (1 << 13))
    with pytest.raises(ValueError, match="out of range"):
        FanoutReader(p, 2)
    with pytest.raises(ValueError, match="created for"):
        FanoutChannel(p, 3)
    ch.close()


def test_wire_fuzz_malformed_input_is_typed_never_garbage():
    """Seeded fuzz over every wire type code: truncated and bit-flipped
    encodings fed to ``wire.decode`` either raise the ONE typed
    ``WireFormatError`` or decode cleanly — never a raw struct/index/
    unicode error, never a hang (every decode loop is bounded by a
    length field that is bounds-checked before use).  Value-level
    integrity of flipped payload bytes is the channel CRC trailer's
    contract, tested above; this pins the decoder itself."""
    import random
    import time as _time

    import numpy as np

    from ray_tpu_torch._private import wire

    exemplars = [  # at least one value per type code, PICKLE included
        None, True, False,                      # NONE / TRUE / FALSE
        5, -7, 2**100, -(2**90),                # I64 / BIGINT
        1.5,                                    # F64
        b"xyz-payload", "héllo wire",      # BYTES / STR
        (1, "a", 2.5, None), [1, b"b", (2, 3)], # TUPLE / LIST
        {"k": 1, 2: "v", "n": {"d": [1.0]}},    # DICT
        np.arange(6, dtype=np.float32).reshape(2, 3),   # NDARRAY
        np.array(7, dtype=np.int8),             # NDARRAY zero-dim
        set([1, 2, 3]),                         # PICKLE fallback
    ]
    rng = random.Random(0xC0FFEE)
    t0 = _time.monotonic()

    def check(buf):
        b = bytes(buf)
        try:
            _, out = wire.decode(memoryview(b))
            return "ok", out
        except wire.WireFormatError:
            return "typed", None
        except (ImportError, AttributeError, NameError):
            # PICKLE-path class resolution is app-level BY CONTRACT
            # (wire.decode lets it propagate so an unimportable class
            # can't masquerade as frame corruption) — permitted only
            # for pickle-framed buffers
            assert len(b) > 1 and b[1] == wire.PICKLE, b[:4]
            return "app", None
        # anything else propagates and fails the test

    for v in exemplars:
        enc = wire.encode(v, tag=1)
        # Every strict truncation of a fast-path encoding starves a
        # bounds-checked length field -> typed error.  The PICKLE
        # fallback may tolerate losing its unused trailing footer (past
        # the STOP opcode) — but then the value must be EXACTLY right.
        lengths = range(len(enc)) if len(enc) <= 64 else sorted(
            rng.sample(range(len(enc)), 64)
        )
        for n in lengths:
            verdict, out = check(enc[:n])
            if enc[1] == wire.PICKLE:
                if verdict == "ok":
                    assert out == v, (v, n, out)  # only the footer was cut
            else:
                assert verdict == "typed", (v, n, out)
        # seeded single-bit flips anywhere in the buffer
        for _ in range(150):
            b = bytearray(enc)
            b[rng.randrange(len(b))] ^= 1 << rng.randrange(8)
            check(b)
        # multi-bit shotgun: up to 8 flips per trial
        for _ in range(50):
            b = bytearray(enc)
            for _ in range(rng.randint(2, 8)):
                b[rng.randrange(len(b))] ^= 1 << rng.randrange(8)
            check(b)
    # pure-noise buffers (random type codes, random lengths)
    for _ in range(300):
        check(bytes(rng.randrange(256) for _ in range(rng.randint(0, 80))))
    assert _time.monotonic() - t0 < 60.0  # bounded: no decode may hang
