"""util compat shims of the port: multiprocessing.Pool, joblib backend,
dask scheduler (copies of tests/test_util_shims.py over the port's
cluster; no JAX.  Reference: python/ray/util/{multiprocessing,joblib,dask}/
and their tests, shrunk to CI size)."""

import numpy as np
import pytest

import ray_tpu_torch


@pytest.fixture(scope="module")
def ray_cluster():
    """Module-scoped local cluster of the port (the conftest's fixture of
    this name starts the JAX package's)."""
    with pytest.MonkeyPatch.context() as mp:
        # The suite runs many clusters at once: no shm arena prefault per
        # raylet, and no memory monitor (it watches the whole machine).
        mp.setenv("RAY_TPU_TORCH_arena_prefault_bytes", "0")
        mp.setenv("RAY_TPU_TORCH_memory_monitor_enabled", "0")
        ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
        yield ray_tpu_torch
        ray_tpu_torch.shutdown()


def _sq(x):
    return x * x


def _add(a, b):
    return a + b


def _boom(x):
    raise RuntimeError(f"boom-{x}")


_INIT_FLAG = {"v": 0}


def _init(v):
    _INIT_FLAG["v"] = v


def _read_init(_):
    return _INIT_FLAG["v"]


def test_pool_map_apply_starmap(ray_cluster):
    from ray_tpu_torch.util.multiprocessing import Pool

    with Pool(processes=2) as pool:
        assert pool.map(_sq, range(10)) == [i * i for i in range(10)]
        assert pool.apply(_add, (3, 4)) == 7
        assert pool.starmap(_add, [(1, 2), (3, 4)]) == [3, 7]
        r = pool.apply_async(_sq, (9,))
        assert r.get(timeout=30) == 81
        assert r.successful()
        # ordered and unordered lazy iterators
        assert list(pool.imap(_sq, range(6), chunksize=2)) == [i * i for i in range(6)]
        assert sorted(pool.imap_unordered(_sq, range(6), chunksize=2)) == [
            i * i for i in range(6)
        ]


def test_pool_initializer_and_errors(ray_cluster):
    from ray_tpu_torch.util.multiprocessing import Pool

    with Pool(processes=2, initializer=_init, initargs=(42,)) as pool:
        # initializer ran in whichever worker served the task
        assert set(pool.map(_read_init, range(4))) == {42}
        with pytest.raises(RuntimeError, match="boom-3"):
            pool.map(_boom, [3])
        r = pool.apply_async(_boom, (7,))
        with pytest.raises(RuntimeError, match="boom-7"):
            r.get(timeout=30)
        assert not r.successful()
    with pytest.raises(ValueError):
        pool.map(_sq, [1])  # closed


def test_joblib_ray_backend(ray_cluster):
    import joblib

    from ray_tpu_torch.util.joblib import register_ray

    register_ray()
    with joblib.parallel_backend("ray", n_jobs=2):
        out = joblib.Parallel()(joblib.delayed(_sq)(i) for i in range(12))
    assert out == [i * i for i in range(12)]


def test_joblib_sklearn_grid_search(ray_cluster):
    """The reference's headline joblib use case: sklearn fans its CV
    fits out through the backend."""
    import joblib
    from sklearn.linear_model import LogisticRegression
    from sklearn.model_selection import GridSearchCV

    from ray_tpu_torch.util.joblib import register_ray

    register_ray()
    rng = np.random.default_rng(0)
    X = rng.normal(size=(60, 4))
    y = (X[:, 0] + X[:, 1] > 0).astype(int)
    with joblib.parallel_backend("ray", n_jobs=2):
        gs = GridSearchCV(LogisticRegression(), {"C": [0.1, 1.0]}, cv=2)
        gs.fit(X, y)
    assert gs.best_score_ > 0.7


def test_dask_scheduler_graph(ray_cluster):
    from ray_tpu_torch.util.dask import ray_dask_get

    def inc(x):
        return x + 1

    dsk = {
        "a": 1,
        "b": (inc, "a"),                # depends on a
        "c": (inc, "b"),
        "d": (_add, "b", "c"),          # join
        "e": (_add, (inc, "a"), 10),    # nested inline task
        "alias": "d",
        "lst": ["b", "c", (inc, 100)],  # list computation
    }
    assert ray_dask_get(dsk, "d") == 5   # b=2, c=3
    assert ray_dask_get(dsk, ["b", "e", "alias"]) == [2, 12, 5]
    assert ray_dask_get(dsk, "lst") == [2, 3, 101]


def test_dask_scheduler_detects_cycles(ray_cluster):
    from ray_tpu_torch.util.dask import ray_dask_get

    def f(x):
        return x

    with pytest.raises(ValueError, match="cycle"):
        ray_dask_get({"a": (f, "b"), "b": (f, "a")}, "a")
