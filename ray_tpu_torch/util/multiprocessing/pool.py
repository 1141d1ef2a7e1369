"""multiprocessing.Pool API over ray_tpu_torch tasks (reference:
python/ray/util/multiprocessing/pool.py:1 — Pool/apply/map/imap/starmap
with AsyncResult semantics).

Design: stateless calls run as plain remote tasks (not actor-bound like
the reference's actor pool) — the scheduler spreads them across the
cluster, `processes` caps in-flight submissions, and an `initializer`
runs lazily once per worker process via a module-level guard (matching
multiprocessing's per-process initializer contract)."""

from __future__ import annotations

from multiprocessing import TimeoutError  # re-export the stdlib type
from typing import Any, Callable, Iterable, List, Optional, Tuple

import ray_tpu_torch

# per-worker-process initializer guard: (id of pool instance) -> done
_initialized_pools = set()


def _run_call(pool_id: str, initializer, initargs, fn, args, kwargs):
    if initializer is not None and pool_id not in _initialized_pools:
        initializer(*initargs)
        _initialized_pools.add(pool_id)
    return fn(*args, **(kwargs or {}))


def _run_chunk(pool_id: str, initializer, initargs, fn, chunk: List, star: bool):
    if initializer is not None and pool_id not in _initialized_pools:
        initializer(*initargs)
        _initialized_pools.add(pool_id)
    return [fn(*item) if star else fn(item) for item in chunk]


class AsyncResult:
    """multiprocessing.pool.AsyncResult over object refs.

    Callbacks fire ASYNCHRONOUSLY from a waiter thread when the result
    lands (multiprocessing semantics) — joblib's dispatch loop depends
    on completion callbacks arriving without anyone calling get()."""

    def __init__(self, refs: List, *, flatten: bool = False, callback=None,
                 error_callback=None, single: bool = False):
        import threading

        self._refs = refs
        self._flatten = flatten
        self._single = single
        self._callback = callback
        self._error_callback = error_callback
        self._done = False
        self._value: Any = None
        self._error: Optional[BaseException] = None
        self._lock = threading.RLock()  # callbacks may re-enter get()
        if callback is not None or error_callback is not None:
            threading.Thread(
                target=self._resolve_quiet, daemon=True, name="pool-async-result"
            ).start()

    def _resolve_quiet(self):
        try:
            self._resolve(None)
        except Exception:
            pass

    def _resolve(self, timeout: Optional[float]):
        # Wait OUTSIDE the lock: the background callback waiter holds an
        # untimed wait, and get(timeout=...) must still be able to raise
        # TimeoutError while it blocks (joblib's timeout retrieval
        # depends on this).
        if not self._done and timeout is not None:
            done, _ = ray_tpu_torch.wait(
                list(self._refs), num_returns=len(self._refs), timeout=timeout
            )
            if len(done) < len(self._refs):
                raise TimeoutError()
        with self._lock:
            if self._done:
                return
            try:
                out = ray_tpu_torch.get(self._refs)
                if self._flatten:
                    out = [x for chunk in out for x in chunk]
                self._value = out[0] if self._single else out
                # _done BEFORE the callback: a callback that re-enters
                # get() must see the settled state, not recurse
                self._done = True
                if self._callback is not None:
                    self._callback(self._value)
            except BaseException as e:  # noqa: BLE001 — stored, re-raised on get
                if not self._done:
                    self._error = e
                    self._done = True
                    if self._error_callback is not None:
                        self._error_callback(e)
                else:
                    raise  # callback itself raised: propagate

    def get(self, timeout: Optional[float] = None):
        self._resolve(timeout)
        with self._lock:
            if self._error is not None:
                raise self._error
            return self._value

    def wait(self, timeout: Optional[float] = None):
        try:
            ray_tpu_torch.wait(list(self._refs), num_returns=len(self._refs), timeout=timeout)
        except Exception:
            pass

    def ready(self) -> bool:
        if self._done:
            return True
        done, _ = ray_tpu_torch.wait(list(self._refs), num_returns=len(self._refs), timeout=0)
        return len(done) == len(self._refs)

    def successful(self) -> bool:
        if not self.ready():
            raise ValueError("not ready")
        self._resolve(None)
        with self._lock:
            return self._error is None


class Pool:
    """reference: util/multiprocessing/pool.py Pool."""

    def __init__(self, processes: Optional[int] = None, initializer: Optional[Callable] = None,
                 initargs: Tuple = (), ray_remote_args: Optional[dict] = None):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        if processes is None:
            processes = max(1, int(ray_tpu_torch.cluster_resources().get("CPU", 1)))
        if processes < 1:
            raise ValueError("processes must be >= 1")
        self._processes = processes
        self._initializer = initializer
        self._initargs = initargs
        self._id = f"pool-{id(self)}-{ray_tpu_torch.runtime_context.get_runtime_context().get_job_id()}"
        opts = dict(ray_remote_args or {})
        opts.setdefault("num_cpus", 1)
        self._call = ray_tpu_torch.remote(**opts)(_run_call)
        self._chunk_task = ray_tpu_torch.remote(**opts)(_run_chunk)
        self._closed = False

    # -- helpers ---------------------------------------------------------
    def _check_running(self):
        if self._closed:
            raise ValueError("Pool not running")

    def _chunks(self, iterable: Iterable, chunksize: Optional[int]) -> List[List]:
        items = list(iterable)
        if chunksize is None:
            chunksize = max(1, len(items) // (self._processes * 4) or 1)
        return [items[i : i + chunksize] for i in range(0, len(items), chunksize)]

    def _submit_chunks(self, fn, chunks: List[List], star: bool) -> List:
        """Submit with at most processes*2 chunks in flight (the
        reference bounds in-flight work the same way so huge maps don't
        flood the scheduler)."""
        refs, pending = [], []
        for chunk in chunks:
            if len(pending) >= self._processes * 2:
                _, pending = ray_tpu_torch.wait(pending, num_returns=1)
            ref = self._chunk_task.remote(
                self._id, self._initializer, self._initargs, fn, chunk, star
            )
            refs.append(ref)
            pending.append(ref)
        return refs

    # -- API -------------------------------------------------------------
    def apply(self, fn, args: Tuple = (), kwargs: Optional[dict] = None):
        return self.apply_async(fn, args, kwargs).get()

    def apply_async(self, fn, args: Tuple = (), kwargs: Optional[dict] = None,
                    callback=None, error_callback=None) -> AsyncResult:
        self._check_running()
        ref = self._call.remote(
            self._id, self._initializer, self._initargs, fn, args, kwargs
        )
        return AsyncResult([ref], single=True, callback=callback,
                           error_callback=error_callback)

    def map(self, fn, iterable: Iterable, chunksize: Optional[int] = None) -> List:
        return self.map_async(fn, iterable, chunksize).get()

    def map_async(self, fn, iterable: Iterable, chunksize: Optional[int] = None,
                  callback=None, error_callback=None) -> AsyncResult:
        self._check_running()
        refs = self._submit_chunks(fn, self._chunks(iterable, chunksize), star=False)
        return AsyncResult(refs, flatten=True, callback=callback,
                           error_callback=error_callback)

    def starmap(self, fn, iterable: Iterable, chunksize: Optional[int] = None) -> List:
        return self.starmap_async(fn, iterable, chunksize).get()

    def starmap_async(self, fn, iterable: Iterable, chunksize: Optional[int] = None,
                      callback=None, error_callback=None) -> AsyncResult:
        self._check_running()
        refs = self._submit_chunks(fn, self._chunks(iterable, chunksize), star=True)
        return AsyncResult(refs, flatten=True, callback=callback,
                           error_callback=error_callback)

    def imap(self, fn, iterable: Iterable, chunksize: int = 1):
        """Ordered results iterator.  Submission happens EAGERLY at the
        call (multiprocessing semantics: imap kicks off the work even if
        the iterator is never consumed; only retrieval is lazy)."""
        self._check_running()
        refs = self._submit_chunks(fn, self._chunks(iterable, chunksize), star=False)

        def results():
            for ref in refs:
                yield from ray_tpu_torch.get(ref)

        return results()

    def imap_unordered(self, fn, iterable: Iterable, chunksize: int = 1):
        """Completion-ordered results iterator (eager submission, as
        above)."""
        self._check_running()
        refs = self._submit_chunks(fn, self._chunks(iterable, chunksize), star=False)

        def results():
            pending = list(refs)
            while pending:
                done, pending = ray_tpu_torch.wait(pending, num_returns=1)
                yield from ray_tpu_torch.get(done[0])

        return results()

    def close(self):
        self._closed = True

    def terminate(self):
        self._closed = True

    def join(self):
        if not self._closed:
            raise ValueError("Pool is still running")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.terminate()
