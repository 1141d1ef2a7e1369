"""RayBackend for joblib (reference: python/ray/util/joblib/ray_backend.py
— the reference plugs its multiprocessing Pool into joblib's
MultiprocessingBackend; here the seam is the same: a Pool-shaped object
whose apply_async ships each joblib BatchedCalls to a remote task)."""

from __future__ import annotations

from joblib._parallel_backends import MultiprocessingBackend

from ray_tpu_torch.util.multiprocessing import Pool


class _PicklingPool(Pool):
    """joblib expects pool.apply_async(batch, callback=...) where batch
    is a zero-arg BatchedCalls; adapt to Pool's (fn, args) signature."""

    def apply_async(self, func, args=(), kwds=None, callback=None,
                    error_callback=None):
        # joblib passes the batch as `func` (zero-arg callable)
        return super().apply_async(
            _call_zero_arg, (func,), None, callback=callback,
            error_callback=error_callback,
        )


def _call_zero_arg(batch):
    return batch()


class RayBackend(MultiprocessingBackend):
    """parallel_backend("ray") — joblib batches run as cluster tasks."""

    supports_timeout = True

    def configure(self, n_jobs=1, parallel=None, prefer=None, require=None,
                  **memmapping_args):
        n_jobs = self.effective_n_jobs(n_jobs)
        # joblib's nesting guard: inner parallel regions run sequentially
        if n_jobs == 1:
            return 1
        self.parallel = parallel
        self._pool = _PicklingPool(processes=n_jobs)
        return n_jobs

    def effective_n_jobs(self, n_jobs):
        import ray_tpu_torch

        if n_jobs == 0:
            raise ValueError("n_jobs == 0 has no meaning")
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        cpus = max(1, int(ray_tpu_torch.cluster_resources().get("CPU", 1)))
        if n_jobs is None or n_jobs < 0:
            return cpus
        return n_jobs

    def apply_async(self, func, callback=None):
        return self._pool.apply_async(func, callback=callback)

    def terminate(self):
        if getattr(self, "_pool", None) is not None:
            self._pool.terminate()
            self._pool = None

    def abort_everything(self, ensure_ready=True):
        self.terminate()
        if ensure_ready:
            self.configure(n_jobs=self.parallel.n_jobs, parallel=self.parallel)
