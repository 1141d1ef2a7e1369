"""joblib backend over the cluster (reference:
python/ray/util/joblib/__init__.py register_ray +
ray_backend.py RayBackend).

    from ray_tpu_torch.util.joblib import register_ray
    register_ray()
    with joblib.parallel_backend("ray"):
        GridSearchCV(...).fit(X, y)   # sklearn fans out as remote tasks

The backend subclasses joblib's MultiprocessingBackend surface at the
``apply_async`` seam: each joblib batch becomes one remote task, so
nested numpy/BLAS work runs in cluster workers instead of local forks.
"""

from __future__ import annotations

import logging

logger = logging.getLogger(__name__)


def register_ray() -> None:
    """Register the 'ray' parallel backend with joblib."""
    from joblib.parallel import register_parallel_backend

    from ray_tpu_torch.util.joblib.ray_backend import RayBackend

    register_parallel_backend("ray", RayBackend)


__all__ = ["register_ray"]
