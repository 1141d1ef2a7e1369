"""@ray_tpu_torch.remote on functions (reference: python/ray/remote_function.py:41
RemoteFunction; _remote() :303 pickles to the GCS function table and builds
a TaskSpec)."""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.worker import get_global_worker

_DEFAULT_OPTIONS = dict(
    num_cpus=None,
    num_gpus=None,
    memory=None,
    resources=None,
    num_returns=1,
    max_retries=None,
    retry_exceptions=False,
    scheduling_strategy=None,
    placement_group=None,
    placement_group_bundle_index=-1,
    runtime_env=None,
    name=None,
)


class RemoteFunction:
    def __init__(self, function, options: Optional[Dict[str, Any]] = None):
        self._function = function
        self._options = dict(_DEFAULT_OPTIONS)
        if options:
            self._options.update(options)
        self._function_blob: Optional[bytes] = None
        self._name = f"{function.__module__}.{function.__qualname__}"
        functools.update_wrapper(self, function)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function '{self._name}' cannot be called directly. "
            f"Use '{self._function.__name__}.remote()' instead."
        )

    def options(self, **options) -> "RemoteFunction":
        new = dict(self._options)
        new.update(options)
        rf = RemoteFunction(self._function, new)
        rf._function_blob = self._function_blob
        return rf

    def _blob(self) -> bytes:
        if self._function_blob is None:
            self._function_blob = serialization.dumps_function(self._function)
        return self._function_blob

    def remote(self, *args, **kwargs):
        worker = get_global_worker()
        opts = dict(self._options)
        if opts.get("max_retries") is None:
            opts.pop("max_retries")
        refs = worker.submit_task(
            self._blob(), opts.get("name") or self._name, args, kwargs, opts
        )
        if self._options["num_returns"] == "streaming":
            return refs  # an ObjectRefGenerator
        if self._options["num_returns"] == 1:
            return refs[0]
        return refs

    @property
    def bind(self):
        from ray_tpu_torch.dag import bind_function

        return bind_function(self)
