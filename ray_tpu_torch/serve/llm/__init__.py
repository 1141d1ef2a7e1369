"""LLM inference serving (port of ``ray_tpu.serve.llm``): a token-granular
engine with prefill/decode split over ``models/gpt2.py``, a preallocated
paged KV cache on the device, and continuous in-flight batching, served
through the normal ``serve.run()`` stack with streaming, queue-depth
autoscaling, and load shedding.

Public surface::

    from ray_tpu_torch import serve
    from ray_tpu_torch.serve import llm

    app = llm.build_app(llm.LLMConfig(model="tiny", max_batch_size=8))
    handle = serve.run(app, name="llm")
    for ev in handle.options(stream=True).generate.remote(
        {"prompt": "hello", "max_tokens": 16}
    ):
        print(ev["token"])

The names load lazily (module ``__getattr__``): the serve controller and
HTTP proxy import ``serve.llm.overload`` through this package, and must
not import torch, which the engine and the deployments need.
"""

import importlib

_EXPORTS = {
    "LLMConfig": "ray_tpu_torch.serve.llm.config",
    "LLMServer": "ray_tpu_torch.serve.llm.deployment",
    "StaticBatchLLMServer": "ray_tpu_torch.serve.llm.deployment",
    "build_app": "ray_tpu_torch.serve.llm.deployment",
    "LLMEngine": "ray_tpu_torch.serve.llm.engine",
    "BlockManager": "ray_tpu_torch.serve.llm.kv_cache",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(list(globals()) + __all__)
