"""LLM inference serving (port of ``ray_tpu.serve.llm``): a token-granular
engine with prefill/decode split over ``models/gpt2.py``, a preallocated
paged KV cache on the device, and continuous in-flight batching.

Public surface::

    from ray_tpu_torch.serve.llm import LLMConfig, LLMEngine

    eng = LLMEngine(LLMConfig(model="small", dtype="bfloat16"))
    req = await eng.add_request("hello", max_tokens=16)
    # token events on req.out, ending with engine.FINISHED

The deployment wrappers (``LLMServer``, ``build_app``) sit on the serve
control plane and are not ported yet.
"""

from ray_tpu_torch.serve.llm.config import LLMConfig
from ray_tpu_torch.serve.llm.engine import LLMEngine
from ray_tpu_torch.serve.llm.kv_cache import BlockManager

__all__ = ["LLMConfig", "LLMEngine", "BlockManager"]
