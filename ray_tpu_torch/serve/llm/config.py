"""LLM serving configuration (port of ``ray_tpu/serve/llm/config.py``):
the same fields, plus the ``device`` the engine serves on."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch


def tokenize_prompt(prompt: Any, vocab_size: int) -> list:
    """Token ids from a prompt: pass-through for int lists, byte-level
    (mod vocab) for strings.  The reference's placeholder tokenizer."""
    if isinstance(prompt, str):
        return [b % vocab_size for b in prompt.encode("utf-8")] or [0]
    if isinstance(prompt, (list, tuple)):
        return [int(t) for t in prompt] or [0]
    raise TypeError(f"prompt must be str or list[int], got {type(prompt)}")


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_PRESETS = ("tiny", "small", "medium", "large")


@dataclass
class LLMConfig:
    """Engine + cache sizing for one LLM deployment.

    KV sizing: the block pool holds ``num_blocks * block_size`` token
    slots (block 0 is a reserved scratch block, never allocated).  A
    request reserves ``ceil((len(prompt) + max_tokens) / block_size)``
    blocks at admission, so a request admitted once can never die of cache
    exhaustion mid-decode.  ``max_batch_size`` is the number of decode
    lanes: the continuous batcher keeps them full by joining waiting
    requests at step boundaries.
    """

    # model
    model: str = "tiny"  # GPT2Config preset: tiny | small | medium | large
    seed: int = 0  # synthetic-weights init seed (no checkpoint loading yet)
    dtype: str = "float32"  # serving compute dtype: float32 | bfloat16
    device: str = "cuda"  # "cpu" runs the plain PyTorch path (tests)

    # batching / cache
    max_batch_size: int = 8  # concurrent decode lanes
    block_size: int = 16  # tokens per KV block
    num_blocks: int = 256  # pool size incl. the reserved scratch block 0
    max_model_len: int = 0  # 0 = the model's max_seq_len

    # admission / generation defaults
    max_queue: int = 256  # waiting requests beyond this are shed
    default_max_tokens: int = 32
    temperature: float = 0.0  # <= 0 means greedy
    top_k: int = 0  # 0 = off (static engine-wide truncation)
    eos_token: int = -1  # -1 = generate to max_tokens

    # multi-tenant overload armor: tenant_weights are DRF weights for the
    # engine's fair waiting queue (absent tenant -> 1.0); the tenant_quotas
    # key set bounds the tenant metric-label domain (the quotas themselves
    # are enforced by the serve proxy); preempt_wait_s is how long a
    # higher-priority request may starve before a lower-priority decode
    # lane is preempted by recompute; slo_ttft_s is the TTFT p95 bound that
    # drives the brownout ladder (0 disables it).
    tenant_weights: Dict[str, float] = field(default_factory=dict)
    tenant_quotas: Dict[str, dict] = field(default_factory=dict)
    preempt_wait_s: float = 0.25
    slo_ttft_s: float = 0.0
    brownout_queue_high: int = 0  # 0 -> 4 * max_batch_size
    brownout_down_ticks: int = 3
    brownout_up_ticks: int = 5
    brownout_batch_max_tokens: int = 8

    # observability
    name: str = "llm"  # the deployment name

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def coerce(cls, value: Optional[Any]) -> "LLMConfig":
        if value is None:
            return cls()
        if isinstance(value, cls):
            return value
        if isinstance(value, dict):
            return cls(**value)
        raise TypeError(f"llm_config must be LLMConfig or dict, got {type(value)}")

    def model_config(self):
        """Resolve the port's GPT2Config preset with the serving dtype."""
        from ray_tpu_torch.models.gpt2 import GPT2Config

        if self.model not in _PRESETS:
            raise ValueError(
                f"unknown model preset {self.model!r} "
                "(expected tiny | small | medium | large)"
            )
        dtype = _DTYPES.get(self.dtype)
        if dtype is None:
            raise ValueError(f"unsupported serving dtype {self.dtype!r}")
        return getattr(GPT2Config, self.model)(dtype=dtype)

    @property
    def max_context(self) -> int:
        cfg = self.model_config()
        return min(self.max_model_len or cfg.max_seq_len, cfg.max_seq_len)
