"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

A package of its own beside ``ray_tpu/``: it imports torch and numpy and
nothing of JAX or of ``ray_tpu``, keeping its own copy of what it needs.
Paths mirror ``ray_tpu/`` (``ray_tpu/models/gpt2.py`` is ported at
``ray_tpu_torch/models/gpt2.py``).  Every Pallas kernel of the reference
on a ported path becomes a hand-written Hopper kernel under
``ops/csrc/``, built with nvcc at first use.

Ported so far: the serving path — ``serve.llm.LLMEngine`` over GPT-2
(``models/gpt2.py``) with a paged KV cache, its prefill attention on the
flash-attention forward kernel — and the training path — GPT-2's
``make_train_step`` with AdamW (``models/common.py``), differentiable
through the flash-attention forward and backward kernels
(``ops/flash_attention.py``).  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""

__all__ = ["ops", "models", "serve"]
