"""ray_tpu_torch.models — PyTorch ports of the reference's model families.

Ported so far: GPT-2 (``gpt2``: the model, its training step and the
inference plane), Llama (``llama``: RoPE, GQA, SwiGLU; trains through the
flash kernels), ResNet (``resnet``), the Vision Transformer (``vit``),
the MNIST MLP (``mlp``), the MoE MLP (``moe``), GPT-2 over the SPMD
pipeline (``gpt2_pp``), the shared layers and training scaffolding
(``common``) and the weight converters from the reference's parameter
trees (``convert``)."""

__all__ = ["gpt2", "gpt2_pp", "llama", "resnet", "vit", "mlp", "moe", "common", "convert"]


def __getattr__(name):
    if name in __all__:
        import importlib

        return importlib.import_module(f"ray_tpu_torch.models.{name}")
    raise AttributeError(name)
