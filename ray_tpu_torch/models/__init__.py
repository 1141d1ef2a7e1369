"""ray_tpu_torch.models — PyTorch ports of the reference's model families.

Ported so far: GPT-2 (``gpt2``: the model, its training step and the
inference plane), the shared training scaffolding (``common``) and the
weight converter from the reference's parameter tree (``convert``)."""

__all__ = ["gpt2", "common", "convert"]


def __getattr__(name):
    if name in __all__:
        import importlib

        return importlib.import_module(f"ray_tpu_torch.models.{name}")
    raise AttributeError(name)
