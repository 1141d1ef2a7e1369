"""ray_tpu_torch.models — PyTorch ports of the reference's model families.

Ported so far: GPT-2 (``gpt2``, forward and the inference plane) and the
weight converter from the reference's parameter tree (``convert``)."""

__all__ = ["gpt2", "convert"]


def __getattr__(name):
    if name in __all__:
        import importlib

        return importlib.import_module(f"ray_tpu_torch.models.{name}")
    raise AttributeError(name)
