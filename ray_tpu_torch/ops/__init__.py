"""ray_tpu_torch.ops — attention and the port's hand-written CUDA kernels
(sources in ``csrc/``, built by ``_build.py``): the flash-attention
forward and backward kernels (``flash_attention``) behind the
``attention`` dispatch."""

__all__ = ["attention", "flash_attention"]


def __getattr__(name):
    if name in __all__:
        import importlib

        return importlib.import_module(f"ray_tpu_torch.ops.{name}")
    raise AttributeError(name)
