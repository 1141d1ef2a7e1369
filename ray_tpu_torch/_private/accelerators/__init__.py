"""Pluggable accelerator managers (reference:
python/ray/_private/accelerators/accelerator.py:5).

The port's accelerator is the NVIDIA GPU; ``gpu.py`` is the counterpart
of the JAX package's ``accelerators/tpu.py``.
"""

from ray_tpu_torch._private.accelerators.gpu import GPUAcceleratorManager

__all__ = ["GPUAcceleratorManager", "get_accelerator_manager"]


def get_accelerator_manager(resource_name: str):
    if resource_name == "GPU":
        return GPUAcceleratorManager
    return None
