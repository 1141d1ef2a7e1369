"""Accelerator managers (reference: python/ray/_private/accelerators/).

The port's accelerator is the NVIDIA GPU; ``gpu.py`` is the counterpart
of the JAX package's ``accelerators/tpu.py``.
"""

from ray_tpu_torch._private.accelerators.gpu import GPUAcceleratorManager

__all__ = ["GPUAcceleratorManager"]
