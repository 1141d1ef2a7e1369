"""The torch trainer (counterpart of the JAX package's ``train/jax/``)."""

from ray_tpu_torch.train.torch.config import TorchConfig, _TorchBackend
from ray_tpu_torch.train.torch.torch_trainer import TorchTrainer

__all__ = ["TorchConfig", "TorchTrainer", "_TorchBackend"]
