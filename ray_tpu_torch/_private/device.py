"""Device resolution for the port's entry points: they run on the card
unless the caller asks for the CPU, and never fall back from one to the
other."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    this machine has none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (expected cuda or cpu)")
    return dev
