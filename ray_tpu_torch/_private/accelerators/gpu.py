"""NVIDIA GPU detection for the node's ``GPU`` resource (reference:
python/ray/_private/accelerators/nvidia_gpu.py; the counterpart of the JAX
package's ``accelerators/tpu.py``).

A node counts its cards from the device files the NVIDIA driver makes,
``/dev/nvidia0``, ``/dev/nvidia1``, ..., that this process may open,
restricted by ``CUDA_VISIBLE_DEVICES`` when that is set, as ``tpu.py``
counts ``/dev/accel*``.  Detection runs in the raylet, so it must not make a CUDA
context there (that would hold memory on every card for the life of the
node): it reads the file system and the environment, and never imports
torch.  Every worker sees all of the node's visible cards; no device ids
are assigned per worker (the reference assigns none per TPU worker
either).
"""

from __future__ import annotations

import os
import re
from typing import List

CUDA_VISIBLE_DEVICES_ENV = "CUDA_VISIBLE_DEVICES"
_DEVICE_FILE = re.compile(r"nvidia(\d+)$")


def _openable(path: str) -> bool:
    """Whether this process may open a card's device file: a container can
    show the device files of cards its cgroup does not let it use.
    Opening the file makes no CUDA context."""
    try:
        fd = os.open(path, os.O_RDWR)
    except OSError:
        return False
    os.close(fd)
    return True


def _device_files(dev_dir: str) -> List[int]:
    try:
        names = os.listdir(dev_dir)
    except OSError:
        return []
    return sorted(int(m.group(1)) for m in map(_DEVICE_FILE.match, names)
                  if m and _openable(os.path.join(dev_dir, m.group(0))))


class GPUAcceleratorManager:
    @staticmethod
    def get_current_node_num_accelerators(dev_dir: str = "/dev") -> int:
        n = len(_device_files(dev_dir))
        visible = os.environ.get(CUDA_VISIBLE_DEVICES_ENV)
        if visible is None:
            return n
        # one card per comma-separated entry, at most the cards there are
        return min(len([e for e in visible.split(",") if e.strip()]), n)
