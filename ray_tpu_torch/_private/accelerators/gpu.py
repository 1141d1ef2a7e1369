"""GPU accelerator manager — first-class card resources in the scheduler
(reference: python/ray/_private/accelerators/nvidia_gpu.py; the
counterpart of the JAX package's ``accelerators/tpu.py``).

A node counts its cards from the device files the NVIDIA driver makes,
``/dev/nvidia0``, ``/dev/nvidia1``, ..., that this process may open,
restricted by ``CUDA_VISIBLE_DEVICES`` when that is set, as ``tpu.py``
counts ``/dev/accel*``.  A node with cards advertises

    GPU                      — cards on this host
    GPU-<type>               — accelerator type (e.g. GPU-h100-16)
    GPU-<type>-head          — 1.0 only on worker 0 of the slice, so a
                               placement group can pin the coordinator
    gpu-slice:<name>         — slice-affinity label resource

where a type is ``<family>-<cards in the slice>``: the family is the
lower-cased model word of the card's name ("NVIDIA H100 80GB HBM3" gives
``h100``), so one card machine is ``h100-1`` and two 8-card hosts of one
slice are ``h100-16``.

Detection order, as ``tpu.py``'s: the slice identity the node provider's
bootstrap exports (``RAY_TPU_TORCH_ACCELERATOR_TYPE``, ``_SLICE_NAME``,
``_SLICE_WORKER_INDEX``), then the instance's custom metadata attributes
that ``GceGpuClient`` sets (queried only on a GCE VM, and never when
``RAY_TPU_TORCH_SKIP_METADATA`` is set), then the device files and the
card's model name (``/proc/driver/nvidia/gpus/*/information``, or
``nvidia-smi`` where that is absent).  Detection runs in the raylet, so
it must not make a CUDA context there (that would hold memory on every
card for the life of the node): it reads the file system, the
environment and NVML's view through ``nvidia-smi``, and never imports
torch.  ``tpu.py``'s opt-in JAX-backend probe has no counterpart for
that reason.  Every worker sees all of the node's visible cards; no
device ids are assigned per worker (the reference assigns none per TPU
worker either).
"""

from __future__ import annotations

import functools
import glob
import os
import re
import subprocess
import urllib.request
from typing import Dict, List, Optional, Tuple

# the instance's custom metadata, read as
# https://cloud.google.com/compute/docs/metadata/querying-metadata sets out
GCE_METADATA_URL = "http://metadata.google.internal/computeMetadata/v1/instance/attributes/"
_METADATA_HEADERS = {"Metadata-Flavor": "Google"}
#: the custom metadata attributes GceGpuClient sets on every host of a slice
METADATA_ACCELERATOR_TYPE = "ray-tpu-torch-accelerator-type"
METADATA_SLICE_NAME = "ray-tpu-torch-slice-name"
METADATA_SLICE_WORKER_INDEX = "ray-tpu-torch-slice-worker-index"
#: what a GCE VM's firmware names its product
DMI_PRODUCT_NAME = "/sys/class/dmi/id/product_name"
NVIDIA_PROC_DIR = "/proc/driver/nvidia/gpus"

CUDA_VISIBLE_DEVICES_ENV = "CUDA_VISIBLE_DEVICES"
ACCELERATOR_TYPE_ENV = "RAY_TPU_TORCH_ACCELERATOR_TYPE"
SLICE_NAME_ENV = "RAY_TPU_TORCH_SLICE_NAME"
SLICE_WORKER_INDEX_ENV = "RAY_TPU_TORCH_SLICE_WORKER_INDEX"
SKIP_METADATA_ENV = "RAY_TPU_TORCH_SKIP_METADATA"

_DEVICE_FILE = re.compile(r"nvidia(\d+)$")
# words of a card's name that are not its model
_BRAND_WORDS = {"nvidia", "tesla", "geforce", "quadro"}


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


def _num_visible(dev_dir: str) -> int:
    n = len(_device_files(dev_dir))
    visible = os.environ.get(CUDA_VISIBLE_DEVICES_ENV)
    if visible is None:
        return n
    # one card per comma-separated entry, at most the cards there are
    return min(len([e for e in visible.split(",") if e.strip()]), n)


def _on_gce() -> bool:
    try:
        with open(DMI_PRODUCT_NAME) as f:
            return f.read().strip() == "Google Compute Engine"
    except OSError:
        return False


def _query_gce_metadata(key: str, timeout: float = 0.5) -> Optional[str]:
    try:
        req = urllib.request.Request(GCE_METADATA_URL + key, headers=_METADATA_HEADERS)
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.read().decode()
    except Exception:
        return None


@functools.lru_cache(maxsize=8)
def _cards(proc_dir: str) -> Tuple[Tuple[str, str], ...]:
    """(UUID, name) of every card on the host in bus order, from the
    driver's ``information`` files (their ``GPU UUID:`` and ``Model:``
    lines), else from ``nvidia-smi`` (NVML: no CUDA context).  Cached for
    the life of the process, as ``tpu.py`` caches its detection: the cards
    do not change under a running process, and ``nvidia-smi`` is a
    subprocess that every node start in a driver would otherwise pay."""
    cards = []
    for path in sorted(glob.glob(os.path.join(proc_dir, "*", "information"))):
        fields = {}
        try:
            with open(path) as f:
                for line in f:
                    key, _, value = line.partition(":")
                    fields[key.strip()] = value.strip()
        except OSError:
            continue
        if fields.get("Model"):
            cards.append((fields.get("GPU UUID", ""), fields["Model"]))
    if cards:
        return tuple(cards)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=uuid,name", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=10,
        )
    except (OSError, subprocess.SubprocessError):
        return ()
    if out.returncode != 0:
        return ()
    for line in out.stdout.splitlines():
        uuid, _, name = line.partition(",")
        if name.strip():
            cards.append((uuid.strip(), name.strip()))
    return tuple(cards)


def _visible_card_name(proc_dir: str) -> Optional[str]:
    """The name of the first card this process may use: ``nvidia-smi`` and
    the driver list every card of the host, so the first entry of
    ``CUDA_VISIBLE_DEVICES`` (an index in bus order, or a card's UUID or a
    unique prefix of it, as CUDA reads it) picks the card."""
    cards = _cards(proc_dir)
    if not cards:
        return None
    entries = [e.strip() for e in os.environ.get(CUDA_VISIBLE_DEVICES_ENV, "").split(",")
               if e.strip()]
    if entries:
        first = entries[0]
        if first.isdigit():
            if int(first) < len(cards):
                return cards[int(first)][1]
        else:
            for uuid, name in cards:
                if uuid and uuid.startswith(first):
                    return name
    return cards[0][1]


def family_of(card_name: str) -> str:
    """The lower-cased model word of a card's name: "NVIDIA H100 80GB HBM3"
    gives ``h100``, "NVIDIA A100-SXM4-80GB" ``a100``, "NVIDIA GeForce RTX
    4090" ``rtx4090``."""
    words = [w for w in card_name.split() if w.lower() not in _BRAND_WORDS]
    if not words:
        return "gpu"
    first = words[0].split("-")[0].lower()
    if first in ("rtx", "gtx") and len(words) > 1:
        first += words[1].split("-")[0].lower()
    return first


class GPUAcceleratorManager:
    """Static methods only, with ``TPUAcceleratorManager``'s names.  Each
    call reads the environment and the device files afresh (no metadata
    query is made off GCE); the cards' names and the GCE metadata answers
    are cached for the life of the process."""

    # -- detection ---------------------------------------------------------
    @staticmethod
    def _detect(dev_dir: str = "/dev", proc_dir: Optional[str] = None) -> dict:
        info = {"cards": _num_visible(dev_dir), "accelerator_type": None,
                "worker_id": 0, "pod_name": None}
        env_type = os.environ.get(ACCELERATOR_TYPE_ENV)
        if env_type:
            info["accelerator_type"] = env_type
            info["pod_name"] = os.environ.get(SLICE_NAME_ENV) or None
            info["worker_id"] = int(os.environ.get(SLICE_WORKER_INDEX_ENV) or 0)
        elif info["cards"] and not os.environ.get(SKIP_METADATA_ENV) and _on_gce():
            accel, name, index = _gce_slice_identity()
            if accel:
                info["accelerator_type"] = accel
                info["pod_name"] = name
                info["worker_id"] = index
        if info["cards"] and info["accelerator_type"] is None:
            name = _visible_card_name(proc_dir or NVIDIA_PROC_DIR)
            family = family_of(name) if name else "gpu"
            info["accelerator_type"] = f"{family}-{info['cards']}"
        return info

    # -- reference-parity interface ---------------------------------------
    @staticmethod
    def get_resource_name() -> str:
        return "GPU"

    @staticmethod
    def get_current_node_num_accelerators(dev_dir: str = "/dev") -> int:
        return _num_visible(dev_dir)

    @classmethod
    def get_current_node_accelerator_type(cls, dev_dir: str = "/dev",
                                          proc_dir: Optional[str] = None) -> Optional[str]:
        return cls._detect(dev_dir, proc_dir)["accelerator_type"]

    @classmethod
    def get_current_node_additional_resources(cls, dev_dir: str = "/dev",
                                              proc_dir: Optional[str] = None) -> Dict[str, float]:
        """Type + head resources for slice-topology-aware placement."""
        info = cls._detect(dev_dir, proc_dir)
        out: Dict[str, float] = {}
        if not info["cards"]:
            return out
        accel = info["accelerator_type"]
        out[f"GPU-{accel}"] = float(info["cards"])
        if info["worker_id"] == 0:
            out[f"GPU-{accel}-head"] = 1.0
        if info["pod_name"]:
            out[f"gpu-slice:{info['pod_name']}"] = 1.0
        return out

    @staticmethod
    def set_current_process_visible_accelerators(ids) -> None:
        os.environ[CUDA_VISIBLE_DEVICES_ENV] = ",".join(str(i) for i in ids)

    @staticmethod
    def get_current_process_visible_accelerator_ids():
        v = os.environ.get(CUDA_VISIBLE_DEVICES_ENV)
        return v.split(",") if v else None

    @classmethod
    def get_current_pod_name(cls, dev_dir: str = "/dev") -> Optional[str]:
        return cls._detect(dev_dir)["pod_name"]

    @classmethod
    def get_current_pod_worker_count(cls, dev_dir: str = "/dev") -> Optional[int]:
        info = cls._detect(dev_dir)
        accel = info["accelerator_type"]
        if not accel:
            return None
        try:
            total = int(str(accel).split("-")[-1])
            return max(1, total // max(1, info["cards"]))
        except ValueError:
            return None


@functools.lru_cache(maxsize=1)
def _gce_slice_identity():
    """(type, slice name, worker index) from the instance's metadata."""
    accel = _query_gce_metadata(METADATA_ACCELERATOR_TYPE)
    if not accel:
        return None, None, 0
    name = _query_gce_metadata(METADATA_SLICE_NAME)
    index = _query_gce_metadata(METADATA_SLICE_WORKER_INDEX)
    return accel, name or None, int(index or 0)
