"""Checkpoint = a directory of files (reference:
python/ray/train/_checkpoint.py:56 — directory + filesystem).  The
state helpers save a nested container of tensors (a ``state_dict``, an
optimizer's state, plain Python and numpy values) with ``torch.save``,
every tensor moved to the CPU first, so a checkpoint written on the card
loads in any process."""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import uuid
from typing import Any, Dict, Optional


class Checkpoint:
    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    def to_directory(self, path: Optional[str] = None) -> str:
        """Materialize into `path` (copy if needed) and return it."""
        if path is None or os.path.abspath(path) == self.path:
            return self.path
        os.makedirs(path, exist_ok=True)
        shutil.copytree(self.path, path, dirs_exist_ok=True)
        return path

    def as_directory(self):
        import contextlib

        @contextlib.contextmanager
        def ctx():
            yield self.path

        return ctx()

    # -- state convenience (the reference's pytree helpers) -------------
    @classmethod
    def from_pytree(cls, tree: Any, path: Optional[str] = None) -> "Checkpoint":
        path = path or tempfile.mkdtemp(prefix="ray_tpu_torch_ckpt_")
        os.makedirs(path, exist_ok=True)
        save_pytree(tree, path)
        return cls(path)

    def to_pytree(self) -> Any:
        return load_pytree(self.path)

    def update_metadata(self, metadata: Dict[str, Any]):
        meta_path = os.path.join(self.path, ".metadata.json")
        data = {}
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                data = json.load(f)
        data.update(metadata)
        with open(meta_path, "w") as f:
            json.dump(data, f)

    def get_metadata(self) -> Dict[str, Any]:
        meta_path = os.path.join(self.path, ".metadata.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                return json.load(f)
        return {}

    def __repr__(self):
        return f"Checkpoint({self.path})"

    def __reduce__(self):
        return (Checkpoint, (self.path,))


_STATE_FILE = "state.pt"


def _to_host(tree: Any) -> Any:
    """The same nesting of dicts, lists and tuples, every tensor in it
    detached and on the CPU."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu")
    if isinstance(tree, dict):
        return type(tree)((k, _to_host(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def save_pytree(tree: Any, path: str):
    """``torch.save`` of ``tree`` with every tensor moved to the CPU (the
    reference fetches a JAX pytree to the host, or saves it with orbax)."""
    import torch

    torch.save(_to_host(tree), os.path.join(path, _STATE_FILE))


def load_pytree(path: str) -> Any:
    """What ``save_pytree`` saved, on the CPU.  ``weights_only=False``:
    the state may hold numpy arrays and plain objects, and the file is
    one this program wrote."""
    import torch

    return torch.load(os.path.join(path, _STATE_FILE), map_location="cpu", weights_only=False)
