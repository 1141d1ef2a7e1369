"""Per-shard checkpointing for sharded state, re-shardable at load (port
of ``ray_tpu/train/sharding/checkpoint.py``).

Save: every process writes ONLY its own shards into its own
``shards_p{rank}.npz`` (no gather, no host copy of the global tensor),
plus a ``meta.json`` describing the leaf paths, global shapes/dtypes and
the per-entry index windows.  A rank holds one shard of each DTensor, so
each distinct window of a leaf is stored once per process that owns it.

Load: all shard files found under the directory are read and each leaf
is reassembled into a full host array from its windows, then placed with
the layout of the caller-supplied ``like`` tree.  Because assembly is
window-based, the saving mesh and the loading mesh are independent — a
checkpoint written by a 2-rank batch x model mesh restores onto a 4-rank
one unchanged, the elastic shrink/grow resize applied to sharded state.

A tree is a nested mapping of tensors (DTensors or plain ones).  bfloat16
leaves travel through numpy as their 16-bit patterns (numpy has no
bfloat16), the dtype kept in ``meta.json``.  The reference's saving
processes each publish their files and leave the manifest to a caller
that knows when all have returned; here the ranks meet at a barrier of
the default process group after writing, rank 0 commits the manifest
(file list + CRC32s), and they meet again, so every rank returns from a
save that ``load_sharded`` verifies (``CheckpointCorruptionError`` on a
bit-flipped or truncated shard).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
from typing import Any, Dict, List, Tuple

META_NAME = "meta.json"
_SHARD_PREFIX = "shards_p"


def _leaf_paths(tree: Any) -> Tuple[List[str], List[Any]]:
    from ray_tpu_torch.parallel.sharding import _path_str, tree_items

    flat = tree_items(tree)
    return [_path_str(p) for p, _ in flat], [leaf for _, leaf in flat]


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _to_numpy(t):
    import torch

    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _from_numpy(a, dtype_name: str):
    import torch

    t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if dtype_name == "bfloat16" else t


def _numpy_dtype(dtype_name: str):
    import numpy as np

    return np.dtype(np.int16 if dtype_name == "bfloat16" else dtype_name)


def _window(leaf) -> List[List[int]]:
    """This rank's window of ``leaf`` as [[start, stop], ...] per dim."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    if isinstance(leaf, DTensor):
        shape, offset = compute_local_shape_and_global_offset(
            leaf.shape, leaf.device_mesh, leaf.placements)
        return [[int(o), int(o) + int(n)] for o, n in zip(offset, shape)]
    return [[0, int(n)] for n in leaf.shape]


def _barrier() -> None:
    """Meet the other ranks (a lone process has none)."""
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def save_sharded(state: Any, path: str, mesh=None) -> None:
    """Write this process's shards of ``state`` under ``path`` (created if
    needed).  Every rank calls it (the step that made ``state`` ran on all
    of them); files are per-process."""
    import numpy as np
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.parallel.mesh import axis_sizes
    from ray_tpu_torch.train import checkpoint_plane

    os.makedirs(path, exist_ok=True)
    paths, leaves = _leaf_paths(state)
    proc = dist.get_rank() if dist.is_initialized() else 0
    arrays: Dict[str, Any] = {}
    entries: List[dict] = []
    for li, leaf in enumerate(leaves):
        name = f"L{li}_S0"
        local = leaf.to_local() if isinstance(leaf, DTensor) else leaf
        arrays[name] = _to_numpy(local)
        entries.append({"leaf": li, "key": name, "window": _window(leaf)})
    # Atomic shard publish (checkpoint_plane commit path): a SIGKILL
    # mid-save leaves a .tmp orphan, never a plausible partial .npz
    # under the final name next to an older meta.json.
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    checkpoint_plane.write_file_atomic(path, f"{_SHARD_PREFIX}{proc}.npz", buf.getvalue())
    mesh_shape = axis_sizes(mesh) if mesh is not None else {}
    meta = {
        "leaves": paths,
        "shapes": [list(leaf.shape) for leaf in leaves],
        "dtypes": [_dtype_name(leaf.dtype) for leaf in leaves],
        "entries_per_process": {str(proc): entries},
        "mesh_shape": mesh_shape,
    }
    # Process 0 writes the canonical meta; other processes merge their
    # entry lists in via per-process sidecars (no write contention).
    if proc == 0:
        checkpoint_plane.write_file_atomic(path, META_NAME, json.dumps(meta).encode())
    else:
        checkpoint_plane.write_file_atomic(
            path, f"entries_p{proc}.json", json.dumps(entries).encode())
    _barrier()  # every rank's files are in place
    if proc == 0:
        checkpoint_plane.commit_directory(path, meta={"mesh_shape": mesh_shape})
    _barrier()  # the manifest is committed before any rank reads it


def load_sharded(path: str, like: Any) -> Any:
    """Reassemble a :func:`save_sharded` checkpoint and place it with
    ``like``'s layout: a DTensor leaf of ``like`` gives its mesh and
    placements (each rank keeps its window of the reassembled tensor), a
    plain tensor its device.  The saved mesh size/shape is free to differ
    from ``like``'s — this IS the elastic re-shard path."""
    import numpy as np
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.parallel.sharding import place, tree_leaves, tree_map
    from ray_tpu_torch.train import checkpoint_plane

    # Committed checkpoints verify before a single byte is adopted: a
    # bit-flipped or truncated shard raises CheckpointCorruptionError
    # here instead of silently restoring wrong weights.
    if os.path.exists(os.path.join(path, checkpoint_plane.MANIFEST_NAME)):
        checkpoint_plane.verify_checkpoint(path)

    with open(os.path.join(path, META_NAME)) as f:
        meta = json.load(f)
    # All entry lists: process 0's inline + any sidecars.
    by_proc: Dict[str, List[dict]] = dict(meta.get("entries_per_process", {}))
    for fn in os.listdir(path):
        if fn.startswith("entries_p") and fn.endswith(".json"):
            with open(os.path.join(path, fn)) as f:
                by_proc[fn[len("entries_p"):-len(".json")]] = json.load(f)
    entries = [{**e, "proc": int(proc)} for proc, ents in by_proc.items() for e in ents]

    with contextlib.ExitStack() as stack:
        shard_files: Dict[int, Any] = {}
        for fn in os.listdir(path):
            if fn.startswith(_SHARD_PREFIX) and fn.endswith(".npz"):
                shard_files[int(fn[len(_SHARD_PREFIX):-len(".npz")])] = stack.enter_context(
                    np.load(os.path.join(path, fn)))
        full: List[Any] = []
        for li, (shape, dtype) in enumerate(zip(meta["shapes"], meta["dtypes"])):
            out = np.zeros(tuple(shape), dtype=_numpy_dtype(dtype))
            covered = np.zeros(tuple(shape), dtype=bool)
            for e in entries:
                if e["leaf"] != li or e["proc"] not in shard_files:
                    continue
                sl = tuple(slice(a, b) for a, b in e["window"])
                out[sl] = shard_files[e["proc"]][e["key"]]
                covered[sl] = True
            if not covered.all():
                raise ValueError(
                    f"checkpoint at {path} is missing shards for leaf "
                    f"{meta['leaves'][li]!r} — a process's shard file was not "
                    f"found (saved on shared storage?)"
                )
            full.append(_from_numpy(out, dtype))

    like_leaves = tree_leaves(like)
    if len(like_leaves) != len(full):
        raise ValueError(
            f"checkpoint at {path} holds {len(full)} leaves but the target "
            f"tree has {len(like_leaves)} — model/optimizer mismatch"
        )
    for li, (host, target) in enumerate(zip(full, like_leaves)):
        if tuple(host.shape) != tuple(target.shape):
            raise ValueError(f"checkpoint leaf {meta['leaves'][li]!r} is "
                             f"{tuple(host.shape)}, the target's {tuple(target.shape)}")
    it = iter(full)

    def one(target):
        host = next(it)
        if isinstance(target, DTensor):
            return place(host, target.device_mesh, target.placements)
        return host.to(target.device)

    return tree_map(one, like)
