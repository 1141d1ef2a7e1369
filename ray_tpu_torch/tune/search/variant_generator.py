"""Expand a param_space into concrete trial configs (reference:
python/ray/tune/search/variant_generator.py — grid expansion ×
num_samples random resolution)."""

from __future__ import annotations

import itertools
import random
from typing import Any, Dict, Iterator, List, Tuple

from ray_tpu_torch.tune.sample import Domain


def _find_grid_axes(space: Any, path: Tuple = ()) -> List[Tuple[Tuple, List[Any]]]:
    """All `{"grid_search": [...]}` leaves as (path, values)."""
    axes = []
    if isinstance(space, dict):
        if set(space.keys()) == {"grid_search"}:
            return [(path, space["grid_search"])]
        for k, v in space.items():
            axes.extend(_find_grid_axes(v, path + (k,)))
    return axes


def _set_path(cfg: Dict, path: Tuple, value: Any):
    d = cfg
    for k in path[:-1]:
        d = d[k]
    d[path[-1]] = value


def _resolve(space: Any, rng: random.Random) -> Any:
    """Deep-copy, sampling every Domain leaf."""
    if isinstance(space, Domain):
        return space.sample(rng)
    if isinstance(space, dict):
        if set(space.keys()) == {"grid_search"}:
            return space  # replaced later by the grid product
        return {k: _resolve(v, rng) for k, v in space.items()}
    if isinstance(space, list):
        return [_resolve(v, rng) for v in space]
    return space


def generate_variants(
    param_space: Dict[str, Any], num_samples: int, seed: int = 0
) -> Iterator[Dict[str, Any]]:
    """Yield `num_samples` × (product of grid axes) concrete configs."""
    rng = random.Random(seed)
    grid_axes = _find_grid_axes(param_space)
    grid_values = [vals for _, vals in grid_axes]
    for _ in range(num_samples):
        for combo in itertools.product(*grid_values) if grid_axes else [()]:
            cfg = _resolve(param_space, rng)
            for (path, _), value in zip(grid_axes, combo):
                _set_path(cfg, path, value)
            yield cfg


def count_variants(param_space: Dict[str, Any], num_samples: int) -> int:
    n = num_samples
    for _, vals in _find_grid_axes(param_space):
        n *= len(vals)
    return n
