"""Grid/random search (reference: python/ray/tune/search/basic_variant.py
BasicVariantGenerator)."""

from __future__ import annotations

from typing import Any, Dict, Optional

from ray_tpu_torch.tune.search.searcher import Searcher
from ray_tpu_torch.tune.search.variant_generator import count_variants, generate_variants


class BasicVariantGenerator(Searcher):
    """Exhausts grid axes × num_samples random resolutions."""

    def __init__(self, param_space: Optional[Dict[str, Any]] = None, num_samples: int = 1, seed: int = 0):
        super().__init__()
        self._param_space = param_space or {}
        self._num_samples = num_samples
        self._seed = seed
        self._iter = None
        self._count = 0

    def set_search_properties(self, metric, mode, config) -> bool:
        super().set_search_properties(metric, mode, config)
        if config:
            self._param_space = config
        return True

    @property
    def total_variants(self) -> int:
        return count_variants(self._param_space, self._num_samples)

    def suggest(self, trial_id: str):
        if self._iter is None:
            self._iter = generate_variants(self._param_space, self._num_samples, self._seed)
        try:
            cfg = next(self._iter)
            self._count += 1
            return cfg
        except StopIteration:
            return Searcher.FINISHED

    def save(self):
        # Variants are deterministic given (space, num_samples, seed); resume
        # replays the generator and skips already-issued configs.
        return {"count": self._count}

    def restore(self, state):
        n = state.get("count", 0)
        self._iter = generate_variants(self._param_space, self._num_samples, self._seed)
        for _ in range(n):
            next(self._iter, None)
        self._count = n
