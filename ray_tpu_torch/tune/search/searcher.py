"""Searcher interface (reference: python/ray/tune/search/searcher.py) and
ConcurrencyLimiter (search/concurrency_limiter.py)."""

from __future__ import annotations

from typing import Any, Dict, Optional


class Searcher:
    """Suggests configs; learns from completed trials."""

    FINISHED = "FINISHED"

    def __init__(self, metric: Optional[str] = None, mode: Optional[str] = None):
        self.metric = metric
        self.mode = mode or "max"

    def set_search_properties(self, metric: Optional[str], mode: Optional[str], config: Dict) -> bool:
        if metric:
            self.metric = metric
        if mode:
            self.mode = mode
        return True

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        """Next config, None to wait (in-flight results pending), or
        Searcher.FINISHED when the space is exhausted."""
        raise NotImplementedError

    def on_trial_result(self, trial_id: str, result: Dict[str, Any]):
        pass

    def on_trial_complete(self, trial_id: str, result: Optional[Dict[str, Any]] = None, error: bool = False):
        pass

    def save(self) -> Dict[str, Any]:
        return {}

    def restore(self, state: Dict[str, Any]):
        pass


class ConcurrencyLimiter(Searcher):
    """Caps in-flight suggestions from the wrapped searcher."""

    def __init__(self, searcher: Searcher, max_concurrent: int):
        super().__init__(searcher.metric, searcher.mode)
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self._live = set()

    def set_search_properties(self, metric, mode, config):
        return self.searcher.set_search_properties(metric, mode, config)

    def suggest(self, trial_id: str):
        if len(self._live) >= self.max_concurrent:
            return None
        cfg = self.searcher.suggest(trial_id)
        if isinstance(cfg, dict):
            self._live.add(trial_id)
        return cfg

    def on_trial_result(self, trial_id, result):
        self.searcher.on_trial_result(trial_id, result)

    def on_trial_complete(self, trial_id, result=None, error=False):
        self._live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result, error)

    def save(self):
        return self.searcher.save()

    def restore(self, state):
        self.searcher.restore(state)
