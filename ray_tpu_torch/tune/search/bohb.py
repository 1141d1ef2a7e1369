"""TuneBOHB — BOHB's model-based searcher (reference:
python/ray/tune/search/bohb/bohb_search.py, which wraps the hpbandster
KDE model; here the same multi-fidelity TPE idea on top of our
dependency-free TPESearcher).

BOHB = HyperBand's budget schedule + a density model that learns from
results at EVERY budget: suggestions come from the KDE built over the
HIGHEST budget that has enough observations, falling back down the
budget ladder (and to random) while data is sparse.  Pair with
``HyperBandForBOHB`` so partially-trained (rung-stopped) trials still
feed the model through ``on_trial_result``."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.tune.search.searcher import Searcher
from ray_tpu_torch.tune.search.tpe import TPESearcher


class TuneBOHB(TPESearcher):
    def __init__(
        self,
        space: Optional[Dict[str, Any]] = None,
        metric: Optional[str] = None,
        mode: str = "max",
        time_attr: str = "training_iteration",
        n_startup_trials: int = 8,
        n_candidates: int = 24,
        gamma: float = 0.25,
        seed: int = 0,
    ):
        super().__init__(
            space, metric, mode,
            n_startup_trials=n_startup_trials,
            n_candidates=n_candidates,
            gamma=gamma,
            seed=seed,
        )
        self.time_attr = time_attr
        # budget -> [(point, score)]; a trial contributes its LATEST
        # score per budget level
        self._by_budget: Dict[int, Dict[str, Tuple[Dict, float]]] = {}

    def _record(self, trial_id: str, result: Dict[str, Any]):
        point = self._pending.get(trial_id)
        if point is None or result is None or self.metric not in result:
            return
        budget = int(result.get(self.time_attr, 1))
        self._by_budget.setdefault(budget, {})[trial_id] = (
            point, float(result[self.metric])
        )

    def on_trial_result(self, trial_id: str, result: Dict[str, Any]):
        self._record(trial_id, result)

    def on_trial_complete(self, trial_id: str, result=None, error: bool = False):
        if not error and result is not None:
            self._record(trial_id, result)
        self._pending.pop(trial_id, None)

    def _model_observations(self) -> List[Tuple[Dict, float]]:
        """Observations from the highest budget with enough data; pool
        downward while sparse (BOHB's budget-ladder fallback)."""
        for budget in sorted(self._by_budget, reverse=True):
            obs = list(self._by_budget[budget].values())
            if len(obs) >= self.n_startup:
                return obs
        pooled: Dict[str, Tuple[Dict, float]] = {}
        for budget in sorted(self._by_budget):  # higher budgets overwrite
            pooled.update(self._by_budget[budget])
        return list(pooled.values())

    def suggest(self, trial_id: str):
        # feed the parent's observation list from the budget ladder, then
        # reuse its TPE candidate ranking
        self._observed = self._model_observations()
        return super().suggest(trial_id)
