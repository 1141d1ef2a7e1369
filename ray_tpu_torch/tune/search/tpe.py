"""Native model-based searcher: Tree-structured Parzen Estimator over the
tune search-space domains.  Fills the role of the reference's pluggable
searchers (python/ray/tune/search/{optuna,hyperopt}/ — external deps there;
here a dependency-free implementation of the same TPE algorithm those
libraries use)."""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.tune.sample import Categorical, Domain, Float, Integer
from ray_tpu_torch.tune.search.searcher import Searcher


def _flatten(space: Any, path: Tuple = ()) -> List[Tuple[Tuple, Domain]]:
    out = []
    if isinstance(space, Domain):
        out.append((path, space))
    elif isinstance(space, dict):
        for k, v in space.items():
            out.extend(_flatten(v, path + (k,)))
    return out


def _build(space: Any, values: Dict[Tuple, Any], path: Tuple = ()) -> Any:
    if isinstance(space, Domain):
        return values[path]
    if isinstance(space, dict):
        return {k: _build(v, values, path + (k,)) for k, v in space.items()}
    return space


class TPESearcher(Searcher):
    """Split observations at gamma-quantile into good/bad, sample candidates
    from a KDE over the good set, rank by good/bad density ratio."""

    def __init__(
        self,
        space: Optional[Dict[str, Any]] = None,
        metric: Optional[str] = None,
        mode: str = "max",
        n_startup_trials: int = 8,
        n_candidates: int = 24,
        gamma: float = 0.25,
        seed: int = 0,
    ):
        super().__init__(metric, mode)
        self._space = space or {}
        self._params: List[Tuple[Tuple, Domain]] = _flatten(self._space)
        self._rng = random.Random(seed)
        self.n_startup = n_startup_trials
        self.n_candidates = n_candidates
        self.gamma = gamma
        self._observed: List[Tuple[Dict[Tuple, Any], float]] = []
        self._pending: Dict[str, Dict[Tuple, Any]] = {}

    def set_search_properties(self, metric, mode, config) -> bool:
        super().set_search_properties(metric, mode, config)
        if config:
            self._space = config
            self._params = _flatten(config)
        return True

    # -- sampling ---------------------------------------------------------
    def _random_point(self) -> Dict[Tuple, Any]:
        return {p: d.sample(self._rng) for p, d in self._params}

    def _kde_sample(self, good: List[Dict[Tuple, Any]], path: Tuple, dom: Domain):
        vals = [g[path] for g in good]
        if isinstance(dom, Categorical):
            # Dirichlet-smoothed empirical distribution.
            weights = {c: 1.0 for c in dom.categories}
            for v in vals:
                weights[v] = weights.get(v, 1.0) + 2.0
            total = sum(weights.values())
            r = self._rng.uniform(0, total)
            acc = 0.0
            for c, w in weights.items():
                acc += w
                if r <= acc:
                    return c
            return dom.categories[-1]
        if isinstance(dom, (Float, Integer)):
            center = self._rng.choice(vals)
            log = isinstance(dom, Float) and dom.log
            lo, hi = float(dom.lower), float(dom.upper)
            if log:
                lo, hi, center = math.log(lo), math.log(hi), math.log(center)
            bw = max((hi - lo) / 5.0, 1e-12)
            v = self._rng.gauss(float(center), bw)
            v = min(max(v, lo), hi)
            if log:
                v = math.exp(v)
            if isinstance(dom, Integer):
                v = int(round(v))
                v = min(max(v, dom.lower), dom.upper - 1)
            return v
        return dom.sample(self._rng)

    def _density(self, pts: List[Dict[Tuple, Any]], x: Dict[Tuple, Any]) -> float:
        """Log-density of x under a product KDE fit to pts."""
        if not pts:
            return 0.0
        logp = 0.0
        for path, dom in self._params:
            vals = [p[path] for p in pts]
            xv = x[path]
            if isinstance(dom, Categorical):
                count = sum(1 for v in vals if v == xv) + 1.0
                logp += math.log(count / (len(vals) + len(dom.categories)))
            elif isinstance(dom, (Float, Integer)):
                log = isinstance(dom, Float) and dom.log
                lo, hi = float(dom.lower), float(dom.upper)
                tx = math.log(xv) if log else float(xv)
                tlo, thi = (math.log(lo), math.log(hi)) if log else (lo, hi)
                bw = max((thi - tlo) / 5.0, 1e-12)
                dens = sum(
                    math.exp(-0.5 * ((tx - (math.log(v) if log else float(v))) / bw) ** 2)
                    for v in vals
                ) / (len(vals) * bw * math.sqrt(2 * math.pi))
                logp += math.log(max(dens, 1e-300))
        return logp

    def suggest(self, trial_id: str):
        if not self._params:
            return Searcher.FINISHED
        if len(self._observed) < self.n_startup:
            point = self._random_point()
        else:
            obs = sorted(self._observed, key=lambda o: o[1], reverse=(self.mode == "max"))
            n_good = max(1, int(self.gamma * len(obs)))
            good = [o[0] for o in obs[:n_good]]
            bad = [o[0] for o in obs[n_good:]] or good
            cands = [
                {p: self._kde_sample(good, p, d) for p, d in self._params}
                for _ in range(self.n_candidates)
            ]
            point = max(cands, key=lambda c: self._density(good, c) - self._density(bad, c))
        self._pending[trial_id] = point
        return _build(self._space, point)

    def on_trial_complete(self, trial_id: str, result=None, error: bool = False):
        point = self._pending.pop(trial_id, None)
        if point is None or error or result is None or self.metric not in result:
            return
        self._observed.append((point, float(result[self.metric])))

    def save(self):
        return {
            "observed": [(list(p.items()), v) for p, v in self._observed],
        }

    def restore(self, state):
        self._observed = [(dict((tuple(k), v) for k, v in items), val) for items, val in state.get("observed", [])]
