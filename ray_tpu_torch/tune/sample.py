"""Search-space domains (reference: python/ray/tune/search/sample.py —
Categorical/Float/Integer domains + grid_search marker).

A param_space is a nested dict whose leaves may be Domain objects or
``{"grid_search": [...]}`` markers; the variant generator resolves them.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, List, Optional, Sequence


class Domain:
    """A distribution over values for one hyperparameter."""

    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Categorical(Domain):
    def __init__(self, categories: Sequence[Any]):
        if not categories:
            raise ValueError("choice() requires a non-empty sequence")
        self.categories = list(categories)

    def sample(self, rng: random.Random) -> Any:
        return rng.choice(self.categories)

    def __repr__(self):
        return f"choice({self.categories})"


class Float(Domain):
    def __init__(self, lower: float, upper: float, log: bool = False, q: Optional[float] = None):
        if lower >= upper:
            raise ValueError(f"uniform() requires lower < upper, got [{lower}, {upper}]")
        if log and lower <= 0:
            raise ValueError("loguniform() requires lower > 0")
        self.lower, self.upper, self.log, self.q = lower, upper, log, q

    def sample(self, rng: random.Random) -> float:
        if self.log:
            import math

            v = math.exp(rng.uniform(math.log(self.lower), math.log(self.upper)))
        else:
            v = rng.uniform(self.lower, self.upper)
        if self.q is not None:
            v = round(v / self.q) * self.q
        return v

    def __repr__(self):
        kind = "loguniform" if self.log else "uniform"
        return f"{kind}({self.lower}, {self.upper})"


class Integer(Domain):
    def __init__(self, lower: int, upper: int, q: int = 1):
        if lower >= upper:
            raise ValueError(f"randint() requires lower < upper, got [{lower}, {upper}]")
        self.lower, self.upper, self.q = lower, upper, q

    def sample(self, rng: random.Random) -> int:
        v = rng.randrange(self.lower, self.upper)
        if self.q > 1:
            v = int(round(v / self.q) * self.q)
        return v

    def __repr__(self):
        return f"randint({self.lower}, {self.upper})"


class Normal(Domain):
    def __init__(self, mean: float = 0.0, sd: float = 1.0):
        self.mean, self.sd = mean, sd

    def sample(self, rng: random.Random) -> float:
        return rng.gauss(self.mean, self.sd)


class Function(Domain):
    """sample_from(lambda spec: ...): arbitrary sampling function."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def sample(self, rng: random.Random) -> Any:
        try:
            return self.fn({})
        except TypeError:
            return self.fn()


# -- public constructors (match the reference tune.* names) ---------------
def choice(categories: Sequence[Any]) -> Categorical:
    return Categorical(categories)


def uniform(lower: float, upper: float) -> Float:
    return Float(lower, upper)


def quniform(lower: float, upper: float, q: float) -> Float:
    return Float(lower, upper, q=q)


def loguniform(lower: float, upper: float) -> Float:
    return Float(lower, upper, log=True)


def qloguniform(lower: float, upper: float, q: float) -> Float:
    return Float(lower, upper, log=True, q=q)


def randint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper)


def qrandint(lower: int, upper: int, q: int) -> Integer:
    return Integer(lower, upper, q=q)


def randn(mean: float = 0.0, sd: float = 1.0) -> Normal:
    return Normal(mean, sd)


def sample_from(fn: Callable) -> Function:
    return Function(fn)


def grid_search(values: List[Any]) -> Dict[str, List[Any]]:
    """Marker consumed by the variant generator: every value is tried."""
    return {"grid_search": list(values)}
