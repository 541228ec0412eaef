"""Search-space primitives and variant generation.

Counterpart of ``ray_lightning_tpu/tune/search.py`` (the ``ray.tune``
search-space surface the reference's examples use,
``examples/ray_ddp_example.py:81-115``): ``choice``, ``uniform``,
``loguniform``, ``randint``, ``grid_search``.  Grid axes are expanded
exhaustively; the other domains are sampled per trial from one numpy
``default_rng(seed)`` in the JAX package's draw order, so one space and
one seed give the same configs in both packages.
"""

from __future__ import annotations

import itertools
import math
from typing import Any, Sequence

import numpy as np


class Domain:
    """A hyperparameter sampled per trial."""

    def sample(self, rng: np.random.Generator) -> Any:
        raise NotImplementedError


class Choice(Domain):
    def __init__(self, categories: Sequence[Any]):
        self.categories = list(categories)

    def sample(self, rng):
        return self.categories[int(rng.integers(len(self.categories)))]

    def __repr__(self):
        return f"choice({self.categories})"


class Uniform(Domain):
    def __init__(self, low: float, high: float):
        self.low, self.high = float(low), float(high)

    def sample(self, rng):
        return float(rng.uniform(self.low, self.high))

    def __repr__(self):
        return f"uniform({self.low}, {self.high})"


class LogUniform(Domain):
    def __init__(self, low: float, high: float, base: float = 10.0):
        self.low, self.high, self.base = float(low), float(high), float(base)

    def sample(self, rng):
        lo = math.log(self.low, self.base)
        hi = math.log(self.high, self.base)
        return float(self.base ** rng.uniform(lo, hi))

    def __repr__(self):
        return f"loguniform({self.low}, {self.high})"


class RandInt(Domain):
    def __init__(self, low: int, high: int):
        self.low, self.high = int(low), int(high)

    def sample(self, rng):
        return int(rng.integers(self.low, self.high))

    def __repr__(self):
        return f"randint({self.low}, {self.high})"


class GridSearch:
    """An exhaustive axis: expanded across trials, not sampled."""

    def __init__(self, values: Sequence[Any]):
        self.values = list(values)

    def __repr__(self):
        return f"grid_search({self.values})"


def choice(categories: Sequence[Any]) -> Choice:
    return Choice(categories)


def uniform(low: float, high: float) -> Uniform:
    return Uniform(low, high)


def loguniform(low: float, high: float) -> LogUniform:
    return LogUniform(low, high)


def randint(low: int, high: int) -> RandInt:
    return RandInt(low, high)


def grid_search(values: Sequence[Any]) -> GridSearch:
    return GridSearch(values)


def generate_variants(space: dict, num_samples: int,
                      seed: int = 0) -> "list[dict]":
    """The grid axes' product times ``num_samples`` draws of the other
    domains, as concrete configs (``ray.tune``'s semantics: each grid
    combination runs ``num_samples`` times with fresh samples)."""
    grid_keys = [k for k, v in space.items() if isinstance(v, GridSearch)]
    grid_values = [space[k].values for k in grid_keys]
    rng = np.random.default_rng(seed)
    variants = []
    combos = list(itertools.product(*grid_values)) if grid_keys else [()]
    for combo in combos:
        for _ in range(num_samples):
            cfg = {}
            for k, v in space.items():
                if isinstance(v, GridSearch):
                    cfg[k] = combo[grid_keys.index(k)]
                elif isinstance(v, Domain):
                    cfg[k] = v.sample(rng)
                else:
                    cfg[k] = v
            variants.append(cfg)
    return variants


__all__ = ["Choice", "Domain", "GridSearch", "LogUniform", "RandInt",
           "Uniform", "choice", "generate_variants", "grid_search",
           "loguniform", "randint", "uniform"]
