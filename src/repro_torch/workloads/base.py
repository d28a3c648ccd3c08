"""Data-size laws and per-edge popularity: a numpy copy of ``SizeSpec`` and
``edge_weights`` from ``repro/workloads/base.py``.

The port keeps its own copy because importing ``repro.workloads`` pulls in
jax. Everything is deterministic given the caller's
``numpy.random.Generator``, and the copy draws exactly the reference's
numbers (pinned by ``tests/test_torch_inference.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SizeSpec:
    """A named data-size law. ``dist`` selects the family, ``params`` its
    parameters; every family is clipped to (0, cap] so sizes stay on the
    scale the policy/objective were built for (paper sizes are U(0,1)).

    Families:
      uniform(lo=0, hi=1)
      fixed(value)
      pareto(alpha=1.5, scale=0.05)   heavy tail, mean scale*alpha/(alpha-1)
      lognormal(mu=-1.5, sigma=0.8)
    """

    dist: str = "uniform"
    params: tuple = ()
    cap: float = 1.0

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        p = self.params
        if self.dist == "uniform":
            lo, hi = p if p else (0.0, 1.0)
            out = rng.uniform(lo, hi, size=n)
        elif self.dist == "fixed":
            (value,) = p if p else (0.5,)
            out = np.full(n, value, float)
        elif self.dist == "pareto":
            alpha, scale = p if p else (1.5, 0.05)
            out = scale * (1.0 + rng.pareto(alpha, size=n))
        elif self.dist == "lognormal":
            mu, sigma = p if p else (-1.5, 0.8)
            out = rng.lognormal(mu, sigma, size=n)
        else:
            raise ValueError(f"unknown size distribution {self.dist!r}")
        return np.clip(out, 1e-6, self.cap).astype(np.float64)


def edge_weights(num_edges: int, skew: float = 0.0,
                 hot_edge: int = 0) -> np.ndarray:
    """Zipf-style edge popularity: weight of the k-th most popular edge is
    (k+1)^-skew. ``skew=0`` is uniform; the hottest rank sits at
    ``hot_edge`` and the rest follow in index order."""
    ranks = np.arange(num_edges, dtype=np.float64)
    w = (ranks + 1.0) ** (-float(skew))
    w = np.roll(w, hot_edge % num_edges)
    return w / w.sum()
