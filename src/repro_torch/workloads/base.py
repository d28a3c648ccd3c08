"""Workload description layer: arrivals, size laws, and the Workload protocol.

A numpy copy of ``repro/workloads/base.py``: the port keeps its own,
because importing ``repro.workloads`` pulls in jax. Everything draws
exactly the reference's numbers (held bit for bit by
``tests/test_torch_workloads.py``).

The paper evaluates CoRaiS on i.i.d. uniform request sets (§V.A); real
multi-edge traffic is bursty, diurnal, and skewed. This module is the
vocabulary everything else shares:

* :class:`Arrival` — one request brief hitting one edge at one time.
* :class:`Workload` — anything that can produce a time-ordered arrival
  stream for a cluster of ``num_edges`` edges (generators in
  ``processes.py``, recorded traces in ``trace.py``).
* :class:`SizeSpec` — named data-size distributions (uniform / pareto /
  lognormal / fixed), shared between arrival generators and the static
  instance sampler in ``core/instances.py`` so training and serving draw
  from the same laws.
* :func:`edge_weights` — Zipf-style per-edge popularity skew.
* :func:`merge` — superpose independent workloads into one stream.

Everything is deterministic given the caller's ``numpy.random.Generator``:
the same seed always yields the same arrival sequence, which is what makes
trace record/replay and paired scheduler comparisons exact.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Iterator, Protocol, runtime_checkable

import numpy as np


@dataclasses.dataclass(frozen=True, order=True)
class Arrival:
    """One request brief: at time ``t`` a client of edge ``edge`` submits a
    request of input data size ``size`` for service ``service``.

    Schema-v3 fields (``corais.trace.v3``): ``deadline`` is a *relative*
    response-time budget in seconds (the request's hard SLO is
    ``t + deadline``; 0.0 = no deadline) and ``priority`` is a small
    non-negative importance level (0 = default). Both default to their
    "absent" values so v1/v2 traces and pre-v3 generators are unchanged."""

    t: float
    edge: int
    size: float
    service: int = 0
    deadline: float = 0.0
    priority: int = 0


@runtime_checkable
class Workload(Protocol):
    """A source of arrivals over the horizon [0, until]."""

    def arrivals(self, rng: np.random.Generator, num_edges: int,
                 until: float) -> Iterator[Arrival]:
        """Yield arrivals in nondecreasing time order, all with t <= until."""
        ...


# -- data-size distributions -------------------------------------------------

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

    def sample_one(self, rng: np.random.Generator) -> float:
        return float(self.sample(rng, 1)[0])


def workload_rng(seed: int) -> np.random.Generator:
    """The canonical generator stream for materializing a workload from
    ``seed``. Both :meth:`MultiEdgeSim.drive` and :func:`record_trace`
    derive it this way, so recording a workload under a seed captures
    exactly the arrivals a live drive under that seed would generate. The
    (seed, constant) key keeps it disjoint from the simulator's topology
    rng (seed) and per-edge rngs ((seed, edge_id))."""
    return np.random.default_rng((seed, 1_000_000_007))


# -- per-edge popularity -----------------------------------------------------

def edge_weights(num_edges: int, skew: float = 0.0,
                 hot_edge: int = 0) -> np.ndarray:
    """Zipf-style edge popularity: weight of the k-th most popular edge is
    (k+1)^-skew. ``skew=0`` is uniform; the hottest rank sits at
    ``hot_edge`` and the rest follow in index order."""
    ranks = np.arange(num_edges, dtype=np.float64)
    w = (ranks + 1.0) ** (-float(skew))
    w = np.roll(w, hot_edge % num_edges)
    return w / w.sum()


def pick_edge(rng: np.random.Generator, probs: np.ndarray) -> int:
    return int(rng.choice(len(probs), p=probs))


# -- service mixes (schema v3) ----------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServiceMix:
    """Wrap any workload with a per-request service law plus optional
    deadline / priority draws — the schema-v3 vocabulary for the edge–cloud
    tier (service caches key on ``service``; deadlines become hard SLOs).

    Services are drawn Zipf-style: popularity of the k-th service is
    (k+1)^-skew (skew=0 uniform). ``deadline=(lo, hi)`` attaches a uniform
    relative response budget to a ``deadline_frac`` fraction of requests;
    ``priorities`` is a weight vector over levels 0..len-1. Draws interleave
    deterministically with the inner generator's rng consumption, so the
    same seed still yields the same stream everywhere (materialized batches,
    ``MultiEdgeSim.drive``, recorded traces)."""

    inner: Workload
    num_services: int = 8
    skew: float = 1.0
    deadline: tuple = ()
    deadline_frac: float = 1.0
    priorities: tuple = ()

    def arrivals(self, rng, num_edges, until):
        ranks = np.arange(max(1, self.num_services), dtype=np.float64)
        probs = (ranks + 1.0) ** (-float(self.skew))
        probs = probs / probs.sum()
        prio_w = np.asarray(self.priorities, np.float64)
        if prio_w.size:
            prio_w = prio_w / prio_w.sum()
        for a in self.inner.arrivals(rng, num_edges, until):
            service = int(rng.choice(len(probs), p=probs))
            d = 0.0
            if self.deadline:
                lo, hi = self.deadline
                take = (self.deadline_frac >= 1.0
                        or rng.random() < self.deadline_frac)
                if take:
                    d = float(rng.uniform(lo, hi))
            pr = int(rng.choice(prio_w.size, p=prio_w)) if prio_w.size else 0
            yield dataclasses.replace(a, service=service, deadline=d,
                                      priority=pr)


# -- composition -------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Merged:
    """Superposition of independent workloads (e.g. steady base traffic plus
    a flash-crowd spike). Each component gets its own child generator spawned
    deterministically from the caller's rng, so the merged stream is as
    reproducible as its parts."""

    parts: tuple

    def arrivals(self, rng, num_edges, until):
        streams = []
        for part in self.parts:
            child = np.random.default_rng(int(rng.integers(0, 2**63)))
            streams.append(part.arrivals(child, num_edges, until))
        yield from heapq.merge(*streams)


def merge(*parts: Workload) -> Workload:
    return Merged(parts=tuple(parts))
