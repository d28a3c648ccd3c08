"""Composable arrival-process generators behind the :class:`Workload` protocol.

A numpy copy of ``repro/workloads/processes.py``: the same seed draws the
same arrivals in both packages (held bit for bit by
``tests/test_torch_workloads.py``).

Each generator is a frozen dataclass (a pure description — cheap to build,
hashable, trivially loggable) whose ``arrivals(rng, num_edges, until)``
yields time-ordered :class:`Arrival` events. Rates are *system-wide*
expected arrivals per unit time; per-edge placement is controlled by
``edge_skew``/``hot_edge`` (Zipf popularity, see base.edge_weights).

Processes:
  PoissonArrivals        homogeneous Poisson(rate)
  InhomogeneousPoisson   rate(t) via Lewis-Shedler thinning
  DiurnalArrivals        sinusoidal rate (day/night cycle)
  FlashCrowdArrivals     steady base + a multiplier spike window at one edge
  MMPPArrivals           Markov-modulated Poisson (bursty regime switching)
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.workloads.base import (Arrival, SizeSpec, edge_weights,
                                        merge, pick_edge)


def _emit(rng, t, probs, sizes: SizeSpec, service: int) -> Arrival:
    return Arrival(t=float(t), edge=pick_edge(rng, probs),
                   size=sizes.sample_one(rng), service=service)


@dataclasses.dataclass(frozen=True)
class PoissonArrivals:
    """Homogeneous Poisson process: exponential(1/rate) inter-arrivals."""

    rate: float = 20.0
    sizes: SizeSpec = SizeSpec()
    edge_skew: float = 0.0
    hot_edge: int = 0
    service: int = 0

    def arrivals(self, rng, num_edges, until):
        probs = edge_weights(num_edges, self.edge_skew, self.hot_edge)
        t = 0.0
        while True:
            t += rng.exponential(1.0 / self.rate)
            if t > until:
                return
            yield _emit(rng, t, probs, self.sizes, self.service)


@dataclasses.dataclass(frozen=True)
class InhomogeneousPoisson:
    """Poisson process with time-varying ``rate_fn(t)`` <= ``rate_max``,
    sampled by Lewis-Shedler thinning: candidates at rate_max, kept with
    probability rate_fn(t)/rate_max."""

    rate_fn: Callable[[float], float]
    rate_max: float
    sizes: SizeSpec = SizeSpec()
    edge_skew: float = 0.0
    hot_edge: int = 0
    service: int = 0

    def arrivals(self, rng, num_edges, until):
        probs = edge_weights(num_edges, self.edge_skew, self.hot_edge)
        t = 0.0
        while True:
            t += rng.exponential(1.0 / self.rate_max)
            if t > until:
                return
            keep = rng.uniform() * self.rate_max
            if keep <= max(0.0, float(self.rate_fn(t))):
                yield _emit(rng, t, probs, self.sizes, self.service)


@dataclasses.dataclass(frozen=True)
class DiurnalArrivals:
    """Sinusoidal day/night cycle: rate(t) = base*(1 + amplitude*sin(...))."""

    base_rate: float = 20.0
    amplitude: float = 0.8          # in [0, 1]: 0 = flat, 1 = full swing
    period: float = 4.0
    phase: float = 0.0
    sizes: SizeSpec = SizeSpec()
    edge_skew: float = 0.0
    hot_edge: int = 0
    service: int = 0

    def rate(self, t: float) -> float:
        return self.base_rate * (
            1.0 + self.amplitude * np.sin(2.0 * np.pi * t / self.period
                                          + self.phase))

    def arrivals(self, rng, num_edges, until):
        inner = InhomogeneousPoisson(
            rate_fn=self.rate,
            rate_max=self.base_rate * (1.0 + abs(self.amplitude)),
            sizes=self.sizes, edge_skew=self.edge_skew,
            hot_edge=self.hot_edge, service=self.service)
        yield from inner.arrivals(rng, num_edges, until)


@dataclasses.dataclass(frozen=True)
class FlashCrowdArrivals:
    """Steady base traffic plus a flash crowd: during
    [spike_start, spike_start+spike_duration] an *extra* stream of
    (multiplier-1)*base_rate concentrates on ``spike_edge``."""

    base_rate: float = 20.0
    multiplier: float = 10.0
    spike_start: float = 1.0
    spike_duration: float = 0.5
    spike_edge: int = 0
    sizes: SizeSpec = SizeSpec()
    edge_skew: float = 0.0
    service: int = 0

    def arrivals(self, rng, num_edges, until):
        t0, t1 = self.spike_start, self.spike_start + self.spike_duration
        spike_rate = max(0.0, (self.multiplier - 1.0) * self.base_rate)
        base = PoissonArrivals(rate=self.base_rate, sizes=self.sizes,
                               edge_skew=self.edge_skew, service=self.service)
        spike = InhomogeneousPoisson(
            rate_fn=lambda t: spike_rate if t0 <= t <= t1 else 0.0,
            rate_max=max(spike_rate, 1e-9),
            sizes=self.sizes, edge_skew=64.0,   # ~all spike traffic on one edge
            hot_edge=self.spike_edge, service=self.service)
        yield from merge(base, spike).arrivals(rng, num_edges, until)


@dataclasses.dataclass(frozen=True)
class MMPPArrivals:
    """Markov-modulated Poisson process: the rate switches between hidden
    states (e.g. calm/burst) with exponential sojourn times. The classic
    bursty-traffic model from the edge-scheduling literature."""

    rates: tuple = (5.0, 80.0)          # per-state arrival rate
    mean_sojourn: tuple = (2.0, 0.25)   # per-state expected dwell time
    start_state: int = 0
    sizes: SizeSpec = SizeSpec()
    edge_skew: float = 0.0
    hot_edge: int = 0
    service: int = 0

    def arrivals(self, rng, num_edges, until):
        n = len(self.rates)
        assert n == len(self.mean_sojourn) >= 1
        probs = edge_weights(num_edges, self.edge_skew, self.hot_edge)
        state = self.start_state % n
        t = 0.0
        while t < until:
            dwell = rng.exponential(self.mean_sojourn[state])
            t_end = min(t + dwell, until)
            rate = self.rates[state]
            if rate > 0:
                while True:
                    t += rng.exponential(1.0 / rate)
                    if t > t_end:
                        break
                    yield _emit(rng, t, probs, self.sizes, self.service)
            t = t_end
            if n == 2:
                state = 1 - state       # alternation IS the 2-state chain
            elif n > 2:                 # uniform jump to any *other* state
                state = int(rng.choice([s for s in range(n) if s != state]))
