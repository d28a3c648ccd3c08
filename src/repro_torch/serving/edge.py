"""Edge executors for the multi-edge cooperative serving runtime: a numpy
copy of ``repro/serving/edge.py`` for the port.

``SimEdge`` models one edge: hidden true performance (phi coefficients the
scheduler never sees), zeta parallel service replicas (the paper's
Docker/K8s replica observation, §III-C), the five request queues of Fig. 5,
and an online :class:`PhiEstimator` fitted purely from local history —
exactly the paper's system-level state evaluation model. The estimator
keeps the reference's rule (``flat_fit=False``: a window whose slope is not
positive keeps the last coefficients), the rule the rollout engine's
``learn_phi`` refit follows too, so the port's oracle, the port's engine
and the reference's oracle fit phi alike.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.state import (EdgeServiceState, PhiEstimator,
                                    QueuedRequest)
from repro_torch.serving.rounds import service_runtime


@dataclasses.dataclass
class SimEdge:
    edge_id: int
    coords: tuple
    true_a: float                 # hidden: runtime = true_a * size + true_b
    true_b: float
    replicas: int
    rng: np.random.Generator
    noise: float = 0.02
    speed_factor: float = 1.0     # >1 = straggler (slowed edge)
    alive: bool = True
    phi_oracle: bool = False      # pin the estimator to the true coefficients
    # Optional injected jitter, keyed by rid (rid -> multiplier). Set by
    # resilience.faults.schedule_into_sim so both engines realize the same
    # per-request noise (a retried request keeps its jitter); replaces the
    # edge-local gaussian noise draw when present.
    jitter_fn: Optional[object] = None

    def __post_init__(self):
        phi = (PhiEstimator(a=self.true_a, b=self.true_b, frozen=True)
               if self.phi_oracle
               else PhiEstimator(a=1.0, b=0.0, flat_fit=False))
        self.state = EdgeServiceState(
            edge_id=self.edge_id,
            coords=self.coords,
            phi=phi,
            replicas=self.replicas,
        )
        # replica lanes: next-free times
        self._lanes = [0.0] * self.replicas
        self.completed: list[QueuedRequest] = []
        self.inflight: dict[int, QueuedRequest] = {}

    # -- execution -----------------------------------------------------

    def true_runtime(self, size: float, rid: Optional[int] = None,
                     warmup: float = 0.0) -> float:
        if self.jitter_fn is not None and rid is not None:
            jitter = float(self.jitter_fn(rid))
        else:
            jitter = 1.0 + self.noise * float(self.rng.standard_normal())
        return float(service_runtime(self.true_a, self.true_b, size,
                                     speed=self.speed_factor, jitter=jitter,
                                     warmup=warmup))

    def start_executable(self, now: float) -> list[tuple[float, QueuedRequest]]:
        """Pop requests from Q^le onto free replica lanes.

        Returns (finish_time, request) events. The lane model reproduces
        eq (1)'s zeta-way parallel service."""
        events = []
        while self.state.q_le and min(self._lanes) <= now + 1e-12 and self.alive:
            lane = int(np.argmin(self._lanes))
            req = self.state.q_le.pop(0)
            rt = self.true_runtime(req.data_size, rid=req.rid,
                                   warmup=req.miss_penalty)
            start = max(now, self._lanes[lane])
            self._lanes[lane] = start + rt
            req.start_time = start
            req.finish_time = start + rt
            # local learning for phi (paper §III-C1: only local history)
            self.state.phi.observe(req.data_size, rt)
            self.inflight[req.rid] = req
            events.append((req.finish_time, req))
        return events

    def next_free(self) -> float:
        return min(self._lanes)

    def fail(self) -> list[QueuedRequest]:
        """Edge failure: return every unfinished request (queued AND mid-
        execution) for re-dispatch; replica lanes die with the edge."""
        self.alive = False
        orphans = (list(self.state.q_le) + list(self.state.q_in)
                   + list(self.state.q_r) + list(self.inflight.values()))
        # canonical re-admission order (global arrival order), so failover
        # tie-breaks match the batched engine's slot order
        orphans.sort(key=lambda r: r.rid)
        self.state.q_le.clear()
        self.state.q_in.clear()
        self.state.q_r.clear()
        self.inflight.clear()
        return orphans

    def recover(self, now: float) -> None:
        self.alive = True
        self._lanes = [now] * self.replicas
