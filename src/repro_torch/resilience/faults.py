"""Fault processes for the multi-edge engines: failures, stragglers, jitter.

The host paths of ``repro/resilience/faults.py``, copied in numpy
(held bit for bit by ``tests/test_torch_workloads.py``): a
:class:`FaultSpec` is a pure description (scripted outages, Markov up/down
churn, straggler slowdowns, per-request runtime jitter), and
:func:`materialize_faults` turns it into fixed-shape per-round event
tensors that :func:`attach_faults` / :func:`attach_fault_batch` fold into
a padded arrival batch for the port's engine. The same (spec, num_edges,
num_rounds, seed) names the same fault trajectory in both packages. The
device-resident twins and the event-driven oracle's schedulers are not
ported yet.

Event-tensor layout (R rounds, Q edges), mirroring ``workloads/batch.py``:

    alive (R, Q) bool   edge up-status in effect at scheduling round r
    speed (R, Q) f32    straggler runtime multiplier (1.0 = nominal)

Row ``r`` takes effect at the round-r scheduling instant, wall time
``(r+1) * round_interval``: it governs the dispatch of window-r arrivals
and execution until the next round.

Per-request runtime jitter is keyed by the *global arrival index* (rid),
not by draw order, so a request keeps its jitter across retries:
:func:`jitter_table` builds the rid -> multiplier lookup and
:func:`attach_faults` folds it into the padded arrival batch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.serving.rounds import MIN_JITTER

#: rng-stream salt keeping fault draws disjoint from the workload stream
#: (which uses (seed, 1_000_000_007)) and the cluster prior (seed).
_FAULT_SALT = 416_273_909
_JITTER_SALT = 86_028_121


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault process: everything is per scheduling round.

    Scripted and stochastic parts compose: scripted outages/stragglers are
    applied on top of the Markov draws, and ``min_alive`` is enforced last
    (a failure transition that would leave fewer than ``min_alive`` edges
    up is refused, deterministically in edge order).

    Fields:
      fail_prob / recover_prob      Markov up->down / down->up per round
      scripted_failures             ((edge, start_round, end_round), ...)
                                    edge is down for rounds [start, end)
      rolling                       (start_round, down_rounds): every edge
                                    in turn is down for ``down_rounds``
                                    rounds beginning at ``start_round``
      straggle_prob / straggle_recover_prob   Markov straggler churn
      straggle_factor               runtime multiplier while straggling
      scripted_stragglers           ((edge, start, end, factor), ...)
      jitter_sigma                  lognormal sigma of per-request runtime
                                    jitter (0 = deterministic runtimes)
      min_alive                     floor on simultaneously-alive edges
    """

    fail_prob: float = 0.0
    recover_prob: float = 0.25
    scripted_failures: tuple = ()
    rolling: Optional[tuple] = None
    straggle_prob: float = 0.0
    straggle_recover_prob: float = 0.5
    straggle_factor: float = 4.0
    scripted_stragglers: tuple = ()
    jitter_sigma: float = 0.0
    min_alive: int = 1

    @property
    def has_faults(self) -> bool:
        return bool(self.fail_prob or self.scripted_failures or self.rolling
                    or self.straggle_prob or self.scripted_stragglers
                    or self.jitter_sigma)


def fault_rng(seed: int) -> np.random.Generator:
    """The canonical fault-event stream for ``seed`` (disjoint from the
    workload and cluster streams by salt)."""
    return np.random.default_rng((seed, _FAULT_SALT))


def materialize_faults(spec: FaultSpec, num_edges: int, num_rounds: int,
                       *, seed: int = 0) -> dict:
    """Materialize a fault trajectory as per-round event tensors.

    Returns ``{"alive": (R, Q) bool, "speed": (R, Q) float32}``.
    Deterministic in (spec, num_edges, num_rounds, seed).
    """
    rng = fault_rng(seed)
    alive = np.ones((num_rounds, num_edges), bool)
    speed = np.ones((num_rounds, num_edges), np.float32)

    up = np.ones(num_edges, bool)
    straggling = np.zeros(num_edges, bool)
    for r in range(num_rounds):
        # Markov churn (draw per edge every round so the stream consumed is
        # independent of the current state -> trajectories stay comparable
        # across specs with the same seed)
        u_fail = rng.random(num_edges)
        u_rec = rng.random(num_edges)
        for q in range(num_edges):
            if up[q]:
                if u_fail[q] < spec.fail_prob and up.sum() > spec.min_alive:
                    up[q] = False
            elif u_rec[q] < spec.recover_prob:
                up[q] = True
        u_str = rng.random(num_edges)
        u_strrec = rng.random(num_edges)
        straggling = np.where(
            straggling, u_strrec >= spec.straggle_recover_prob,
            u_str < spec.straggle_prob)
        alive[r] = up
        speed[r] = np.where(straggling, spec.straggle_factor, 1.0)

    # scripted outages / stragglers override the Markov draws
    scripted = list(spec.scripted_failures)
    if spec.rolling is not None:
        start, dur = spec.rolling
        scripted += [(q, start + q * dur, start + (q + 1) * dur)
                     for q in range(num_edges)]
    for q, lo, hi in scripted:
        alive[max(lo, 0):hi, q % num_edges] = False
    for q, lo, hi, factor in spec.scripted_stragglers:
        speed[max(lo, 0):hi, q % num_edges] = factor

    # min_alive floor: refuse the highest-indexed scripted kills last
    for r in range(num_rounds):
        short = spec.min_alive - int(alive[r].sum())
        if short > 0:
            dead = np.flatnonzero(~alive[r])
            alive[r, dead[:short]] = True
    return {"alive": alive, "speed": speed.astype(np.float32)}


def jitter_table(spec: FaultSpec, num_requests: int, *, seed: int = 0
                 ) -> np.ndarray:
    """Per-rid runtime jitter multipliers, lognormal(0, sigma), floored at
    the shared :data:`repro_torch.serving.rounds.MIN_JITTER` contract."""
    if not spec.jitter_sigma:
        return np.ones(num_requests, np.float32)
    rng = np.random.default_rng((seed, _JITTER_SALT))
    j = np.exp(spec.jitter_sigma * rng.standard_normal(num_requests))
    return np.maximum(j, MIN_JITTER).astype(np.float32)


def attach_faults(arrivals: dict, events: dict,
                  jitter_by_rid: Optional[np.ndarray] = None) -> dict:
    """Fold a materialized fault trajectory into a padded arrival batch
    (the dict from ``workloads.batch.materialize_rounds``): adds ``alive``
    and ``speed`` rows plus a per-slot ``jitter`` lookup by rid. The result
    feeds ``engine.make_rollout`` unchanged — the engine switches into
    fault mode when the keys are present."""
    num_rounds = arrivals["mask"].shape[-2]
    if events["alive"].shape[0] < num_rounds:
        raise ValueError(
            f"fault events cover {events['alive'].shape[0]} rounds but the "
            f"arrival batch holds {num_rounds}")
    out = dict(arrivals)
    out["alive"] = events["alive"][:num_rounds]
    out["speed"] = events["speed"][:num_rounds]
    if jitter_by_rid is not None:
        rid = np.asarray(arrivals["rid"])
        table = np.asarray(jitter_by_rid, np.float32)
        jit = table[np.clip(rid, 0, len(table) - 1)]
        out["jitter"] = np.where(np.asarray(arrivals["mask"]), jit,
                                 1.0).astype(np.float32)
    return out


def attach_fault_batch(arrivals: dict, spec: FaultSpec, num_edges: int,
                       *, seeds) -> dict:
    """Batched :func:`attach_faults`: one independent fault trajectory per
    batch element (arrivals (B, R, A) from ``materialize_round_batch``,
    one seed per element)."""
    seeds = list(seeds)
    batch, num_rounds = arrivals["mask"].shape[0], arrivals["mask"].shape[1]
    if len(seeds) != batch:
        raise ValueError(f"{len(seeds)} fault seeds for batch {batch}")
    merged = []
    for i, s in enumerate(seeds):
        one = {k: np.asarray(v[i]) for k, v in arrivals.items()}
        ev = materialize_faults(spec, num_edges, num_rounds, seed=int(s))
        n_rid = int(one["rid"].max()) + 1 if one["mask"].any() else 1
        jit = (jitter_table(spec, n_rid, seed=int(s))
               if spec.jitter_sigma else None)
        merged.append(attach_faults(one, ev, jit))
    return {k: np.stack([m[k] for m in merged]) for k in merged[0]}
