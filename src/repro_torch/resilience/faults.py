"""Fault processes for the multi-edge engines: failures, stragglers, jitter.

The host paths of ``repro/resilience/faults.py``, copied in numpy
(held bit for bit by ``tests/test_torch_workloads.py``): a
:class:`FaultSpec` is a pure description (scripted outages, Markov up/down
churn, straggler slowdowns, per-request runtime jitter), and
:func:`materialize_faults` turns it into fixed-shape per-round event
tensors that :func:`attach_faults` / :func:`attach_fault_batch` fold into
a padded arrival batch for the port's engine. The same (spec, num_edges,
num_rounds, seed) names the same fault trajectory in both packages. The
device twins (:func:`materialize_faults_device`,
:func:`attach_fault_batch_device`) draw the same laws with torch on a
generator's device, for training episodes that never leave the card.
:func:`schedule_into_sim` realizes the same rows as fail/recover/straggle
events on the event-driven oracle (``serving/simulator.py``).

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
import torch

#: Oracle-side fault event offset past the round boundary: after the
#: window's arrivals (t <= boundary), before the CC round at boundary+1e-9.
FAULT_EPS = 5e-10

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
    from repro_torch.serving.rounds import MIN_JITTER

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


# -- device-resident fault materialization (torch generators) -----------------

def _scripted_overrides(spec: FaultSpec, num_edges: int,
                        num_rounds: int) -> tuple:
    """Static (host numpy) parts of a fault trajectory: scripted/rolling
    outage masks and scripted straggler overrides, identical to the
    override pass in :func:`materialize_faults`."""
    alive_ok = np.ones((num_rounds, num_edges), bool)
    scripted = list(spec.scripted_failures)
    if spec.rolling is not None:
        start, dur = spec.rolling
        scripted += [(q, start + q * dur, start + (q + 1) * dur)
                     for q in range(num_edges)]
    for q, lo, hi in scripted:
        alive_ok[max(lo, 0):hi, q % num_edges] = False
    speed_mask = np.zeros((num_rounds, num_edges), bool)
    speed_val = np.ones((num_rounds, num_edges), np.float32)
    for q, lo, hi, factor in spec.scripted_stragglers:
        speed_mask[max(lo, 0):hi, q % num_edges] = True
        speed_val[max(lo, 0):hi, q % num_edges] = factor
    return alive_ok, speed_mask, speed_val


def materialize_faults_device(spec: FaultSpec, num_edges: int,
                              num_rounds: int, *, batch: int,
                              generator: torch.Generator) -> dict:
    """Device twin of :func:`materialize_faults` for ``batch`` independent
    trajectories at once, on ``generator``'s device: the same fault laws
    (Markov fail/recover with the min_alive refusal in edge order,
    straggler churn, scripted/rolling overrides, the min_alive floor).
    Returns ``{"alive": (B, R, Q) bool, "speed": (B, R, Q) float32}``.
    Distributionally equivalent to the host path, not draw for draw.

    The Markov step stays sequential in edge order, as on the host: each
    edge's failure sees the up-count that the earlier edges left. Only the
    batch is vectorised."""
    device = generator.device
    Q, R, B = num_edges, num_rounds, batch
    alive_ok, spd_mask, spd_val = (
        torch.as_tensor(x, device=device)
        for x in _scripted_overrides(spec, Q, R))
    # u_fail, u_rec, u_str, u_strrec for every round in one draw
    u = torch.rand((4, B, R, Q), generator=generator, device=device)
    up = torch.ones((B, Q), dtype=torch.bool, device=device)
    straggling = torch.zeros((B, Q), dtype=torch.bool, device=device)
    alive, speed = [], []
    for r in range(R):
        if spec.fail_prob:
            for q in range(Q):
                upq = up[:, q]
                can_fail = (upq & (u[0, :, r, q] < spec.fail_prob)
                            & (up.sum(-1) > spec.min_alive))
                rec = ~upq & (u[1, :, r, q] < spec.recover_prob)
                up = up.clone()
                up[:, q] = torch.where(can_fail, False,
                                       torch.where(rec, True, upq))
        if spec.straggle_prob:
            straggling = torch.where(
                straggling, u[3, :, r] >= spec.straggle_recover_prob,
                u[2, :, r] < spec.straggle_prob)
        row = up & alive_ok[r]
        # min_alive floor: revive the lowest-indexed dead edges
        short = spec.min_alive - row.sum(-1, keepdim=True)
        dead_rank = torch.cumsum(~row, -1)    # 1-based rank among dead
        row = row | (~row & (dead_rank <= short))
        speed_row = torch.where(straggling, spec.straggle_factor, 1.0)
        speed_row = torch.where(spd_mask[r], spd_val[r], speed_row)
        alive.append(row)
        speed.append(speed_row.to(torch.float32))
    return {"alive": torch.stack(alive, 1), "speed": torch.stack(speed, 1)}


def attach_fault_batch_device(arrivals: dict, spec: FaultSpec,
                              num_edges: int,
                              generator: torch.Generator) -> dict:
    """Device twin of :func:`attach_fault_batch`: one independent fault
    trajectory per batch element, drawn on ``generator``'s device, plus
    per-slot runtime jitter drawn directly per slot (floored at
    ``MIN_JITTER``; padding gets 1). Retries reuse the engine's stored
    ``slot_jitter``, so a per-slot draw realizes the same law as the host's
    rid-keyed table without materializing it. ``arrivals`` is the (B, R, A)
    batch of :func:`repro_torch.workloads.batch.materialize_round_batch_device`
    (or the host sampler's arrays); the result is tensors on the
    generator's device."""
    from repro_torch.serving.rounds import MIN_JITTER

    device = generator.device
    out = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor)
                              else v).to(device)
           for k, v in arrivals.items()}
    mask = out["mask"]
    batch, num_rounds = mask.shape[0], mask.shape[1]
    out.update(materialize_faults_device(spec, num_edges, num_rounds,
                                         batch=batch, generator=generator))
    if spec.jitter_sigma:
        n = torch.randn(mask.shape, generator=generator, device=device)
        j = torch.exp(spec.jitter_sigma * n)
        out["jitter"] = torch.where(mask, torch.clamp(j, min=MIN_JITTER),
                                    1.0).to(torch.float32)
    return out


def fault_events_from_rows(events: dict, round_interval: float) -> tuple:
    """Flatten materialized per-round event tensors into the absolute-time
    :class:`repro_torch.workloads.trace.FaultEvent` timeline a v2 trace
    records: one event per alive/speed *transition*, stamped at the round
    boundary it takes effect (``(r+1)*dt + FAULT_EPS``)."""
    from repro_torch.workloads.trace import FaultEvent

    alive, speed = np.asarray(events["alive"]), np.asarray(events["speed"])
    num_rounds, num_edges = alive.shape
    prev_alive = np.ones(num_edges, bool)
    prev_speed = np.ones(num_edges, np.float32)
    out = []
    for r in range(num_rounds):
        t = (r + 1) * round_interval + FAULT_EPS
        # within a round: recoveries, then speed changes, then failures —
        # a fail event's orphan failover must see every same-round recovery
        # already applied (the batched engine applies the row atomically)
        for q in range(num_edges):
            if not prev_alive[q] and alive[r, q]:
                out.append(FaultEvent(t=t, kind="recover", edge=q))
        for q in range(num_edges):
            if speed[r, q] != prev_speed[q]:
                out.append(FaultEvent(t=t, kind="straggle", edge=q,
                                      factor=float(speed[r, q])))
        for q in range(num_edges):
            if prev_alive[q] and not alive[r, q]:
                out.append(FaultEvent(t=t, kind="fail", edge=q))
        prev_alive, prev_speed = alive[r], speed[r]
    return tuple(out)


def schedule_fault_events(sim, fault_events) -> None:
    """Push a :class:`FaultEvent` timeline (e.g. from a v2 trace's
    ``fault_events``) onto a ``MultiEdgeSim``."""
    for ev in fault_events:
        if ev.kind == "fail":
            sim.fail_edge(ev.edge, ev.t)
        elif ev.kind == "recover":
            sim.recover_edge(ev.edge, ev.t)
        else:
            sim.set_straggler(ev.edge, float(ev.factor), ev.t)


def schedule_into_sim(sim, events: dict, round_interval: float,
                      jitter_by_rid: Optional[np.ndarray] = None) -> None:
    """Realize a materialized fault trajectory on a ``MultiEdgeSim``: push
    fail/recover/straggle events at ``(r+1)*dt + FAULT_EPS`` (row r takes
    effect at the round-r scheduling instant, exactly as in the batched
    engine) and pin per-request jitter to the shared rid table."""
    schedule_fault_events(sim, fault_events_from_rows(events, round_interval))
    if jitter_by_rid is not None:
        table = np.asarray(jitter_by_rid, np.float32)

        def fn(rid, _table=table):
            return float(_table[min(int(rid), len(_table) - 1)])

        for e in sim.edges:
            e.jitter_fn = fn
