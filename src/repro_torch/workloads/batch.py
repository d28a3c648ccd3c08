"""Materialize arrival streams into padded per-round batches for the
array-native engine (:mod:`repro_torch.serving.engine`).

The host paths of ``repro/workloads/batch.py``, copied: the reference
module imports jax at its top, so the port copies these functions rather
than the module (held bit for bit by ``tests/test_torch_workloads.py``).
The device-resident sampler (``materialize_round_batch_device``) is not
ported yet.

The engine schedules in fixed rounds: round ``r`` (0-indexed) fires at
``(r+1) * round_interval`` and schedules every arrival in the window
``(r*dt, (r+1)*dt]``. :func:`materialize_rounds` buckets a
:class:`Workload`'s stream into those windows and pads each to a fixed
width, yielding the dict of (R, A) arrays ``make_rollout`` steps over:

    t    (R, A) f32   arrival times (submit timestamps)
    src  (R, A) i32   source edge per arrival
    size (R, A) f32   data size per arrival
    mask (R, A) bool  True for real arrivals
    rid  (R, A) i32   global arrival index in time order
    service  (R, A) i32  service id per arrival (cache key; 0 default)
    deadline (R, A) f32  absolute hard-SLO time (arrival.t + relative
                      budget); DEADLINE_INF for requests with no deadline
    priority (R, A) f32  importance level (0 default)
    dropped (R,) i32  arrivals clipped from each round by the overflow
                      policy (always 0 with overflow='error'); the engine
                      folds these into its drop accounting

The stream is drawn from ``workload_rng(seed)``, so the same (workload,
seed) materializes the same arrivals in both packages.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.workloads.base import Workload, workload_rng

# "No deadline" sentinel in materialized tensors: matches the engine's INF
# (serving.engine.INF) so deadline comparisons stay trivially false in f32.
DEADLINE_INF = 1e30


def _bucketize(workload: Workload, num_edges: int, num_rounds: int,
               round_interval: float, seed: int,
               rng: Optional[np.random.Generator]) -> list[list]:
    until = num_rounds * round_interval
    rng = workload_rng(seed) if rng is None else rng
    buckets: list[list] = [[] for _ in range(num_rounds)]
    rid = 0
    for a in workload.arrivals(rng, num_edges, until):
        if not 0 <= a.edge < num_edges:
            raise ValueError(f"arrival at t={a.t} targets edge {a.edge}, "
                             f"outside 0..{num_edges - 1}")
        # Round windows are (r*dt, (r+1)*dt] over (0, until]; an arrival
        # outside them has no round to fire in, and silently clamping it
        # into row 0 / row R-1 would rewrite its submit time's window (the
        # engine would schedule it rounds away from when it arrived).
        if not 0 < a.t <= until:
            raise ValueError(
                f"arrival at t={a.t} falls outside the scheduling horizon "
                f"(0, {until}] covered by {num_rounds} round(s) of "
                f"{round_interval}; generators must emit 0 < t <= until")
        row = int(np.ceil(a.t / round_interval)) - 1  # window (r*dt, (r+1)*dt]
        # clamp only against float rounding at the window edges (t == until
        # ceil-ing one past R-1, denormal t flooring to -1) — real
        # out-of-horizon arrivals were rejected above
        row = min(max(row, 0), num_rounds - 1)
        deadline = a.t + a.deadline if a.deadline > 0 else DEADLINE_INF
        buckets[row].append((a.t, a.edge, a.size, rid, a.service, deadline,
                             a.priority))
        rid += 1
    return buckets


def _pack(buckets: list[list], width: int, overflow: str) -> dict:
    num_rounds = len(buckets)
    out = {
        "t": np.zeros((num_rounds, width), np.float32),
        "src": np.zeros((num_rounds, width), np.int32),
        "size": np.zeros((num_rounds, width), np.float32),
        "mask": np.zeros((num_rounds, width), bool),
        "rid": np.zeros((num_rounds, width), np.int32),
        "service": np.zeros((num_rounds, width), np.int32),
        "deadline": np.full((num_rounds, width), DEADLINE_INF, np.float32),
        "priority": np.zeros((num_rounds, width), np.float32),
        "dropped": np.zeros(num_rounds, np.int32),
    }
    for r, row in enumerate(buckets):
        if len(row) > width:
            if overflow == "error":
                raise ValueError(
                    f"round {r} holds {len(row)} arrivals but max_per_round "
                    f"is {width}; raise max_per_round or pass "
                    f"overflow='clip'")
            out["dropped"][r] = len(row) - width
            row = row[:width]  # overflow == "clip": drop the tail
        for j, (t, edge, size, rid, service, deadline, prio) in enumerate(row):
            out["t"][r, j] = t
            out["src"][r, j] = edge
            out["size"][r, j] = size
            out["rid"][r, j] = rid
            out["service"][r, j] = service
            out["deadline"][r, j] = deadline
            out["priority"][r, j] = prio
            out["mask"][r, j] = True
    return out


def materialize_rounds(workload: Workload, num_edges: int, num_rounds: int,
                       round_interval: float, *, seed: int = 0,
                       rng: Optional[np.random.Generator] = None,
                       max_per_round: Optional[int] = None,
                       overflow: str = "error") -> dict:
    """Bucket one workload's arrivals over [0, num_rounds * round_interval]
    into padded per-round arrays (see module docstring for the layout).

    ``max_per_round=None`` sizes the width to the busiest round. With an
    explicit width, a busier round raises (``overflow='error'``) or drops
    the excess arrivals (``overflow='clip'`` — acceptable for RL training
    batches, never for equivalence tests).
    """
    if overflow not in ("error", "clip"):
        raise ValueError(f"unknown overflow policy {overflow!r}")
    buckets = _bucketize(workload, num_edges, num_rounds, round_interval,
                         seed, rng)
    width = (max(1, max(len(b) for b in buckets)) if max_per_round is None
             else int(max_per_round))
    return _pack(buckets, width, overflow)


def materialize_round_batch(workload: Workload, num_edges: int,
                            num_rounds: int, round_interval: float,
                            batch: int, *, base_seed: int = 0,
                            max_per_round: Optional[int] = None,
                            overflow: str = "error") -> dict:
    """Stack ``batch`` independent materializations (seeds base_seed + i)
    into (B, R, A) arrays for the vmapped engine. With ``max_per_round=None``
    every element is padded to the batch-wide busiest round."""
    if overflow not in ("error", "clip"):
        raise ValueError(f"unknown overflow policy {overflow!r}")
    all_buckets = [
        _bucketize(workload, num_edges, num_rounds, round_interval,
                   base_seed + i, None)
        for i in range(batch)
    ]
    width = (max(1, max(len(b) for bs in all_buckets for b in bs))
             if max_per_round is None else int(max_per_round))
    packed = [_pack(bs, width, overflow) for bs in all_buckets]
    return {k: np.stack([p[k] for p in packed]) for k in packed[0]}
