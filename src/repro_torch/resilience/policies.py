"""Resilience mechanisms as tensor ops on engine state, batched over a
leading instance axis; counterpart of ``repro/resilience/policies.py``.

Three mechanisms, driven from ``serving/engine.py::step_round`` when a
:class:`ResilienceConfig` is set on the engine config:

* **Admission control**: per-request admit/shed at dispatch time.
  ``slo_threshold`` sheds requests whose estimated response exceeds a
  bound; ``queue_depth`` sheds when the target edge's backlog is too deep;
  ``admission="policy"`` takes the policy's admission head (the assign
  fn's second output).
* **Circuit breaking**: an edge that dies trips a breaker with an
  exponentially growing cooldown; while open the edge is masked out of the
  dispatch instance, and when the cooldown lapses the breaker is half-open:
  at most ``breaker_probe`` requests per round may probe it until it has
  stayed healthy for ``breaker_reset_rounds`` rounds.
* **Retry with backoff**: requests orphaned by an edge failure are
  re-admitted at the nearest alive edge (:func:`nearest_alive`); with
  ``retry_backoff_rounds > 0`` each successive retry of the same request
  waits an exponentially growing number of rounds.

Every function takes any leading batch shape: per-edge arrays are
(..., Q), per-request arrays (..., A), distance matrices (..., Q, Q).
The module imports nothing from ``repro_torch.serving``, which keeps the
package import graph acyclic.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Resilience mechanisms toggled on an ``EngineConfig``.

    ``admission`` selects the shed rule: ``"none"`` (admit everything),
    ``"slo_threshold"`` / ``"queue_depth"`` (heuristics below), or
    ``"policy"`` (the assign fn supplies an admit mask; the engine falls
    back to admit-all if it returns only assignments). ``slo`` is the
    response-time objective used for violation metrics and the
    slo_threshold heuristic's default bound."""

    admission: str = "none"
    admit_threshold: float = 0.0   # slo_threshold bound; 0 -> use ``slo``
    queue_depth: float = 2.0       # max per-replica backlog (phi-seconds)
    slo: float = 3.0               # response-time SLO (seconds)
    retry_backoff_rounds: float = 0.0
    retry_backoff_cap: int = 6
    breaker: bool = False
    breaker_cooldown_rounds: float = 2.0
    breaker_backoff_cap: int = 4
    breaker_reset_rounds: int = 4
    breaker_probe: int = 1

    def __post_init__(self):
        if self.admission not in ("none", "slo_threshold", "queue_depth",
                                  "policy"):
            raise ValueError(f"unknown admission rule {self.admission!r}")


def _rows(w, idx):
    """w[..., idx, :]: (..., K, Q) distance rows of the indices (..., K)."""
    idx = idx.long()
    return torch.gather(w, -2, idx[..., None].expand(*idx.shape, w.shape[-1]))


def _pick(x, idx):
    """x[..., idx]: per-request values of a per-edge array (..., Q)."""
    return torch.gather(x, -1, idx.long())


def nearest_alive(w, alive, idx):
    """Failover target per index: the nearest alive edge by distance row
    ``w[idx]`` (itself when alive, w's diagonal being zero). Distance ties
    resolve to the lowest edge index (``torch.argmin`` returns the first
    minimum), as in ``repro_torch.serving.topology.nearest_alive_edge``.
    ``alive`` must have at least one edge up."""
    d = torch.where(alive[..., None, :], _rows(w, idx), torch.inf)
    return torch.argmin(d, dim=-1).to(torch.int32)


def est_response(inst, assign):
    """Cheap response-time estimate for dispatching each pending request to
    its assigned edge, from what a real CC knows: the eq (2) transfer
    delay, the target's per-replica backlog (c_le + c_in workload features)
    and the phi-estimate execution time."""
    assign = assign.long()
    src = inst["req_src"].long()
    size = inst["req_size"]
    dist = torch.gather(_rows(inst["w"], src), -1, assign[..., None])[..., 0]
    transfer = torch.where(assign == src, 0.0,
                           inst["ct"][..., None] * size * dist)
    wl = inst["workload"]
    backlog = _pick(wl[..., 0] + wl[..., 1], assign)
    phi = inst["phi"]
    exec_t = _pick(phi[..., 0], assign) * size + _pick(phi[..., 1], assign)
    return transfer + backlog + exec_t


def admission_mask(res: ResilienceConfig, inst, assign):
    """Heuristic admit mask (..., A) bool for this round's pending requests.
    ``"policy"`` admission is decided by the policy head, not here."""
    if res.admission in ("none", "policy"):
        return torch.ones_like(inst["req_mask"])
    if res.admission == "slo_threshold":
        bound = res.admit_threshold if res.admit_threshold > 0 else res.slo
        return est_response(inst, assign) <= bound
    # queue_depth: shed when the target's backlog is already too deep
    wl = inst["workload"]
    return _pick(wl[..., 0] + wl[..., 1], assign) <= res.queue_depth


# -- circuit breaker ---------------------------------------------------------


def breaker_step(open_until, trips, healthy, died, alive, t, dt,
                 res: ResilienceConfig):
    """One round of breaker bookkeeping at fault-application time ``t``
    (broadcastable to the per-edge arrays, e.g. (B, 1)).

    A death trips the breaker with cooldown ``cooldown * 2^(trips-1)``
    rounds (capped); an edge that is alive with a lapsed cooldown counts a
    healthy round, and ``breaker_reset_rounds`` consecutive healthy rounds
    reset its trip counter (half-open -> closed)."""
    trips = trips + died.to(torch.float32)
    backoff = torch.exp2(torch.clamp(trips - 1.0, 0.0,
                                     float(res.breaker_backoff_cap)))
    cooldown = res.breaker_cooldown_rounds * dt * backoff
    open_until = torch.where(died, t + cooldown, open_until)
    healthy = torch.where(alive & (t >= open_until), healthy + 1.0, 0.0)
    trips = torch.where(healthy >= res.breaker_reset_rounds, 0.0, trips)
    return open_until, trips, healthy


def dispatch_mask(alive, open_until, t):
    """Edges eligible for dispatch: alive with no open breaker (``t``
    broadcastable to the per-edge arrays). Falls back to plain liveness
    where every alive edge is behind an open breaker (the system must keep
    serving)."""
    m = alive & (t >= open_until)
    return torch.where(m.any(-1, keepdim=True), m, alive)


def probe_cap(w, assign, req_mask, src, half_open, closed,
              res: ResilienceConfig):
    """Cap dispatches to half-open edges at ``breaker_probe`` per round:
    excess requests fail over to the nearest fully-closed edge (in slot
    order, so the first arrivals get the probes). No-op where no closed
    edge exists."""
    assign = assign.to(torch.int32)
    num_edges = w.shape[-1]
    edges = torch.arange(num_edges, device=assign.device)
    onehot = ((assign[..., :, None] == edges) & req_mask[..., :, None])
    nth = torch.gather(torch.cumsum(onehot.to(torch.int32), dim=-2), -1,
                       assign.long()[..., None])[..., 0]
    over = _pick(half_open, assign) & (nth > res.breaker_probe) & req_mask
    fallback = nearest_alive(w, closed, src)
    return torch.where(over & closed.any(-1, keepdim=True), fallback, assign)
