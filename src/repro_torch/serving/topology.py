"""Cluster-topology helpers shared by the simulator, the central controller,
and the workload driver — including the edge–cloud tier description.

A numpy copy of ``repro/serving/topology.py`` (held bit for bit by
``tests/test_torch_workloads.py``).

Topology with a cloud tier (``CloudSpec``)::

        clients ──► edge 0 ──┐
        clients ──► edge 1 ──┤   LAN: delay = ct * size * w[i, j]
           ...               ├──────────────────────────────────────┐
        clients ──► edge Q-1─┘                                      │
                                                                    ▼
                              WAN: delay = wan_rtt + ct * size * wan_dist
                                                                    │
                                                              ┌─────▼─────┐
                                                              │   cloud   │
                                                              │ lanes >> m│
                                                              │ all-hit $ │
                                                              └───────────┘

The cloud is one extra node (index Q) appended to every per-node array:
requests never *arrive* there, but any request may be dispatched there.
Its transfer law adds a fixed WAN round-trip ``wan_rtt`` on top of the
size-proportional term (eq 2 with distance ``wan_dist``), its service law
is its own phi line (``phi_a * size + phi_b``), and its capacity is
elastic — ``lanes`` parallel service lanes vs. an edge's few replicas. Its
service cache is the origin store: always a hit (see serving/cache.py).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class CloudSpec:
    """The cloud tier's transfer/runtime laws (see module docstring).

    wan_rtt   fixed WAN round-trip seconds added to every edge→cloud
              transfer (independent of size; the speed-of-light + peering
              floor a LAN hop doesn't pay).
    wan_dist  effective transmission distance of the WAN link — the
              size-proportional bandwidth term (eq 2's w) between every
              edge and the cloud.
    lanes     parallel service lanes (elastic capacity; an edge has
              ``replicas`` ∈ [1, replicas_high], the cloud has many).
    phi_a/b   the cloud's service-runtime line phi(size) = a*size + b.
    coords    nominal unit-square coordinates (only feeds the policy's
              edge-coordinate features; WAN costs ignore geometry).
    """

    wan_rtt: float = 0.5
    wan_dist: float = 2.0
    lanes: int = 16
    phi_a: float = 0.2
    phi_b: float = 0.05
    coords: tuple = (0.5, 0.5)


def nearest_alive_edge(w: np.ndarray, src: int,
                       alive: Sequence[bool]) -> int:
    """Nearest alive edge to ``src`` by transmission distance ``w[src]``
    (``src`` itself when alive, since w[src, src] == 0). This is the single
    failover rule used everywhere a request references a dead edge: client
    arrivals, orphan re-dispatch, and controller source remapping.

    Raises ``RuntimeError`` when the whole cluster is down.
    """
    for cand in np.argsort(w[src], kind="stable"):
        if alive[cand]:
            return int(cand)
    raise RuntimeError("no alive edges")
