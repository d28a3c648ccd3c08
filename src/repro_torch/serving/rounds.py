"""Round semantics shared by the two serving engines.

A numpy copy of ``repro/serving/rounds.py``: the port's engine builds its
clusters through the same :func:`sample_cluster`, so (cfg, seed) names the
same cluster in both packages (held bit for bit by
``tests/test_torch_workloads.py``).

The event-driven oracle (:class:`repro.serving.simulator.MultiEdgeSim`) and
the array-native batched engine (:mod:`repro.serving.engine`) implement the
same physical model; this module is the single home for the pieces both
must agree on bit-for-bit:

* :func:`sample_cluster` — the cluster prior (coords, distances, hidden phi
  coefficients, replica counts) with a *pinned rng call order*, so the two
  engines built from the same seed simulate the same cluster.
* :func:`transfer_delay` / :func:`exec_time` / :func:`service_runtime` —
  eq (2)'s transmission cost and the affine service model with the
  straggler speed factor and the runtime floor.

The lane model itself (zeta parallel replicas, work-conserving FIFO by
data-ready time) is what makes the engines equivalent: a request's start
time is ``max(ready, earliest lane free)`` processed in ready order. The
oracle realizes it with heap events and cascading ``start_executable``
calls; the engine realizes it with a ``lax.scan`` over slots sorted by
ready time (it mirrors :func:`service_runtime` in jnp — constants here are
the contract, pinned by a cross-engine test).
"""
from __future__ import annotations

import dataclasses

import numpy as np

#: Execution times are floored here so a zero-size request still occupies a
#: replica lane for a nonzero interval (keeps the event heap ordered).
MIN_RUNTIME = 1e-6

#: Straggler jitter multipliers are floored here (a noisy draw may not make
#: an edge more than 10x faster than its mean).
MIN_JITTER = 0.1


@dataclasses.dataclass(frozen=True)
class ClusterParams:
    """One sampled cluster: everything both engines derive from the seed."""

    coords: np.ndarray      # (Q, 2) edge positions, U(0,1)^2
    w: np.ndarray           # (Q, Q) pairwise transmission distances
    true_a: np.ndarray      # (Q,) hidden phi slope per edge
    true_b: np.ndarray      # (Q,) hidden phi intercept per edge
    replicas: np.ndarray    # (Q,) int service replica count zeta


def sample_cluster(num_edges: int, replicas_high: int, phi_low: float,
                   phi_high: float, seed: int) -> ClusterParams:
    """Sample the cluster exactly as the seed simulator always has.

    The rng call order (coords first, then per-edge a/b/replicas) is part
    of the contract: both engines call this, so a given seed names one
    cluster everywhere.
    """
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0, 1, size=(num_edges, 2))
    w = np.linalg.norm(coords[:, None] - coords[None, :], axis=-1)
    true_a = np.zeros(num_edges)
    true_b = np.zeros(num_edges)
    replicas = np.zeros(num_edges, np.int64)
    for i in range(num_edges):
        true_a[i] = rng.uniform(phi_low, phi_high)
        true_b[i] = rng.uniform(0.0, 0.1)
        replicas[i] = rng.integers(1, replicas_high + 1)
    return ClusterParams(coords=coords, w=w, true_a=true_a, true_b=true_b,
                         replicas=replicas)


def transfer_delay(ct: float, size, dist):
    """Eq (2): moving ``size`` over distance ``dist`` costs ct * size * dist."""
    return ct * size * dist


def exec_time(a, b, size):
    """The affine service model phi(x) = a x + b (paper §III-C1)."""
    return a * size + b


def service_runtime(a, b, size, speed: float = 1.0, jitter: float = 1.0,
                    warmup: float = 0.0):
    """Realized lane occupancy of one request: the affine mean, scaled by
    the straggler ``speed`` factor and a noise ``jitter`` multiplier (both
    1.0 in the deterministic engine), plus an additive ``warmup`` (the
    service-cache miss penalty — a cache-aside pull happens once, so it is
    not scaled by speed or jitter), floored at :data:`MIN_RUNTIME`."""
    return np.maximum(
        MIN_RUNTIME,
        exec_time(a, b, size) * np.maximum(jitter, MIN_JITTER) * speed + warmup,
    )


def extend_cluster_with_cloud(cluster: ClusterParams, cloud) -> ClusterParams:
    """Append the cloud tier as one extra node row (index Q) to a sampled
    cluster: transmission distance ``cloud.wan_dist`` from every edge (the
    size-proportional WAN bandwidth term; the fixed ``wan_rtt`` is additive
    per-destination delay and lives outside ``w`` — see
    :class:`repro.serving.topology.CloudSpec`), its own phi line, and
    ``cloud.lanes`` elastic service lanes. Both engines call this with the
    same spec, so (seed, CloudSpec) names one tiered cluster everywhere."""
    q = cluster.w.shape[0]
    w = np.zeros((q + 1, q + 1), cluster.w.dtype)
    w[:q, :q] = cluster.w
    w[:q, q] = w[q, :q] = cloud.wan_dist
    return ClusterParams(
        coords=np.concatenate(
            [cluster.coords, np.asarray([cloud.coords], cluster.coords.dtype)]),
        w=w,
        true_a=np.concatenate([cluster.true_a, [cloud.phi_a]]),
        true_b=np.concatenate([cluster.true_b, [cloud.phi_b]]),
        replicas=np.concatenate([cluster.replicas, [cloud.lanes]]),
    )
