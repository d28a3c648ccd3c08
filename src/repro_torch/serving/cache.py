"""Per-node service caches for the edge–cloud tier (schema v3); counterpart
of ``repro/serving/cache.py``.

Every edge keeps a fixed number of *service slots*. A request dispatched
to a node whose cache holds its ``service`` id runs at the nominal phi
runtime; a miss adds ``miss_penalty`` seconds of warm-up to that request's
runtime *and* installs the service in the node's cache (FIFO eviction), so
the next request for the same service hits. The cloud tier caches
everything: a cloud dispatch is always a hit.

:class:`CacheSpec`, :func:`initial_cache` and :class:`HostCache` are numpy
copies of the reference's. :func:`cache_commit` is the torch port of its
``lax.scan``: sequential over a round's arrivals in slot (== rid) order,
vectorised over a leading instance axis, with hit/miss outcomes equal to
the reference's (``tests/test_torch_engine.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

CACHE_EMPTY = -1


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """Service-cache law shared by both engines.

    slots         per-edge cache capacity (service ids resident at once).
    miss_penalty  seconds of cache-aside warm-up added to the runtime of
                  the request that misses (the service pull).
    num_services  size of the service-id universe (drives warm placement
                  and the policy's cache-locality features).
    warm          deterministically pre-place services edge-by-edge
                  (edge e starts holding services (e + j) % num_services,
                  j < slots) so locality structure exists from round 0;
                  False starts every edge cold.
    """

    slots: int = 2
    miss_penalty: float = 0.5
    num_services: int = 8
    warm: bool = True


def initial_cache(num_nodes: int, num_edges: int,
                  spec: CacheSpec) -> np.ndarray:
    """(num_nodes, slots) int32 initial cache contents (CACHE_EMPTY = free).
    Rows past ``num_edges`` (the cloud) stay empty — the cloud is an
    always-hit by convention, its row is never consulted."""
    cache = np.full((num_nodes, spec.slots), CACHE_EMPTY, np.int32)
    if spec.warm:
        for e in range(num_edges):
            for j in range(spec.slots):
                cache[e, j] = (e + j) % max(1, spec.num_services)
    return cache


def cache_commit(cache, ptr, assign, service, on, num_edges: int):
    """One round's cache pass for B instances at once: visit the round's
    arrivals in slot (== rid) order, looking up and cache-aside-installing
    each.

    cache   (B, N, C) int32  per-node resident service ids
    ptr     (B, N)    int32  per-node FIFO insertion cursor
    assign  (B, A)    int    dispatch decision per arrival
    service (B, A)    int    service id per arrival
    on      (B, A)    bool   real, scheduled arrivals (mask & admitted)
    Returns new (cache, ptr, hit) with hit (B, A) bool (False wherever
    ``on`` is False). Cloud nodes (index >= num_edges) always hit, never
    install."""
    slots = cache.shape[-1]
    cache, ptr = cache.clone(), ptr.clone()
    rows = torch.arange(cache.shape[0], device=cache.device)
    node, svc = assign.long(), service.to(cache.dtype)
    hits = []
    for j in range(assign.shape[-1]):
        n, s = node[:, j], svc[:, j]
        hit = (cache[rows, n] == s[:, None]).any(-1) | (n >= num_edges)
        install = on[:, j] & ~hit
        slot = ptr[rows, n].long()
        cache[rows, n, slot] = torch.where(install, s, cache[rows, n, slot])
        ptr[rows, n] = torch.where(install, (slot + 1) % slots,
                                   slot).to(ptr.dtype)
        hits.append(hit & on[:, j])
    return cache, ptr, torch.stack(hits, -1)


class HostCache:
    """The event-driven oracle's cache mirror: same FIFO cache-aside
    semantics as :func:`cache_commit`, accessed one request at a time (the
    simulator sorts each round's decisions by rid first). Tracks aggregate
    hit/miss counts for ``MultiEdgeSim.metrics``."""

    def __init__(self, num_nodes: int, num_edges: int, spec: CacheSpec):
        self.spec = spec
        self.num_edges = int(num_edges)
        self.cache = initial_cache(num_nodes, num_edges, spec)
        self.ptr = np.zeros(num_nodes, np.int64)
        self.hits = 0
        self.misses = 0

    def access(self, node: int, service: int) -> bool:
        """Look up (and on miss, install) ``service`` at ``node``; returns
        True on a hit. The caller charges ``spec.miss_penalty`` runtime
        warm-up on False."""
        node = int(node)
        if node >= self.num_edges or service in self.cache[node]:
            self.hits += 1
            return True
        self.misses += 1
        self.cache[node, self.ptr[node]] = service
        self.ptr[node] = (self.ptr[node] + 1) % self.spec.slots
        return False

    def hit_fraction(self, node: int, services) -> float:
        """Fraction of ``services`` resident at ``node`` right now (no
        state change) — the oracle twin of the engine's per-edge
        cache-locality feature."""
        if len(services) == 0:
            return 0.0
        if node >= self.num_edges:
            return 1.0
        row = self.cache[int(node)]
        return float(np.mean([s in row for s in services]))
