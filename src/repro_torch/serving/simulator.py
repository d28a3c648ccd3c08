"""Event-driven multi-edge cooperative serving simulator: a numpy copy of
``repro/serving/simulator.py`` for the port.

Implements the seven scheduling-process steps of paper Fig. 2 on a virtual
cluster: clients submit to their local edge (Q^r), the central controller
schedules each round from request *briefs* + evaluated edge states, data
transfers cost C_t * size * distance (eq 2/7 semantics), zeta replica lanes
execute in parallel, and completions flow to Q^F. Supports edge failures
(orphaned requests re-enter the controller pool — fault tolerance) and
stragglers (a slowed edge is routed around via workload perception, paper
§V-B3/WP). With ``phi_oracle=True`` and ``exec_noise=0`` it is the oracle
the port's rollout engine (``serving/engine.py``) is held to.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Optional

import numpy as np

from repro_torch.core.state import QueuedRequest
from repro_torch.serving.cache import CacheSpec, HostCache
from repro_torch.serving.controller import CentralController
from repro_torch.serving.edge import SimEdge
from repro_torch.serving.rounds import (extend_cluster_with_cloud,
                                        sample_cluster, transfer_delay)
from repro_torch.serving.topology import CloudSpec, nearest_alive_edge
from repro_torch.workloads.base import Workload, workload_rng


@dataclasses.dataclass
class SimConfig:
    num_edges: int = 5
    replicas_high: int = 4
    ct: float = 1.0
    round_interval: float = 0.25
    seed: int = 0
    phi_low: float = 0.2
    phi_high: float = 1.0
    exec_noise: float = 0.02
    # Oracle mode: every edge's estimator is pinned to its hidden true
    # coefficients (no online fitting). Used with exec_noise=0 to pin this
    # simulator against the batched engine, which shares the same cluster
    # prior via rounds.sample_cluster.
    phi_oracle: bool = False
    # Edge–cloud tier (schema v3): an optional cloud node appended as index
    # ``num_edges`` (WAN distance + fixed RTT, elastic lanes) and optional
    # per-edge service caches. Mirrors EngineConfig.cloud / .cache.
    cloud: Optional[CloudSpec] = None
    cache: Optional[CacheSpec] = None

    @property
    def num_nodes(self) -> int:
        return self.num_edges + (1 if self.cloud is not None else 0)


class MultiEdgeSim:
    def __init__(self, cfg: SimConfig, controller: CentralController):
        self.cfg = cfg
        self.cc = controller
        cluster = sample_cluster(cfg.num_edges, cfg.replicas_high,
                                 cfg.phi_low, cfg.phi_high, cfg.seed)
        if cfg.cloud is not None:
            cluster = extend_cluster_with_cloud(cluster, cfg.cloud)
        self.w = cluster.w
        self.edges = [
            SimEdge(
                edge_id=i,
                coords=tuple(cluster.coords[i]),
                true_a=float(cluster.true_a[i]),
                true_b=float(cluster.true_b[i]),
                replicas=int(cluster.replicas[i]),
                rng=np.random.default_rng((cfg.seed, i)),
                noise=cfg.exec_noise,
                phi_oracle=cfg.phi_oracle,
            )
            for i in range(cfg.num_nodes)
        ]
        # fixed per-destination RTT (zero for edges, wan_rtt for the cloud);
        # additive on top of the size-proportional eq-(2) transfer delay
        self.rtt = np.zeros(cfg.num_nodes)
        if cfg.cloud is not None:
            self.rtt[cfg.num_edges] = cfg.cloud.wan_rtt
        self.cache = (HostCache(cfg.num_nodes, cfg.num_edges, cfg.cache)
                      if cfg.cache is not None else None)
        self.now = 0.0
        self._events: list = []   # heap of (time, seq, kind, payload)
        self._seq = 0
        self._rid = 0
        self._deadline_finite = 0   # submitted requests with a finite deadline
        self._retried: set[int] = set()   # rids orphaned by an edge failure
        self.metrics_rows: list[dict] = []
        self.decision_times: list[float] = []   # one entry per non-empty round

    # -- client API ------------------------------------------------------

    def submit(self, edge_id: int, data_size: float, t: Optional[float] = None,
               service: int = 0, deadline: float = float("inf"),
               priority: int = 0):
        """Submit one request brief. ``deadline`` is the *absolute* hard-SLO
        time (schema v3; ``inf`` = none), ``service`` keys the node caches."""
        req = QueuedRequest(rid=self._rid, data_size=float(data_size),
                            source_edge=edge_id,
                            service=int(service),
                            submit_time=self.now if t is None else t,
                            deadline=float(deadline), priority=int(priority))
        self._rid += 1
        if np.isfinite(req.deadline):
            self._deadline_finite += 1
        self._push(req.submit_time, "arrival", req)
        return req

    def drive(self, workload: Workload, until: float,
              run_until: Optional[float] = None,
              seed: Optional[int] = None) -> dict:
        """Generate arrivals from a :class:`repro_torch.workloads.Workload`
        (or a replayed trace) over [0, until], submit them, and run the
        event loop to ``run_until`` (default: ``until``; pass a larger
        horizon to let late arrivals drain). Arrivals aimed at a dead edge fail over to the
        nearest alive edge via the standard arrival path. Deterministic for a
        fixed (workload, seed, config)."""
        trace_edges = int(getattr(workload, "num_edges", 0))
        if trace_edges > self.cfg.num_edges:
            raise ValueError(
                f"trace was recorded on {trace_edges} edges but this sim has "
                f"only {self.cfg.num_edges}; refusing to alias edge ids")
        rng = workload_rng(self.cfg.seed if seed is None else seed)
        for a in workload.arrivals(rng, self.cfg.num_edges, until):
            if not 0 <= a.edge < self.cfg.num_edges:
                raise ValueError(f"arrival at t={a.t} targets edge {a.edge}, "
                                 f"outside 0..{self.cfg.num_edges - 1}")
            self.submit(int(a.edge), float(a.size), t=float(a.t),
                        service=int(getattr(a, "service", 0)),
                        deadline=(float(a.t) + float(a.deadline)
                                  if getattr(a, "deadline", 0.0) > 0
                                  else float("inf")),
                        priority=int(getattr(a, "priority", 0)))
        return self.run(until if run_until is None else run_until)

    def fail_edge(self, edge_id: int, t: float):
        self._push(t, "fail", edge_id)

    def recover_edge(self, edge_id: int, t: float):
        self._push(t, "recover", edge_id)

    def set_straggler(self, edge_id: int, factor: float, t: float):
        self._push(t, "straggle", (edge_id, factor))

    # -- internals ---------------------------------------------------------

    def _push(self, t, kind, payload):
        heapq.heappush(self._events, (t, self._seq, kind, payload))
        self._seq += 1

    def _round(self):
        """One CC scheduling round over all pending briefs (Fig. 2 iii-vi)."""
        pending = []
        for e in self.edges:
            pending.extend(e.state.q_r)
            e.state.q_r = []
        if pending:
            decisions = self.cc.schedule(self.edges, pending, self.w,
                                         self.cfg.ct)
            self.decision_times.append(self.cc.last_decision_time)
            if self.cache is not None:
                # Cache pass in global arrival (rid) order — the batched
                # engine's commit scans the round's slots in the same order,
                # so hit/miss outcomes are identical across engines.
                for req, target in sorted(decisions, key=lambda d: d[0].rid):
                    hit = self.cache.access(target, req.service)
                    req.miss_penalty = (0.0 if hit
                                        else self.cache.spec.miss_penalty)
            # Dispatch in decision (admission) order: fault-mode orphan
            # retries must join queues after the round's fresh arrivals
            # (the engine's RETRY_EPS ready-time nudge encodes the same).
            for req, target in decisions:
                req.exec_edge = target
                src, dst = self.edges[req.source_edge], self.edges[target]
                if target == req.source_edge:
                    dst.state.q_le.append(req)
                else:
                    src.state.q_out.append(req)
                    dst.state.q_in.append(req)
                    dt = (transfer_delay(self.cfg.ct, req.data_size,
                                         self.w[req.source_edge, target])
                          + self.rtt[target])
                    self._push(self.now + dt, "transfer_done", req)
        # kick executions
        for e in self.edges:
            for ft, req in e.start_executable(self.now):
                self._push(ft, "exec_done", (req, e.edge_id, ft))

    def run(self, until: float):
        # arm the scheduling-round chain once: a second run()/drive() call
        # must not stack a parallel chain and double the round frequency
        if not any(kind == "round" for _, _, kind, _ in self._events):
            self._push(self.now + 1e-9, "round", None)
        while self._events and self._events[0][0] <= until:
            t, _, kind, payload = heapq.heappop(self._events)
            self.now = max(self.now, t)
            if kind == "arrival":
                self._admit(payload)
            elif kind == "transfer_done":
                req = payload
                dst = self.edges[req.exec_edge]
                if not dst.alive:
                    continue  # failure path re-queues via fail()
                if req in dst.state.q_in:
                    dst.state.q_in.remove(req)
                    if req in self.edges[req.source_edge].state.q_out:
                        self.edges[req.source_edge].state.q_out.remove(req)
                    dst.state.q_le.append(req)
                    for ft, r2 in dst.start_executable(self.now):
                        self._push(ft, "exec_done", (r2, dst.edge_id, ft))
            elif kind == "exec_done":
                req, eid, ft = payload
                e = self.edges[eid]
                # stale-event guard: the request may have been orphaned by a
                # failure and re-dispatched elsewhere
                stale = (not e.alive or req.rid not in e.inflight
                         or req.exec_edge != eid
                         or abs(req.finish_time - ft) > 1e-12)
                if not stale:
                    e.inflight.pop(req.rid)
                    e.state.q_f.append(req)
                    e.completed.append(req)
                    self.metrics_rows.append({
                        "rid": req.rid,
                        "edge": eid,
                        "response": req.finish_time - req.submit_time,
                        "finish": req.finish_time,
                        "transferred": eid != req.source_edge,
                        "deadline": req.deadline,
                        "cloud": eid >= self.cfg.num_edges,
                    })
                    for ft2, r2 in e.start_executable(self.now):
                        self._push(ft2, "exec_done", (r2, e.edge_id, ft2))
            elif kind == "fail":
                orphans = self.edges[payload].fail()
                # fault tolerance: orphaned requests re-enter the pool at the
                # nearest alive edge (their data is re-sent from the source)
                for req in orphans:
                    req.exec_edge = -1
                    self._retried.add(req.rid)
                    self._admit(req)
            elif kind == "recover":
                self.edges[payload].recover(self.now)
            elif kind == "straggle":
                eid, factor = payload
                self.edges[eid].speed_factor = factor
            elif kind == "round":
                self._round()
                self._push(self.now + self.cfg.round_interval, "round", None)
        self.now = until
        return self.metrics()

    def _nearest_alive(self, src: int) -> int:
        """Nearest alive edge id to ``src`` (``src`` itself when alive)."""
        return nearest_alive_edge(self.w, src, [e.alive for e in self.edges])

    def _admit(self, req) -> None:
        """Enqueue a request at its source edge, failing over to the nearest
        alive edge. During a total outage the client retries next round
        instead of crashing the sim (the request just waits in the heap)."""
        try:
            cand = self._nearest_alive(req.source_edge)
        except RuntimeError:
            self._push(self.now + self.cfg.round_interval, "arrival", req)
            return
        req.source_edge = cand
        self.edges[cand].state.q_r.append(req)

    def metrics(self) -> dict:
        """Run summary: exactly
        :data:`repro_torch.serving.engine.SUMMARY_KEYS` (the one summary
        schema shared with ``engine.summarize`` and the reference's
        ``fleet.fleet_summary``), plus the oracle-only ``decision_*``
        wall-clock keys. The oracle has no admission control or overflow
        clip, so ``shed_requests``/``dropped_requests`` are always 0 and
        ``stranded_requests`` counts submitted-but-never-completed work."""
        rows = self.metrics_rows
        dec = np.asarray(self.decision_times) if self.decision_times else None
        decision = {
            "scheduler_decision_s": self.cc.last_decision_time,
            "decision_rounds": len(self.decision_times),
            "decision_mean_s": float(dec.mean()) if dec is not None else 0.0,
            "decision_p95_s": (float(np.percentile(dec, 95))
                               if dec is not None else 0.0),
            "decision_max_s": float(dec.max()) if dec is not None else 0.0,
        }
        completed = len(rows)
        submitted = self._rid
        dl_total = self._deadline_finite
        fin_rows = [r for r in rows if np.isfinite(r["deadline"])]
        dl_missed = (sum(1 for r in fin_rows if r["finish"] > r["deadline"])
                     + (dl_total - len(fin_rows)))
        hits = self.cache.hits if self.cache is not None else 0
        misses = self.cache.misses if self.cache is not None else 0
        cloud_done = sum(1 for r in rows if r["cloud"])
        transferred = sum(1 for r in rows if r["transferred"])
        out = {
            "completed": completed,
            "submitted": submitted,
            "shed_requests": 0,
            "dropped_requests": 0,
            "stranded_requests": submitted - completed,
            "retried_requests": len(self._retried),
            "shed_rate": 0.0,
            "displaced_instances": 0,
            "deadline_total": dl_total,
            "deadline_missed": dl_missed,
            "deadline_miss_frac": dl_missed / max(dl_total, 1),
            "cache_hits": hits,
            "cache_misses": misses,
            "cache_hit_rate": hits / max(hits + misses, 1),
            "cloud_completed": cloud_done,
            "cloud_offload_frac": cloud_done / max(completed, 1),
            "transferred": transferred,
            "cross_shard_transferred": 0,
            "intra_fleet_transferred": transferred,
            "cross_shard_frac": 0.0,
            "cross_shard_completed": 0,
            **decision,
        }
        if not completed:
            out.update({k: 0.0 for k in ("mean_response", "p50_response",
                                         "p95_response", "max_response",
                                         "makespan", "transferred_frac")})
            out["per_edge_completed"] = {}
            return out
        resp = np.asarray([r["response"] for r in rows])
        per_edge = {e.edge_id: sum(1 for r in rows if r["edge"] == e.edge_id)
                    for e in self.edges}
        out.update({
            "mean_response": float(resp.mean()),
            "p50_response": float(np.percentile(resp, 50)),
            "p95_response": float(np.percentile(resp, 95)),
            "max_response": float(resp.max()),
            "transferred_frac": transferred / completed,
            "per_edge_completed": per_edge,
            "makespan": float(max(r["finish"] for r in rows)),
        })
        return out
