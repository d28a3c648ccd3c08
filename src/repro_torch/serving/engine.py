"""Batched rollout engine for multi-edge cooperative serving in PyTorch;
counterpart of ``repro/serving/engine.py``.

The whole serving system of B instances lives in one dict of tensors with a
leading instance axis (the ``SimState``), and one ``step_round`` moves all
B instances forward by one scheduling round together. The reference jits
and vmaps its one-instance transition; the port is batched natively and
runs eagerly, on the card unless the state lives on the CPU.

Why the schedule is the oracle's: the replica-lane model is a
work-conserving FIFO-by-ready-time multi-server queue. Each round the
engine *finalizes* the start and finish of every slot whose start time has
arrived, by a lane recursion over the slots in ready order, and leaves
in-transfer and still-queued slots open. Within one edge, start times are
nondecreasing along the ready-order recursion, so a deferred slot only
postpones a per-edge suffix (see the reference's module docstring).

Faults: when the arrival batch carries materialized fault rows
(``alive``/``speed``/``jitter`` from ``resilience.faults.attach_faults``),
``step_round`` switches into fault mode: row r is applied at the round-r
scheduling instant, orphans on newly-dead edges are re-admitted at the
nearest alive edge, and arrivals are source-remapped by the oracle's
two-step admission. An optional :class:`ResilienceConfig` adds admission
control, circuit breaking with half-open probes, and retry backoff.

State layout (B instances, N = Q edges (+ 1 cloud node), L lanes, Z =
num_rounds * max_per_round request slots):

    coords (B,N,2)  w (B,N,N)  phi_true/phi_est (B,N,2)  replicas (B,N)
    speed (B,N)  ct (B,)  t (B,)  round (B,) i32  completed (B,) i32
    lane_free (B,N,L)                      INF beyond an edge's zeta lanes
    slot_size/src/edge/submit/ready/start/finish (B,Z)   edge=-1 => empty
    slot_jitter/slot_retries (B,Z)         fault-mode runtime noise/retries
    alive (B,N)  breaker_open/trips/healthy (B,N)   fault + breaker state
    shed/dropped/retried (B,) i32          admission & overflow accounting
    phi_n/sx/sy/sxx/sxy (B,N)              running LSQ sums (learn_phi)

Where the port departs from the reference's code (not its results):

* :func:`stable_order` is ``torch.sort(stable=True)``; the reference's
  pairwise rank only dodged an SPMD sort bug under ``shard_map``, and both
  give the same permutation, ties included.
* :func:`advance` runs the lane recursion over the first
  ``max_b(#startable)`` entries of the order only (one host read per
  call): the slots past them carry key INF, for which the reference's step
  changes nothing.
* Randomness: an assign fn gets one ``torch.Generator`` for the whole
  rollout (the reference splits a jax key per round); greedy and heuristic
  backends ignore it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.inference import (make_policy_assign,
                                        make_policy_assign_fused)
from repro_torch.core.objective import makespan
from repro_torch.core.state import slot_workload_features
from repro_torch.resilience.policies import (ResilienceConfig, admission_mask,
                                             breaker_step, dispatch_mask,
                                             nearest_alive, probe_cap)
from repro_torch.serving import rounds
from repro_torch.serving.cache import (CACHE_EMPTY, CacheSpec, cache_commit,
                                       initial_cache)
from repro_torch.serving.topology import CloudSpec

#: Sentinel for "never" (empty lane slots, un-ready/un-started requests).
INF = 1e30
#: Horizon passed to :func:`advance` to drain every committed request.
DRAIN_HORIZON = 1e7
#: Ready-time nudge for retried orphans: they must sort after same-instant
#: fresh local commits in the ready order, as in the oracle's event heap.
RETRY_EPS = 1e-6
#: Deadline-slack cap (seconds) for the policy's per-request slack feature.
SLACK_CAP = 8.0

#: assign_fn(generator, inst) -> (B, A) int32 execution node per pending
#: request, or an (assign, admit) pair when the policy also decides
#: admission (core.inference.make_policy_assign with DecisionSpec(
#: admission=True)).
AssignFn = Callable[[Optional[torch.Generator], dict], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static shape/physics parameters of a batched rollout (the
    reference's fields; (cfg, seed) names the same cluster in both)."""

    num_edges: int = 5
    replicas_high: int = 4
    ct: float = 1.0
    round_interval: float = 0.25
    phi_low: float = 0.2
    phi_high: float = 1.0
    num_rounds: int = 12           # scheduling rounds (slot table rows)
    max_per_round: int = 16        # padded arrivals per round (slot cols)
    learn_phi: bool = False        # online phi fitting vs oracle phi_true
    phi_min_samples: int = 8
    resilience: Optional[ResilienceConfig] = None
    # Edge–cloud tier: ``cloud`` appends one node (index num_edges) to every
    # per-node array; ``cache`` gives every edge a service cache.
    cloud: Optional[CloudSpec] = None
    cache: Optional[CacheSpec] = None

    @property
    def num_nodes(self) -> int:
        """Dispatchable nodes: the edges plus the cloud row when tiered."""
        return self.num_edges + (1 if self.cloud is not None else 0)

    @property
    def lane_width(self) -> int:
        """Lane-table width L: the cloud's elastic lanes may exceed
        ``replicas_high``."""
        return max(self.replicas_high,
                   self.cloud.lanes if self.cloud is not None else 0)

    @property
    def num_slots(self) -> int:
        return self.num_rounds * self.max_per_round

    @property
    def until(self) -> float:
        """Arrival horizon covered by the slot table."""
        return self.num_rounds * self.round_interval


def _init_state_np(cfg: EngineConfig, seed: int) -> dict:
    """One instance's state in numpy, exactly the reference's
    ``init_state``."""
    q, n, z = cfg.num_edges, cfg.num_nodes, cfg.num_slots
    cluster = rounds.sample_cluster(q, cfg.replicas_high, cfg.phi_low,
                                    cfg.phi_high, seed)
    if cfg.cloud is not None:
        cluster = rounds.extend_cluster_with_cloud(cluster, cfg.cloud)
    phi_true = np.stack([cluster.true_a, cluster.true_b], -1).astype(np.float32)
    lane_free = np.where(
        np.arange(cfg.lane_width)[None, :] < cluster.replicas[:, None],
        0.0, INF).astype(np.float32)
    rtt = np.zeros(n, np.float32)
    tier = np.zeros(n, np.float32)
    if cfg.cloud is not None:
        rtt[q:] = cfg.cloud.wan_rtt
        tier[q:] = 1.0
    cache = (initial_cache(n, q, cfg.cache) if cfg.cache is not None
             else np.full((n, 1), CACHE_EMPTY, np.int32))
    return {
        "coords": cluster.coords.astype(np.float32),
        "w": cluster.w.astype(np.float32),
        "phi_true": phi_true,
        "phi_est": (np.tile(np.float32([1.0, 0.0]), (n, 1))
                    if cfg.learn_phi else phi_true.copy()),
        "replicas": cluster.replicas.astype(np.float32),
        "speed": np.ones(n, np.float32),
        "ct": np.float32(cfg.ct),
        "t": np.float32(0.0),
        "round": np.int32(0),
        "completed": np.int32(0),
        "lane_free": lane_free,
        "rtt": rtt,
        "tier": tier,
        "cache": cache,
        "cache_ptr": np.zeros(n, np.int32),
        "cache_hits": np.int32(0),
        "cache_misses": np.int32(0),
        "slot_size": np.zeros(z, np.float32),
        "slot_src": np.zeros(z, np.int32),
        "slot_edge": np.full(z, -1, np.int32),
        "slot_submit": np.zeros(z, np.float32),
        "slot_ready": np.full(z, INF, np.float32),
        "slot_start": np.full(z, INF, np.float32),
        "slot_finish": np.full(z, INF, np.float32),
        "slot_jitter": np.ones(z, np.float32),
        "slot_retries": np.zeros(z, np.float32),
        "slot_service": np.zeros(z, np.int32),
        "slot_deadline": np.full(z, INF, np.float32),
        "slot_priority": np.zeros(z, np.float32),
        "slot_penalty": np.zeros(z, np.float32),
        "alive": np.ones(n, np.float32),
        "breaker_open": np.full(n, -1.0, np.float32),
        "breaker_trips": np.zeros(n, np.float32),
        "breaker_healthy": np.zeros(n, np.float32),
        "shed": np.int32(0),
        "dropped": np.int32(0),
        "retried": np.int32(0),
        "phi_n": np.zeros(n, np.float32),
        "phi_sx": np.zeros(n, np.float32),
        "phi_sy": np.zeros(n, np.float32),
        "phi_sxx": np.zeros(n, np.float32),
        "phi_sxy": np.zeros(n, np.float32),
    }


def init_state(cfg: EngineConfig, seed: int = 0, *, device=None) -> dict:
    """Fresh SimState of one instance (no batch axis) as tensors on
    ``device`` (CUDA by default; ``device="cpu"`` for the CPU). The cluster
    is drawn through ``rounds.sample_cluster``, as in the reference."""
    device = resolve_device(device)
    return {k: torch.as_tensor(v).to(device)
            for k, v in _init_state_np(cfg, seed).items()}


def init_batch(cfg: EngineConfig, seeds, *, device=None) -> dict:
    """Per-seed states stacked into one dict with a leading batch axis."""
    device = resolve_device(device)
    states = [_init_state_np(cfg, int(s)) for s in seeds]
    return {k: torch.as_tensor(np.stack([s[k] for s in states])).to(device)
            for k in states[0]}


# ---------------------------------------------------------------------------
# transition pieces (pure: each returns a new state dict)
# ---------------------------------------------------------------------------


def stable_order(keys):
    """Stable ascending argsort along the last axis: ties resolve toward
    the lower index, as the reference's pairwise rank does."""
    return torch.sort(keys, dim=-1, stable=True).indices


def _bcast(x, like):
    """A per-instance (B,) tensor or a float as (B, 1) on ``like``'s
    device."""
    x = torch.as_tensor(x, dtype=torch.float32, device=like.device)
    return x.expand(like.shape[0])[:, None]


def _lane_recursion(state, keys, order, t_new, steps, cfg):
    """The reference's lane scan over the first ``steps`` slots of
    ``order``, vectorised over the instances: each step takes instance b's
    slot ``order[b, i]`` and puts it on its edge's earliest free lane if it
    starts by ``t_new``. Returns (lane_free, start, finish, ok, e, size,
    rt) with the per-step arrays (B, steps)."""
    bsz, n = keys.shape[0], cfg.num_nodes
    idx = order[:, :steps]

    def take(x):
        return torch.gather(x, 1, idx)

    e = torch.clamp(take(state["slot_edge"]), 0, n - 1).long()
    ready, size = take(state["slot_ready"]), take(state["slot_size"])
    a = torch.gather(state["phi_true"][..., 0], 1, e)
    b = torch.gather(state["phi_true"][..., 1], 1, e)
    # rounds.service_runtime, cache-miss warm-up included, in its order
    rt = torch.clamp(
        (a * size + b)
        * torch.clamp(take(state["slot_jitter"]), min=rounds.MIN_JITTER)
        * torch.gather(state["speed"], 1, e)
        + take(state["slot_penalty"]),
        min=rounds.MIN_RUNTIME)
    # a slot starts when its start time is <= t_new; padding (key INF)
    # never does
    limit = torch.where(take(keys) < INF / 2, t_new, -torch.inf)
    rows = torch.arange(bsz, device=keys.device)[:, None] * n + e
    lanes = state["lane_free"].reshape(bsz * n, -1).clone()
    starts, finishes, oks = [], [], []
    for i in range(steps):
        row = rows[:, i]
        cur, lane = lanes[row].min(-1)  # first index of the earliest lane
        st = torch.maximum(ready[:, i], cur)
        ok = st <= limit[:, i]
        fin = st + rt[:, i]
        lanes[row, lane] = torch.where(ok, fin, cur)
        starts.append(st)
        finishes.append(fin)
        oks.append(ok)
    st, fin, ok = (torch.stack(x, 1) for x in (starts, finishes, oks))
    start = state["slot_start"].scatter(
        1, idx, torch.where(ok, st, take(state["slot_start"])))
    finish = state["slot_finish"].scatter(
        1, idx, torch.where(ok, fin, take(state["slot_finish"])))
    return (lanes.reshape(state["lane_free"].shape), start, finish, ok, e,
            size, rt)


def advance(state: dict, t_new, cfg: EngineConfig) -> dict:
    """Move time forward to ``t_new`` ((B,) or a float): finalize the lane
    schedule of every slot whose start time arrives by ``t_new`` (ready
    order, the oracle's FIFO lane recursion) and book completions. A slot
    whose start would land past ``t_new`` is left open and re-derived next
    round.

    The recursion steps only through the first ``max_b(#startable)``
    entries of the ready order, read to the host once per call: every later
    entry has key INF, where the reference's step changes nothing."""
    ready = state["slot_ready"]
    t_col = _bcast(t_new, ready)
    startable = ((state["slot_edge"] >= 0) & (state["slot_start"] > INF / 2)
                 & (ready <= t_col))
    keys = torch.where(startable, ready, INF)
    order = stable_order(keys)  # stable: ties resolve in slot (arrival) order
    steps = int(startable.sum(-1).max())

    out = dict(state)
    out["t"] = t_col[:, 0].clone()
    if steps:
        (out["lane_free"], out["slot_start"], out["slot_finish"], ok, e,
         size, rt) = _lane_recursion(state, keys, order, t_col, steps, cfg)
    out["completed"] = (out["slot_finish"] <= t_col).sum(-1).to(torch.int32)
    if cfg.learn_phi:
        n, sx, sy, sxx, sxy = (state[k] for k in ("phi_n", "phi_sx", "phi_sy",
                                                  "phi_sxx", "phi_sxy"))
        if steps:  # observe (size, runtime) at start, like the oracle
            g = ok.to(torch.float32)
            n = n.scatter_add(1, e, g)
            sx = sx.scatter_add(1, e, g * size)
            sy = sy.scatter_add(1, e, g * rt)
            sxx = sxx.scatter_add(1, e, g * size * size)
            sxy = sxy.scatter_add(1, e, g * size * rt)
        out["phi_n"], out["phi_sx"], out["phi_sy"] = n, sx, sy
        out["phi_sxx"], out["phi_sxy"] = sxx, sxy
        # the engine's own refit rule (a > 0), as the reference's engine
        nn = torch.clamp(n, min=1.0)
        var = sxx / nn - torch.square(sx / nn)
        denom = sxx - torch.square(sx) / nn
        a = (sxy - sx * sy / nn) / torch.where(denom == 0, 1.0, denom)
        b = (sy - a * sx) / nn
        valid = ((n >= cfg.phi_min_samples) & (var > 1e-12) & (a > 0)
                 & torch.isfinite(a) & torch.isfinite(b))
        est = torch.stack([a, torch.clamp(b, min=0.0)], -1)
        out["phi_est"] = torch.where(valid[..., None], est, state["phi_est"])
    return out


def apply_faults(state: dict, arr: dict, cfg: EngineConfig) -> dict:
    """Apply this round's fault row (``arr["alive"]``/``arr["speed"]``, (B,
    N)) at the current scheduling instant. A newly-dead edge loses its
    lanes and orphans every not-yet-finished slot; orphans are re-admitted
    as local retries at the nearest alive edge with a small ready-time
    nudge (plus backoff). A recovered edge gets fresh lanes at the current
    time."""
    res = cfg.resilience
    t = state["t"][:, None]
    prev_alive = state["alive"] > 0
    alive = arr["alive"] > 0
    died = prev_alive & ~alive
    recovered = ~prev_alive & alive

    out = dict(state)
    out["alive"] = alive.to(torch.float32)
    out["speed"] = arr["speed"].to(torch.float32)
    lane_free = state["lane_free"]
    lanes = torch.arange(lane_free.shape[-1], device=lane_free.device)
    fresh = torch.where(lanes < state["replicas"][..., None], t[..., None],
                        INF)
    lane_free = torch.where(died[..., None], INF, lane_free)
    out["lane_free"] = torch.where(recovered[..., None], fresh, lane_free)

    e = torch.clamp(state["slot_edge"], 0, cfg.num_nodes - 1).long()
    orphan = ((state["slot_edge"] >= 0) & torch.gather(died, 1, e)
              & (state["slot_finish"] > t))
    retries = state["slot_retries"] + orphan
    new_src = nearest_alive(state["w"], alive,
                            torch.clamp(state["slot_src"], 0,
                                        cfg.num_nodes - 1))
    backoff = 0.0
    if res is not None and res.retry_backoff_rounds:
        backoff = (res.retry_backoff_rounds * cfg.round_interval
                   * torch.exp2(torch.clamp(retries - 1.0, 0.0,
                                            float(res.retry_backoff_cap))))
    out["slot_src"] = torch.where(orphan, new_src, state["slot_src"])
    out["slot_edge"] = torch.where(orphan, new_src, state["slot_edge"])
    out["slot_ready"] = torch.where(orphan, t + RETRY_EPS + backoff,
                                    state["slot_ready"])
    out["slot_start"] = torch.where(orphan, INF, state["slot_start"])
    out["slot_finish"] = torch.where(orphan, INF, state["slot_finish"])
    out["slot_retries"] = retries.to(torch.float32)
    out["retried"] = state["retried"] + orphan.sum(-1).to(torch.int32)
    if res is not None and res.breaker:
        (out["breaker_open"], out["breaker_trips"],
         out["breaker_healthy"]) = breaker_step(
            state["breaker_open"], state["breaker_trips"],
            state["breaker_healthy"], died, alive, t, cfg.round_interval, res)
    return out


def dispatchable_edges(state: dict, cfg: EngineConfig):
    """(B, N) bool dispatch eligibility: alive edges, minus open circuit
    breakers when breaking is enabled."""
    alive = state["alive"] > 0
    res = cfg.resilience
    if res is not None and res.breaker:
        return dispatch_mask(alive, state["breaker_open"], state["t"][:, None])
    return alive


def round_instance(state: dict, arr: dict, cfg: EngineConfig) -> dict:
    """Freeze (state, this round's arrivals) into a batch of scheduling
    instances with the layout of ``core.instances`` (leading axis B), so
    the policy, the heuristics and the objective run on it unchanged.

    Tier/schema-v3 extras (read only by a policy with ``tier_features``):
    ``tier``, ``cache_frac``, ``req_slack`` (deadline slack capped at
    :data:`SLACK_CAP`), ``req_priority`` and ``req_cached``."""
    wl = slot_workload_features(
        state["phi_est"], state["replicas"], state["w"], state["ct"],
        state["slot_size"], state["slot_src"], state["slot_edge"],
        state["slot_ready"], state["slot_start"], state["t"],
    )
    mask = arr["mask"]
    src = arr["src"].to(torch.int32)
    inst = {
        "edge_coords": state["coords"],
        "phi": state["phi_est"],
        "replicas": state["replicas"],
        "workload": wl,
        "w": state["w"],
        "ct": state["ct"],
        "req_src": src,
        "req_size": torch.where(mask, arr["size"], 0.0),
        "edge_mask": dispatchable_edges(state, cfg),
        "req_mask": mask,
        "tier": state["tier"],
    }
    if "rid" in arr:  # pass-through for scripted/replay assign fns
        inst["req_rid"] = arr["rid"].to(torch.int32)
    if "deadline" in arr:
        slack = torch.clamp(arr["deadline"] - state["t"][:, None], 0.0,
                            SLACK_CAP)
        inst["req_slack"] = torch.where(mask, slack, 0.0).to(torch.float32)
    if "priority" in arr:
        inst["req_priority"] = torch.where(
            mask, arr["priority"], 0.0).to(torch.float32)
    if cfg.cache is not None and "service" in arr:
        svc = arr["service"].to(torch.int32)
        # (B, N, A) residency now: cloud rows (tier 1) always hit
        res = (state["cache"][..., None] == svc[:, None, None, :]).any(2)
        res = res | (state["tier"][..., None] > 0)
        mf = mask.to(torch.float32)
        inst["cache_frac"] = ((res * mf[:, None, :]).sum(-1)
                              / torch.clamp(mf.sum(-1), min=1.0)[:, None]
                              ).to(torch.float32)
        cached = torch.gather(res, 1, src.long()[:, None, :])[:, 0]
        inst["req_cached"] = (cached & mask).to(torch.float32)
    return inst


def commit(state: dict, arr: dict, assign, cfg: EngineConfig,
           admit=None, ready_offset=None) -> dict:
    """Dispatch this round's arrivals (CC steps v-vi): write them into the
    round's slot row with their execution node and data-ready time (local:
    now; remote: now + the eq (2) transfer delay). ``admit`` is an
    optional (B, A) bool admission mask: non-admitted arrivals are shed
    (never written to the slot table, counted in ``state["shed"]``).
    ``ready_offset`` is an optional (B, A) ready-time bump (fault mode)."""
    a_cols = cfg.max_per_round
    if arr["size"].shape[-1] != a_cols:
        raise ValueError(
            f"arrival batch width {arr['size'].shape[-1]} != "
            f"cfg.max_per_round {a_cols}; slot-table rows would misalign "
            f"(materialize with max_per_round={a_cols}, or build the "
            f"EngineConfig from the materialized width)")
    lo, hi = (int(x) for x in torch.aminmax(state["round"]))
    if lo != hi:
        raise ValueError(f"instances of one batch are at rounds {lo}..{hi}; "
                         f"a batch steps all its instances together")
    base = lo * a_cols
    if base + a_cols > state["slot_edge"].shape[-1]:
        raise ValueError(f"round {lo} is past the slot table's "
                         f"{state['slot_edge'].shape[-1] // a_cols} rounds")
    assign = assign.to(torch.int32)
    src = arr["src"].to(torch.int32)
    mask = arr["mask"]
    sched = mask if admit is None else mask & admit
    size = torch.where(mask, arr["size"], 0.0).to(torch.float32)
    exec_node = torch.clamp(assign, 0, cfg.num_nodes - 1).long()
    # eq (2) + per-destination additive delay (the cloud's WAN rtt; zero
    # for every edge destination)
    n = cfg.num_nodes
    dist = torch.gather(state["w"].flatten(-2), 1, src.long() * n + exec_node)
    delay = (rounds.transfer_delay(state["ct"][:, None], size, dist)
             + torch.gather(state["rtt"], 1, exec_node))
    ready = state["t"][:, None] + torch.where(assign == src, 0.0, delay)
    if ready_offset is not None:
        ready = ready + ready_offset

    out = dict(state)

    def put(key, vals):
        row = state[key].clone()
        row[:, base:base + a_cols] = vals.to(row.dtype)
        out[key] = row

    svc = (arr["service"].to(torch.int32) if "service" in arr
           else torch.zeros_like(src))
    if cfg.cache is not None:
        # one sequential cache pass over the round's dispatches in slot
        # (== rid) order, as the oracle's HostCache accesses them
        cache, ptr, hit = cache_commit(state["cache"], state["cache_ptr"],
                                       exec_node, svc, sched, cfg.num_edges)
        miss = sched & ~hit
        out["cache"], out["cache_ptr"] = cache, ptr
        out["cache_hits"] = (state["cache_hits"]
                             + hit.sum(-1).to(torch.int32))
        out["cache_misses"] = (state["cache_misses"]
                               + miss.sum(-1).to(torch.int32))
        penalty = cfg.cache.miss_penalty * miss.to(torch.float32)
    else:
        penalty = torch.zeros_like(size)
    put("slot_penalty", penalty)
    put("slot_service", svc)
    if "deadline" in arr:
        put("slot_deadline", arr["deadline"])
    if "priority" in arr:
        put("slot_priority", arr["priority"])
    put("slot_size", size)
    put("slot_src", src)
    put("slot_edge", torch.where(sched, assign, -1))
    put("slot_submit", arr["t"])
    put("slot_ready", torch.where(sched, ready, INF))
    if "jitter" in arr:
        put("slot_jitter", arr["jitter"])
    if admit is not None:
        out["shed"] = state["shed"] + (mask & ~admit).sum(-1).to(torch.int32)
    if "dropped" in arr:  # materializer overflow clips, per round
        out["dropped"] = state["dropped"] + arr["dropped"].to(torch.int32)
    out["round"] = state["round"] + 1
    return out


def step_round(state: dict, arr: dict, assign_fn: AssignFn,
               cfg: EngineConfig, generator=None) -> tuple[dict, dict]:
    """One scheduling round for every instance (paper Fig. 2 iii-vi):
    advance one round interval, apply this round's fault row (if the
    arrivals carry one), evaluate per-edge workload state, schedule the
    round's arrivals with one ``assign_fn`` call for the whole batch, apply
    admission control, dispatch. ``arr`` holds this round's (B, A) arrays.
    Returns (state, per-round info)."""
    res = cfg.resilience
    fault_mode = "alive" in arr
    ready_offset = None
    prev_completed = state["completed"]
    prev_shed, prev_retried = state["shed"], state["retried"]
    state = advance(state, state["t"] + cfg.round_interval, cfg)
    if fault_mode and cfg.cloud is not None:
        # materialized fault rows cover the edges; the cloud column is
        # always alive at nominal speed
        arr = dict(arr)
        pad = torch.ones_like(arr["alive"][..., :1])
        arr["alive"] = torch.cat([arr["alive"], pad], -1)
        arr["speed"] = torch.cat([arr["speed"], pad.to(arr["speed"].dtype)],
                                 -1)
    if fault_mode:
        # two-step source failover, the oracle's admission path: arrivals
        # fail over under the liveness they arrived under, then a fail
        # event re-admits the dead edge's pool under the new row, after the
        # surviving edges' native arrivals
        arr = dict(arr)
        arr["src"] = nearest_alive(state["w"], state["alive"] > 0,
                                   torch.clamp(arr["src"].to(torch.int32), 0,
                                               cfg.num_edges - 1))
        state = apply_faults(state, arr, cfg)
        alive = state["alive"] > 0
        readmitted = ~torch.gather(alive, 1, arr["src"].long())
        ready_offset = RETRY_EPS * readmitted
        arr["src"] = nearest_alive(state["w"], alive, arr["src"])
    inst = round_instance(state, arr, cfg)
    decision = assign_fn(generator, inst)
    assign, admit = (decision if isinstance(decision, tuple)
                     else (decision, None))
    if fault_mode:
        # clamp any dispatch outside the eligible set to the nearest
        # eligible node: a policy must not resurrect a dead edge
        assign = nearest_alive(state["w"], inst["edge_mask"],
                               torch.clamp(assign.to(torch.int32), 0,
                                           cfg.num_nodes - 1))
        if res is not None and res.breaker:
            half_open = ((state["alive"] > 0)
                         & (state["t"][:, None] >= state["breaker_open"])
                         & (state["breaker_trips"] > 0))
            closed = inst["edge_mask"] & ~half_open
            assign = probe_cap(state["w"], assign, arr["mask"], arr["src"],
                               half_open, closed, res)
    if admit is None and res is not None and res.admission != "none":
        admit = admission_mask(res, inst, assign)
    state = commit(state, arr, assign, cfg, admit=admit,
                   ready_offset=ready_offset)
    finish = state["slot_finish"]
    done = finish <= state["t"][:, None]
    info = {
        "t": state["t"],
        "features": inst["workload"],
        "assign": assign.to(torch.int32),
        "completed": state["completed"],
        "round_completions": state["completed"] - prev_completed,
        "round_shed": state["shed"] - prev_shed,
        "round_retries": state["retried"] - prev_retried,
        "makespan": torch.where(done, finish, 0.0).amax(-1),
    }
    return state, info


def _to_device(arrivals: dict, device) -> dict:
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.as_tensor(np.asarray(v))).to(device)
            for k, v in arrivals.items()}


def make_rollout(cfg: EngineConfig, assign_fn: AssignFn, *,
                 batch: bool = False,
                 drain_to: Optional[float] = DRAIN_HORIZON):
    """Build ``run(state, arrivals, generator=None) -> (state, infos)``.

    ``arrivals`` is the padded per-round batch from
    :func:`repro_torch.workloads.batch.materialize_round_batch` ((B, R, A)
    numpy arrays or tensors; moved to the state's device) with a state
    from :func:`init_batch`; ``infos`` come stacked as (B, R, ...). With
    ``batch=False`` the state and the arrivals are one instance's
    (:func:`init_state`, ``materialize_rounds``) and so are the results.
    ``generator`` is handed to ``assign_fn`` every round. ``drain_to``
    runs a final :func:`advance` so in-flight work completes (None: leave
    it in flight)."""

    def run(state, arrivals, generator=None):
        num_rounds = arrivals["size"].shape[-2]
        if num_rounds > cfg.num_rounds:
            raise ValueError(
                f"arrivals cover {num_rounds} rounds but the slot table "
                f"holds cfg.num_rounds={cfg.num_rounds}")
        arr = _to_device(arrivals, state["t"].device)
        if not batch:
            state = {k: v[None] for k, v in state.items()}
            arr = {k: v[None] for k, v in arr.items()}
        infos = []
        with torch.no_grad():
            for r in range(num_rounds):
                state, info = step_round(
                    state, {k: v[:, r] for k, v in arr.items()}, assign_fn,
                    cfg, generator)
                infos.append(info)
            if drain_to is not None:
                state = advance(state, drain_to, cfg)
        infos = {k: torch.stack([i[k] for i in infos], 1) for k in infos[0]}
        if not batch:
            state = {k: v[0] for k, v in state.items()}
            infos = {k: v[0] for k, v in infos.items()}
        return state, infos

    return run


#: The one summary schema: :func:`summarize` and :func:`partials_to_summary`
#: return exactly these keys (zero-valued defaults when nothing completed),
#: plus ``slo`` / ``slo_violation_frac`` when an SLO is given.
#: ``per_edge_completed`` is the one nested dict (node id -> completions).
SUMMARY_KEYS = (
    "completed", "submitted", "shed_requests", "dropped_requests",
    "stranded_requests", "retried_requests", "shed_rate",
    "displaced_instances",
    "mean_response", "p50_response", "p95_response", "max_response",
    "makespan",
    "transferred", "transferred_frac", "cross_shard_transferred",
    "intra_fleet_transferred", "cross_shard_frac", "cross_shard_completed",
    "per_edge_completed",
    "deadline_total", "deadline_missed", "deadline_miss_frac",
    "cache_hits", "cache_misses", "cache_hit_rate",
    "cloud_completed", "cloud_offload_frac",
)


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def summarize(state: dict, slo: Optional[float] = None) -> dict:
    """Host-side metrics from the final slot table, returning exactly
    :data:`SUMMARY_KEYS`. Works on one instance or a batch (the leading
    axis is aggregated as one population); the reference's arithmetic in
    numpy.

    ``submitted`` counts every arrival the engine saw (dispatched, shed by
    admission control, or dropped by the materializer's overflow clip).
    With ``slo`` set, a violation is a completion slower than the SLO or
    any request that was shed, dropped, or stranded on a dead edge.
    ``deadline_*`` covers committed requests with a finite deadline: a miss
    is a completion past its deadline or a request that never completed."""
    s = {k: _host(v) for k, v in state.items()}
    committed = s["slot_edge"] >= 0
    done = committed & (s["slot_finish"] <= np.expand_dims(
        s["t"], axis=tuple(range(np.ndim(s["t"]), s["slot_finish"].ndim))))
    shed = int(np.sum(s["shed"]))
    dropped = int(np.sum(s["dropped"]))
    stranded = int(committed.sum() - done.sum())
    submitted = int(committed.sum()) + shed + dropped
    completed = int(done.sum())
    finite_dl = committed & (s["slot_deadline"] < INF / 2)
    dl_missed = finite_dl & (~done | (s["slot_finish"] > s["slot_deadline"]))
    dl_total = int(finite_dl.sum())
    n = s["w"].shape[-1]
    e_clip = np.clip(s["slot_edge"], 0, n - 1)
    on_cloud = np.take_along_axis(s["tier"], e_clip, axis=-1) > 0
    cloud_done = int(np.sum(done & on_cloud))
    hits, misses = int(np.sum(s["cache_hits"])), int(np.sum(s["cache_misses"]))
    out = {
        "completed": completed,
        "submitted": submitted,
        "shed_requests": shed,
        "dropped_requests": dropped,
        "stranded_requests": stranded,
        "retried_requests": int((s["slot_retries"][committed] > 0).sum()),
        "shed_rate": (shed + dropped) / max(submitted, 1),
        "displaced_instances": 0,
        "deadline_total": dl_total,
        "deadline_missed": int(dl_missed.sum()),
        "deadline_miss_frac": int(dl_missed.sum()) / max(dl_total, 1),
        "cache_hits": hits,
        "cache_misses": misses,
        "cache_hit_rate": hits / max(hits + misses, 1),
        "cloud_completed": cloud_done,
        "cloud_offload_frac": cloud_done / max(completed, 1),
    }
    if not completed:
        out.update({k: 0.0 for k in ("mean_response", "p50_response",
                                     "p95_response", "max_response",
                                     "makespan", "transferred_frac",
                                     "cross_shard_frac")})
        out.update({k: 0 for k in ("transferred", "cross_shard_transferred",
                                   "intra_fleet_transferred",
                                   "cross_shard_completed")})
        out["per_edge_completed"] = {}
        if slo is not None:
            out["slo"] = float(slo)
            out["slo_violation_frac"] = ((shed + dropped + stranded)
                                         / max(submitted, 1))
        return out
    resp = (s["slot_finish"] - s["slot_submit"])[done]
    edges = s["slot_edge"][done]
    transferred = int((edges != s["slot_src"][done]).sum())
    out.update({
        "mean_response": float(resp.mean()),
        "p50_response": float(np.percentile(resp, 50)),
        "p95_response": float(np.percentile(resp, 95)),
        "max_response": float(resp.max()),
        "transferred": transferred,
        "transferred_frac": transferred / completed,
        "cross_shard_transferred": 0,
        "intra_fleet_transferred": transferred,
        "cross_shard_frac": 0.0,
        "cross_shard_completed": 0,
        "per_edge_completed": {int(e): int(c) for e, c in
                               zip(*np.unique(edges, return_counts=True))},
        "makespan": float(s["slot_finish"][done].max()),
    })
    if slo is not None:
        violations = int((resp > slo).sum()) + shed + dropped + stranded
        out["slo"] = float(slo)
        out["slo_violation_frac"] = violations / max(submitted, 1)
    return out


#: Response-time histogram defaults for the mergeable summary path.
HIST_BINS = 256
HIST_MAX = 32.0


def summarize_partials(state: dict, *, hist_bins: int = HIST_BINS,
                       hist_max: float = HIST_MAX, displaced=None,
                       slo: Optional[float] = None) -> dict:
    """Summary partials from a (possibly batched) final state, on its
    device: every value is a sum (counts, the fixed-bin response-time
    histogram, per-edge completions, the response-time total) or a max
    (max response, makespan) over the instances, so partials of several
    states merge into one. :func:`partials_to_summary` turns them into
    ``summarize``-style metrics, p50/p95 estimated from the histogram.

    ``displaced`` is an optional (B,) bool marking instances placed off
    their home shard, which splits transfers into intra-fleet and
    cross-shard accounting."""
    committed = state["slot_edge"] >= 0
    finish = state["slot_finish"]
    t = torch.as_tensor(state["t"])
    tb = t.reshape(t.shape + (1,) * (finish.ndim - t.ndim))
    done = committed & (finish <= tb)
    resp = torch.where(done, finish - state["slot_submit"], 0.0)

    def count(x):
        return x.sum().to(torch.int32)

    num_done = count(done)
    shed, dropped = count(state["shed"]), count(state["dropped"])
    num_committed = count(committed)

    scale = hist_bins / hist_max
    idx = torch.clamp((resp * scale).to(torch.int32), 0, hist_bins - 1)
    hist = torch.zeros(hist_bins, dtype=torch.int32, device=resp.device
                       ).index_add_(0, idx.reshape(-1).long(),
                                    done.reshape(-1).to(torch.int32))
    q = state["w"].shape[-1]
    edges = torch.clamp(state["slot_edge"], 0, q - 1).long()
    per_edge = torch.zeros(q, dtype=torch.int32, device=resp.device
                           ).index_add_(0, edges.reshape(-1),
                                        done.reshape(-1).to(torch.int32))

    finite_dl = committed & (state["slot_deadline"] < INF / 2)
    dl_missed = finite_dl & (~done | (finish > state["slot_deadline"]))
    on_cloud = torch.gather(state["tier"], -1, edges) > 0

    transferred = done & (state["slot_edge"] != state["slot_src"])
    if displaced is None:
        disp_slots = torch.zeros_like(done)
        displaced_instances = torch.zeros((), dtype=torch.int32,
                                          device=resp.device)
    else:
        disp = torch.as_tensor(displaced, dtype=torch.bool,
                               device=resp.device)
        disp_slots = disp.reshape(disp.shape + (1,) * (done.ndim - disp.ndim)
                                  ) & done
        displaced_instances = count(disp)

    out = {
        "completed": num_done,
        "submitted": num_committed + shed + dropped,
        "shed": shed,
        "dropped": dropped,
        "stranded": num_committed - num_done,
        "retried": count(committed & (state["slot_retries"] > 0)),
        "resp_sum": resp.sum(),
        "resp_max": resp.max(),
        "makespan": torch.where(done, finish, 0.0).max(),
        "resp_hist": hist,
        "per_edge_completed": per_edge,
        "transferred": count(transferred),
        "cross_shard_transferred": count(transferred & disp_slots),
        "cross_shard_completed": count(disp_slots),
        "displaced_instances": displaced_instances,
        "deadline_total": count(finite_dl),
        "deadline_missed": count(dl_missed),
        "cache_hits": count(state["cache_hits"]),
        "cache_misses": count(state["cache_misses"]),
        "cloud_completed": count(done & on_cloud),
    }
    if slo is not None:
        out["slo_violations"] = count(done & (resp > slo))
    return out


#: partial keys merged with a max (everything else sums)
PARTIAL_MAX_KEYS = frozenset({"resp_max", "makespan"})


def _hist_percentile(hist: np.ndarray, pct: float, hist_max: float,
                     resp_max: float) -> float:
    """Deterministic percentile estimate from fixed-bin counts (linear
    interpolation inside the covering bin; the overflow bin reports
    ``resp_max``)."""
    total = int(hist.sum())
    cum = np.cumsum(hist)
    target = pct / 100.0 * total
    b = int(np.searchsorted(cum, max(target, 1e-9), side="left"))
    b = min(b, len(hist) - 1)
    if b == len(hist) - 1:  # overflow bin: past hist_max, report the max
        return float(resp_max)
    prev = float(cum[b - 1]) if b > 0 else 0.0
    frac = (target - prev) / max(float(hist[b]), 1.0)
    width = hist_max / len(hist)
    return float(min((b + min(max(frac, 0.0), 1.0)) * width, resp_max))


def partials_to_summary(partials: dict, slo: Optional[float] = None,
                        hist_max: float = HIST_MAX) -> dict:
    """Host-side: (merged) :func:`summarize_partials` -> the
    :data:`SUMMARY_KEYS` metrics dict. p50/p95 come from the histogram;
    all counts, ``mean_response``, ``max_response`` and ``makespan`` are
    exact."""
    p = {k: _host(v) for k, v in partials.items()}
    completed = int(p["completed"])
    submitted = int(p["submitted"])
    shed, dropped = int(p["shed"]), int(p["dropped"])
    stranded = int(p["stranded"])
    dl_total, dl_missed = int(p["deadline_total"]), int(p["deadline_missed"])
    hits, misses = int(p["cache_hits"]), int(p["cache_misses"])
    cloud_done = int(p["cloud_completed"])
    out = {
        "completed": completed,
        "submitted": submitted,
        "shed_requests": shed,
        "dropped_requests": dropped,
        "stranded_requests": stranded,
        "retried_requests": int(p["retried"]),
        "shed_rate": (shed + dropped) / max(submitted, 1),
        "displaced_instances": int(p["displaced_instances"]),
        "deadline_total": dl_total,
        "deadline_missed": dl_missed,
        "deadline_miss_frac": dl_missed / max(dl_total, 1),
        "cache_hits": hits,
        "cache_misses": misses,
        "cache_hit_rate": hits / max(hits + misses, 1),
        "cloud_completed": cloud_done,
        "cloud_offload_frac": cloud_done / max(completed, 1),
    }
    if not completed:
        out.update({k: 0.0 for k in ("mean_response", "p50_response",
                                     "p95_response", "max_response",
                                     "makespan", "transferred_frac",
                                     "cross_shard_frac")})
        out.update({k: 0 for k in ("transferred", "cross_shard_transferred",
                                   "intra_fleet_transferred",
                                   "cross_shard_completed")})
        out["per_edge_completed"] = {}
        if slo is not None and "slo_violations" in p:
            out["slo"] = float(slo)
            out["slo_violation_frac"] = ((shed + dropped + stranded)
                                         / max(submitted, 1))
        return out
    resp_max = float(p["resp_max"])
    transferred = int(p["transferred"])
    cross = int(p["cross_shard_transferred"])
    out.update({
        "mean_response": float(p["resp_sum"]) / completed,
        "p50_response": _hist_percentile(p["resp_hist"], 50.0, hist_max,
                                         resp_max),
        "p95_response": _hist_percentile(p["resp_hist"], 95.0, hist_max,
                                         resp_max),
        "max_response": resp_max,
        "transferred": transferred,
        "transferred_frac": transferred / completed,
        "cross_shard_transferred": cross,
        "intra_fleet_transferred": transferred - cross,
        "cross_shard_frac": cross / max(transferred, 1),
        "cross_shard_completed": int(p["cross_shard_completed"]),
        "per_edge_completed": {int(e): int(c)
                               for e, c in enumerate(p["per_edge_completed"])
                               if c},
        "makespan": float(p["makespan"]),
    })
    if slo is not None and "slo_violations" in p:
        violations = int(p["slo_violations"]) + shed + dropped + stranded
        out["slo"] = float(slo)
        out["slo_violation_frac"] = violations / max(submitted, 1)
    return out


# ---------------------------------------------------------------------------
# built-in assign functions (each decides the whole batch at once)
# ---------------------------------------------------------------------------


def local_assign(generator, inst):
    """Every request executes at its source edge (the Local baseline)."""
    del generator
    return inst["req_src"].to(torch.int32)


def greedy_assign(generator, inst):
    """Twin of heuristics.solve_greedy: size-descending greedy insertion,
    each request to the eligible edge (``edge_mask``) minimizing the
    incremental makespan (later requests parked at their source during
    evaluation). One step per request slot, each evaluating all Q
    candidates of all B instances with ``core.objective.makespan``; masked
    edges cost inf and ties go to the first index."""
    del generator
    num_edges = inst["w"].shape[-1]
    sizes, rmask = inst["req_size"], inst["req_mask"]
    order = stable_order(torch.where(rmask, -sizes, torch.inf))
    cur = inst["req_src"].long().clone()
    rows = torch.arange(cur.shape[0], device=cur.device)
    cands = torch.arange(num_edges, device=cur.device)[:, None]
    eligible = inst["edge_mask"].T  # (Q, B)
    # masked requests sort last and their steps change nothing
    for j in range(int(rmask.sum(-1).max())):
        z = order[:, j]
        trial = cur.expand(num_edges, *cur.shape).clone()  # (Q, B, A)
        trial[:, rows, z] = cands
        costs = torch.where(eligible, makespan(inst, trial), torch.inf)
        best = torch.argmin(costs, dim=0)
        cur[rows, z] = torch.where(rmask[rows, z], best, cur[rows, z])
    return cur.to(torch.int32)


#: Engine scheduling backends, selectable by name. Plain entries are
#: AssignFns; entries tagged ``_assign_factory`` (the policy) are built
#: with a policy through :func:`resolve_assign_fn`. Both policy names are
#: one factory (:func:`repro_torch.core.inference.make_assign_factory`)
#: with different default DecisionSpecs: ``"policy"`` takes the
#: materialized head (B1), ``"policy-fused"`` the fused decode (B3), which
#: never writes the round's (Z, Q) log-probs.
ASSIGN_FNS = {
    "local": local_assign,
    "greedy": greedy_assign,
    "policy": make_policy_assign,
    "policy-fused": make_policy_assign_fused,
}


def resolve_assign_fn(name: str, **policy_kwargs) -> AssignFn:
    """Look an engine backend up by name.

    Heuristic backends resolve to their AssignFn directly; ``"policy"`` /
    ``"policy-fused"`` are built from ``policy_kwargs`` (``policy=`` a
    :class:`~repro_torch.core.policy.CoRaiSPolicy`, optional
    ``spec=DecisionSpec(...)``)."""
    try:
        entry = ASSIGN_FNS[name]
    except KeyError:
        raise ValueError(
            f"unknown engine backend {name!r}; registered: "
            f"{', '.join(sorted(ASSIGN_FNS))}") from None
    if getattr(entry, "_assign_factory", False):
        if not policy_kwargs:
            raise ValueError(
                f"engine backend {name!r} is a policy factory; pass at "
                f"least policy= (see "
                f"repro_torch.core.inference.make_policy_assign)")
        return entry(**policy_kwargs)
    if policy_kwargs:
        raise ValueError(
            f"engine backend {name!r} is not a policy factory; it takes "
            f"no kwargs (got {sorted(policy_kwargs)})")
    return entry
