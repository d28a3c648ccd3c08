"""Materialize arrival streams into padded per-round batches for the
array-native engine (:mod:`repro_torch.serving.engine`).

The host paths of ``repro/workloads/batch.py``, copied: the reference
module imports jax at its top, so the port copies these functions rather
than the module (held bit for bit by ``tests/test_torch_workloads.py``).
The device half, :func:`materialize_round_batch_device`, draws the same
arrival laws with ``torch`` on a generator's device (the section below).

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

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.workloads import processes as P
from repro_torch.workloads.base import (Merged, ServiceMix, SizeSpec, Workload,
                                        edge_weights, workload_rng)

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


# -- device-resident materialization (torch generators) -----------------------
#
# ``materialize_round_batch_device`` is the device twin of
# ``materialize_round_batch``: the same arrival *laws*, drawn with torch on
# the generator's device, all B elements at once (one draw per law for the
# whole batch), so training episodes never leave the card. Equivalence to
# the host sampler is distributional (moment/KS tests in
# tests/test_torch_device_episodes.py), not draw for draw.
#
# How a workload compiles to a device plan (the numpy part, copied bit for
# bit from the reference): every supported generator is a superposition of
# Poisson components with a *static* per-round integrated rate Lambda[r]
# (constant for PoissonArrivals, trapezoid-integrated for DiurnalArrivals,
# window-overlap for FlashCrowdArrivals' spike), plus at most one MMPP
# component whose per-round Lambda is realized by stepping the 2-state chain
# round by round. Per round: total count ~ Poisson(sum_c Lambda_c), each
# arrival's component ~ Categorical(Lambda_c / sum), edge ~ that
# component's Zipf weights. Arrival times within a round are the order
# statistics of n uniforms on the window. Clipping reproduces the host
# overflow="clip" contract exactly: rids count *all* arrivals in time order
# and each round drops its latest count-A arrivals, realized by drawing the
# A-th order statistic of n as Beta(A, n-A+1) and the first A-1 as scaled
# order statistics beneath it.

_MMPP_SUBSTEPS = 8       # max regime switches resolved per round (P(more)
                         # is negligible for registered sojourn scales)
_DIURNAL_GRID = 64       # trapezoid points per round for rate integration


@dataclasses.dataclass(frozen=True)
class _DevicePlan:
    """Static compilation of a workload for the device sampler."""

    static_lam: tuple        # (R, Cs) per-round integrated rates, row-major
    edge_probs: tuple        # (C, Q) per-component edge weights (mmpp last)
    service_ids: tuple       # (C,) per-component constant service id
    mmpp: Optional[tuple]    # (rates, mean_sojourn, start_state) or None
    sizes: SizeSpec
    mix: Optional[tuple]     # (svc_probs, deadline, deadline_frac, prio_w)


def _diurnal_round_rates(wl, num_rounds: int, dt: float) -> np.ndarray:
    grid = np.linspace(0.0, dt, _DIURNAL_GRID + 1)
    lam = np.empty(num_rounds)
    for r in range(num_rounds):
        rates = np.maximum([wl.rate(r * dt + g) for g in grid], 0.0)
        lam[r] = getattr(np, "trapezoid", np.trapz)(rates, grid)
    return lam


def _flatten_components(wl, num_edges: int, num_rounds: int, dt: float,
                        out: list, mmpp: list) -> None:
    if isinstance(wl, Merged):
        for part in wl.parts:
            _flatten_components(part, num_edges, num_rounds, dt, out, mmpp)
    elif isinstance(wl, P.PoissonArrivals):
        out.append((np.full(num_rounds, wl.rate * dt),
                    edge_weights(num_edges, wl.edge_skew, wl.hot_edge),
                    wl.service, wl.sizes))
    elif isinstance(wl, P.DiurnalArrivals):
        out.append((_diurnal_round_rates(wl, num_rounds, dt),
                    edge_weights(num_edges, wl.edge_skew, wl.hot_edge),
                    wl.service, wl.sizes))
    elif isinstance(wl, P.FlashCrowdArrivals):
        t0, t1 = wl.spike_start, wl.spike_start + wl.spike_duration
        spike_rate = max(0.0, (wl.multiplier - 1.0) * wl.base_rate)
        edges = np.arange(num_rounds)
        overlap = np.maximum(
            0.0, np.minimum(t1, (edges + 1) * dt) - np.maximum(t0, edges * dt))
        out.append((np.full(num_rounds, wl.base_rate * dt),
                    edge_weights(num_edges, wl.edge_skew, 0),
                    wl.service, wl.sizes))
        out.append((spike_rate * overlap,
                    edge_weights(num_edges, 64.0, wl.spike_edge),
                    wl.service, wl.sizes))
    elif isinstance(wl, P.MMPPArrivals):
        if len(wl.rates) != 2 or len(wl.mean_sojourn) != 2:
            raise ValueError(
                "materialize_round_batch_device supports 2-state MMPP only "
                f"(got {len(wl.rates)} states)")
        if mmpp:
            raise ValueError("at most one MMPP component per device workload")
        mmpp.append((tuple(float(x) for x in wl.rates),
                     tuple(float(x) for x in wl.mean_sojourn),
                     int(wl.start_state) % 2,
                     edge_weights(num_edges, wl.edge_skew, wl.hot_edge),
                     wl.service, wl.sizes))
    else:
        raise ValueError(
            f"workload {type(wl).__name__} has no device sampler; use the "
            f"host materialize_round_batch (supported: Poisson, Diurnal, "
            f"FlashCrowd, 2-state MMPP, ServiceMix/Merged thereof)")


def compile_device_plan(workload: Workload, num_edges: int, num_rounds: int,
                        round_interval: float) -> _DevicePlan:
    """Flatten a workload into the static tables the device sampler needs.
    Raises ValueError for workloads with no device law (traces, custom
    generators, >2-state MMPP)."""
    mix = None
    wl = workload
    if isinstance(wl, ServiceMix):
        ranks = np.arange(max(1, wl.num_services), dtype=np.float64)
        probs = (ranks + 1.0) ** (-float(wl.skew))
        probs = probs / probs.sum()
        prio_w = np.asarray(wl.priorities, np.float64)
        prio_w = prio_w / prio_w.sum() if prio_w.size else None
        deadline = tuple(wl.deadline) if wl.deadline else None
        mix = (tuple(probs), deadline, float(wl.deadline_frac),
               tuple(prio_w) if prio_w is not None else None)
        wl = wl.inner

    comps: list = []
    mmpp_parts: list = []
    _flatten_components(wl, num_edges, num_rounds, round_interval,
                        comps, mmpp_parts)

    sizes = [c[3] for c in comps] + [m[5] for m in mmpp_parts]
    if any(s != sizes[0] for s in sizes[1:]):
        raise ValueError(
            "device sampler requires all merged components to share one "
            f"SizeSpec (got {sizes})")

    static_lam = (np.stack([c[0] for c in comps], axis=1) if comps
                  else np.zeros((num_rounds, 0)))
    edge_probs = [c[1] for c in comps]
    service_ids = [c[2] for c in comps]
    mmpp = None
    if mmpp_parts:
        rates, sojourn, start, eprobs, svc, _ = mmpp_parts[0]
        mmpp = (rates, sojourn, start)
        edge_probs.append(eprobs)
        service_ids.append(svc)
    return _DevicePlan(
        static_lam=tuple(map(tuple, static_lam)),
        edge_probs=tuple(map(tuple, edge_probs)),
        service_ids=tuple(int(s) for s in service_ids),
        mmpp=mmpp, sizes=sizes[0], mix=mix)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _categorical(generator, logits, shape) -> torch.Tensor:
    """Draws of shape ``shape`` from Categorical(softmax(logits)) by
    Gumbel-max (``logits`` (..., K) broadcasts to ``shape + (K,)``); int64.
    Gumbel noise is -log of a standard exponential."""
    e = torch.empty(tuple(shape) + logits.shape[-1:], device=logits.device)
    e.exponential_(generator=generator)
    return torch.argmax(logits - torch.log(e), dim=-1)


def _mmpp_round_lam(generator, rates, mean_sojourn, start_state,
                    num_rounds: int, dt: float, batch: int) -> torch.Tensor:
    """Integrated per-round rate (B, R) of B independent 2-state MMPP
    trajectories: step the alternating chain round by round, resolving up
    to _MMPP_SUBSTEPS regime switches inside each round. The B chains move
    together; every exponential holding time comes from one draw."""
    device = generator.device
    rates_t, soj = _f32(rates, device), _f32(mean_sojourn, device)
    hold = torch.empty(batch, 1 + num_rounds * _MMPP_SUBSTEPS, device=device)
    hold.exponential_(generator=generator)
    state = torch.full((batch,), int(start_state), dtype=torch.long,
                       device=device)
    rem = hold[:, 0] * soj[state]
    lams = []
    for r in range(num_rounds):
        left = torch.full((batch,), float(dt), device=device)
        lam = torch.zeros(batch, device=device)
        for i in range(_MMPP_SUBSTEPS):
            seg = torch.minimum(rem, left)
            lam = lam + rates_t[state] * seg
            left = left - seg
            rem = rem - seg
            switch = rem <= 1e-12
            new_state = 1 - state
            new_rem = hold[:, 1 + r * _MMPP_SUBSTEPS + i] * soj[new_state]
            state = torch.where(switch, new_state, state)
            rem = torch.where(switch, new_rem, rem)
        lams.append(lam + rates_t[state] * torch.clamp(left, min=0.0))
    return torch.stack(lams, 1)


def _device_sizes(spec: SizeSpec, generator, shape) -> torch.Tensor:
    """Torch twin of SizeSpec.sample (same families, same clip)."""
    p = spec.params
    device = generator.device
    if spec.dist == "uniform":
        lo, hi = p if p else (0.0, 1.0)
        u = torch.rand(shape, generator=generator, device=device)
        out = lo + (hi - lo) * u
    elif spec.dist == "fixed":
        (value,) = p if p else (0.5,)
        out = torch.full(shape, float(value), device=device)
    elif spec.dist == "pareto":
        alpha, scale = p if p else (1.5, 0.05)
        # numpy's rng.pareto is the Lomax (standard Pareto minus one), so
        # host scale*(1+pareto) == device scale*Pareto, Pareto = exp(E/alpha)
        e = torch.empty(shape, device=device).exponential_(generator=generator)
        out = scale * torch.exp(e / alpha)
    elif spec.dist == "lognormal":
        mu, sigma = p if p else (-1.5, 0.8)
        n = torch.randn(shape, generator=generator, device=device)
        out = torch.exp(mu + sigma * n)
    else:
        raise ValueError(f"unknown size distribution {spec.dist!r}")
    return torch.clamp(out, 1e-6, spec.cap).to(torch.float32)


def _device_element(generator, plan: _DevicePlan, num_rounds: int,
                    width: int, dt: float, batch: int) -> dict:
    """Sample B episodes' (B, R, A) padded arrival tensors at once."""
    device = generator.device
    B, R, A = batch, num_rounds, width

    lam = _f32(plan.static_lam, device).expand(B, R, -1)   # (B, R, Cs)
    if plan.mmpp is not None:
        rates, sojourn, start = plan.mmpp
        lam_m = _mmpp_round_lam(generator, rates, sojourn, start, R, dt, B)
        lam = torch.cat([lam, lam_m[..., None]], dim=-1)
    lam_tot = lam.sum(-1)                                    # (B, R)

    counts = torch.poisson(lam_tot, generator=generator).to(torch.int32)
    kept = torch.clamp(counts, max=A)
    clipped = counts > A
    slot = torch.arange(A, device=device)

    # order-statistic arrival times on (r*dt, (r+1)*dt]
    u = 1.0 - torch.rand((B, R, A), generator=generator, device=device)
    n_plain = torch.where(clipped, A - 1, counts)           # plain uniforms
    u = torch.where(slot < n_plain[..., None], u, torch.inf)
    u = torch.sort(u, dim=-1).values
    u = torch.where(clipped[..., None] & (slot == A - 1), 1.0, u)
    # clipped rounds: slot A-1 is the A-th of n order stats ~ Beta(A, n-A+1)
    # = G1 / (G1 + G2) for independent G1 ~ Gamma(A), G2 ~ Gamma(n-A+1);
    # conditioned on it, slots 0..A-2 are scaled order stats beneath it
    b_param = torch.clamp(counts - A + 1, min=1).to(torch.float32)
    g1 = torch._standard_gamma(torch.full_like(b_param, float(A)),
                               generator=generator)
    g2 = torch._standard_gamma(b_param, generator=generator)
    s = g1 / (g1 + g2)
    u = u * torch.where(clipped, s, 1.0)[..., None]
    mask = slot < kept[..., None]
    rows = torch.arange(R, dtype=torch.float32, device=device)[:, None]
    t = torch.where(mask, (rows + u) * dt, 0.0).to(torch.float32)

    # component then edge: exact superposition mixture
    frac = lam / torch.clamp(lam_tot, min=1e-12)[..., None]  # (B, R, C)
    comp = _categorical(generator, torch.log(torch.clamp(frac, min=1e-30))
                        [:, :, None, :], (B, R, A))
    eprob = _f32(plan.edge_probs, device)                   # (C, Q)
    elogits = torch.log(torch.clamp(eprob, min=1e-30))[comp]  # (B, R, A, Q)
    edge = _categorical(generator, elogits, (B, R, A)).to(torch.int32)

    size = _device_sizes(plan.sizes, generator, (B, R, A))

    inf = torch.full((B, R, A), DEADLINE_INF, device=device)
    if plan.mix is not None:
        svc_probs, deadline, deadline_frac, prio_w = plan.mix
        service = _categorical(generator, torch.log(_f32(svc_probs, device)),
                               (B, R, A)).to(torch.int32)
        if deadline:
            lo, hi = deadline
            d = lo + (hi - lo) * torch.rand((B, R, A), generator=generator,
                                            device=device)
            take = (torch.ones((B, R, A), dtype=torch.bool, device=device)
                    if deadline_frac >= 1.0
                    else torch.rand((B, R, A), generator=generator,
                                    device=device) < deadline_frac)
            dl = torch.where(mask & take, t + d, inf)
        else:
            dl = inf
        if prio_w is not None:
            prio = _categorical(generator, torch.log(_f32(prio_w, device)),
                                (B, R, A)).to(torch.float32)
        else:
            prio = torch.zeros((B, R, A), device=device)
    else:
        service = torch.as_tensor(plan.service_ids, dtype=torch.int32,
                                  device=device)[comp]
        dl = inf
        prio = torch.zeros((B, R, A), device=device)

    # rids count every arrival (pre-clip) in global time order; each round's
    # kept slots take the first `kept` of its contiguous range: exactly the
    # host clip contract (the latest count-A arrivals of the round drop)
    starts = torch.cumsum(counts, -1) - counts
    rid = (starts[..., None] + slot).to(torch.int32)
    zi = torch.zeros((B, R, A), dtype=torch.int32, device=device)
    return {
        "t": t,
        "src": torch.where(mask, edge, zi),
        "size": torch.where(mask, size, 0.0),
        "mask": mask,
        "rid": torch.where(mask, rid, zi),
        "service": torch.where(mask, service, zi),
        "deadline": torch.where(mask, dl, DEADLINE_INF).to(torch.float32),
        "priority": torch.where(mask, prio, 0.0).to(torch.float32),
        "dropped": torch.clamp(counts - A, min=0).to(torch.int32),
    }


def materialize_round_batch_device(workload: Workload, num_edges: int,
                                   num_rounds: int, round_interval: float,
                                   batch: int, *,
                                   generator: torch.Generator,
                                   max_per_round: int,
                                   overflow: str = "clip") -> dict:
    """Device twin of :func:`materialize_round_batch`: sample a (B, R, A)
    padded arrival batch (the host layout, as tensors) with torch on
    ``generator``'s device, every element at once.

    ``max_per_round`` is required (fixed shapes) and only
    ``overflow="clip"`` is supported: counts are drawn on the device, so
    the host sampler's ``overflow="error"`` cannot raise here."""
    if overflow != "clip":
        raise ValueError(
            "materialize_round_batch_device supports overflow='clip' only "
            "(counts are drawn on the device; 'error' cannot raise there)")
    if max_per_round is None:
        raise ValueError("max_per_round is required (fixed device shapes)")
    plan = compile_device_plan(workload, num_edges, num_rounds,
                               round_interval)
    return _device_element(generator, plan, num_rounds, int(max_per_round),
                           float(round_interval), int(batch))
