"""The port's device episode and fault samplers against the port's host
samplers (the reference's numpy samplers, copied bit for bit) and the
reference's static parts, on the CPU (a CPU generator; the same code runs
on a CUDA generator, ``tests/test_torch_cuda.py``).

``materialize_round_batch_device`` and ``attach_fault_batch_device`` draw
with torch generators, so they can never equal the host samplers draw for
draw: they are held to the same *laws*, as ``tests/test_device_episodes.py``
holds the reference's jax sampler: count moments, size-distribution KS
statistics, edge/service/priority marginals, within-round order statistics,
the overflow="clip" rid/dropped contract (exact), the flash-crowd spike,
and the fault processes' rates. Their static parts (``compile_device_plan``,
``_scripted_overrides``) equal the reference's bit for bit, with the same
``ValueError``s.

KS thresholds are the reference tests' (no scipy needed): the two-sample
band is c * sqrt((n+m)/(n*m)) with c = 1.95 (alpha ~ 1e-3), one-sample
c / sqrt(n).

MMPP: the reference's ``test_mmpp_round_profile_matches_host`` fails its
last line, the overall means' ``rel=0.1`` (a fixed threshold on bursty
counts at B = 256), while its per-round 5-SE band passes. Here the MMPP
twin is held to the chain's exact transient mean per round and to the
host sampler, each within 5 standard errors computed from the samples
themselves; no fixed relative threshold.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.resilience import faults as jfaults
from repro.workloads import batch as jbatch
from repro.workloads import base as jbase
from repro.workloads import processes as jproc
from repro.workloads import scenarios as jscen
from repro_torch.resilience import faults as tfaults
from repro_torch.serving.rounds import MIN_JITTER
from repro_torch.workloads import (DEADLINE_INF, FlashCrowdArrivals, Merged,
                                   MMPPArrivals, PoissonArrivals, ServiceMix,
                                   SizeSpec, compile_device_plan,
                                   edge_weights, materialize_round_batch,
                                   materialize_round_batch_device, scenario)
from repro_torch.workloads import base as tbase
from repro_torch.workloads import processes as tproc
from repro_torch.workloads import scenarios as tscen

torch.set_num_threads(1)

DT = 0.25
C_KS = 1.95
SE = 5.0   # standard errors allowed for a sample mean


def device_batch(wl, num_edges, num_rounds, batch, width, seed=0):
    out = materialize_round_batch_device(
        wl, num_edges, num_rounds, DT, batch,
        generator=torch.Generator().manual_seed(seed), max_per_round=width)
    return {k: v.numpy() for k, v in out.items()}


def host_batch(wl, num_edges, num_rounds, batch, width, seed=0):
    return materialize_round_batch(
        wl, num_edges, num_rounds, DT, batch, base_seed=seed,
        max_per_round=width, overflow="clip")


def ks_two_sample(a, b):
    a, b = np.sort(a), np.sort(b)
    grid = np.concatenate([a, b])
    fa = np.searchsorted(a, grid, side="right") / a.size
    fb = np.searchsorted(b, grid, side="right") / b.size
    return float(np.max(np.abs(fa - fb)))


def ks_uniform(u):
    u = np.sort(u)
    n = u.size
    emp = np.arange(1, n + 1) / n
    return float(max(np.max(np.abs(emp - u)),
                     np.max(np.abs(emp - 1.0 / n - u))))


def ks_band(n, m):
    return C_KS * np.sqrt((n + m) / (n * m))


# -- arrival laws ---------------------------------------------------------------


def test_layout_dtypes_and_device():
    d = materialize_round_batch_device(
        scenario("cloud-cache-churn"), 4, 6, DT, 8,
        generator=torch.Generator().manual_seed(0), max_per_round=16)
    h = host_batch(scenario("cloud-cache-churn"), 4, 6, 8, 16)
    assert set(d) == set(h)
    for k, v in h.items():
        assert d[k].device.type == "cpu"
        assert tuple(d[k].shape) == v.shape, k
        assert d[k].numpy().dtype == v.dtype, k
    m = d["mask"]
    assert not d["src"][~m].any() and not d["size"][~m].any()
    assert bool((d["deadline"][~m] == DEADLINE_INF).all())


def test_poisson_count_moments():
    rate, R, B = 30.0, 8, 384
    d = device_batch(PoissonArrivals(rate=rate), 4, R, B, width=64)
    counts = d["mask"].sum(-1)
    lam = rate * DT
    assert counts.mean() == pytest.approx(lam, rel=0.05)
    assert counts.var() == pytest.approx(lam, rel=0.15)
    assert d["dropped"].sum() == 0


def test_edge_marginal_matches_zipf_weights():
    Q = 5
    wl = PoissonArrivals(rate=40.0, edge_skew=1.5, hot_edge=1)
    d = device_batch(wl, Q, 8, 256, width=64)
    src = d["src"][d["mask"]]
    hist = np.bincount(src, minlength=Q) / src.size
    np.testing.assert_allclose(hist, edge_weights(Q, 1.5, 1), atol=0.02)


@pytest.mark.parametrize("spec", [
    SizeSpec("pareto", (1.5, 0.05)),
    SizeSpec("lognormal", (-1.5, 0.8)),
    SizeSpec("uniform", (0.2, 0.9)),
    SizeSpec("fixed", (0.37,)),
])
def test_size_law_matches_host(spec):
    d = device_batch(PoissonArrivals(rate=40.0, sizes=spec), 3, 8, 128,
                     width=64)
    dev = d["size"][d["mask"]].astype(np.float64)
    host = spec.sample(np.random.default_rng(7), dev.size)
    if spec.dist == "fixed":
        np.testing.assert_allclose(dev, 0.37, atol=1e-6)
        return
    assert ks_two_sample(dev, host) < ks_band(dev.size, host.size), spec


def test_within_round_times_are_uniform_order_statistics():
    R = 6
    d = device_batch(PoissonArrivals(rate=30.0), 4, R, 256, width=64)
    t, mask = d["t"], d["mask"]
    rounds = np.arange(R)[None, :, None]
    lo, hi = rounds * DT, (rounds + 1) * DT
    assert np.all(t[mask] > np.broadcast_to(lo, t.shape)[mask])
    assert np.all(t[mask] <= np.broadcast_to(hi, t.shape)[mask] + 1e-6)
    diffs = np.diff(t, axis=-1)
    both = mask[..., 1:] & mask[..., :-1]
    assert np.all(diffs[both] >= 0)
    u = (t / DT - np.broadcast_to(rounds, t.shape))[mask]
    assert ks_uniform(np.clip(u, 0.0, 1.0)) < C_KS / np.sqrt(u.size)


def test_clip_contract_rids_and_dropped():
    R, A, B = 6, 8, 64
    d = device_batch(PoissonArrivals(rate=120.0), 4, R, B, width=A)
    counts = d["mask"].sum(-1)
    clipped = d["dropped"] > 0
    assert clipped.any()
    assert np.all(counts[clipped] == A)
    # the mask is a prefix of each round's row
    assert np.all(d["mask"] == (np.arange(A) < counts[..., None]))
    # clipped rounds keep the *earliest* A of n arrivals: the last kept one
    # sits at the A-th order statistic of n uniforms, mean A / (n + 1)
    u_last = (d["t"][..., A - 1] / DT - np.arange(R))[clipped]
    n = (counts + d["dropped"])[clipped]
    assert np.all((u_last > 0) & (u_last <= 1.0 + 1e-6))
    assert u_last.mean() == pytest.approx((A / (n + 1.0)).mean(), rel=0.05)
    # rids count *all* arrivals in time order (exact): each round's ids
    # start where the earlier rounds' arrivals, dropped ones included, end
    total = counts + d["dropped"]
    starts = np.cumsum(total, -1) - total
    want = np.where(d["mask"], starts[..., None] + np.arange(A), 0)
    np.testing.assert_array_equal(d["rid"], want)
    for b in range(B):
        ids = d["rid"].reshape(B, -1)[b][d["mask"].reshape(B, -1)[b]]
        assert np.all(np.diff(ids) > 0)


def _mmpp_transient_means(rates, sojourn, start, num_rounds, dt):
    """Exact expected count per round of a 2-state MMPP started in
    ``start``: the integral of lam_0 p_0(s) + lam_1 p_1(s) over each round,
    p_other(s) = pi_other (1 - exp(-k s)), k = the sum of the leave rates."""
    leave = 1.0 / np.asarray(sojourn, np.float64)
    k = leave.sum()
    other = 1 - start
    pi_other = leave[start] / k
    t0 = np.arange(num_rounds) * dt
    t1 = t0 + dt
    mass_other = pi_other * (dt - (np.exp(-k * t0) - np.exp(-k * t1)) / k)
    return rates[start] * dt + (rates[other] - rates[start]) * mass_other


def test_mmpp_round_profile_matches_analytic_law():
    wl = scenario("mmpp_bursty")
    R, B = 12, 1024
    cd = device_batch(wl, 4, R, B, width=64)["mask"].sum(-1)
    want = _mmpp_transient_means(np.asarray(wl.rates), wl.mean_sojourn,
                                 wl.start_state, R, DT)
    se_round = np.sqrt(cd.var(0) / B)
    np.testing.assert_array_less(np.abs(cd.mean(0) - want), SE * se_round)
    per_elem = cd.mean(1)   # rounds of one element are correlated
    assert abs(per_elem.mean() - want.mean()) < SE * np.sqrt(
        per_elem.var() / B)


def test_mmpp_round_profile_matches_host():
    wl = scenario("mmpp_bursty")
    R, B = 12, 512
    cd = device_batch(wl, 4, R, B, width=64)["mask"].sum(-1)
    ch = host_batch(wl, 4, R, 256, width=64, seed=11)["mask"].sum(-1)
    tol = SE * np.sqrt(cd.var(0) / B + ch.var(0) / ch.shape[0])
    np.testing.assert_array_less(np.abs(cd.mean(0) - ch.mean(0)), tol)
    md, mh = cd.mean(1), ch.mean(1)
    assert abs(md.mean() - mh.mean()) < SE * np.sqrt(
        md.var() / md.size + mh.var() / mh.size)


def test_flash_crowd_spike_rounds_and_edge():
    wl = FlashCrowdArrivals(base_rate=10.0, multiplier=10.0,
                            spike_start=1.0, spike_duration=0.5,
                            spike_edge=2)
    R, Q, B = 8, 4, 256
    d = device_batch(wl, Q, R, B, width=64)
    counts = d["mask"].sum(-1).mean(0)
    spike, base = counts[[4, 5]], counts[[0, 1, 2, 3, 6, 7]]
    assert spike.min() > 3.0 * base.max()
    in_spike = d["mask"][:, 4:6, :]
    frac_hot = (d["src"][:, 4:6, :][in_spike] == 2).mean()
    h = host_batch(wl, Q, R, B, width=64, seed=3)
    h_hot = (h["src"][:, 4:6, :][h["mask"][:, 4:6, :]] == 2).mean()
    assert frac_hot == pytest.approx(h_hot, abs=0.05)


def test_service_mix_laws():
    wl = ServiceMix(PoissonArrivals(rate=40.0), num_services=6, skew=1.2,
                    deadline=(0.5, 2.0), deadline_frac=0.5,
                    priorities=(3.0, 1.0))
    d = device_batch(wl, 3, 8, 256, width=64)
    m = d["mask"]
    svc = d["service"][m]
    ranks = np.arange(6, dtype=np.float64)
    probs = (ranks + 1.0) ** -1.2
    probs /= probs.sum()
    np.testing.assert_allclose(np.bincount(svc, minlength=6) / svc.size,
                               probs, atol=0.02)
    prio = d["priority"][m]
    np.testing.assert_allclose(np.bincount(prio.astype(int), minlength=2)
                               / prio.size, [0.75, 0.25], atol=0.02)
    dl, t = d["deadline"][m], d["t"][m]
    finite = dl < DEADLINE_INF / 2
    assert finite.mean() == pytest.approx(0.5, abs=0.03)
    rel = (dl - t)[finite]
    assert np.all((rel >= 0.5 - 1e-5) & (rel <= 2.0 + 1e-5))
    u = np.clip((rel - 0.5) / 1.5, 0.0, 1.0)
    assert ks_uniform(u) < C_KS / np.sqrt(u.size)


@pytest.mark.parametrize("name", ["uniform_iid", "hotspot_skew",
                                  "heavy_tail_pareto", "diurnal",
                                  "chaos-rolling-failure"])
def test_scenario_moment_parity_with_host(name):
    wl = scenario(name)
    R, Q, B = 8, 5, 192
    width = 64 if name != "chaos-rolling-failure" else 96
    d = device_batch(wl, Q, R, B, width=width)
    h = host_batch(wl, Q, R, B, width=width, seed=5)
    assert d["mask"].sum(-1).mean() == pytest.approx(
        h["mask"].sum(-1).mean(), rel=0.1)
    assert d["size"][d["mask"]].mean() == pytest.approx(
        h["size"][h["mask"]].mean(), rel=0.1)


# -- static parts against the reference, and the refusals -----------------------


def _plan_fields(plan):
    out = dataclasses.asdict(plan)
    out["sizes"] = (plan.sizes.dist, plan.sizes.params, plan.sizes.cap)
    return out


EXTRA_WORKLOADS = {
    "merged_spike": lambda m: m.Merged((
        m.PoissonArrivals(rate=12.0, edge_skew=0.7, hot_edge=2, service=1),
        m.FlashCrowdArrivals(base_rate=5.0, multiplier=6.0, spike_start=0.4,
                             spike_duration=0.6, spike_edge=1, service=3))),
    "mmpp_plus_diurnal": lambda m: m.Merged((
        m.MMPPArrivals(rates=(3.0, 40.0), mean_sojourn=(1.0, 0.5),
                       start_state=3, edge_skew=1.1, hot_edge=1),
        m.DiurnalArrivals(base_rate=9.0, amplitude=0.5, period=2.0,
                          phase=0.3))),
    "mix_no_deadline": lambda m: m.ServiceMix(
        m.PoissonArrivals(rate=25.0), num_services=4, skew=0.0),
}


def _ns(base, proc):
    ns = dict(vars(base))
    ns.update(vars(proc))
    return type("M", (), ns)


@pytest.mark.parametrize("name", [n for n in jscen.list_scenarios()]
                         + sorted(EXTRA_WORKLOADS))
def test_compile_device_plan_matches_reference(name):
    if name in EXTRA_WORKLOADS:
        jwl = EXTRA_WORKLOADS[name](_ns(jbase, jproc))
        twl = EXTRA_WORKLOADS[name](_ns(tbase, tproc))
    else:
        jwl, twl = jscen.scenario(name), tscen.scenario(name)
    for q, r in ((5, 12), (3, 7)):
        want = jbatch.compile_device_plan(jwl, q, r, DT)
        got = compile_device_plan(twl, q, r, DT)
        assert _plan_fields(got) == _plan_fields(want)


def _refusals(m, batch_mod):
    mm = m.MMPPArrivals()
    mixed = m.Merged((m.PoissonArrivals(sizes=m.SizeSpec("uniform")),
                      m.PoissonArrivals(sizes=m.SizeSpec("pareto",
                                                         (1.5, 0.05)))))
    three = m.MMPPArrivals(rates=(1.0, 2.0, 3.0),
                           mean_sojourn=(1.0, 1.0, 1.0))
    inhom = m.InhomogeneousPoisson(rate_fn=lambda t: 5.0, rate_max=5.0)
    out = []
    for wl in (m.Merged((mm, mm)), mixed, three, inhom):
        with pytest.raises(ValueError) as err:
            batch_mod.compile_device_plan(wl, 3, 4, DT)
        out.append(str(err.value))
    return out


def test_unsupported_workloads_raise_as_the_reference():
    want = _refusals(_ns(jbase, jproc), jbatch)
    from repro_torch.workloads import batch as tbatch
    assert _refusals(_ns(tbase, tproc), tbatch) == want


def test_unsupported_options_raise():
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="MMPP"):
        materialize_round_batch_device(Merged((MMPPArrivals(),) * 2), 3, 4,
                                       DT, 8, generator=gen, max_per_round=8)
    with pytest.raises(ValueError, match="clip"):
        materialize_round_batch_device(PoissonArrivals(), 3, 4, DT, 8,
                                       generator=gen, max_per_round=8,
                                       overflow="error")
    with pytest.raises(ValueError, match="max_per_round"):
        materialize_round_batch_device(PoissonArrivals(), 3, 4, DT, 8,
                                       generator=gen, max_per_round=None)


FAULT_SPECS = [
    dict(rolling=(2, 2)),
    dict(scripted_failures=((0, 1, 4), (7, 3, 9), (2, -1, 2)),
         scripted_stragglers=((1, 2, 5, 3.5), (6, 0, 20, 2.0))),
    dict(rolling=(1, 3), scripted_failures=((1, 0, 2),), min_alive=2,
         scripted_stragglers=((4, 4, 6, 7.0),)),
    dict(fail_prob=0.3, straggle_prob=0.2, jitter_sigma=0.4),
]


@pytest.mark.parametrize("kw", FAULT_SPECS)
@pytest.mark.parametrize("q,r", [(5, 12), (3, 8)])
def test_scripted_overrides_match_reference(kw, q, r):
    want = jfaults._scripted_overrides(jfaults.FaultSpec(**kw), q, r)
    got = tfaults._scripted_overrides(tfaults.FaultSpec(**kw), q, r)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


# -- the fault twin ---------------------------------------------------------------


def device_faults(spec, q, r, batch, seed=0):
    out = tfaults.materialize_faults_device(
        spec, q, r, batch=batch, generator=torch.Generator().manual_seed(seed))
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("kw", FAULT_SPECS[:3])
def test_scripted_and_rolling_rows_equal_the_host(kw):
    """With no Markov part the trajectory is deterministic: every element
    equals the host's rows exactly (min_alive floor included)."""
    spec = tfaults.FaultSpec(**kw)
    q, r = 5, 12
    d = device_faults(spec, q, r, batch=3)
    h = tfaults.materialize_faults(spec, q, r, seed=0)
    assert d["alive"].dtype == h["alive"].dtype
    assert d["speed"].dtype == h["speed"].dtype
    for b in range(3):
        np.testing.assert_array_equal(d["alive"][b], h["alive"])
        np.testing.assert_array_equal(d["speed"][b], h["speed"])


def test_min_alive_floor_revives_the_lowest_indexed_dead_edges():
    spec = tfaults.FaultSpec(scripted_failures=tuple((q, 0, 6)
                                                     for q in range(5)),
                             min_alive=2)
    d = device_faults(spec, 5, 6, batch=2)
    np.testing.assert_array_equal(
        d["alive"], np.broadcast_to([True, True, False, False, False],
                                    (2, 6, 5)))
    churn = tfaults.FaultSpec(fail_prob=0.9, recover_prob=0.05, min_alive=3)
    d = device_faults(churn, 6, 20, batch=64, seed=1)
    assert d["alive"].sum(-1).min() >= 3
    assert (d["alive"].sum(-1) == 3).mean() > 0.5   # the floor binds


def _rates(alive):
    """Empirical P(up -> down) and P(down -> up) per edge-round."""
    prev, nxt = alive[:, :-1], alive[:, 1:]
    fail = (prev & ~nxt).sum() / max(prev.sum(), 1)
    rec = (~prev & nxt).sum() / max((~prev).sum(), 1)
    return fail, rec


def test_fail_and_recover_rates_match_the_host():
    spec = tfaults.FaultSpec(fail_prob=0.15, recover_prob=0.3)
    q, r, b = 8, 24, 256
    d = device_faults(spec, q, r, batch=b, seed=2)["alive"]
    h = np.stack([tfaults.materialize_faults(spec, q, r, seed=s)["alive"]
                  for s in range(b)])
    for x in (d, h):
        fail, rec = _rates(x)
        assert fail == pytest.approx(0.15, abs=0.01)
        assert rec == pytest.approx(0.3, abs=0.02)
    up_d, up_h = d.mean((1, 2)), h.mean((1, 2))
    assert abs(up_d.mean() - up_h.mean()) < SE * np.sqrt(
        up_d.var() / b + up_h.var() / b)


def test_straggle_rates_and_factor_match_the_host():
    spec = tfaults.FaultSpec(straggle_prob=0.2, straggle_recover_prob=0.5,
                             straggle_factor=5.0)
    q, r, b = 6, 24, 256
    d = device_faults(spec, q, r, batch=b, seed=3)["speed"]
    h = np.stack([tfaults.materialize_faults(spec, q, r, seed=s)["speed"]
                  for s in range(b)])
    assert set(np.unique(d)) == {1.0, 5.0}
    for x in (d, h):
        on = x > 1.0
        start, stop = _rates(~on)   # up -> straggling, straggling -> up
        assert start == pytest.approx(0.2, abs=0.015)
        assert stop == pytest.approx(0.5, abs=0.03)
    sd, sh = (d > 1).mean((1, 2)), (h > 1).mean((1, 2))
    assert abs(sd.mean() - sh.mean()) < SE * np.sqrt(
        sd.var() / b + sh.var() / b)


def test_attached_jitter_law_and_floor():
    spec = tfaults.FaultSpec(straggle_prob=0.2, jitter_sigma=0.6)
    arr = materialize_round_batch_device(
        PoissonArrivals(rate=40.0), 4, 8, DT, 64,
        generator=torch.Generator().manual_seed(4), max_per_round=32)
    out = tfaults.attach_fault_batch_device(arr, spec, 4,
                                            torch.Generator().manual_seed(5))
    assert tuple(out["alive"].shape) == (64, 8, 4)
    assert out["alive"].dtype == torch.bool
    assert out["speed"].dtype == out["jitter"].dtype == torch.float32
    m = out["mask"].numpy()
    jit = out["jitter"].numpy()
    assert np.all(jit[~m] == 1.0)
    assert jit[m].min() >= MIN_JITTER
    host = tfaults.jitter_table(tfaults.FaultSpec(jitter_sigma=0.6),
                                20_000, seed=1)
    assert ks_two_sample(jit[m], host) < ks_band(int(m.sum()), host.size)
    # no jitter without sigma; host arrays are accepted too
    plain = tfaults.attach_fault_batch_device(
        host_batch(PoissonArrivals(rate=40.0), 4, 8, 4, 32),
        tfaults.FaultSpec(rolling=(1, 1)), 4, torch.Generator())
    assert "jitter" not in plain and plain["mask"].dtype == torch.bool
