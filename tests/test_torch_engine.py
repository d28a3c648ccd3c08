"""The port's batched rollout engine against the JAX reference engine, on
the CPU, on the same numpy arrival tensors.

The pieces (``stable_order``, the lane recursion cut to the startable
slots against the full one, ``advance``, ``apply_faults``,
``round_instance``, ``commit``, ``cache_commit``,
``slot_workload_features``, every ``resilience.policies`` function and
the summaries) are held on mid-rollout states of the reference; whole
rollouts with ``local`` and ``greedy`` on the flat, chaos (faults, breaker,
admission, retry backoff) and cloud + cache scenarios, with ``learn_phi``,
and with ``policy`` (B1's plain version) and ``policy-fused`` (B3's) on
weights bridged from the reference's; batched equal to per-instance;
``evaluate_rollouts``.

Tolerances: counts, indices and decisions exact; floats within 1e-4.
Policy decisions are compared where the top-2 gap exceeds 1e-4; where it
does not, the port is handed the reference's decision so the two rollouts
stay in step (every round must hold gapped requests).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import inference as jinf
from repro.core import policy as jpol
from repro.core import state as jstate
from repro.core.evaluate import evaluate_rollouts as j_evaluate_rollouts
from repro.resilience import policies as jres
from repro.serving import cache as jcache
from repro.serving import engine as je
from repro.workloads import scenarios as jscen
from repro_torch.checkpoint import load_reference_params
from repro_torch.core import inference as tinf
from repro_torch.core import policy as tpol
from repro_torch.core import state as tstate
from repro_torch.core.evaluate import evaluate_rollouts
from repro_torch.kernels import policy_score
from repro_torch.resilience import faults as tfaults
from repro_torch.resilience import policies as tres
from repro_torch.serving import cache as tcache
from repro_torch.serving import engine as te
from repro_torch.workloads import batch as tbatch
from repro_torch.workloads import scenarios as tscen

torch.set_num_threads(1)

Q, R, DT, B = 5, 12, 0.25, 4
ATOL = 1e-4
GAP = 1e-4
SMALL = dict(d_model=32, ff_hidden=64, edge_layers=2, request_layers=1)
CHAOS_RES = dict(admission="slo_threshold", breaker=True,
                 retry_backoff_rounds=1.0)
FLAT = ["uniform_iid", "flash_crowd_10x", "mmpp_bursty", "heavy_tail_pareto"]
CHAOS = ["chaos-rolling-failure", "chaos-flash-failure",
         "chaos-straggler-storm"]
CLOUD = ["cloud-cache-churn", "cloud-burst-offload"]


def _configs(name, *, resilience=None, rounds=R, width=64, **kw):
    """(reference EngineConfig, port EngineConfig) for scenario ``name``:
    its cloud + cache specs (Q = 4 edges + the cloud), its faults."""
    jcloud, jcache_spec = jscen.scenario_cloud_spec(name)
    tcloud, tcache_spec = tscen.scenario_cloud_spec(name)
    q = 4 if jcloud is not None else Q
    common = dict(num_edges=q, num_rounds=rounds, round_interval=DT,
                  max_per_round=width, **kw)
    cfg_j = je.EngineConfig(**common, cloud=jcloud, cache=jcache_spec,
                            resilience=(jres.ResilienceConfig(**resilience)
                                        if resilience else None))
    cfg_t = te.EngineConfig(**common, cloud=tcloud, cache=tcache_spec,
                            resilience=(tres.ResilienceConfig(**resilience)
                                        if resilience else None))
    return cfg_j, cfg_t


def _arrivals(name, cfg, seeds, rounds=None):
    """(B, R, A) arrivals of ``name`` (one seed each), with the scenario's
    fault rows attached; overflow clips into ``dropped``."""
    rounds = rounds or cfg.num_rounds
    arr = tbatch.materialize_round_batch(
        tscen.scenario(name), cfg.num_edges, rounds, DT, len(seeds),
        base_seed=seeds[0], max_per_round=cfg.max_per_round, overflow="clip")
    spec = tscen.scenario_fault_spec(name)
    if spec is not None:
        arr = tfaults.attach_fault_batch(arr, spec, cfg.num_edges,
                                         seeds=seeds)
    return arr


def _ref_run(cfg_j, fn, arr, seeds, drain=True):
    run = je.make_rollout(cfg_j, fn, batch=True,
                          drain_to=je.DRAIN_HORIZON if drain else None)
    keys = jax.random.split(jax.random.PRNGKey(0), len(seeds))
    final, infos = run(je.init_batch(cfg_j, seeds), arr, keys)
    return jax.device_get(final), jax.device_get(infos)


def _port_run(cfg_t, fn, arr, seeds, drain=True, generator=None):
    run = te.make_rollout(cfg_t, fn, batch=True,
                          drain_to=te.DRAIN_HORIZON if drain else None)
    return run(te.init_batch(cfg_t, seeds, device="cpu"), arr, generator)


def _t(tree):
    return {k: torch.as_tensor(np.array(v)) for k, v in tree.items()}


def _assert_close(got, want, what=""):
    """Ints and bools exactly, floats within ATOL."""
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        w = np.asarray(want[k])
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL,
                                       err_msg=f"{what} {k}")


def _assert_summary(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if isinstance(w, float):
            assert got[k] == pytest.approx(w, abs=ATOL), k
        else:
            assert got[k] == w, k


def _mid_state(name, rounds_done, resilience=None, seeds=(0, 1, 2, 3)):
    """A reference state after ``rounds_done`` local rounds, undrained,
    with the configs and the full arrivals."""
    cfg_j, cfg_t = _configs(name, resilience=resilience)
    arr = _arrivals(name, cfg_t, list(seeds))
    head = {k: v[:, :rounds_done] for k, v in arr.items()}
    state, _ = _ref_run(cfg_j, je.local_assign, head, list(seeds),
                        drain=False)
    return cfg_j, cfg_t, arr, state


def _round(arr, r):
    return {k: v[:, r] for k, v in arr.items()}


# -- pieces ---------------------------------------------------------------------


def test_stable_order_matches_pairwise_rank_with_ties_and_inf():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 6, size=(5, 300)).astype(np.float32)
    keys[rng.random(keys.shape) < 0.3] = je.INF
    keys[1] = je.INF  # a row of padding only
    keys[2] = 0.5     # one long tie
    want = np.stack([np.asarray(je.stable_order(jnp.asarray(k)))
                     for k in keys])
    got = te.stable_order(torch.from_numpy(keys))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(te.stable_order(torch.from_numpy(keys[0])),
                                  want[0])


@pytest.mark.parametrize("name,rounds_done", [("uniform_iid", 5),
                                              ("hotspot_skew", 7),
                                              ("chaos-rolling-failure", 6)])
def test_cut_lane_loop_equals_full_loop_and_reference(name, rounds_done):
    """The recursion over max_b(#startable) steps equals it over every
    slot bit for bit, and ``advance`` equals the reference's."""
    cfg_j, cfg_t, _, state = _mid_state(name, rounds_done)
    st = _t(state)
    t_new = st["t"] + DT
    t_col = t_new[:, None]
    startable = ((st["slot_edge"] >= 0) & (st["slot_start"] > te.INF / 2)
                 & (st["slot_ready"] <= t_col))
    keys = torch.where(startable, st["slot_ready"], te.INF)
    order = te.stable_order(keys)
    steps = int(startable.sum(-1).max())
    assert 0 < steps < keys.shape[-1]
    cut = te._lane_recursion(st, keys, order, t_col, steps, cfg_t)[:3]
    full = te._lane_recursion(st, keys, order, t_col, keys.shape[-1],
                              cfg_t)[:3]
    for a, b in zip(cut, full):
        assert torch.equal(a, b)
    want = jax.device_get(jax.vmap(lambda s, t: je.advance(s, t, cfg_j))(
        state, state["t"] + DT))
    got = te.advance(st, t_new, cfg_t)
    _assert_close(got, want, "advance")
    # the drain horizon, as a float
    _assert_close(te.advance(st, te.DRAIN_HORIZON, cfg_t),
                  jax.device_get(jax.vmap(
                      lambda s: je.advance(s, je.DRAIN_HORIZON, cfg_j))(state)),
                  "drain")


def test_advance_with_learn_phi_matches_reference():
    cfg_j, cfg_t = _configs("uniform_iid", learn_phi=True, phi_min_samples=3)
    arr = _arrivals("uniform_iid", cfg_t, [0, 1, 2, 3])
    state, _ = _ref_run(cfg_j, je.local_assign,
                        {k: v[:, :8] for k, v in arr.items()}, [0, 1, 2, 3],
                        drain=False)
    assert (state["phi_n"] >= 3).any()
    want = jax.device_get(jax.vmap(lambda s: je.advance(s, s["t"] + DT,
                                                        cfg_j))(state))
    got = te.advance(_t(state), torch.as_tensor(state["t"]) + DT, cfg_t)
    _assert_close(got, want, "learn_phi advance")


@pytest.mark.parametrize("resilience", [None, CHAOS_RES])
def test_apply_faults_matches_reference(resilience):
    cfg_j, cfg_t, arr, state = _mid_state("chaos-rolling-failure", 3,
                                          resilience=resilience)
    for r in (3, 4, 6):  # an edge dies, recovers, the next one dies
        row = _round(arr, r)
        want = jax.device_get(jax.vmap(
            lambda s, a: je.apply_faults(s, a, cfg_j))(state, row))
        got = te.apply_faults(_t(state), _t(row), cfg_t)
        _assert_close(got, want, f"apply_faults round {r}")
        state = want
    assert int(np.sum(state["retried"])) > 0


@pytest.mark.parametrize("name,resilience", [
    ("cloud-cache-churn", None), ("cloud-burst-offload", None),
    ("chaos-rolling-failure", CHAOS_RES), ("uniform_iid", None)])
def test_round_instance_matches_reference(name, resilience):
    cfg_j, cfg_t, arr, state = _mid_state(name, 4, resilience=resilience)
    row = _round(arr, 4)
    if "alive" in row:  # the breaker's mask needs a fault row applied
        state = jax.device_get(jax.vmap(
            lambda s, a: je.apply_faults(s, a, cfg_j))(state, row))
    want = jax.device_get(jax.vmap(
        lambda s, a: je.round_instance(s, a, cfg_j))(state, row))
    got = te.round_instance(_t(state), _t(row), cfg_t)
    assert sorted(got) == sorted(want)
    _assert_close(got, want, "round_instance")
    if cfg_t.cache is not None:
        assert {"cache_frac", "req_cached", "req_slack"} <= set(got)


@pytest.mark.parametrize("name", ["cloud-cache-churn", "uniform_iid"])
def test_commit_matches_reference(name):
    cfg_j, cfg_t, arr, state = _mid_state(name, 5)
    row = _round(arr, 5)
    rng = np.random.default_rng(3)
    assign = rng.integers(0, cfg_t.num_nodes, size=row["mask"].shape
                          ).astype(np.int32)
    admit = rng.random(row["mask"].shape) < 0.8
    offset = (je.RETRY_EPS * (rng.random(admit.shape) < 0.2)).astype(
        np.float32)
    want = jax.device_get(jax.vmap(
        lambda s, a, x, m, o: je.commit(s, a, x, cfg_j, admit=m,
                                        ready_offset=o))(
        state, row, assign, admit, offset))
    got = te.commit(_t(state), _t(row), torch.from_numpy(assign), cfg_t,
                    admit=torch.from_numpy(admit),
                    ready_offset=torch.from_numpy(offset))
    _assert_close(got, want, "commit")
    if cfg_t.cache is not None:
        assert int(got["cache_misses"].sum()) > 0
        assert int(got["cache_hits"].sum()) > 0


def test_commit_rejects_a_batch_out_of_step():
    _, cfg_t, arr, state = _mid_state("uniform_iid", 2)
    st = _t(state)
    st["round"] = st["round"].clone()
    st["round"][1] += 1
    row = _t(_round(arr, 2))
    with pytest.raises(ValueError, match="rounds 2..3"):
        te.commit(st, row, row["src"], cfg_t)


def test_cache_commit_matches_reference():
    rng = np.random.default_rng(1)
    spec = jcache.CacheSpec(slots=2, num_services=6)
    n, edges, a = 6, 5, 40
    cache = np.stack([jcache.initial_cache(n, edges, spec)] * 3)
    ptr = rng.integers(0, 2, size=(3, n)).astype(np.int32)
    assign = rng.integers(0, n, size=(3, a)).astype(np.int32)
    service = rng.integers(0, 6, size=(3, a)).astype(np.int32)
    on = rng.random((3, a)) < 0.8
    want = jax.device_get(jax.vmap(
        lambda c, p, x, s, o: jcache.cache_commit(c, p, x, s, o, edges))(
        cache, ptr, assign, service, on))
    got = tcache.cache_commit(*(torch.from_numpy(x) for x in
                                (cache, ptr, assign, service, on)), edges)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert want[2].sum() > 0 and (~want[2] & on).sum() > 0


def test_slot_workload_features_matches_reference():
    rng = np.random.default_rng(2)
    b, q, z = 3, 6, 80
    phi = rng.uniform(0.1, 1.0, (b, q, 2)).astype(np.float32)
    reps = rng.integers(1, 5, (b, q)).astype(np.float32)
    w = rng.uniform(0, 1.5, (b, q, q)).astype(np.float32)
    ct = np.float32([1.0, 0.5, 2.0])
    size = rng.random((b, z)).astype(np.float32)
    src = rng.integers(0, q, (b, z)).astype(np.int32)
    edge = rng.integers(-1, q, (b, z)).astype(np.int32)
    ready = rng.uniform(0, 2, (b, z)).astype(np.float32)
    start = np.where(rng.random((b, z)) < 0.5, je.INF,
                     ready + 0.3).astype(np.float32)
    t = np.float32([0.9, 1.0, 1.4])
    args = (phi, reps, w, ct, size, src, edge, ready, start, t)
    want = np.asarray(jax.vmap(jstate.slot_workload_features)(*args))
    got = tstate.slot_workload_features(*(torch.from_numpy(x) for x in args))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    one = tstate.slot_workload_features(*(torch.as_tensor(x[0])
                                          for x in args))
    np.testing.assert_allclose(one.numpy(), want[0], rtol=0, atol=1e-6)


def test_resilience_policies_match_reference():
    rng = np.random.default_rng(4)
    b, q, a = 4, 6, 30
    w = rng.integers(0, 3, (b, q, q)).astype(np.float32)  # many ties
    w = np.minimum(w, np.swapaxes(w, 1, 2))
    w[:, np.arange(q), np.arange(q)] = 0.0
    alive = rng.random((b, q)) < 0.6
    alive[:, 2] = True
    idx = rng.integers(0, q, (b, a)).astype(np.int32)
    vj = jax.vmap
    np.testing.assert_array_equal(
        tres.nearest_alive(*map(torch.from_numpy, (w, alive, idx))).numpy(),
        np.asarray(vj(jres.nearest_alive)(w, alive, idx)))

    inst = {"req_src": idx, "req_size": rng.random((b, a)).astype(np.float32),
            "ct": np.float32([1.0, 0.5, 1.5, 1.0]), "w": w,
            "workload": rng.random((b, q, 3)).astype(np.float32) * 3,
            "phi": rng.uniform(0.1, 1, (b, q, 2)).astype(np.float32),
            "req_mask": rng.random((b, a)) < 0.9}
    assign = rng.integers(0, q, (b, a)).astype(np.int32)
    np.testing.assert_allclose(
        tres.est_response(_t(inst), torch.from_numpy(assign)).numpy(),
        np.asarray(vj(jres.est_response)(inst, assign)), rtol=0, atol=1e-6)
    for mode in ("none", "policy", "slo_threshold", "queue_depth"):
        for thr in (0.0, 1.5):
            jr = jres.ResilienceConfig(admission=mode, admit_threshold=thr)
            tr = tres.ResilienceConfig(admission=mode, admit_threshold=thr)
            np.testing.assert_array_equal(
                tres.admission_mask(tr, _t(inst),
                                    torch.from_numpy(assign)).numpy(),
                np.asarray(vj(lambda i, x: jres.admission_mask(jr, i, x))(
                    inst, assign)), err_msg=mode)
    with pytest.raises(ValueError, match="admission"):
        tres.ResilienceConfig(admission="nope")

    jr = jres.ResilienceConfig(breaker=True, breaker_reset_rounds=2,
                               breaker_probe=2)
    tr = tres.ResilienceConfig(breaker=True, breaker_reset_rounds=2,
                               breaker_probe=2)
    open_until = rng.choice([-1.0, 0.5, 1.0, 2.0], (b, q)).astype(np.float32)
    trips = rng.integers(0, 4, (b, q)).astype(np.float32)
    healthy = rng.integers(0, 3, (b, q)).astype(np.float32)
    died = rng.random((b, q)) < 0.3
    t = np.float32([0.5, 1.0, 1.5, 2.0])
    want = vj(lambda o, tr_, h, d, al, tt: jres.breaker_step(
        o, tr_, h, d, al, tt, DT, jr))(open_until, trips, healthy, died,
                                       alive, t)
    got = tres.breaker_step(*map(torch.from_numpy, (open_until, trips, healthy,
                                                    died, alive)),
                            torch.from_numpy(t)[:, None], DT, tr)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    alive2 = alive.copy()
    alive2[0] = [True, False, False, False, False, False]
    open2 = open_until.copy()
    open2[0, 0] = 9.0  # the only alive edge behind an open breaker
    np.testing.assert_array_equal(
        tres.dispatch_mask(torch.from_numpy(alive2), torch.from_numpy(open2),
                           torch.from_numpy(t)[:, None]).numpy(),
        np.asarray(vj(jres.dispatch_mask)(alive2, open2, t)))

    half_open = rng.random((b, q)) < 0.4
    closed = ~half_open & alive
    closed[3] = False  # no closed edge: a no-op
    mask = inst["req_mask"]
    np.testing.assert_array_equal(
        tres.probe_cap(*map(torch.from_numpy, (w, assign, mask, idx,
                                               half_open, closed)), tr).numpy(),
        np.asarray(vj(lambda *x: jres.probe_cap(*x, jr))(
            w, assign, mask, idx, half_open, closed)))


def test_summaries_match_reference():
    cfg_j, cfg_t = _configs("chaos-rolling-failure", resilience=CHAOS_RES)
    arr = _arrivals("chaos-rolling-failure", cfg_t, [0, 1, 2, 3])
    # leave the tail in flight: some requests stranded, deadlines mixed
    final, _ = _ref_run(cfg_j, je.local_assign, arr, [0, 1, 2, 3],
                        drain=False)
    final["slot_deadline"] = np.where(
        final["slot_edge"] >= 0, final["slot_submit"] + 1.5,
        final["slot_deadline"]).astype(np.float32)
    st = _t(final)
    for slo in (None, 2.0):
        _assert_summary(te.summarize(st, slo=slo), je.summarize(final, slo=slo))
        one = {k: v[1] for k, v in final.items()}
        _assert_summary(te.summarize(_t(one), slo=slo),
                        je.summarize(one, slo=slo))
        disp = np.array([True, False, True, False])
        want_p = jax.device_get(je.summarize_partials(final, displaced=disp,
                                                      slo=slo))
        got_p = te.summarize_partials(st, displaced=torch.from_numpy(disp),
                                      slo=slo)
        assert sorted(got_p) == sorted(want_p)
        _assert_close(got_p, want_p, "partials")
        _assert_summary(te.partials_to_summary(got_p, slo=slo),
                        je.partials_to_summary(want_p, slo=slo))
    assert te.SUMMARY_KEYS == je.SUMMARY_KEYS
    hist = np.array([0, 3, 0, 5, 1, 0, 2], np.int64)
    for pct in (0.0, 50.0, 95.0, 100.0):
        assert te._hist_percentile(hist, pct, 7.0, 6.5) == \
            je._hist_percentile(hist, pct, 7.0, 6.5)
    empty = dict(final, slot_edge=np.full_like(final["slot_edge"], -1))
    _assert_summary(te.summarize(_t(empty), slo=1.0),
                    je.summarize(empty, slo=1.0))


# -- whole rollouts ------------------------------------------------------------


@pytest.mark.parametrize("backend", ["local", "greedy"])
@pytest.mark.parametrize("name", FLAT + CHAOS + CLOUD)
def test_rollout_matches_reference(name, backend):
    cfg_j, cfg_t = _configs(name)
    seeds = [0, 1, 2, 3]
    arr = _arrivals(name, cfg_t, seeds)
    want, winfo = _ref_run(cfg_j, je.ASSIGN_FNS[backend], arr, seeds)
    got, ginfo = _port_run(cfg_t, te.ASSIGN_FNS[backend], arr, seeds)
    _assert_close(got, want, "final state")
    _assert_close(ginfo, winfo, "infos")
    summary = te.summarize(got)
    _assert_summary(summary, je.summarize(want))
    assert summary["completed"] > 0
    if name in CHAOS[:2]:
        assert summary["retried_requests"] > 0
    if name in CLOUD:
        assert summary["cache_misses"] > 0
        assert (summary["cloud_completed"] > 0) == (backend == "greedy")


@pytest.mark.parametrize("name", ["chaos-rolling-failure",
                                  "cloud-cache-churn"])
@pytest.mark.parametrize("backend", ["local", "greedy"])
def test_chaos_rollout_with_admission_breaker_and_backoff(backend, name):
    """The resilience mechanisms together; on the tiered cluster the fault
    rows cover the edges and the engine pads the cloud's column."""
    cfg_j, cfg_t = _configs(name, resilience=CHAOS_RES)
    seeds = [3, 4, 5, 6]
    arr = _arrivals(name, cfg_t, seeds)
    if "alive" not in arr:  # a rolling outage over the cloud's edges
        arr = tfaults.attach_fault_batch(
            arr, tfaults.FaultSpec(rolling=(2, 2)), cfg_t.num_edges,
            seeds=seeds)
    want, winfo = _ref_run(cfg_j, je.ASSIGN_FNS[backend], arr, seeds)
    got, ginfo = _port_run(cfg_t, te.ASSIGN_FNS[backend], arr, seeds)
    _assert_close(got, want, "final state")
    _assert_close(ginfo, winfo, "infos")
    m = te.summarize(got, slo=3.0)
    _assert_summary(m, je.summarize(want, slo=3.0))
    assert m["shed_requests"] > 0 and m["retried_requests"] > 0
    assert (got["breaker_trips"] > 0).any()
    assert m["completed"] + m["shed_requests"] + m["stranded_requests"] \
        + m["dropped_requests"] == m["submitted"]


def test_learn_phi_rollout_matches_reference_and_recovers_phi():
    """Twin of the reference's test_learn_phi_recovers_true_coefficients:
    the engine's own refit (a > 0) converges to the hidden truth, and the
    port's rollout equals the reference's."""
    arr = tbatch.materialize_rounds(tscen.scenario("uniform_iid"), Q, R, DT,
                                    seed=5)
    cfg_j, cfg_t = _configs("uniform_iid", learn_phi=True,
                            width=arr["mask"].shape[-1])
    state = te.init_state(cfg_t, seed=5, device="cpu")
    np.testing.assert_array_equal(state["phi_est"].numpy(),
                                  np.tile([1.0, 0.0], (Q, 1)))
    final, _ = te.make_rollout(cfg_t, te.local_assign)(state, arr)
    want, _ = je.make_rollout(cfg_j, je.local_assign)(
        je.init_state(cfg_j, seed=5), arr, jax.random.PRNGKey(0))
    _assert_close(final, jax.device_get(want), "learn_phi rollout")
    fitted = final["phi_n"].numpy() >= cfg_t.phi_min_samples
    assert fitted.any()
    np.testing.assert_allclose(final["phi_est"].numpy()[fitted],
                               final["phi_true"].numpy()[fitted], atol=5e-2)


def test_batched_rollout_equals_per_instance():
    name, seeds = "chaos-rolling-failure", [0, 1, 2]
    _, cfg_t = _configs(name, resilience=CHAOS_RES)
    arr = _arrivals(name, cfg_t, seeds)
    fin_b, info_b = _port_run(cfg_t, te.greedy_assign, arr, seeds)
    run_1 = te.make_rollout(cfg_t, te.greedy_assign)
    for i, seed in enumerate(seeds):
        fin, info = run_1(te.init_state(cfg_t, seed, device="cpu"),
                          {k: v[i] for k, v in arr.items()})
        for k in fin:
            assert torch.equal(fin_b[k][i], fin[k]), (k, i)
        for k in info:
            assert torch.equal(info_b[k][i], info[k]), (k, i)


def test_init_state_and_cluster_match_reference():
    for name in ("uniform_iid", "cloud-cache-churn"):
        cfg_j, cfg_t = _configs(name, learn_phi=name == "uniform_iid")
        _assert_close(te.init_state(cfg_t, 7, device="cpu"),
                      je.init_state(cfg_j, 7), name)
        _assert_close(te.init_batch(cfg_t, [1, 2], device="cpu"),
                      je.init_batch(cfg_j, [1, 2]), name)


def test_mismatched_arrival_width_and_rounds_are_rejected():
    arr = tbatch.materialize_rounds(tscen.scenario("uniform_iid"), Q, 6, DT,
                                    seed=0, max_per_round=16)
    cfg = te.EngineConfig(num_edges=Q, num_rounds=6, max_per_round=8)
    run = te.make_rollout(cfg, te.local_assign)
    with pytest.raises(ValueError, match="max_per_round"):
        run(te.init_state(cfg, 0, device="cpu"), arr)
    short = te.EngineConfig(num_edges=Q, num_rounds=4, max_per_round=16)
    with pytest.raises(ValueError, match="rounds"):
        te.make_rollout(short, te.local_assign)(
            te.init_state(short, 0, device="cpu"), arr)


def test_resolve_assign_fn():
    assert te.resolve_assign_fn("greedy") is te.greedy_assign
    with pytest.raises(ValueError, match="unknown engine backend"):
        te.resolve_assign_fn("nope")
    with pytest.raises(ValueError, match="policy factory"):
        te.resolve_assign_fn("policy")
    with pytest.raises(ValueError, match="takes no kwargs"):
        te.resolve_assign_fn("local", policy=None)
    assert te.ASSIGN_FNS["policy"]._decision_defaults == tinf.DecisionSpec()
    assert te.ASSIGN_FNS["policy-fused"]._decision_defaults.fused_decode


# -- the policy backends -------------------------------------------------------


def _flat(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = np.array(leaf)
    return out


@pytest.fixture(scope="module")
def policies():
    out = {}
    for admit in (False, True):
        jcfg = jpol.PolicyConfig(**SMALL, admit_head=admit)
        params, state = jax.jit(jpol.corais_init, static_argnums=1)(
            jax.random.PRNGKey(0), jcfg)
        policy = tpol.CoRaiSPolicy(tpol.PolicyConfig(**SMALL, admit_head=admit),
                                   device="cpu")
        load_reference_params(policy, _flat(params), _flat(state))
        out[admit] = (jcfg, params, state, policy)
    return out


def _teacher_forced(fn, policy, want_assign):
    """Wrap a port assign fn: record, per round, its decision and which
    real requests have a top-2 gap above GAP, and hand back the
    reference's decision (``want_assign`` (B, R, A)) on the others."""
    rounds = []

    def assign(generator, inst):
        out = fn(generator, inst)
        got, admit = out if isinstance(out, tuple) else (out, None)
        c, h = tpol.corais_encode(policy, inst, per_instance=True)
        _, tv = tpol.corais_score_decode(policy, c, h, inst["edge_mask"], k=2,
                                         normalize=False, backend="torch")
        gapped = ((tv[..., 0] - tv[..., 1]) > GAP) & inst["req_mask"]
        ref = torch.from_numpy(np.array(want_assign[:, len(rounds)]))
        ref = ref.to(got.dtype)
        rounds.append((got, gapped, inst["req_mask"]))
        forced = torch.where(gapped, got, ref)
        return forced if admit is None else (forced, admit)

    return assign, rounds


@pytest.mark.parametrize("name,admission", [("uniform_iid", False),
                                            ("hotspot_skew", False),
                                            ("chaos-rolling-failure", True)])
@pytest.mark.parametrize("backend", ["policy", "policy-fused"])
def test_policy_rollout_matches_reference(policies, backend, name,
                                          admission):
    """``policy`` (B1 on the card, its plain version here) and
    ``policy-fused`` (B3) against the reference's Pallas head in interpret
    mode; the policy is called once per round for the whole batch."""
    jcfg, params, pstate, policy = policies[admission]
    res = dict(CHAOS_RES, admission="policy") if admission else None
    cfg_j, cfg_t = _configs(name, resilience=res, rounds=8)
    seeds = [0, 1, 2, 3]
    arr = _arrivals(name, cfg_t, seeds)
    fused = backend == "policy-fused"
    jspec = jinf.DecisionSpec(fused_decode=fused, backend="pallas",
                              admission=admission)
    want, winfo = _ref_run(cfg_j, je.ASSIGN_FNS[backend](
        params, pstate, jcfg, spec=jspec), arr, seeds)
    fn = te.resolve_assign_fn(backend, policy=policy,
                              spec=tinf.DecisionSpec(fused_decode=fused,
                                                     admission=admission))
    calls = []

    def counted(generator, inst):
        calls.append(inst["req_mask"].shape)
        return fn(generator, inst)

    forced, rounds = _teacher_forced(counted, policy, winfo["assign"])
    policy_score.reset_launch_counts()
    got, ginfo = _port_run(cfg_t, forced, arr, seeds)
    assert calls == [(B, cfg_t.max_per_round)] * cfg_t.num_rounds
    assert all(v == 0 for v in policy_score.LAUNCHES.values())  # CPU tensors
    compared = 0
    for r, (dec, gapped, rmask) in enumerate(rounds):
        if rmask.any():
            assert gapped.any(), f"round {r} holds no request above the gap"
        if not ("alive" in arr):  # in fault mode infos hold clamped picks
            np.testing.assert_array_equal(
                dec[gapped].numpy(), winfo["assign"][:, r][gapped.numpy()])
        np.testing.assert_array_equal(
            ginfo["assign"][:, r][gapped].numpy(),
            winfo["assign"][:, r][gapped.numpy()])
        compared += int(gapped.sum())
    assert compared > 0.9 * int(arr["mask"].sum())
    _assert_close(got, want, "final state")
    _assert_close(ginfo, winfo, "infos")
    m = te.summarize(got)
    _assert_summary(m, je.summarize(want))
    assert m["completed"] + m["shed_requests"] + m["stranded_requests"] \
        + m["dropped_requests"] == m["submitted"] > 0


def test_sampled_policy_rollout(policies):
    """Sampled dispatch is held by what holds for any draw: it is
    reproducible from the generator's seed, picks eligible edges, and each
    round's pick is no worse than greedy on that round's instance (greedy
    is a candidate)."""
    from repro_torch.core.objective import makespan
    _, _, _, policy = policies[False]
    cfg_j, cfg_t = _configs("uniform_iid", rounds=6)
    seeds = [0, 1, 2]
    arr = _arrivals("uniform_iid", cfg_t, seeds)
    spec = tinf.DecisionSpec(mode="sample", num_samples=16, fused_decode=True)
    fn = te.resolve_assign_fn("policy-fused", policy=policy, spec=spec)
    greedy = te.resolve_assign_fn("policy-fused", policy=policy)

    def checked(generator, inst):
        got = fn(generator, inst)
        g = greedy(None, inst)
        assert (makespan(inst, got) <= makespan(inst, g) + 1e-5).all()
        assert bool(inst["edge_mask"].gather(1, got.long()).all())
        return got

    runs = [_port_run(cfg_t, checked, arr, seeds,
                      generator=torch.Generator().manual_seed(9))
            for _ in range(2)]
    for k in runs[0][0]:
        assert torch.equal(runs[0][0][k], runs[1][0][k]), k
    m = te.summarize(runs[0][0])
    assert m["completed"] == m["submitted"] == int(arr["mask"].sum())
    with pytest.raises(ValueError, match="Generator"):
        _port_run(cfg_t, fn, arr, seeds)


def test_evaluate_rollouts_matches_reference(policies):
    jcfg, params, pstate, policy = policies[False]
    wl_t, wl_j = tscen.scenario("hotspot_skew"), jscen.scenario("hotspot_skew")
    width = tbatch.materialize_round_batch(wl_t, Q, 8, DT, 3,
                                           base_seed=2)["mask"].shape[-1]
    cfg_j, cfg_t = _configs("hotspot_skew", rounds=8, width=width)
    want = j_evaluate_rollouts(
        {"local": "local", "greedy": "greedy",
         "policy": je.make_policy_assign(params, pstate, jcfg)},
        cfg_j, wl_j, batch=3, base_seed=2)
    got = evaluate_rollouts(
        {"local": "local", "greedy": "greedy",
         "policy": te.make_policy_assign(policy)},
        cfg_t, wl_t, batch=3, base_seed=2, device="cpu")
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name]
        assert g.wall_s > 0
        for f in dataclasses.fields(w):
            if f.name == "wall_s":
                continue
            if f.name == "metrics":
                _assert_summary(g.metrics, w.metrics)
            elif isinstance(getattr(w, f.name), float):
                assert getattr(g, f.name) == pytest.approx(
                    getattr(w, f.name), abs=ATOL), (name, f.name)
            else:
                assert getattr(g, f.name) == getattr(w, f.name), (name, f.name)
