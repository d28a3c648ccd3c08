"""The port's event-driven simulator (``serving/simulator.py``, ``edge.py``)
and its fault timeline helpers against the JAX package's, and the port's
rollout engine against the port's simulator as its oracle, on the CPU.

* The numpy copies: the port's ``MultiEdgeSim`` with the ``greedy``,
  ``local`` and ``random`` controllers reproduces the reference's
  ``metrics()`` exactly (the wall-clock ``decision_*`` keys apart) on
  ``tests/test_serving.py``'s flows and on ``drive(scenario)``, with the
  default execution noise and online phi; ``fault_events_from_rows`` gives
  the reference's timeline; ``PhiEstimator(flat_fit=False)`` is the
  reference's estimator bit for bit.
* The port's engine against the port's oracle, as ``tests/test_engine.py``
  and ``tests/test_cloud.py`` hold the reference's engine to the
  reference's oracle: the same scripted hash assignment, per-request
  finish times within rtol 1e-5 and atol 1e-4, per-round completion
  buckets exact, per-round workload features within 1e-4.
"""
import numpy as np
import pytest
import torch

from repro.core.state import PhiEstimator as JPhi
from repro.resilience import faults as jfaults
from repro.serving import CentralController as JCC
from repro.serving import MultiEdgeSim as JSim
from repro.serving import SimConfig as JCfg
from repro.workloads import scenarios as jscen
from repro_torch.core.state import PhiEstimator, snapshot_instance
from repro_torch.resilience import faults as tfaults
from repro_torch.serving import CentralController, MultiEdgeSim, SimConfig
from repro_torch.serving import engine as te
from repro_torch.serving.topology import nearest_alive_edge
from repro_torch.workloads import scenarios as tscen
from repro_torch.workloads.batch import materialize_rounds

torch.set_num_threads(1)

Q, ROUNDS, DT = 5, 12, 0.25
DRAIN = 120.0  # simulated seconds: every scenario below drains by then
WALL_KEYS = ("scheduler_decision_s", "decision_mean_s", "decision_p95_s",
             "decision_max_s")


def _strip(m):
    return {k: v for k, v in m.items() if k not in WALL_KEYS}


def _submit(sim, n, seed, window=2.0, edge=None):
    """``tests/test_serving.py``'s open-loop workload."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        src = edge if edge is not None else int(rng.integers(0, sim.cfg.num_edges))
        sim.submit(src, float(rng.uniform(0.1, 1.0)),
                   t=float(rng.uniform(0, window)))


# flow -> (sim seed, requests, hotspot edge, failure, straggler, until)
FLOWS = {
    "all_complete": (0, 120, None, None, None, 120.0),
    "hotspot": (3, 100, 0, None, None, 300.0),
    "failure": (0, 120, None, (0, 1.0), None, 240.0),
    "straggler": (1, 100, 1, None, (1, 10.0), 300.0),
}


def _flow(sim_cls, cfg_cls, cc, flow):
    seed, n, edge, fail, straggle, until = FLOWS[flow]
    sim = sim_cls(cfg_cls(num_edges=5, seed=seed), cc)
    if straggle is not None:
        sim.set_straggler(straggle[0], straggle[1], t=0.0)
    _submit(sim, n, seed, edge=edge)
    if fail is not None:
        sim.fail_edge(fail[0], t=fail[1])
    return sim, sim.run(until=until)


@pytest.mark.parametrize("scheduler", ["greedy", "local", "random"])
@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_simulator_flows_match_reference(flow, scheduler):
    jsim, want = _flow(JSim, JCfg, JCC(scheduler=scheduler), flow)
    tsim, got = _flow(MultiEdgeSim, SimConfig,
                      CentralController(scheduler=scheduler), flow)
    assert want["completed"] == want["submitted"] > 0
    assert set(got) == set(want)
    assert _strip(got) == _strip(want)
    assert got["decision_rounds"] == len(tsim.decision_times) > 0
    # the online phi fits (exec noise 0.02) are the reference's, bit for bit
    for je, e in zip(jsim.edges, tsim.edges):
        assert e.state.phi.coefficients == je.state.phi.coefficients
        assert e.state.phi.flat_fit is False


def _scenario_pair(name, scheduler, seed=0):
    """``drive(scenario)`` through both packages' simulators, with the
    scenario's cloud, cache and fault rows (``schedule_into_sim``)."""
    out = []
    for sim_cls, cfg_cls, cc_cls, scen, faults in (
            (JSim, JCfg, JCC, jscen, jfaults),
            (MultiEdgeSim, SimConfig, CentralController, tscen, tfaults)):
        cloud, cache = scen.scenario_cloud_spec(name)
        sim = sim_cls(cfg_cls(num_edges=Q, round_interval=DT, seed=seed,
                              cloud=cloud, cache=cache),
                      cc_cls(scheduler=scheduler))
        spec = scen.scenario_fault_spec(name)
        if spec is not None:
            ev = faults.materialize_faults(spec, Q, ROUNDS, seed=seed)
            jit = (faults.jitter_table(spec, 4096, seed=seed)
                   if spec.jitter_sigma else None)
            faults.schedule_into_sim(sim, ev, DT, jit)
        out.append((sim, sim.drive(scen.scenario(name), until=ROUNDS * DT,
                                   run_until=DRAIN, seed=seed)))
    return out


@pytest.mark.parametrize("scheduler", ["greedy", "local"])
@pytest.mark.parametrize("name", ["uniform_iid", "mmpp_bursty",
                                  "cloud-cache-churn",
                                  "chaos-straggler-storm"])
def test_simulator_drive_matches_reference(name, scheduler):
    (jsim, want), (tsim, got) = _scenario_pair(name, scheduler)
    assert want["submitted"] > 0 and want["completed"] == want["submitted"]
    assert _strip(got) == _strip(want)
    if name == "cloud-cache-churn":
        assert got["cache_hits"] > 0 and got["cache_misses"] > 0
    if name == "chaos-straggler-storm":
        ev = tfaults.materialize_faults(tscen.scenario_fault_spec(name), Q,
                                        ROUNDS, seed=0)
        assert (ev["speed"] != 1.0).any()
        assert all(e.jitter_fn is not None for e in tsim.edges)


@pytest.mark.parametrize("name,num_edges,seed", [
    ("chaos-rolling-failure", 5, 0), ("chaos-straggler-storm", 5, 1),
    ("chaos-flash-failure", 5, 0), ("chaos-rolling-failure", 100, 0)])
def test_fault_events_from_rows_match_reference(name, num_edges, seed):
    spec_j, spec_t = (jscen.scenario_fault_spec(name),
                      tscen.scenario_fault_spec(name))
    ev_j = jfaults.materialize_faults(spec_j, num_edges, ROUNDS, seed=seed)
    ev_t = tfaults.materialize_faults(spec_t, num_edges, ROUNDS, seed=seed)
    want = jfaults.fault_events_from_rows(ev_j, DT)
    got = tfaults.fault_events_from_rows(ev_t, DT)
    assert len(want) > 0
    assert ([(e.t, e.kind, e.edge, e.factor) for e in got]
            == [(e.t, e.kind, e.edge, e.factor) for e in want])
    assert tfaults.FAULT_EPS == jfaults.FAULT_EPS


def test_schedule_into_sim_clamps_the_jitter_table():
    """A rid past the table's end reads its last entry, as in the
    reference."""
    sim = MultiEdgeSim(SimConfig(num_edges=3), CentralController())
    ev = {"alive": np.ones((2, 3), bool), "speed": np.ones((2, 3), np.float32)}
    tfaults.schedule_into_sim(sim, ev, DT, np.array([1.5, 2.5], np.float32))
    assert [sim.edges[0].jitter_fn(r) for r in (0, 1, 7)] == [1.5, 2.5, 2.5]
    assert not sim._events  # no transition, no event


def _histories():
    rng = np.random.default_rng(5)
    xs = rng.uniform(0.1, 2.0, 300)
    return {
        "random": (xs, 0.6 * xs + 0.2 + rng.normal(0, 0.05, xs.size)),
        "constant_size": (np.full(40, 0.7), rng.uniform(0.5, 1.5, 40)),
        "falling": (xs[:60], 2.0 - 0.5 * xs[:60] + rng.normal(0, 0.01, 60)),
        "rise_then_fall": (np.concatenate([xs[:40], xs[40:100]]),
                           np.concatenate([0.8 * xs[:40] + 0.1,
                                           1.5 - 0.4 * xs[40:100]])),
    }


@pytest.mark.parametrize("history", sorted(_histories()))
def test_phi_estimator_reference_rule_bit_for_bit(history):
    xs, ys = _histories()[history]
    want = JPhi(window=64)
    got = PhiEstimator(window=64, flat_fit=False)
    flat = PhiEstimator(window=64)
    for x, y in zip(xs, ys):
        want.observe(x, y)
        got.observe(x, y)
        flat.observe(x, y)
        assert got.coefficients == want.coefficients
    if history == "falling":
        # the reference keeps its prior where the port's default fits a = 0
        assert want.coefficients == (1.0, 0.0)
        assert flat.a == 0.0 and flat.b > 0.0


# -- the port's engine against the port's oracle -------------------------------


def _scripted_assign(generator, inst):
    """A hash of the global arrival index, shared by both engines."""
    del generator
    return (inst["req_rid"] * 7 + 3) % Q


class _ScriptedController:
    """Oracle-side twin of ``_scripted_assign``, recording the per-round
    workload features the controller would feed a scheduler."""

    last_decision_time = 0.0

    def __init__(self):
        self.features = {}

    def schedule(self, edges, pending, w, ct):
        inst = snapshot_instance([e.state for e in edges], pending, w, ct)
        t = min(r.submit_time for r in pending)
        self.features[int(np.ceil(t / DT)) - 1] = inst["workload"].copy()
        return [(r, (r.rid * 7 + 3) % Q) for r in pending]


class _ChaosController:
    """Oracle twin of the engine's fault-mode scheduling: fresh requests go
    to the hash target failed over to the nearest alive edge; re-admitted
    orphans retry at their failed-over source."""

    last_decision_time = 0.0

    def __init__(self, sim):
        self.sim = sim
        self.seen = set()
        self.features = {}

    def schedule(self, edges, pending, w, ct):
        inst = snapshot_instance([e.state for e in edges], pending, w, ct)
        self.features[int(round(self.sim.now / DT)) - 1] = (
            inst["workload"].copy())
        alive = [e.alive for e in edges]
        out = []
        for r in pending:
            if r.rid in self.seen:
                out.append((r, r.source_edge))
            else:
                self.seen.add(r.rid)
                out.append((r, nearest_alive_edge(
                    self.sim.w, (r.rid * 7 + 3) % Q, alive)))
        return out


def _engine(cfg, assign, arr, seed):
    run = te.make_rollout(cfg, assign)
    final, infos = run(te.init_state(cfg, seed=seed, device="cpu"), arr)
    return ({k: v.numpy() for k, v in final.items()},
            {k: v.numpy() for k, v in infos.items()})


def _finish_times(arr, final, sim):
    rids = np.asarray(arr["rid"]).ravel()[np.asarray(arr["mask"]).ravel()]
    committed = final["slot_edge"].ravel() >= 0
    fin_engine = final["slot_finish"].ravel()[committed]
    oracle = {r.rid: r.finish_time for e in sim.edges for r in e.completed}
    return rids, committed, fin_engine, np.array([oracle[r] for r in rids])


def _assert_finish(fin_engine, fin_oracle):
    np.testing.assert_allclose(fin_engine, fin_oracle, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(fin_engine.max(), fin_oracle.max(),
                               rtol=1e-5, atol=1e-4)
    bounds = (np.arange(ROUNDS) + 1) * DT + 1e-6
    np.testing.assert_array_equal(
        (fin_engine[None, :] <= bounds[:, None]).sum(-1),
        (fin_oracle[None, :] <= bounds[:, None]).sum(-1))


@pytest.mark.parametrize("name", ["uniform_iid", "flash_crowd_10x",
                                  "mmpp_bursty", "heavy_tail_pareto"])
def test_engine_matches_port_oracle_on_traces(name):
    seed = 0
    arr = materialize_rounds(tscen.scenario(name), Q, ROUNDS, DT, seed=seed,
                             max_per_round=64)
    cfg = te.EngineConfig(num_edges=Q, num_rounds=ROUNDS, round_interval=DT,
                          max_per_round=64)
    final, infos = _engine(cfg, _scripted_assign, arr, seed)
    cc = _ScriptedController()
    sim = MultiEdgeSim(SimConfig(num_edges=Q, round_interval=DT, seed=seed,
                                 exec_noise=0.0, phi_oracle=True), cc)
    m = sim.drive(tscen.scenario(name), until=ROUNDS * DT, run_until=1e5,
                  seed=seed)
    rids, _, fin_engine, fin_oracle = _finish_times(arr, final, sim)
    assert m["completed"] == m["submitted"] == len(rids) > 0
    _assert_finish(fin_engine, fin_oracle)
    assert cc.features
    for r, wl_oracle in cc.features.items():
        np.testing.assert_allclose(infos["features"][r], wl_oracle,
                                   rtol=1e-4, atol=1e-4,
                                   err_msg=f"round {r} features diverged")


@pytest.mark.parametrize("name,seed", [
    ("chaos-rolling-failure", 0), ("chaos-rolling-failure", 1),
    ("chaos-straggler-storm", 0), ("chaos-flash-failure", 0)])
def test_engine_matches_port_oracle_under_faults(name, seed):
    spec = tscen.scenario_fault_spec(name)
    assert spec is not None and spec.has_faults
    arr = materialize_rounds(tscen.scenario(name), Q, ROUNDS, DT, seed=seed,
                             max_per_round=64)
    ev = tfaults.materialize_faults(spec, Q, ROUNDS, seed=seed)
    jit = (tfaults.jitter_table(spec, int(arr["rid"].max()) + 1, seed=seed)
           if spec.jitter_sigma else None)
    cfg = te.EngineConfig(num_edges=Q, num_rounds=ROUNDS, round_interval=DT,
                          max_per_round=64)
    final, infos = _engine(cfg, _scripted_assign,
                           tfaults.attach_faults(arr, ev, jit), seed)

    sim = MultiEdgeSim(SimConfig(num_edges=Q, round_interval=DT, seed=seed,
                                 exec_noise=0.0, phi_oracle=True), None)
    cc = _ChaosController(sim)
    sim.cc = cc
    tfaults.schedule_into_sim(sim, ev, DT, jit)
    m = sim.drive(tscen.scenario(name), until=ROUNDS * DT, run_until=1e5,
                  seed=seed)
    rids, committed, fin_engine, fin_oracle = _finish_times(arr, final, sim)
    assert m["completed"] == m["submitted"] == len(rids) > 0
    assert committed.sum() == len(rids)
    _assert_finish(fin_engine, fin_oracle)
    if "failure" in name:
        assert int(final["retried"]) > 0
    quiet = np.ones(ROUNDS, bool)
    prev = np.ones(Q, bool)
    for r in range(ROUNDS):
        quiet[r] = bool((ev["alive"][r] == prev).all())
        prev = ev["alive"][r]
    checked = 0
    for r, wl_oracle in cc.features.items():
        if quiet[r] and (r == 0 or quiet[r - 1]):
            np.testing.assert_allclose(infos["features"][r], wl_oracle,
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f"round {r} features diverged")
            checked += 1
    assert checked > 0


class _CloudController:
    """Oracle twin of the hash over N = Q + 1 nodes."""

    last_decision_time = 0.0

    def __init__(self, num_nodes):
        self.n = num_nodes

    def schedule(self, edges, pending, w, ct):
        return [(r, (r.rid * 7 + 3) % self.n) for r in pending]


@pytest.mark.parametrize("name,q,rounds,seed", [
    ("cloud-cache-churn", 4, 16, 3), ("cloud-burst-offload", 5, 20, 7)])
def test_engine_matches_port_oracle_on_the_cloud_tier(name, q, rounds, seed):
    cloud, cache = tscen.scenario_cloud_spec(name)
    assert cloud is not None and cache is not None
    n = q + 1
    cfg = te.EngineConfig(num_edges=q, num_rounds=rounds, round_interval=DT,
                          max_per_round=64, cloud=cloud, cache=cache)
    arr = materialize_rounds(tscen.scenario(name), q, rounds, DT, seed=seed,
                             max_per_round=64)
    final, _ = _engine(cfg, lambda g, inst: (inst["req_rid"] * 7 + 3) % n,
                       arr, seed)
    s = te.summarize({k: torch.from_numpy(v) for k, v in final.items()})
    sim = MultiEdgeSim(
        SimConfig(num_edges=q, round_interval=DT, seed=seed, exec_noise=0.0,
                  phi_oracle=True, cloud=cloud, cache=cache),
        _CloudController(n))
    m = sim.drive(tscen.scenario(name), until=rounds * DT, run_until=1e5,
                  seed=seed)
    assert m["completed"] == m["submitted"] == s["completed"] > 0
    assert s["stranded_requests"] == 0
    for k in ("cache_hits", "cache_misses", "cloud_completed",
              "deadline_total", "deadline_missed", "transferred",
              "completed"):
        assert s[k] == m[k], (k, s[k], m[k])
    assert s["cache_misses"] > 0 and s["cache_hits"] > 0
    assert s["cloud_completed"] > 0
    assert set(te.SUMMARY_KEYS) <= set(m)
    rids, _, fin_engine, fin_oracle = _finish_times(arr, final, sim)
    np.testing.assert_allclose(fin_engine, fin_oracle, rtol=1e-5, atol=1e-4)
    assert s["deadline_miss_frac"] == pytest.approx(m["deadline_miss_frac"])
    assert s["cache_hit_rate"] == pytest.approx(m["cache_hit_rate"])
    assert s["cloud_offload_frac"] == pytest.approx(m["cloud_offload_frac"])
