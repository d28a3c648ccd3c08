"""Scenario sweep: every registered workload scenario x scheduler backend;
counterpart of ``benchmarks/scenario_sweep.py``.

Drives :meth:`MultiEdgeSim.drive` with each named scenario from the
workload registry against each scheduler backend and writes a JSON report
(per-cell completion, latency and decision metrics plus a per-scenario
winner): the scenario-diversity counterpart of the paper's Table II, which
covers only the i.i.d. uniform regime.

    python -m repro_torch.paper.scenario_sweep                      # the card
    python -m repro_torch.paper.scenario_sweep --device cpu \\
        --scenarios uniform_iid --backends greedy,local,batched-greedy
    python -m repro_torch.paper.scenario_sweep \\
        --backends batched-local,batched-greedy,batched-corais,batched-corais-temporal
    python -m repro_torch.paper.scenario_sweep --chaos   # the fault matrix
    python -m repro_torch.paper.scenario_sweep \\
        --scenarios cloud-cache-churn,cloud-burst-offload \\
        --backends batched-greedy,batched-corais,batched-corais-cloud

``corais`` trains (or loads a cached) policy through
:mod:`repro_torch.paper.common` first; the heuristic backends need no
training. A ``batched-*`` backend runs the same scenario through the
batched engine (:mod:`repro_torch.serving.engine`, online phi fitting on)
instead of the event-driven simulator: the same cluster seed and arrival
stream, so its cells compare directly with the event-driven columns.
``batched-corais-temporal`` selects the temporal policy (REINFORCE on
whole engine rollouts), ``batched-corais-admit`` the static dispatch plus
an admission head trained per chaos scenario, ``batched-corais-cloud`` the
tier-feature policy trained against deadline misses on cloud-cache-churn.

Chaos scenarios (any scenario registered with a FaultSpec) run
fault-injected: batched cells fold the materialized fault trajectory into
the arrival batch, event-driven cells schedule the identical timeline
into the heap, and every cell reports shed rate and SLO-violation fraction.
Edge-cloud scenarios (a CloudSpec) run with the cloud tier and the service
caches in both engines and report deadline-miss, cache-hit and
cloud-offload columns plus a per-scenario deadline winner.

The policy backends run on the card (``--device``); the event-driven
simulator and the heuristics run on the host. A batched cell draws sampled
dispatch from a ``torch.Generator`` seeded with the cell's seed.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch import resolve_device
from repro_torch.core.evaluate import _sync
from repro_torch.core.inference import DecisionSpec
from repro_torch.paper import common
from repro_torch.resilience import faults as faults_lib
from repro_torch.serving import (ASSIGN_FNS, CentralController, EngineConfig,
                                 MultiEdgeSim, SimConfig, init_batch,
                                 make_rollout, resolve_assign_fn, summarize)
from repro_torch.workloads import (list_scenarios, materialize_round_batch,
                                   materialize_rounds, scenario,
                                   scenario_cloud_spec, scenario_fault_spec)

REPORT_SCHEMA = "corais.scenario_sweep.v3"
DEFAULT_SLO = 3.0  # response-time SLO for the fault-matrix columns
RESULTS_DIR = os.path.dirname(common.RESULTS)


def _make_controller(backend: str, num_edges: int, batches: int,
                     z_pad: int, device=None) -> CentralController:
    if backend in ("corais", "corais-sample"):
        policy, _ = common.get_trained_policy(num_edges, 50, batches,
                                              verbose=False, device=device)
        return CentralController(scheduler=backend, policy=policy,
                                 z_pad=z_pad)
    return CentralController(scheduler=backend)


#: batched-* inner names that resolve to a trained policy AssignFn: the
#: static-trained policy's greedy or sampled decode, the temporal policy
#: (the policy-vs-baseline rollout comparison against batched-greedy and
#: batched-local on paired episodes), corais-admit (the static dispatch
#: plus an admission head trained per scenario on fault-injected episodes)
#: and corais-cloud (tier features, trained against deadline misses on
#: cloud-cache-churn and reused on every scenario, sampled decode).
POLICY_BACKENDS = ("corais", "corais-sample", "corais-temporal", "policy",
                   "corais-admit", "corais-cloud")


def _engine_assign_fn(inner: str, num_edges: int, batches: int,
                      scenario_name: str = "uniform_iid", device=None):
    if inner in POLICY_BACKENDS:
        admission = False
        if inner == "corais-admit":
            admission = True
            policy, _ = common.get_resilient_policy(
                num_edges, scenario_name=scenario_name, slo=DEFAULT_SLO,
                verbose=False, device=device)
            mode = "greedy"
        elif inner == "corais-cloud":
            # one shared column, sampled: episode REINFORCE trains the
            # stochastic policy, and argmax would herd a round's
            # identical-looking requests onto one node
            policy, _ = common.get_cloud_policy(num_edges, verbose=False,
                                                device=device)
            mode = "sample"
        elif inner == "corais-temporal":
            policy, _ = common.get_temporal_policy(
                num_edges, batches, verbose=False, device=device)
            mode = "greedy"
        else:
            policy, _ = common.get_trained_policy(num_edges, 50, batches,
                                                  verbose=False,
                                                  device=device)
            mode = "sample" if inner == "corais-sample" else "greedy"
        return resolve_assign_fn("policy", policy=policy, spec=DecisionSpec(
            mode=mode, admission=admission))
    try:
        return resolve_assign_fn(inner)
    except ValueError:
        known = sorted(set(ASSIGN_FNS) - {"policy"}) + list(POLICY_BACKENDS)
        raise ValueError(
            f"no batched-engine backend {inner!r}; supported: "
            f"{', '.join('batched-' + k for k in known)}") from None


def _run_batched(backend: str, name: str, *, num_edges: int, until: float,
                 seed: int, batches: int, slo: float = DEFAULT_SLO,
                 device=None) -> dict:
    """One batched-engine cell (a batch of one rollout, paired with the
    event-driven cells by seed and arrival stream), on ``device``. Chaos
    scenarios run fault-injected and carry the shed and SLO columns. The
    rollout runs once untimed (first-call costs), then once timed."""
    device = resolve_device(device)
    inner = backend.split("-", 1)[1]
    interval = SimConfig().round_interval
    rounds = max(1, int(round(until / interval)))
    arrivals = materialize_round_batch(scenario(name), num_edges, rounds,
                                       interval, 1, base_seed=seed)
    fspec = scenario_fault_spec(name)
    if fspec is not None:
        arrivals = faults_lib.attach_fault_batch(arrivals, fspec, num_edges,
                                                 seeds=[seed])
    cloud, cache = scenario_cloud_spec(name)
    cfg = EngineConfig(num_edges=num_edges, num_rounds=rounds,
                       round_interval=interval, learn_phi=True,
                       max_per_round=arrivals["mask"].shape[-1],
                       cloud=cloud, cache=cache)
    state0 = init_batch(cfg, [seed], device=device)
    run = make_rollout(cfg, _engine_assign_fn(
        inner, num_edges, batches, name, device=device), batch=True)
    run(state0, arrivals, torch.Generator(device=device).manual_seed(seed))
    _sync(device)
    t0 = time.time()
    final, _ = run(state0, arrivals,
                   torch.Generator(device=device).manual_seed(seed))
    _sync(device)
    m = summarize(final, slo=slo if fspec is not None else None)
    m["wall_s"] = time.time() - t0
    m["decision_rounds"] = rounds
    m["decision_mean_s"] = m["wall_s"] / rounds   # whole-round proxy: the
    m["decision_p95_s"] = m["decision_mean_s"]    # rollout does not isolate
    m["decision_max_s"] = m["decision_mean_s"]    # the decode's time
    m["scheduler_decision_s"] = m["decision_mean_s"]
    m["engine"] = "batched"
    return m


def _run_event_driven(backend: str, name: str, *, num_edges: int,
                      until: float, horizon: float, seed: int, batches: int,
                      slo: float = DEFAULT_SLO, device=None) -> dict:
    """One event-driven cell. On a fault scenario the same materialized
    fail/recover/straggle timeline the batched cells fold into their
    arrival batch is scheduled into the heap, so the columns stay paired."""
    cc = _make_controller(backend, num_edges, batches, z_pad=256,
                          device=device)
    cloud, cache = scenario_cloud_spec(name)
    sim = MultiEdgeSim(SimConfig(num_edges=num_edges, seed=seed,
                                 cloud=cloud, cache=cache), cc)
    interval = sim.cfg.round_interval
    fspec = scenario_fault_spec(name)
    if fspec is not None:
        rounds = max(1, int(round(until / interval)))
        ev = faults_lib.materialize_faults(fspec, num_edges, rounds,
                                           seed=seed)
        jit = None
        if fspec.jitter_sigma:
            # size the shared per-rid jitter table off the identical
            # arrival stream the batched cells materialize
            probe = materialize_rounds(scenario(name), num_edges, rounds,
                                       interval, seed=seed,
                                       max_per_round=256)
            n_rid = (int(probe["rid"].max()) + 1 if probe["mask"].any()
                     else 1)
            jit = faults_lib.jitter_table(fspec, n_rid, seed=seed)
        faults_lib.schedule_into_sim(sim, ev, interval, jit)
    t0 = time.time()
    m = sim.drive(scenario(name), until=until, run_until=horizon)
    m["wall_s"] = time.time() - t0
    if fspec is not None:
        resp = [r.finish_time - r.submit_time
                for e in sim.edges for r in e.completed]
        viol = sum(1 for r in resp if r > slo) \
            + (m["submitted"] - m["completed"])
        m["shed_requests"] = 0  # the event sim has no admission control
        m["shed_rate"] = 0.0
        m["slo"] = float(slo)
        m["slo_violation_frac"] = viol / max(m["submitted"], 1)
    return m


def run_sweep(scenarios: list[str], backends: list[str], *, num_edges: int = 5,
              until: float = 3.0, horizon: float = 400.0, seed: int = 0,
              batches: int = 800, slo: float = DEFAULT_SLO,
              verbose: bool = True, device=None) -> dict:
    for backend in backends:  # fail fast, before any cell is computed
        if backend.startswith("batched-"):
            inner = backend.split("-", 1)[1]
            if inner not in ASSIGN_FNS and inner not in POLICY_BACKENDS:
                _engine_assign_fn(inner, num_edges, batches)  # raises
    cells = {}
    winners = {}
    slo_winners = {}
    deadline_winners = {}
    for name in scenarios:
        cells[name] = {}
        fspec = scenario_fault_spec(name)
        for backend in backends:
            if backend.startswith("batched-"):
                m = _run_batched(backend, name, num_edges=num_edges,
                                 until=until, seed=seed, batches=batches,
                                 slo=slo, device=device)
            else:
                m = _run_event_driven(backend, name, num_edges=num_edges,
                                      until=until, horizon=horizon,
                                      seed=seed, batches=batches, slo=slo,
                                      device=device)
            m["per_edge_completed"] = {str(k): v for k, v
                                       in m["per_edge_completed"].items()}
            cells[name][backend] = m
            if verbose:
                line = (f"  {name:20s} {backend:12s} completed="
                        f"{m['completed']:4d}/{m['submitted']:<4d} "
                        f"mean={m['mean_response']:7.3f} "
                        f"p95={m['p95_response']:7.3f} "
                        f"dec_mean={m['decision_mean_s'] * 1e3:6.2f}ms")
                if "slo_violation_frac" in m:
                    line += (f" shed={m['shed_rate']:5.3f} "
                             f"slo_viol={m['slo_violation_frac']:5.3f}")
                if m["deadline_total"]:
                    line += (f" dl_miss={m['deadline_miss_frac']:5.3f} "
                             f"cache_hit={m['cache_hit_rate']:5.3f} "
                             f"cloud={m['cloud_offload_frac']:5.3f}")
                print(line, flush=True)
        # fault-free scenarios rank complete runs by mean response; fault
        # scenarios admit shed/dropped load, so rank everything that
        # completed work (and additionally by SLO-violation fraction)
        ok = {b: r for b, r in cells[name].items()
              if r["completed"] > 0
              and (fspec is not None or r["completed"] == r["submitted"])}
        if ok:
            winners[name] = min(ok, key=lambda b: ok[b]["mean_response"])
            if verbose:
                print(f"  {name:20s} -> best mean response: {winners[name]}")
        slo_ok = {b: r for b, r in ok.items() if "slo_violation_frac" in r}
        if slo_ok:
            slo_winners[name] = min(
                slo_ok, key=lambda b: (slo_ok[b]["slo_violation_frac"],
                                       slo_ok[b]["mean_response"]))
            if verbose:
                print(f"  {name:20s} -> best SLO violation:  "
                      f"{slo_winners[name]}")
        # deadline-carrying scenarios (cloud-*) also rank by deadline-miss
        # fraction, ties broken by mean response
        dl_ok = {b: r for b, r in cells[name].items()
                 if r["completed"] > 0 and r["deadline_total"] > 0}
        if dl_ok:
            deadline_winners[name] = min(
                dl_ok, key=lambda b: (dl_ok[b]["deadline_miss_frac"],
                                      dl_ok[b]["mean_response"]))
            if verbose:
                print(f"  {name:20s} -> best deadline miss:  "
                      f"{deadline_winners[name]}")
    return {
        "schema": REPORT_SCHEMA,
        "config": {"num_edges": num_edges, "until": until,
                   "horizon": horizon, "seed": seed, "slo": slo,
                   "scenarios": scenarios, "backends": backends},
        "results": cells,
        "winners": winners,
        "slo_winners": slo_winners,
        "deadline_winners": deadline_winners,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenarios", default="all",
                    help="comma list, or 'all' for the full registry")
    ap.add_argument("--backends", default="greedy,local,random")
    ap.add_argument("--edges", type=int, default=5)
    ap.add_argument("--until", type=float, default=3.0,
                    help="arrival window (workload horizon)")
    ap.add_argument("--horizon", type=float, default=400.0,
                    help="simulation end time (lets late arrivals drain)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batches", type=int, default=None,
                    help="training budget when a corais backend is requested "
                         "(default 800; the corais-admit head has its own "
                         "fixed budget, see repro_torch.paper.common."
                         "get_resilient_policy)")
    ap.add_argument("--slo", type=float, default=DEFAULT_SLO,
                    help="response-time SLO for the fault-matrix columns")
    ap.add_argument("--chaos", action="store_true",
                    help="resilience fault matrix: default to the fault-"
                         "injected scenarios and the admission-policy / "
                         "dispatch-policy / greedy / local columns, writing "
                         "results/torch_chaos_sweep.json")
    ap.add_argument("--out", default=None,
                    help="report path (default results/torch_scenario_sweep"
                         ".json; results/torch_chaos_sweep.json under "
                         "--chaos)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.chaos:
        default_scenarios = [n for n in list_scenarios()
                             if scenario_fault_spec(n) is not None]
        default_backends = ("batched-corais-admit,batched-corais,"
                            "batched-greedy,batched-local")
        default_out = "torch_chaos_sweep.json"
    else:
        default_scenarios = list(list_scenarios())
        default_backends = None
        default_out = "torch_scenario_sweep.json"

    names = (default_scenarios if args.scenarios == "all"
             else args.scenarios.split(","))
    backends_arg = args.backends
    if args.chaos and backends_arg == ap.get_default("backends"):
        backends_arg = default_backends
    backends = backends_arg.split(",")
    batches = args.batches if args.batches is not None else 800
    print(f"== scenario sweep: {len(names)} scenarios x "
          f"{len(backends)} backends ==")
    report = run_sweep(names, backends, num_edges=args.edges,
                       until=args.until, horizon=args.horizon,
                       seed=args.seed, batches=batches, slo=args.slo,
                       device=device)

    out = args.out or os.path.join(RESULTS_DIR, default_out)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
    print(f"== report written to {os.path.abspath(out)} ==")
    return report


if __name__ == "__main__":
    main()
