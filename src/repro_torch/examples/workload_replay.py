"""Workload scenarios and trace record/replay through the multi-edge
simulator (counterpart of ``examples/workload_replay.py``).

  1. pick a named scenario from the registry (here: a 10x flash crowd),
  2. drive the event-driven simulator with it (live synthetic run),
  3. record the exact same arrival stream to a JSONL trace,
  4. replay the trace through a fresh simulator and check that the
     completion metrics are identical: what makes A/B scheduler
     comparisons on captured traffic trustworthy.

    python -m repro_torch.examples.workload_replay
    python -m repro_torch.examples.workload_replay --scenario mmpp_bursty \\
        --backend local

The simulator and the heuristic schedulers run on the host.
"""
import argparse
import os
import tempfile

from repro_torch.serving import CentralController, MultiEdgeSim, SimConfig
from repro_torch.workloads import (list_scenarios, read_trace, record_trace,
                                   scenario)

TIMING_KEYS = ("scheduler_decision_s", "decision_mean_s", "decision_p95_s",
               "decision_max_s", "wall_s")


def completion_metrics(m: dict) -> dict:
    """Drop host-timing fields (nondeterministic wall clock)."""
    return {k: v for k, v in m.items() if k not in TIMING_KEYS}


def live_run(wl, backend: str, edges: int, until: float, horizon: float,
             seed: int) -> dict:
    """The simulator's metrics after driving ``wl`` (a workload or a
    trace) through a fresh simulator with the ``backend`` scheduler."""
    sim = MultiEdgeSim(SimConfig(num_edges=edges, seed=seed),
                       CentralController(scheduler=backend))
    return sim.drive(wl, until=until, run_until=horizon)


def record_and_replay(name: str, backend: str, edges: int, until: float,
                      horizon: float, seed: int, path: str):
    """Steps 2-4: (live metrics, replayed metrics, arrivals recorded)."""
    wl = scenario(name)
    print(f"\n== live run: {name} via {backend} ==")
    live = live_run(wl, backend, edges, until, horizon, seed)
    print(f"  completed {live['completed']}/{live['submitted']}, "
          f"mean response {live['mean_response']:.3f}, "
          f"p95 {live['p95_response']:.3f}, "
          f"decision mean {live['decision_mean_s'] * 1e3:.2f} ms "
          f"over {live['decision_rounds']} rounds")
    n = record_trace(path, wl, num_edges=edges, until=until, seed=seed)
    print(f"\n== recorded {n} arrivals to {path} ==")
    replay = live_run(read_trace(path), backend, edges, until, horizon, seed)
    return live, replay, n


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="flash_crowd_10x",
                    choices=sorted(list_scenarios()))
    ap.add_argument("--backend", default="greedy")
    ap.add_argument("--edges", type=int, default=5)
    ap.add_argument("--until", type=float, default=3.0)
    ap.add_argument("--horizon", type=float, default=400.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    print("== registered scenarios ==")
    for name, desc in list_scenarios().items():
        print(f"  {name:20s} {desc}")

    path = os.path.join(tempfile.gettempdir(),
                        f"corais_{args.scenario}.jsonl")
    live, replay, _ = record_and_replay(args.scenario, args.backend,
                                        args.edges, args.until, args.horizon,
                                        args.seed, path)
    assert completion_metrics(live) == completion_metrics(replay), \
        "replay diverged from live run"
    print("== replay reproduced the live run's completion metrics exactly ==")
    print("OK")
    return {"live": live, "replay": replay}


if __name__ == "__main__":
    main()
