"""Multi-edge cooperative serving command line; counterpart of
``repro/launch/serve.py``.

Runs the event-driven cluster with a chosen scheduler (optionally a trained
CoRaiS checkpoint) under a synthetic open-loop workload, with optional
fault/straggler injection. Prints per-scheduler latency metrics. The policy
runs on CUDA unless ``--device cpu`` is given; checkpoints are in the
reference's format, so one written by either package's ``train corais``
serves here.

    python -m repro_torch.launch.serve --scheduler greedy --edges 5 --requests 200
    python -m repro_torch.launch.serve --scheduler corais --policy-ckpt /tmp/corais
    python -m repro_torch.launch.serve --scheduler greedy --fail-edge 0 --straggle 1:8
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.checkpoint import Checkpointer, load_train_state
from repro_torch.core.policy import CoRaiSPolicy, PolicyConfig
from repro_torch.serving import (CentralController, MultiEdgeSim, SchedulerChoice,
                                 SimConfig)


def build_controller(args) -> CentralController:
    if args.scheduler.startswith("corais"):
        restored = (Checkpointer(args.policy_ckpt, every=1).restore_latest()
                    if args.policy_ckpt else None)
        if restored is None:
            raise SystemExit(f"no checkpoint under {args.policy_ckpt}; train "
                             "one with: python -m repro_torch.launch.train "
                             "corais")
        policy = CoRaiSPolicy(PolicyConfig(d_model=args.policy_dim),
                              device=resolve_device(args.device))
        load_train_state(policy, restored["tree"])
        return CentralController(scheduler=args.scheduler, policy=policy,
                                 z_pad=args.z_pad)
    return CentralController(scheduler=args.scheduler)


def main(argv=None) -> dict:
    """Parse ``argv`` (default: the command line), serve, print the metrics
    and return them."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--scheduler", default="greedy", choices=SchedulerChoice)
    ap.add_argument("--edges", type=int, default=5)
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--arrival-window", type=float, default=5.0)
    ap.add_argument("--until", type=float, default=240.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fail-edge", type=int, default=None)
    ap.add_argument("--fail-at", type=float, default=2.0)
    ap.add_argument("--straggle", default=None, help="edge:factor, e.g. 1:8")
    ap.add_argument("--policy-ckpt", default=None)
    ap.add_argument("--policy-dim", type=int, default=256)
    ap.add_argument("--z-pad", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="device of the policy: cuda (default) or cpu")
    args = ap.parse_args(argv)

    cc = build_controller(args)
    sim = MultiEdgeSim(SimConfig(num_edges=args.edges, seed=args.seed), cc)
    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        sim.submit(int(rng.integers(0, args.edges)),
                   float(rng.uniform(0.05, 1.0)),
                   t=float(rng.uniform(0, args.arrival_window)))
    if args.fail_edge is not None:
        sim.fail_edge(args.fail_edge, t=args.fail_at)
    if args.straggle:
        eid, factor = args.straggle.split(":")
        sim.set_straggler(int(eid), float(factor), t=0.0)
    m = sim.run(until=args.until)
    print(f"scheduler={args.scheduler}")
    for k, v in m.items():
        print(f"  {k}: {v}")
    if m.get("completed", 0) < args.requests:
        raise SystemExit("not all requests completed; increase --until")
    return m


if __name__ == "__main__":
    main()
