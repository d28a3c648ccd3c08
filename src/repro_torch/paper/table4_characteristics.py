"""Paper Table IV / Figs 8-10, the characteristic validation; counterpart
of ``benchmarks/table4_characteristics.py``.

LB (load balancing): homogeneous edges, equal backlogs, all requests at
edge A -> expect near-equal per-edge request counts.
WP (workload perception): homogeneous edges, edge A has the largest
backlog -> expect n_A smallest.
HA (heterogeneity awareness): heterogeneous speeds E>D>C>B>A with
equalized backlog response times -> expect faster edges to serve more.

Reports per-edge EReqN (mean executed requests) and LCost (mean response
time of that edge) over many sampled decisions of the trained policy. The
decisions are drawn on the policy's device from a seeded
``torch.Generator`` (the reference draws with ``jax.random`` keys), and
counted there.

    python -m repro_torch.paper.table4_characteristics              # the card
    python -m repro_torch.paper.table4_characteristics --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.decode import sampling_decode
from repro_torch.core.objective import per_edge_times
from repro_torch.core.policy import corais_apply
from repro_torch.paper.common import csv_line, get_trained_policy

KINDS = ("LB", "WP", "HA")


def _base_instance(q=5, z=50):
    coords = np.stack([np.linspace(0.1, 0.9, q), np.full(q, 0.5)], -1)
    w = np.linalg.norm(coords[:, None] - coords[None], axis=-1)
    return {
        "edge_coords": coords.astype(np.float32),
        "phi": np.tile(np.array([[0.5, 0.05]], np.float32), (q, 1)),
        "replicas": np.full(q, 2.0, np.float32),
        "workload": np.zeros((q, 3), np.float32),
        "w": w.astype(np.float32),
        "ct": np.float32(1.0),
        "req_src": np.zeros(z, np.int32),  # all submitted to edge A
        "req_size": np.full(z, 0.5, np.float32),
        "edge_mask": np.ones(q, bool),
        "req_mask": np.ones(z, bool),
    }


def scenario(kind: str, q=5, z=50):
    inst = _base_instance(q, z)
    if kind == "LB":
        inst["workload"][:, 0] = 2.0  # same backlogs everywhere
    elif kind == "WP":
        # same hardware, edge A much more loaded
        inst["workload"][:, 0] = np.linspace(4.0, 1.0, q)
    elif kind == "HA":
        # speeds E > D > C > B > A; backlog response times equalized
        speeds = np.linspace(1.0, 0.2, q)  # phi slope: smaller = faster
        inst["phi"] = np.stack([speeds, np.full(q, 0.02)], -1).astype(np.float32)
        inst["workload"][:, 0] = 2.0
    return inst


@torch.no_grad()
def draws(kind: str, policy, trials=200, sample_n=128, z=50, seed=0):
    """Per-trial (executed requests, response time) of each edge: two
    (trials, Q) float64 arrays, each trial one best-of-``sample_n``
    decision drawn from a ``torch.Generator`` seeded with ``seed`` on the
    policy's device, where the counts are taken."""
    inst = scenario(kind, z=z)
    device = policy.device
    tinst = {k: torch.as_tensor(np.asarray(v)).to(device)
             for k, v in inst.items()}
    q = inst["phi"].shape[0]
    lp = corais_apply(policy, tinst, training=False)
    gen = torch.Generator(device=device).manual_seed(seed)
    counts, costs = [], []
    for _ in range(trials):
        assign, _ = sampling_decode(gen, tinst, lp, sample_n)
        costs.append(per_edge_times(tinst, assign)["T"])
        counts.append(torch.nn.functional.one_hot(assign.long(), q).sum(0))
    return (torch.stack(counts).double().cpu().numpy(),
            torch.stack(costs).double().cpu().numpy())


def run(kind: str, policy, trials=200, sample_n=128, z=50, seed=0):
    """(EReqN, LCost): each edge's executed requests and response time,
    averaged over ``trials`` sampled decisions."""
    counts, costs = draws(kind, policy, trials, sample_n, z, seed)
    return counts.mean(0), costs.mean(0)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=100)
    ap.add_argument("--batches", type=int, default=800)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    policy, _ = get_trained_policy(5, 50, args.batches,
                                   device=resolve_device(args.device))
    rows = []
    for kind in KINDS:
        ereqn, lcost = run(kind, policy, trials=args.trials)
        for i, label in enumerate("ABCDE"):
            rows.append(csv_line(f"table4/{kind}/edge_{label}", 0.0,
                                 f"EReqN={ereqn[i]:.2f};LCost={lcost[i]:.3f}"))
            print(rows[-1])
    return rows


if __name__ == "__main__":
    main()
