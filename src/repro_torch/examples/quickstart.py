"""Quickstart: the paper's pipeline end to end in about two minutes
(counterpart of ``examples/quickstart.py``).

1. Sample a multi-edge scheduling instance (paper §V-A rules).
2. Solve it with the baselines (Local / Random / greedy / ILS / exact B&B).
3. Train a miniature CoRaiS policy with S-sample REINFORCE (paper §IV-B).
4. Compare the learned scheduler's makespan and decision latency.

    python -m repro_torch.examples.quickstart                # the card
    python -m repro_torch.examples.quickstart --device cpu
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.decode import greedy_decode, sampling_decode
from repro_torch.core.heuristics import (solve_greedy, solve_ils, solve_local,
                                         solve_random)
from repro_torch.core.ilp import solve_branch_and_bound, write_lp
from repro_torch.core.instances import InstanceConfig, generate_instance
from repro_torch.core.objective import makespan_np
from repro_torch.core.policy import PolicyConfig, corais_apply
from repro_torch.core.train import RLConfig, to_device, train

ICFG = InstanceConfig(num_edges=4, num_requests=12, backlog_high=10)


def classical(inst, lp_path: str) -> dict:
    """One scheduling round through each classical solver, printed;
    {solver: makespan}. The exact ILP is written to ``lp_path``."""
    print("== one scheduling round, classical solvers ==")
    out = {}
    for name, solver in [
        ("Local", solve_local),
        ("Random(100)", lambda i: solve_random(i, 100)),
        ("Greedy", solve_greedy),
        ("ILS(0.5s)", lambda i: solve_ils(i, budget_s=0.5)),
        ("BranchAndBound*", solve_branch_and_bound),
    ]:
        t0 = time.perf_counter()
        assign = solver(inst)
        out[name] = makespan_np(inst, assign)
        print(f"  {name:16s} makespan={out[name]:8.3f} "
              f"({(time.perf_counter()-t0)*1e3:7.1f} ms)")
    write_lp(inst, lp_path)
    print(f"  (exact ILP exported to {lp_path})")
    return out


def rl_config(num_batches: int = 60) -> RLConfig:
    """The example's miniature CoRaiS and its REINFORCE run."""
    return RLConfig(
        policy=PolicyConfig(d_model=32, ff_hidden=64, edge_layers=2,
                            request_layers=1),
        instance=ICFG, batch_size=16, num_samples=16, lr=1e-3,
        num_batches=num_batches, seed=0)


def train_policy(cfg: RLConfig, device):
    """Train, printed; returns (policy, history)."""
    print("== train a miniature CoRaiS (paper §IV-B) ==")
    t0 = time.time()
    policy, _, hist = train(cfg, device=device)
    print(f"  cost {hist[0]['cost_mean']:.3f} -> {hist[-1]['cost_mean']:.3f} "
          f"in {time.time()-t0:.0f}s")
    return policy, hist


@torch.no_grad()
def schedule(policy, inst, generator: torch.Generator) -> dict:
    """The learned policy's greedy decision, timed after one warm-up call
    (the forward, the decode and the copy to the host), and its best of
    256 sampled decisions; printed. {"greedy", "greedy_makespan",
    "decision_ms", "sampled_makespan"}."""
    print("== schedule with the learned policy ==")
    tinst = to_device(inst, policy.device)

    def forward(i):
        return corais_apply(policy, i, training=False)

    greedy_decode(forward(tinst)).cpu()  # warm up once
    t0 = time.perf_counter()
    lp = forward(tinst)
    g = greedy_decode(lp).cpu().numpy()
    dt = time.perf_counter() - t0
    out = {"greedy": g, "greedy_makespan": makespan_np(inst, g),
           "decision_ms": dt * 1e3}
    print(f"  CoRaiS(greedy)   makespan={out['greedy_makespan']:8.3f} "
          f"({dt*1e3:7.2f} ms real-time decision)")
    _, cost = sampling_decode(generator, tinst, lp, 256)
    out["sampled_makespan"] = float(cost)
    print(f"  CoRaiS(256)      makespan={out['sampled_makespan']:8.3f}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    inst = generate_instance(np.random.default_rng(0), ICFG)
    solvers = classical(inst, os.path.join(tempfile.gettempdir(),
                                           "quickstart.lp"))
    policy, hist = train_policy(rl_config(), device)
    decided = schedule(policy, inst,
                       torch.Generator(device=device).manual_seed(0))
    return {"classical": solvers, "history": hist, **decided}


if __name__ == "__main__":
    main()
