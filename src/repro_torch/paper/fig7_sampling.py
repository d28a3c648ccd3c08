"""Paper Fig. 7, the sampling decode's effect: more samples, a better gap,
at a small (vectorized) time cost; counterpart of
``benchmarks/fig7_sampling.py``. The forward is ``corais_apply``, and the
timed region is the decode alone (to the assignment on the host), as in
the reference.

    python -m repro_torch.paper.fig7_sampling              # the card
    python -m repro_torch.paper.fig7_sampling --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.decode import sampling_decode
from repro_torch.core.evaluate import _sync
from repro_torch.core.heuristics import solve_ils
from repro_torch.core.objective import makespan_np
from repro_torch.core.policy import corais_apply
from repro_torch.paper.common import (csv_line, eval_instances,
                                      get_trained_policy)


@torch.no_grad()
def run(en=10, rn=100, n_instances=10, batches=800,
        samples=(1, 10, 100, 1000), ref_budget=2.0, seed=0, verbose=True,
        device=None):
    """One row a sample count: the mean decode time (us) and the mean gap
    against ILS over ``n_instances`` instances. Instance i's decisions
    draw from a generator seeded ``seed + i`` (the same draws for its
    warm-up and its timed decode)."""
    policy, _ = get_trained_policy(5, 50, batches, verbose=verbose,
                                   device=device)
    device = policy.device
    instances = eval_instances(en, rn, n_instances)
    refs = [makespan_np(i, solve_ils(i, budget_s=ref_budget, seed=0))
            for i in instances]
    staged = [{k: torch.as_tensor(np.asarray(v)).to(device)
               for k, v in inst.items()} for inst in instances]
    gen = torch.Generator(device=device)
    rows = []
    for n in samples:
        gaps, times = [], []
        for i, (inst, tinst, ref) in enumerate(zip(instances, staged, refs)):
            lp = corais_apply(policy, tinst, training=False)
            sampling_decode(gen.manual_seed(seed + i), tinst, lp, n)  # warm
            _sync(device)
            t0 = time.perf_counter()
            assign, _ = sampling_decode(gen.manual_seed(seed + i), tinst, lp,
                                        n)
            assign = assign.cpu().numpy()
            times.append(time.perf_counter() - t0)
            gaps.append(makespan_np(inst, assign) / max(ref, 1e-9))
        rows.append(csv_line(f"fig7/EN{en}_RN{rn}/samples_{n}",
                             float(np.mean(times)) * 1e6,
                             f"gap={float(np.mean(gaps)):.4f}"))
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--en", type=int, default=10)
    ap.add_argument("--rn", type=int, default=100)
    ap.add_argument("--instances", type=int, default=10)
    ap.add_argument("--batches", type=int, default=800)
    ap.add_argument("--samples", type=int, nargs="+",
                    default=[1, 10, 100, 1000])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    rows = run(args.en, args.rn, args.instances, args.batches,
               tuple(args.samples), device=resolve_device(args.device))
    for row in rows:
        print(row)
    return rows


if __name__ == "__main__":
    main()
