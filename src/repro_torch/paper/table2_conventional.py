"""Paper Table II, the conventional test: the methods on the training
scale; counterpart of ``benchmarks/table2_conventional.py``.

The gap is relative to the strongest offline reference available (ILS
with a wall-clock budget, in place of Gurobi). Output: one CSV row per
method, ``name,us_per_call,derived`` (gap and cost).

    python -m repro_torch.paper.table2_conventional            # the card
    python -m repro_torch.paper.table2_conventional --full     # 4 scales
    python -m repro_torch.paper.table2_conventional --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch import resolve_device
from repro_torch.core.ablations import variant_config
from repro_torch.core.evaluate import (_policy_method, evaluate_methods,
                                       standard_method_suite)
from repro_torch.core.train import train
from repro_torch.paper.common import (csv_line, eval_instances,
                                      get_trained_policy, rl_config)


def run(en=5, rn=50, n_instances=20, batches=800, ref_budget=1.0,
        sample_ns=(100, 1000), include_ablations=False, verbose=True,
        device=None):
    policy, cfg = get_trained_policy(en, rn, batches, verbose=verbose,
                                     device=device)
    instances = eval_instances(en, rn, n_instances)
    methods = standard_method_suite(policy, ref_budget_s=ref_budget,
                                    sample_ns=sample_ns)
    if include_ablations:
        for variant in ("fc1", "fc2", "fc3"):
            vcfg = rl_config(en, rn, batches)
            vcfg = dataclasses.replace(
                vcfg, policy=variant_config(vcfg.policy, variant))
            vpolicy, _, _ = train(vcfg, device=policy.device)
            methods[f"{variant.upper()}-CoRaiS(greedy)"] = _policy_method(
                vpolicy, "greedy", 0, seed=0)
    ref = f"ILS({ref_budget}s)"
    results = evaluate_methods(instances, methods, reference=ref)
    rows = []
    for name, r in results.items():
        rows.append(csv_line(
            f"table2/EN{en}_RN{rn}/{name}", r.mean_time_s * 1e6,
            f"gap={r.mean_gap:.4f};cost={r.mean_cost:.4f}"))
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="all four paper scales + ablations")
    ap.add_argument("--instances", type=int, default=20)
    ap.add_argument("--batches", type=int, default=800)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    scales = [(5, 50), (10, 50), (5, 100), (10, 100)] if args.full else [(5, 50)]
    rows = []
    for en, rn in scales:
        for row in run(en, rn, args.instances, args.batches,
                       include_ablations=args.full, device=device):
            print(row, flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    main()
