"""Paper Table III, generalization: a policy trained on a small scale is
applied, unchanged, to larger systems; counterpart of
``benchmarks/table3_generalization.py``. The policy takes any (EN, RN), so
the same forward serves every test scale.

    python -m repro_torch.paper.table3_generalization              # the card
    python -m repro_torch.paper.table3_generalization --device cpu
"""
from __future__ import annotations

import argparse

from repro_torch import resolve_device
from repro_torch.core.evaluate import evaluate_methods, standard_method_suite
from repro_torch.paper.common import (csv_line, eval_instances,
                                      get_trained_policy)


def run(train_scale=(5, 50), test_scales=((10, 100), (15, 150)),
        n_instances=10, batches=800, ref_budget=2.0, verbose=True,
        device=None):
    policy, _ = get_trained_policy(*train_scale, batches, verbose=verbose,
                                   device=device)
    rows = []
    for en, rn in test_scales:
        instances = eval_instances(en, rn, n_instances)
        methods = standard_method_suite(policy, ref_budget_s=ref_budget,
                                        random_ns=(100,),
                                        sample_ns=(1000,))
        ref = f"ILS({ref_budget}s)"
        results = evaluate_methods(instances, methods, reference=ref)
        for name, r in results.items():
            rows.append(csv_line(
                f"table3/train{train_scale[0]}x{train_scale[1]}"
                f"/test{en}x{rn}/{name}",
                r.mean_time_s * 1e6,
                f"gap={r.mean_gap:.4f};cost={r.mean_cost:.4f}"))
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--instances", type=int, default=10)
    ap.add_argument("--batches", type=int, default=800)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    rows = run(n_instances=args.instances, batches=args.batches,
               device=resolve_device(args.device))
    for row in rows:
        print(row)
    return rows


if __name__ == "__main__":
    main()
