#!/usr/bin/env python3
"""Per-launch device time of kernels B1, B3 and B2 (``csrc/policy_score.cu``)
beside their plain versions, for one tree of the port.

    python3 tools/policy_head_split.py [--tree DIR] [--label NAME]

Needs one CUDA card and ``nvcc``. Imports ``repro_torch`` from
``DIR/src`` (default: this checkout), so an unpacked ``git archive`` of
another commit is measured with the same script, on the same card, in the
same call: run it for the parent and the change in turns (parent, change,
change, parent). Each tree builds its kernels into its own ``build/``.
The cases, each with random inputs from a seed:

* ``b1_serve``: B1 at the serving shape (B=1, Q=100, Z=1000, d=256);
* ``b1_train``: B1 at the training shape (B=128, Q=5, Z=50, d=256);
* ``b3_k1``: B3 at the serving shape, K=1, ``normalize=False`` (greedy
  decisions);
* ``b3_sampled``: the same with K=Q=100 and ``normalize=True`` (the
  best-of-64 sampled decisions);
* ``b2_train``: B2 at the training shape;
* ``b1_serve_ops`` and ``b3_k1_ops``: ``b1_serve`` and ``b3_k1`` called
  as the main paths call them, through ``kernels.ops`` with a bool mask.

For each: ``split``, the device us per call of every kernel it launches
(``chip_smoke.launch_split``, a torch.profiler trace); ``ms`` and
``plain_ms``, CUDA events behind a sleep kernel (``chip_smoke.time_ms``) in
the order plain, kernel, kernel, plain; and the kernel's largest error
against its plain version on the same inputs (B1: the value error and
whether two calls give the same bits; B3: index mismatches on rows whose
top-K+1 gap exceeds 1e-4, and the value error; B2: each output's error
relative to its largest entry). Prints one JSON object as its last line
and writes it to ``chiprun_out/policy_head_split_NAME.json``.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def b1_case(policy_score, ops, ref, args, through_ops=False):
    c, h, wx, wy, mask = args
    maskf = mask.to(torch.float32)

    def kern():
        if through_ops:
            return ops.policy_score(c, h, wx, wy, mask)
        return policy_score.policy_score_cuda(c, h, wx, wy, maskf)

    def plain():
        return ref.policy_score_torch(c, h, wx, wy, mask)
    got, again = kern(), kern()
    err = {"same_bits": torch.equal(got, again),
           "max_abs_err": float((got - plain()).abs().max())}
    return kern, plain, err


def b3_case(policy_score, ops, ref, args, k, normalize, through_ops=False):
    c, h, wx, wy, mask = args
    maskf = mask.to(torch.float32)

    def kern():
        if through_ops:
            return ops.policy_score_decode(c, h, wx, wy, mask, k=k,
                                           normalize=normalize)
        return policy_score.policy_score_decode_cuda(
            c, h, wx, wy, maskf, k=k, normalize=normalize)

    def plain():
        return ref.policy_score_decode_torch(c, h, wx, wy, mask, 10.0, k,
                                             normalize)
    ti, tv = kern()
    wi, wv = plain()
    _, sorted_vals = ref.policy_score_decode_torch(c, h, wx, wy, mask, 10.0,
                                                   c.shape[1], normalize)
    rows = cs._gapped_rows(sorted_vals, mask, k)
    err = {"index_mismatch_rows": int(((ti != wi).any(-1) & rows).sum()),
           "rows_checked": int(rows.sum()),
           "max_abs_err": float((tv - wv).abs().max())}
    return kern, plain, err


def b2_case(policy_score, ref, args):
    c, h, wx, wy, mask = args
    maskf = mask.to(torch.float32)
    out = ref.policy_score_torch(c, h, wx, wy, mask)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(12)
                    ).cuda()

    def kern():
        return policy_score.policy_score_bwd_cuda(g, out, c, h, wx, wy, maskf)

    def plain():
        return ref.policy_score_bwd_torch(g, out, c, h, wx, wy, maskf)
    got, again, want = kern(), kern(), plain()
    err = {"same_bits": all(map(torch.equal, got, again))}
    for key, x, w in zip(cs.BWD_TOL, got, want):
        err[f"{key}_rel_err"] = float((x - w).abs().max()
                                      / w.abs().max().clamp_min(1e-30))
    return kern, plain, err


def ptxas_by_kernel(report):
    """nvcc's -Xptxas -v report as {kernel: "registers ..., spills ..."},
    each kernel named by the first known name in its mangled symbol and
    its template arguments."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            sym = m.group(1)
            base = next((k for k in KERNELS if k in sym), sym[-40:])
            name = f"{base} {sym[sym.index(base) + len(base):][:48]}"
        elif name and ("registers" in line or "spill" in line):
            out[name] = (out.get(name, "") + " " + line.split(":")[-1].strip()
                         ).strip()
    return out


KERNELS = ("score_rows", "decode_rows", "bwd_rows", "bwd_ghx",
           "bwd_weights", "gemm")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", default=str(ROOT))
    parser.add_argument("--label", default="tree")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("policy_head_split: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    from repro_torch.kernels import build, ops, policy_score, ref
    report = build.build().get("policy_score.cu", "")
    gen = torch.Generator().manual_seed(1)
    serving = cs._inputs(gen, 1, 100, 1000, valid=[80])
    train = cs.train_shape_case()[4:]
    mods = (policy_score, ops, ref)
    cases = {
        "b1_serve": b1_case(*mods, serving),
        "b1_train": b1_case(*mods, train),
        "b3_k1": b3_case(*mods, serving, 1, False),
        "b3_sampled": b3_case(*mods, serving, 100, True),
        "b2_train": b2_case(policy_score, ref, train),
        "b1_serve_ops": b1_case(*mods, serving, through_ops=True),
        "b3_k1_ops": b3_case(*mods, serving, 1, False, through_ops=True),
    }
    torch.cuda.synchronize()
    result = {"card": cs.card_line(), "tree": args.tree, "label": args.label,
              "ptxas": ptxas_by_kernel(report)}
    for name, (kern, plain, err) in cases.items():
        runs = [cs.time_ms(plain), cs.time_ms(kern), cs.time_ms(kern),
                cs.time_ms(plain)]
        result[name] = {"ms": min(runs[1:3]), "plain_ms": min(runs[0], runs[3]),
                        "ms_runs": runs[1:3], "plain_ms_runs": [runs[0], runs[3]],
                        "split": cs.launch_split(kern), "err": err}
        print(f"{name}: {json.dumps(result[name])}", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"policy_head_split_{args.label}.json").write_text(
        json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
