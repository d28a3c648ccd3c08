#!/usr/bin/env python3
"""Temporal REINFORCE update time and kernels per update (``chip_smoke.py``
phase 6c's paths (a) and (d)) for one tree of the port.

    python3 tools/temporal_update_ab.py [--tree DIR] [--label NAME]

Needs one CUDA card and ``nvcc``. Imports ``chip_smoke`` and
``repro_torch`` from ``DIR`` (default: this checkout), so an unpacked
``git archive`` of another commit is measured with the same functions of
its own tree, on the same card, in the same call: run it for the parent
and the change in turns (parent, change, change, parent). Each tree builds
its kernels into its own ``build/``. It runs, through that tree's
``chip_smoke``:

* ``host``: path (a), ``temporal_train(TemporalRLConfig())`` on the host
  loop for 6 updates (B = 16, Q = 5, 12 rounds), update p50 / p95 ms;
* ``profile``: a ``torch.profiler`` trace of 2 more host-loop updates,
  kernels and device-busy ms per update;
* ``scale``: path (d), 3 updates on 16 of phase 6b's 100-edge instances,
  update p50 ms.

Prints one JSON object as its last line and writes it to
``chiprun_out/temporal_update_ab_NAME.json``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(HERE))
    ap.add_argument("--label", default="change")
    a = ap.parse_args()
    tree = Path(a.tree).resolve()
    sys.path[:0] = [str(tree), str(tree / "src")]
    import torch

    import chip_smoke as cs
    from repro_torch import workloads as wl
    from repro_torch.core import policy as pol
    from repro_torch.core import train as tr
    from repro_torch.kernels import build, policy_score, ref
    from repro_torch.serving import engine

    if not torch.cuda.is_available():
        print("temporal_update_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
    out = {"label": a.label, "tree": str(tree), "card": cs.card_line()}
    host, _, policy = cs.drive_temporal(pol, tr, ref, policy_score,
                                        tr.TemporalRLConfig(), "host",
                                        cs.TEMPORAL_HOST_UPDATES)
    out["host"] = {"update_ms": host["update_ms"],
                   "launches": host["launches"]}
    out["profile"] = cs.profile_temporal(tr, policy)
    del policy
    scale, _ = cs.temporal_scale(pol, tr, engine, ref, policy_score,
                                 cs.rollout_arrivals(wl)[0])
    out["scale"] = {"update_ms": scale["update_ms"],
                    "launches": scale["launches"]}
    dest = HERE / "chiprun_out"
    dest.mkdir(exist_ok=True)
    line = json.dumps(out)
    (dest / f"temporal_update_ab_{a.label}.json").write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
