#!/usr/bin/env python3
"""Kernel B1 (``csrc/policy_score.cu``) in its plan and in the plans its
design dropped, timed on one card in one call.

    python3 tools/b1_plans.py

Needs one CUDA card and ``nvcc``. Copies this checkout's ``src/`` into
``build/b1_plans/NAME/`` with one set of text changes each (each text
found exactly once), and runs ``tools/policy_head_split.py --tree`` on
every copy in turn, so each builds its own kernels. The copies:

* ``source``: the source as it is (at Q <= ``kFlatQ`` the small-Q plan);
* ``qp32``: ``kFlatQ`` = 0, so the training shape (Q = 5) takes B3's
  plan, Q padded to 32 (px by ``EdgeTile``, pxy by ``EdgeTileT``,
  ``score_rows<32>``);
* ``qp32_pxtile``: the same with px by ``PxTile``;
* ``narrow``: the small-Q plan with both of its products by a 16 x 64
  tile, 2 x 4 outputs a thread.

Each run holds B1 against its plain version (``max_abs_err``). Prints one
JSON object {"card", "plans": {NAME: {"b1_serve", "b1_train"}}} as its
last line, each case as ``policy_head_split.py`` reports it (``ms``,
``plain_ms``, ``split``, ``err``).
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = "repro_torch/kernels/csrc/policy_score.cu"
FLAT_Q = ("constexpr int kFlatQ = 8;", "constexpr int kFlatQ = 0;")
#: name -> (text, replacement) pairs applied to the source
PLANS = {
    "source": [],
    "qp32": [FLAT_Q],
    "qp32_pxtile": [FLAT_Q, (
        "launch_gemm<EdgeTile>(c, d, 0, wpx,",
        "launch_gemm<PxTile>(c, d, 0, wpx,")],
    "narrow": [
        ("using PxTile = Tile<32, 64, 64, 4, 4, false, true, 4>;",
         "using PxTile = Tile<32, 64, 64, 4, 4, false, true, 4>;\n"
         "using NarrowTile = Tile<16, 64, 64, 2, 4, false, true, 4>;\n"
         "using NarrowTileT = Tile<16, 64, 64, 2, 4, false, false, 4>;"),
        ("launch_gemm<PxTile>(c, d, 0, wpx, d, 0, px, d, 0, B * Q,",
         "launch_gemm<NarrowTile>(c, d, 0, wpx, d, 0, px, d, 0, B * Q,"),
        ("launch_gemm<PxyTile>(px, d, 0, wpy, d, 0, pxy, d, 0, B * Q,",
         "launch_gemm<NarrowTileT>(px, d, 0, wpy, d, 0, pxy, d, 0, B * Q,"),
    ],
}


def patched(text: str, name: str, edits) -> str:
    """``text`` with ``edits`` applied; raises if a text to replace is not
    found exactly once."""
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} found {text.count(old)} "
                               f"times in {SOURCE}")
        text = text.replace(old, new)
    return text


def make_tree(name: str, edits) -> Path:
    """A copy of ``src/`` under build/b1_plans/NAME with ``edits`` applied
    to the source."""
    tree = ROOT / "build" / "b1_plans" / name
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(ROOT / "src", tree / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = tree / "src" / SOURCE
    path.write_text(patched(path.read_text(), name, edits))
    return tree


def main() -> int:
    trees = {name: make_tree(name, edits) for name, edits in PLANS.items()}
    result = {"plans": {}}
    for name, tree in trees.items():
        label = f"b1_plans_{name}"
        subprocess.run([sys.executable, str(ROOT / "tools" /
                                            "policy_head_split.py"),
                        "--tree", str(tree), "--label", label], check=True)
        run = json.loads((ROOT / "chiprun_out" /
                          f"policy_head_split_{label}.json").read_text())
        result["card"] = run["card"]
        result["plans"][name] = {k: run[k] for k in ("b1_serve", "b1_train")}
        print(f"{name}: " + ", ".join(
            f"{k} {run[k]['ms']:.5f} ms (plain {run[k]['plain_ms']:.5f})"
            for k in ("b1_serve", "b1_train")), flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
