#!/usr/bin/env python3
"""B4b (``csrc/flash_attention_bwd.cu``) against its plain version, and its
device time, for one tree of the port.

    python3 tools/b4b_timing.py [--tree DIR] [--label NAME] [--no-time]
    python3 tools/b4b_timing.py --variants [NAME,...]

Needs one CUDA card and ``nvcc``. Imports ``repro_torch`` from ``DIR/src``
(default: this checkout), so that an unpacked ``git archive`` of another
commit is measured by the same script on the same card; each tree builds
its kernels into its own ``build/``. Prints nvcc's report for B4b's
kernels (registers, shared memory, spills), then, for each of ``CASES``
(random inputs from a seed): B4's forward with its log-sum-exp, then B4b
against ``ref.flash_attention_bwd_torch`` on the same residuals and
cotangent (its chunk at least Sq, so that one block holds all of Sq), each
gradient's largest error relative to its largest entry, held to
``chip_smoke.ATTN_BWD_TOL``, and whether two calls give the same bits.
Then, unless ``--no-time``, at ``TIMED`` (olmo-1b's and hymba-1.5b's
training heads): B4b's ms beside the plain pair-scan's (chunk 512),
PyTorch's ``scaled_dot_product_attention`` backward on the same inputs (a
yardstick) and the bound from ``counts.flash_attention_bwd_counts``
(``chip_smoke.time_ms``: CUDA events behind a sleep kernel, in the order
plain, kernel, kernel, plain). Prints one JSON object as its last line and
writes it to ``chiprun_out/b4b_timing_NAME.json``.

``--variants`` runs this script on this checkout (label ``source``) and
then on copies of its ``src/`` under the git-ignored
``build/b4b_variants/NAME/``, each with one text change of
``csrc/flash_attention_bwd.cu`` from ``VARIANTS`` (each found exactly
once), one process a tree in turn on the same card: what the register
budget costs at hd = 64 and 128 (nvcc spills a few hundred bytes a thread
at hd = 128 in the source's plan).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32
# (B, Sq, Sk, H, KV, hd, dtype, causal, window, cap): olmo-1b's training
# heads in bf16 and f32; GQA; ragged S; hymba-1.5b's with its window;
# whisper-tiny's encoder, decoder and cross attention; the cap; rows with
# no allowed column; hd 16, 32, 80
CASES = (
    (8, 1024, 1024, 16, 16, 128, BF16, True, None, 0.0),
    (8, 1024, 1024, 16, 16, 128, F32, True, None, 0.0),
    (2, 1024, 1024, 32, 8, 128, BF16, True, None, 0.0),
    (2, 65, 65, 32, 8, 128, BF16, True, None, 0.0),
    (2, 65, 65, 32, 8, 128, F32, True, 48, 0.0),
    (8, 1024, 1024, 25, 5, 64, BF16, True, 2048, 0.0),
    (16, 1500, 1500, 6, 6, 64, BF16, False, None, 0.0),
    (16, 448, 448, 6, 6, 64, BF16, True, None, 0.0),
    (16, 448, 1500, 6, 6, 64, BF16, False, None, 0.0),
    (2, 1024, 1024, 16, 16, 128, BF16, True, None, 30.0),
    (2, 256, 256, 16, 16, 128, F32, True, None, 30.0),
    (2, 200, 70, 4, 1, 64, BF16, True, 40, 0.0),
    (1, 64, 50, 2, 1, 64, F32, True, 14, 0.0),
    (3, 97, 97, 5, 1, 80, BF16, True, 33, 0.0),
    (2, 130, 130, 4, 2, 16, BF16, True, None, 0.0),
    (2, 100, 120, 4, 4, 32, F32, False, None, 0.0),
)
TIMED = ((8, 1024, 16, 16, 128), (8, 1024, 25, 5, 64))
_PRODUCT_LOOP = """#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    unsigned a[4];"""
_MIN_BLOCKS = "constexpr int kMinBlocks = HD <= 64 ? 3 : 1;"
# name -> (text of csrc/flash_attention_bwd.cu, its replacement)
VARIANTS = {
    # the k16 steps of S and dP not unrolled: fewer fragments live at once
    "k_steps_rolled": (_PRODUCT_LOOP, _PRODUCT_LOOP.replace(
        "#pragma unroll", "#pragma unroll 1")),
    # the blocks an SM asked of the compiler for both passes: one at every
    # hd (up to 255 registers a thread), three at every hd (up to 168)
    "one_block": (_MIN_BLOCKS, _MIN_BLOCKS.replace("? 3 : 1", "? 1 : 1")),
    "three_blocks": (_MIN_BLOCKS, _MIN_BLOCKS.replace("? 3 : 1", "? 3 : 3")),
}


def _inputs(gen, b, sq, sk, h, kv, hd, dtype):
    return [torch.randn(b, n, m, hd, generator=gen).to("cuda", dtype)
            for n, m in ((sq, h), (sk, kv), (sk, kv), (sq, h))]


def check_case(b4b, ref, gen, case):
    b, sq, sk, h, kv, hd, dtype, causal, window, cap = case
    q, k, v, dout = _inputs(gen, b, sq, sk, h, kv, hd, dtype)
    out, lse = torch.ops.repro_torch.flash_attention_lse(q, k, v, causal,
                                                          window, cap)
    kw = dict(causal=causal, window=window, softcap=cap)
    got = b4b.flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
    again = b4b.flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
    plain = ref.flash_attention_bwd_torch(q, k, v, out, lse, dout,
                                          chunk=max(512, sq), **kw)
    torch.cuda.synchronize()
    row = {"case": [b, sq, sk, h, kv, hd, str(dtype), causal, window, cap]}
    ok = True
    for name, g, a, p in zip(("dq", "dk", "dv"), got, again, plain):
        err = float((g.float() - p.float()).abs().max())
        rel = err / max(float(p.float().abs().max()), 1e-30)
        same = bool(torch.equal(g, a))
        finite = bool(torch.isfinite(g).all())
        row[name] = {"max_abs_err": err, "of_largest": rel,
                     "same_bits": same}
        ok = ok and finite and same and rel <= cs.ATTN_BWD_TOL[dtype]
    row["ok"] = ok
    return row


def time_case(b4b, ref, counts, gen, b, s, h, kv, hd):
    import torch.nn.functional as F
    q, k, v, dout = _inputs(gen, b, s, s, h, kv, hd, BF16)
    out, lse = torch.ops.repro_torch.flash_attention_lse(q, k, v, True, None,
                                                          0.0)

    def kern():
        return b4b.flash_attention_bwd_cuda(q, k, v, out, lse, dout)

    def plain():
        return ref.flash_attention_bwd_torch(q, k, v, out, lse, dout,
                                             chunk=512)

    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                       enable_gqa=True)
    dot = dout.transpose(1, 2).contiguous()

    def sdpa():
        return torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True)

    runs = [cs.time_ms(plain, reps=3, inner=3), cs.time_ms(kern),
            cs.time_ms(kern), cs.time_ms(plain, reps=3, inner=3)]
    bound_ms, bound_by = cs.bound(*counts.flash_attention_bwd_counts(
        b, s, s, h, kv, hd), peak=cs.BF16_FLOPS)
    return {"shape": [b, s, h, kv, hd], "ms": min(runs[1:3]),
            "ms_runs": runs[1:3], "plain_ms": min(runs[0], runs[3]),
            "sdpa_backward_ms": cs.time_ms(sdpa, reps=5, inner=5),
            "bound_ms": bound_ms, "bound_by": bound_by}


def variant_tree(name: str) -> Path:
    """A copy of this checkout's ``src/`` under ``build/b4b_variants/NAME``
    with VARIANTS[name] applied to B4b's source."""
    import shutil
    old, new = VARIANTS[name]
    tree = ROOT / "build" / "b4b_variants" / name
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(ROOT / "src", tree / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = tree / "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
    text = cu.read_text()
    if text.count(old) != 1:
        raise ValueError(f"variant {name}: its text is found "
                         f"{text.count(old)} times in the source")
    cu.write_text(text.replace(old, new))
    return tree


def run_variants(names) -> int:
    import subprocess
    runs = [("source", ROOT)] + [(n, variant_tree(n)) for n in names]
    rcs = {}
    for label, tree in runs:
        rcs[label] = subprocess.call([sys.executable, __file__, "--tree",
                                      str(tree), "--label", label])
    print(json.dumps({"variants": rcs}))
    return 0 if rcs["source"] == 0 else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--label", default="change")
    ap.add_argument("--no-time", action="store_true")
    ap.add_argument("--variants", nargs="?", const=",".join(VARIANTS))
    args = ap.parse_args(argv)
    if args.variants is not None:
        return run_variants(args.variants.split(","))
    if not torch.cuda.is_available():
        print("b4b_timing: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    from repro_torch.kernels import build, counts, ref
    from repro_torch.kernels import flash_attention_bwd as b4b
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    t0 = time.perf_counter()
    report = build.build(force=True).get("flash_attention_bwd.cu", "")
    result = {"label": args.label, "card": card,
              "build_s": time.perf_counter() - t0,
              "nvcc": [line.strip() for line in report.splitlines()
                       if "registers" in line or "spill" in line
                       or "Compiling entry" in line]}
    for line in result["nvcc"]:
        print(f"  {line}", flush=True)
    gen = torch.Generator().manual_seed(43)
    result["cases"] = []
    for case in CASES:
        row = check_case(b4b, ref, gen, case)
        print(json.dumps(row), flush=True)
        result["cases"].append(row)
        torch.cuda.empty_cache()
    if not args.no_time:
        result["timed"] = [time_case(b4b, ref, counts, gen, *shape)
                           for shape in TIMED]
    result["ok"] = all(r["ok"] for r in result["cases"])
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"b4b_timing_{args.label}.json").write_text(
        json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
