#!/usr/bin/env python3
"""B4b (``csrc/flash_attention_bwd.cu``) against its plain version, and its
device time, for one tree of the port.

    python3 tools/b4b_timing.py [--tree DIR] [--label NAME] [--no-time]
    python3 tools/b4b_timing.py --variants [NAME,...]
    python3 tools/b4b_timing.py --probes
    python3 tools/b4b_timing.py [--tree DIR] [--label NAME] --steps ARCH

Needs one CUDA card and ``nvcc``. Imports ``repro_torch`` from ``DIR/src``
(default: this checkout), so that an unpacked ``git archive`` of another
commit is measured by the same script on the same card; each tree builds
its kernels into its own ``build/``. Prints nvcc's report for B4b's
kernels, both plans' (registers, shared memory, spills, and ptxas's notes
where it serializes the wgmma plan's products), then, for each of ``CASES``
(random inputs from a seed): B4's forward with its log-sum-exp, then B4b
against ``ref.flash_attention_bwd_torch`` on the same residuals and
cotangent (its chunk at least Sq, so that one block holds all of Sq), each
gradient's largest error relative to its largest entry, held to
``chip_smoke.ATTN_BWD_TOL``, and whether two calls give the same bits; in
bf16 also each gradient's norm distance from the bf16 rounding of the
pair-scan in f32 on the same bf16 residuals (``split_err``), held to
``SPLIT_TOL``, which P and dS rounded once to bf16 exceed.
Then the host's microseconds a call of the wrapper (``host_us``: calls
queued without a sync at a shape whose device work is shorter). Then,
unless ``--no-time``, at ``TIMED`` (olmo-1b's and hymba-1.5b's
training heads): B4b's ms beside the plain pair-scan's (chunk 512),
PyTorch's ``scaled_dot_product_attention`` backward on the same inputs (a
yardstick), the bound from ``counts.flash_attention_bwd_counts``
(``chip_smoke.time_ms``: CUDA events behind a sleep kernel, in the order
plain, kernel, kernel, plain) and the device ms a call of each pass (a
profile of five calls). Prints one JSON object as its last line and
writes it to ``chiprun_out/b4b_timing_NAME.json``. To compare two commits,
unpack a ``git archive`` of the other under the git-ignored ``build/``
and run ``--tree`` on it and this checkout in turns in one call.

``--steps ARCH`` runs, in place of the cases and times, ``launch.train
lm`` of the tree at ARCH as ``chip_smoke.py`` trains it (full width,
``TRAIN_LM_STEPS`` steps of 8 x 1024 tokens) and reports each step's wall
ms after ``TRAIN_LM_TIMED`` warm-up steps and their median.

``--variants`` runs this script on this checkout (label ``source``) and
then on copies of its ``src/`` under the git-ignored
``build/b4b_variants/NAME/``, each with one text change of
``csrc/flash_attention_bwd.cu`` from ``VARIANTS`` (each found exactly
once; each changes the wgmma plan, hd = 64 and 128), one process a tree
in turn on the same card. ``--probes`` runs it on a copy whose consumer
warpgroup 0 stores ``clock64()`` at the phases of each tile (``PHASES``)
and prints the mean cycles a tile of each phase and pass at ``TIMED``.
"""
from __future__ import annotations

import argparse
import json
import statistics
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
# no allowed column (hd 64 in f32, 32 and 80 in bf16 on the mma.sync plan);
# hd 16, 32, 80
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
    (1, 64, 50, 2, 1, 32, BF16, True, 14, 0.0),
    (1, 64, 50, 2, 1, 80, BF16, True, 14, 0.0),
    (3, 97, 97, 5, 1, 80, BF16, True, 33, 0.0),
    (2, 130, 130, 4, 2, 16, BF16, True, None, 0.0),
    (2, 100, 120, 4, 4, 32, F32, False, None, 0.0),
)
TIMED = ((8, 1024, 16, 16, 128), (8, 1024, 25, 5, 64))
# each bf16 gradient's norm distance from the bf16 rounding of the
# pair-scan in f32 on the same bf16 residuals, of that gradient's norm (the
# card tests' bar; P and dS rounded once to bf16 exceed it)
SPLIT_TOL = 1e-3
_REGS = """constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;"""
# name -> (text of csrc/flash_attention_bwd.cu, its replacement); each
# changes the wgmma plan (hd = 64 and 128) only
VARIANTS = {
    # a ring of four stages in both passes, not two
    "ring_4": ("constexpr int kRing = 2;", "constexpr int kRing = 4;"),
    # setmaxnreg: 40 registers a producer thread, 232 a consumer's
    "regs_40_232": (_REGS, _REGS.replace("24;", "40;").replace("240;",
                                                                "232;")),
    # the exponential through exp2f (both bf16 plans), not one ex2 with
    # its results below 2^-126 flushed
    "exp2f": ('  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));',
              "  y = exp2f(x);"),
    # the price of the split: P and dS as one bf16 term (hi) in dQ, dK and
    # dV; timed only, its errors larger (never the shipped plan)
    "hi_only": ("  wg::mma_rs<HD>(d, lo, db);\n", ""),
}

# --probes: the wgmma plan's consumer warpgroup 0, thread 0, stores
# clock64() at PHASE_SLOTS points of each tile it works, per block and
# pass; phase k runs from point k - 1 to point k, "to_next" from the last
# point of a tile to the first of the next.
PROBE_TILES = 128  # tiles a block stores (the timed shapes walk at most 80)
PHASES = ("full_wait", "s_dp_issue_s_wait", "p", "dp_wait", "ds_split",
          "rs_issue", "rs_wait", "to_next")


def _stamp(pass_: int, k: int) -> str:
    return (f"      if (threadIdx.x == 128 && it < {PROBE_TILES}) "
            f"g_b4b_probe[{pass_}][((((long)blockIdx.z * gridDim.y + "
            f"blockIdx.y) * gridDim.x + blockIdx.x) * {PROBE_TILES} + it) * "
            f"8 + {k}] = clock64();\n")


def _probes() -> list:
    """(text, replacement) pairs of the probed copy, each found once."""
    out = [("namespace {\n\nusing namespace tc;",
            "__device__ long long g_b4b_probe[2][1 << 21];\n\n"
            "namespace {\n\nusing namespace tc;")]
    for p, (top, s_issue, s_wait, p_end, grads, rs_end) in enumerate((
            ("      const bf16* vt = vs + st * KT::kElems;\n",
             "  // S = Q K^T\n",
             "  // S; P formed while dP is in flight\n      wg::hold(sc);\n",
             "causal, window); });\n      wg::mma_wait<0>();\n",
             "return dl_r[e / 2]; });\n      split_steps(dp, dhi, dlo);\n",
             "  // dQ's products: the stage is free\n"),
            ("      auto qcol = [&](int nt, int e) { return nt * 8 + 2 * tq + "
             "(e & 1); };\n",
             "  // S^T = K Q^T\n",
             "  // S^T; P^T formed while dP^T is in flight\n"
             "      wg::hold(sc);\n",
             "causal, window);\n          });\n      wg::mma_wait<0>();\n",
             "      split_steps(sc, phi, plo);\n      split_steps(dp, dhi, dlo);\n",
             "  // dV's and dK's products: the stage is free\n"))):
        wait = "      wg::bar_wait(&full[st], (it / kRing) & 1);\n"
        issue = ("      wg::mma_fence();\n#pragma unroll\n      for (int kk = 0;"
                 " kk < HD / 16; ++kk)" + s_issue)
        out += [(top, top + _stamp(p, 0)),
                (wait + issue, wait + _stamp(p, 1) + issue),
                (s_wait, s_wait + _stamp(p, 2)),
                (p_end, p_end.replace("      wg::mma_wait<0>();\n",
                                      _stamp(p, 3) + "      wg::mma_wait<0>()"
                                      ";\n" + _stamp(p, 4))),
                (grads, grads + _stamp(p, 5)),
                ("      wg::mma_commit();\n      wg::mma_wait<0>();" + rs_end,
                 "      wg::mma_commit();\n" + _stamp(p, 6)
                 + "      wg::mma_wait<0>();" + rs_end + _stamp(p, 7))]
    return out


_PROBE_READER = (
    '\nextern "C" int b4b_probes(void* dst, int pass, long long n) {\n'
    "  if (dst == nullptr) {\n"
    "    void* p;\n"
    "    cudaError_t e = cudaGetSymbolAddress(&p, g_b4b_probe);\n"
    "    return e ? (int)e : (int)cudaMemset(p, 0, sizeof(g_b4b_probe));\n"
    "  }\n"
    "  return (int)cudaMemcpyFromSymbol(dst, g_b4b_probe, n * 8,\n"
    "                                   (size_t)pass * (1 << 21) * 8);\n}\n")


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
    if dtype == BF16:
        f32 = ref.flash_attention_bwd_torch(
            *(t.float() for t in (q, k, v, out)), lse, dout.float(),
            chunk=max(512, sq), **kw)
        for name, g, w in zip(("dq", "dk", "dv"), got, f32):
            w = w.float()
            err = float((g.float() - w.to(BF16).float()).norm() / w.norm())
            row[name]["split_err"] = err
            ok = ok and err <= SPLIT_TOL
        del f32
    row["ok"] = ok
    return row


def host_us(b4b, gen, calls: int = 200, reps: int = 5) -> dict:
    """Host microseconds a call of the wrapper, at (1, 128, 4, 4, 64) bf16
    causal: ``calls`` calls queued without a sync, the median of ``reps``;
    ``wall_us`` a call to the sync after them (about the same when the
    device keeps up)."""
    q, k, v, dout = _inputs(gen, 1, 128, 128, 4, 4, 64, BF16)
    out, lse = torch.ops.repro_torch.flash_attention_lse(q, k, v, True, None,
                                                          0.0)
    host, wall = [], []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            b4b.flash_attention_bwd_cuda(q, k, v, out, lse, dout)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        host.append((t1 - t0) / calls * 1e6)
        wall.append((time.perf_counter() - t0) / calls * 1e6)
    host, wall = sorted(host[1:]), sorted(wall[1:])
    return {"host_us": host[reps // 2], "wall_us": wall[reps // 2]}


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
    passes = pass_ms(kern)
    bound_ms, bound_by = cs.bound(*counts.flash_attention_bwd_counts(
        b, s, s, h, kv, hd), peak=cs.BF16_FLOPS)
    return {"shape": [b, s, h, kv, hd], "ms": min(runs[1:3]),
            "ms_runs": runs[1:3], "plain_ms": min(runs[0], runs[3]),
            "sdpa_backward_ms": cs.time_ms(sdpa, reps=5, inner=5),
            "bound_ms": bound_ms, "bound_by": bound_by, "pass_ms": passes}


def pass_ms(kern, calls: int = 5) -> dict:
    """Device ms a call by pass (the dq pass, the dk/dv pass), from a
    profile of ``calls`` calls: each kernel's name from the source."""
    from torch.profiler import ProfilerActivity, profile
    kern()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            kern()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        for name in ("flash_bwd_dq", "flash_bwd_dkdv"):
            if name in ev.key:
                plan = "wg" if "_wg" in ev.key else "tc"
                key = f"{name}_{plan}"
                out[key] = out.get(key, 0.0) + us / calls / 1000.0
    return out


def train_steps(arch: str) -> dict:
    """Wall ms a training step of ``launch.train lm`` at ``arch``, as the
    smoke trains it, after its warm-up steps."""
    from repro_torch.launch import train
    run = train.main(cs._train_lm_argv("cuda", cs.TRAIN_LM_STEPS, arch=arch))
    return {"arch": arch, "step_ms": run["step_ms"],
            "p50": statistics.median(run["step_ms"][cs.TRAIN_LM_TIMED:])}


def variant_tree(name: str) -> Path:
    """A copy of this checkout's ``src/`` under ``build/b4b_variants/NAME``
    with VARIANTS[name] (or, for ``probes``, the probes) applied to B4b's
    source."""
    import shutil
    pairs = (_probes() if name == "probes" else [VARIANTS[name]])
    tree = ROOT / "build" / "b4b_variants" / name
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(ROOT / "src", tree / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = tree / "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
    text = cu.read_text()
    for old, new in pairs:
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: its text is found "
                             f"{text.count(old)} times in the source")
        text = text.replace(old, new)
    cu.write_text(text + (_PROBE_READER if name == "probes" else ""))
    return tree


def read_phases(build, kern) -> dict:
    """Mean cycles a tile by phase and pass (consumer warpgroup 0 of every
    block) over one call of ``kern`` in the probed build."""
    import ctypes
    import numpy as np
    lib = ctypes.CDLL(str(build._library("flash_attention_bwd.cu")))
    lib.b4b_probes.argtypes = [ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_longlong]
    kern()
    torch.cuda.synchronize()
    if lib.b4b_probes(None, 0, 0):
        raise RuntimeError("could not zero the probes")
    kern()
    torch.cuda.synchronize()
    out = {}
    for p, name in enumerate(("dq", "dkdv")):
        buf = np.zeros(1 << 21, dtype=np.int64)
        if lib.b4b_probes(buf.ctypes.data, p, 1 << 21):
            raise RuntimeError("could not read the probes")
        t = buf.reshape(-1, PROBE_TILES, 8)
        ok = (t != 0).all(-1)
        d = np.diff(t, axis=-1)[ok]
        nxt = (t[:, 1:, 0] - t[:, :-1, 7])[ok[:, 1:] & ok[:, :-1]]
        out[name] = {"tiles": int(ok.sum()),
                     **{ph: float(d[:, i].mean()) for i, ph in
                        enumerate(PHASES[:-1])},
                     "to_next": float(nxt.mean()) if len(nxt) else None}
    return out


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
    ap.add_argument("--probes", action="store_true")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--steps", metavar="ARCH")
    args = ap.parse_args(argv)
    if args.variants is not None:
        return run_variants(args.variants.split(","))
    if args.probes:
        import subprocess
        return subprocess.call([sys.executable, __file__, "--tree",
                                str(variant_tree("probes")), "--label",
                                "probes", "--phases"])
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
                       or "Compiling entry" in line or "arning" in line
                       or "wgmma" in line]}
    for line in result["nvcc"]:
        print(f"  {line}", flush=True)
    gen = torch.Generator().manual_seed(43)
    result["cases"] = []
    if args.steps:
        result["steps"] = train_steps(args.steps)
        print(json.dumps(result["steps"]), flush=True)
        cases, args.no_time = (), True
    else:
        cases = CASES
    if args.phases:
        result["phases"] = []
        for b, s, h, kv, hd in TIMED:
            q, k, v, dout = _inputs(gen, b, s, s, h, kv, hd, BF16)
            out, lse = torch.ops.repro_torch.flash_attention_lse(
                q, k, v, True, None, 0.0)
            row = {"shape": [b, s, h, kv, hd], **read_phases(
                build, lambda: b4b.flash_attention_bwd_cuda(
                    q, k, v, out, lse, dout))}
            print(json.dumps(row), flush=True)
            result["phases"].append(row)
        args.no_time = True
    for case in cases:
        row = check_case(b4b, ref, gen, case)
        print(json.dumps(row), flush=True)
        result["cases"].append(row)
        torch.cuda.empty_cache()
    if not args.steps:
        result["host"] = host_us(b4b, gen)
        print(json.dumps(result["host"]), flush=True)
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
