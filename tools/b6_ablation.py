#!/usr/bin/env python3
"""What bounds kernel B6 (``csrc/mamba_scan.cu``) on the card, and which
plan it takes: ablations and a plan sweep.

    python3 tools/b6_ablation.py

Needs one CUDA card and ``nvcc``. Compiles copies of the source into
``build/b6_ablation/`` (one ``nvcc`` each, all started together) and times
the bare scan at falcon-mamba-7b's prefill shape (B=1, S=2048, d=8192,
N=16) and the gated entry at the same shape (z and the output in bf16),
with CUDA events behind a sleep kernel (``chip_smoke.time_ms``). The
copies:

* ``full``: the source as it is;
* ``plan_P_SEG_U``: the source with another plan (segments per chunk,
  steps per segment, states unrolled; ``SWEEP``) in place of its own;
* ``no_shuffle``: the segment combine's shuffles return the thread's own
  value;
* ``no_exp``: ``ex2`` returns its argument;
* ``no_second_pass``: the second walk of each segment (h and y) is cut;
* ``no_memory``: no device-memory traffic: chunks are not loaded and y is
  not stored (the kernel computes on what shared memory holds);
* ``no_compute``: the loop over states is cut (loads, transposes and
  stores only);
* ``no_softplus``: the gated entry's softplus is cut (the gated time only).

``full`` and the plans are held against the plain versions on the inputs
they time (``max_abs_err``; ``within_tol``: inside chip_smoke.py's bars);
the cut copies compute wrong values and only their times mean anything.
Prints one JSON object {"card", "shape", "plan", "ms": {copy: {"bare",
"gated", ...}}} as its last line.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build, ref  # noqa: E402

SOURCE = build.CSRC / "mamba_scan.cu"
PLAN_RE = re.compile(r"constexpr int kSegments = (\d+), kSegLen = (\d+), "
                     r"kUnroll = (\d+);")
#: Plans (segments per chunk, steps per segment, states unrolled) timed
#: beside the source's own.
SWEEP = ((8, 16, 4), (8, 8, 32), (4, 16, 32), (8, 12, 32), (8, 16, 32),
         (8, 8, 4), (16, 8, 32), (4, 8, 32))
#: Ablations: (text, replacement) pairs, each found exactly once.
CUTS = {
    "no_shuffle": [("__shfl_up_sync(kFull, ac, off, P)", "ac"),
                   ("__shfl_up_sync(kFull, bc, off, P)", "bc"),
                   ("__shfl_up_sync(kFull, ac, 1, P)", "ac"),
                   ("__shfl_up_sync(kFull, bc, 1, P)", "bc")],
    "no_exp": [('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));',
                "r = x;")],
    "no_second_pass": [("          h = rnd<R>(fmaf(ea[i + j], h, eb[i + j]));\n"
                        "          yv[i + j] = fmaf(h, cv[j], yv[i + j]);",
                        "          h += cv[j];")],
    "no_memory": [("  const int rows = min(L::kChunk, p.S - t0);\n"
                   "  for (int v = tid;",
                   "  const int rows = min(L::kChunk, p.S - t0);\n"
                   "  if (rows > -1) return;\n  for (int v = tid;"),
                  ("  Z* yg = static_cast<Z*>(p.y);\n",
                   "  Z* yg = static_cast<Z*>(p.y);\n"
                   "  if (rows > -1) return;\n")],
    "no_compute": [("    for (int n = 0; n < NP; ++n) {",
                    "    for (int n = 0; n < 0; ++n) {")],
    "no_softplus": [("        x = softplus(x + bias);",
                     "        x = x + bias;")],
}
SCAN_TOL = 5e-4          # chip_smoke.py's bar for both entries
BF16_HALF_ULP = 2.0 ** -8


def source_plan(text: str) -> tuple[int, int, int]:
    """The plan the source compiles: (segments, steps per segment, states
    unrolled)."""
    m = PLAN_RE.search(text)
    if m is None:
        raise RuntimeError("mamba_scan.cu no longer states its plan as "
                           f"{PLAN_RE.pattern!r}")
    return tuple(int(v) for v in m.groups())


def patched(text: str, name: str, cuts) -> str:
    for old, new in cuts:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: mamba_scan.cu has {text.count(old)} "
                               f"copies of {old!r}, not one")
        text = text.replace(old, new)
    return text


def variants(text: str) -> dict[str, str]:
    """Every copy's source by name: ``full``, a ``plan_P_SEG_U`` for each
    plan of SWEEP other than the source's own, and the cuts."""
    plan = source_plan(text)
    line = PLAN_RE.search(text).group(0)
    out = {"full": text}
    for p in SWEEP:
        if p != plan:
            out["plan_%d_%d_%d" % p] = patched(text, "plan", [(
                line, "constexpr int kSegments = %d, kSegLen = %d, "
                      "kUnroll = %d;" % p)])
    for name, cuts in CUTS.items():
        out[name] = patched(text, name, cuts)
    return out


def compile_all(out: Path) -> dict[str, Path]:
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants(SOURCE.read_text()).items():
        cu = out / f"{name}.cu"
        cu.write_text(text)
        lib = out / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        libs[name] = lib
    return libs


def _err(got, want, tol, rel_extra=0.0):
    """(largest |got - want|, within allclose(tol) plus rel_extra of
    |want|)."""
    want = want.float()
    diff = (got.float() - want).abs()
    return (float(diff.max()),
            bool(((diff - (tol + rel_extra) * want.abs()) <= tol).all()))


def main() -> int:
    if not torch.cuda.is_available():
        print("b6_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import card_line, time_ms
    libs = compile_all(ROOT / "build" / "b6_ablation")
    b, s, d, n = 1, 2048, 8192, 16
    gen = torch.Generator().manual_seed(0)
    u = torch.randn(b, s, d, generator=gen)
    dt = torch.nn.functional.softplus(torch.randn(b, s, d, generator=gen))
    dt_raw = 0.5 * torch.randn(b, s, d, generator=gen)
    bias = torch.log(torch.expm1(torch.full((d,), 0.01)))
    bm = torch.randn(b, s, n, generator=gen)
    cm = torch.randn(b, s, n, generator=gen)
    a = -torch.exp(0.2 * torch.randn(d, n, generator=gen))
    dskip = torch.ones(d)
    u, dt, dt_raw, bias, bm, cm, a, dskip = (
        t.cuda() for t in (u, 0.1 * dt, dt_raw, bias, bm, cm, a, dskip))
    z = torch.randn(b, s, 2 * d, generator=gen).to("cuda",
                                                   torch.bfloat16)[..., d:]
    y = torch.empty(b, s, d, device="cuda")
    out = torch.empty(b, s, d, device="cuda", dtype=torch.bfloat16)
    h = torch.empty(b, d, n, device="cuda")
    want_y, want_h = ref.mamba_scan_torch(u, dt, bm, cm, a)
    want_o, want_go = ref.mamba_scan_gated_torch(u, dt_raw, bias, bm, cm, a,
                                                 dskip, z.float())
    stream = torch.cuda.current_stream().cuda_stream
    ptr = ctypes.c_void_p
    result = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        bare = lib.corais_mamba_scan
        bare.argtypes = [ptr] * 7 + [ctypes.c_int] * 5 + [ptr]
        gated = lib.corais_mamba_scan_gated
        gated.argtypes = ([ptr] * 8 + [ctypes.c_longlong, ctypes.c_int]
                          + [ptr] * 3 + [ctypes.c_int] * 5 + [ptr])

        def run_bare():
            return bare(u.data_ptr(), dt.data_ptr(), bm.data_ptr(),
                        cm.data_ptr(), a.data_ptr(), y.data_ptr(),
                        h.data_ptr(), b, s, d, n, 0, stream)

        def run_gated():
            return gated(u.data_ptr(), dt_raw.data_ptr(), bias.data_ptr(),
                         bm.data_ptr(), cm.data_ptr(), a.data_ptr(),
                         dskip.data_ptr(), z.data_ptr(), z.stride(1), 1,
                         out.data_ptr(), h.data_ptr(), None, b, s, d, n, 0,
                         stream)

        row = {}
        if run_bare() != 0:
            raise RuntimeError(f"{name}: launch refused")
        if name == "full" or name.startswith("plan_"):
            torch.cuda.synchronize()
            ey, oky = _err(y, want_y, SCAN_TOL)
            eh, okh = _err(h, want_h, SCAN_TOL)
        if run_gated() != 0:
            raise RuntimeError(f"{name}: launch refused")
        if name == "full" or name.startswith("plan_"):
            torch.cuda.synchronize()
            eo, oko = _err(out, want_o, SCAN_TOL, BF16_HALF_ULP)
            eg, okg = _err(h, want_go, SCAN_TOL)
            row["max_abs_err"] = {"bare": max(ey, eh), "gated": max(eo, eg)}
            row["within_tol"] = oky and okh and oko and okg
        row["bare"] = time_ms(run_bare, 10, 10)
        row["gated"] = time_ms(run_gated, 10, 10)
        result[name] = row
        print(f"{name}: {json.dumps(row)}", flush=True)
    print(json.dumps({"card": card_line(), "shape": [b, s, d, n],
                      "plan": source_plan(SOURCE.read_text()),
                      "ms": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
