#!/usr/bin/env python3
"""What bounds kernel B6b (``csrc/mamba_scan_bwd.cu``, the gated selective
scan's backward) on the card, and which plan it takes: ablations, a plan
sweep and phase probes.

    python3 tools/b6b_ablation.py

Needs one CUDA card, ``nvcc`` and ``cuobjdump``. Compiles copies of the
source into ``build/b6b_ablation/`` (one ``nvcc`` each, all started
together) and times each copy's launch at hymba-1.5b's training shape
(B=8, S=1024, d=3200, N=16) and falcon-mamba-7b's (d=8192), z and dout in
bf16, from the chunk states B6's gated entry stores there, with CUDA
events behind a sleep kernel (``chip_smoke.time_ms``). The copies of the
source:

* ``full``: the source as it is; also timed with the wrapper's
  ``torch.sum`` of its partials (``with_sums``);
* ``plan_C_SEG_K_U``: the source with another plan (channels a block,
  steps a segment, blocks a cluster, states at once; ``SWEEP``) in place
  of its own;
* the cuts of ``CUTS``: ``no_exp`` (``ex2`` returns its argument),
  ``no_memory`` (no device-memory traffic but the chunk states: tiles are
  not loaded, gradients and partials not stored), ``no_channel_sum`` (the
  in-warp and cross-warp sums over channels cut), ``no_cluster_fold`` (each
  partial read from one block of the cluster, not added over them),
  ``no_scan`` (the segment combines' shuffles return the thread's own
  value), ``no_state_sync`` (the barrier after each group of states
  cut);
* ``probes``: thread 0 of every block stores ``clock64()`` at the phase
  boundaries of each chunk (``PROBES``, in the order of ``PHASES``) and at
  the start of each group of states. At hymba's shape the tool prints the
  median and mean cycles of each phase over every block and chunk, and of
  a group of states (``phases``); the probes cost a few cycles each.

The full copies are held against the plain version on the inputs they time
(``max_err_of_largest``: the largest error over the eight gradients
against that gradient's largest |entry|; ``within_tol``: inside
chip_smoke.py's SCAN_BWD_TOL); the cut copies compute wrong values and only
their times mean anything. ``state_loop_ops`` counts the instructions of
the state loop of ``full``'s Wide-plan bf16 kernel by opcode, from
``cuobjdump -sass``. Prints one JSON object {"card", "shapes", "plan",
"ms": {copy: {shape: ms, ...}}, "phases", "state_loop_ops"} as its last
line.
"""
from __future__ import annotations

import collections
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build, mamba_scan, ref  # noqa: E402,F401

SOURCE = build.CSRC / "mamba_scan_bwd.cu"
PLAN_RE = re.compile(r"constexpr int kChannels = (\d+), kSegLen = (\d+), "
                     r"kCluster = (\d+), kStates = (\d+);")
#: Plans (channels a block, steps a segment, blocks a cluster, states a
#: thread walks at once) timed beside the source's own. Channels times
#: cluster is what one partial of dB and dC covers (128; 64 in the plan
#: that sets two 8-warp blocks an SM against (32, 8, 4, 1)'s one 16-warp
#: block, the cluster and the states unchanged); the kernel takes 8 steps a
#: segment.
SWEEP = ((32, 8, 4, 2), (32, 8, 4, 1), (16, 8, 8, 1), (16, 8, 8, 2),
         (16, 8, 4, 1))
#: Ablations of the source: (text, replacement) pairs, each found exactly
#: once.
CUTS = {
    "no_exp": [('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));',
                "r = x;")],
    "no_memory": [("  const int rows = min(kChunk, p.S - t0);\n"
                   "  const long row0",
                   "  const int rows = min(kChunk, p.S - t0);\n"
                   "  if (rows > -1) return;\n  const long row0"),
                  ("  Z* dzg = static_cast<Z*>(p.dz);\n",
                   "  Z* dzg = static_cast<Z*>(p.dz);\n"
                   "  if (rows > -1) return;\n"),
                  ("        if (t + j < rows) dst[j * N] = o[j];",
                   "        if (t + j < -1) dst[j * N] = o[j];")],
    "no_channel_sum": [("            if (kWarpChannels > 1) {  // channel sum\n",
                        "            if (kWarpChannels < 0) {  // channel sum\n"),
                       ("        for (int w = 0; w < W; ++w)  // warps\n",
                        "        for (int w = 0; w < 1; ++w)  // warps\n")],
    "no_cluster_fold": [("      for (int r = 0; r < P::kCluster; ++r) {  // ranks\n",
                         "      for (int r = 0; r < 1; ++r) {  // ranks\n"),
                        ("            cluster.map_shared_rank(src, r));",
                         "            src);")],
    "no_scan": [("  return __shfl_up_sync(kFull, v, off, kSegments);",
                 "  return v;"),
                ("  return __shfl_down_sync(kFull, v, off, kSegments);",
                 "  return v;")],
    "no_state_sync": [("      __syncthreads();  // the group's channel sums\n",
                       "      __syncwarp();  // the group's channel sums\n")],
}
SLOTS = 24  # clock values a block stores per chunk in ``probes``
GROUPS = 12  # groups of states probed per chunk (slots 9 ..)


def _probe(k: int) -> str:
    return ("    if (threadIdx.x == 0) g_prof[((blockIdx.y * gridDim.x + "
            f"blockIdx.x) * p.nchunks + it) * {SLOTS} + {k}] = clock64();\n")


#: Phase boundaries of a chunk, in the order it runs them: phase k runs
#: from probe k-1 to probe k, ``to_next`` from the last probe of a chunk
#: to the first of the next.
PHASES = ("prologue", "states", "fold_prev", "finish", "write", "wait_acq",
          "fold", "wait_end", "to_next")
#: The ``probes`` copy: (text, replacement) pairs, each found exactly once.
PROBES = [
    ("    __syncthreads();\n    float* us = st;",
     "    __syncthreads();\n" + _probe(0) + "    float* us = st;"),
    ("    float s1[kSegLen], s2[kSegLen], s3[kSegLen];",
     _probe(1) + "    float s1[kSegLen], s2[kSegLen], s3[kSegLen];"),
    ("    fold_prev();\n    cluster_arrive_release();",
     _probe(2) + "    fold_prev();\n" + _probe(3)
     + "    cluster_arrive_release();"),
    ("    __syncthreads();  // the block's gradients are staged\n",
     _probe(4) + "    __syncthreads();  // the block's gradients are staged\n"),
    ("    cluster_wait_acquire();  // every block's channel sums are in\n",
     _probe(5) + "    cluster_wait_acquire();  // every block's channel sums "
     "are in\n" + _probe(6)),
    ("    cluster_arrive_relaxed();  // this block",
     _probe(7) + "    cluster_arrive_relaxed();  // this block"),
    ("    cluster_wait();  // every block's are: the stage can be refilled\n",
     "    cluster_wait();  // every block's are: the stage can be refilled\n"
     + _probe(8)),
    ("      const int cn = cl * N + n0 + v;",
     "      const int cn = cl * N + n0 + v;\n"
     f"      if (v == 0 && threadIdx.x == 0 && grp < {GROUPS})\n"
     "        g_prof[((blockIdx.y * gridDim.x + blockIdx.x) * p.nchunks + "
     f"it) * {SLOTS} + 9 + grp] = clock64();"),
    ("namespace {\n\nconstexpr int kChunk",
     "__device__ long long g_prof[1 << 21];\n\nnamespace {\n\n"
     "constexpr int kChunk"),
]
_READER = ('\nextern "C" int b6b_probes_read(void* dst, long long n) {\n'
           "  return (int)cudaMemcpyFromSymbol(dst, g_prof, n * 8);\n}\n")
SHAPES = {"hymba": (8, 1024, 3200, 16), "falcon_mamba": (8, 1024, 8192, 16)}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}  # SCAN_BWD_TOL
_P, _I = ctypes.c_void_p, ctypes.c_int


def source_plan(text: str) -> tuple[int, int, int, int]:
    """The plan the source compiles: (channels a block, steps a segment,
    blocks a cluster, states at once)."""
    m = PLAN_RE.search(text)
    if m is None:
        raise RuntimeError("mamba_scan_bwd.cu no longer states its plan as "
                           f"{PLAN_RE.pattern!r}")
    return tuple(int(v) for v in m.groups())


def patched(text: str, name: str, cuts) -> str:
    for old, new in cuts:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the source has {text.count(old)} "
                               f"copies of {old!r}, not one")
        text = text.replace(old, new)
    return text


def variants(text: str) -> dict[str, str]:
    """Every copy of the source by name: ``full``, a ``plan_C_SEG_K_U``
    for each plan of SWEEP other than the source's own, the cuts and
    ``probes``."""
    plan = source_plan(text)
    line = PLAN_RE.search(text).group(0)
    out = {"full": text}
    for p in SWEEP:
        if p != plan:
            out["plan_%d_%d_%d_%d" % p] = patched(text, "plan", [(
                line, "constexpr int kChannels = %d, kSegLen = %d, "
                      "kCluster = %d, kStates = %d;" % p)])
    for name, cuts in CUTS.items():
        out[name] = patched(text, name, cuts)
    out["probes"] = patched(text, "probes", PROBES) + _READER
    return out


def compile_all(sources: dict[str, str], out: Path) -> dict[str, Path]:
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
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
        spills = [ln.strip() for ln in log.splitlines()
                  if "registers" in ln or "spill" in ln]
        print(f"{name}: {' | '.join(spills[-2:])}", flush=True)
    return libs


def _inputs(b, s, d, n):
    """chip_smoke.py's _gated_inputs at this shape (seed 47, as its B6b
    timing), dout bf16, and the chunk states B6 stores."""
    sys.path.insert(0, str(ROOT))
    from chip_smoke import _gated_inputs
    gen = torch.Generator().manual_seed(47)
    args, uz = _gated_inputs(gen, b, s, d, n)
    z = uz[..., d:]
    dout = torch.randn(b, s, d, generator=gen).to("cuda", torch.bfloat16)
    _, _, states = torch.ops.repro_torch.mamba_scan_gated_states(*args, z)
    return args, z, dout, states


def _bind(path: Path):
    lib = ctypes.CDLL(str(path))
    fn = lib.corais_mamba_scan_gated_bwd
    fn.argtypes = ([_P] * 8 + [ctypes.c_longlong, _I] + [_P] * 11 + [_I] * 6
                   + [_P])
    lib.corais_mamba_scan_bwd_block_channels.argtypes = []
    return lib, fn


def _runner(lib, fn, args, z, dout, states):
    """(launch, outputs, sums): a call of the C entry into fixed buffers,
    and the wrapper's torch.sum of the partials."""
    u, dt_raw, bias, bm, cm, a, dskip = args
    b, s, d = u.shape
    n = a.shape[-1]
    nblk = -(-d // lib.corais_mamba_scan_bwd_block_channels())
    f32 = dict(dtype=torch.float32, device="cuda")
    du, ddt = torch.empty(b, s, d, **f32), torch.empty(b, s, d, **f32)
    dz = torch.empty(b, s, d, dtype=z.dtype, device="cuda")
    dBp, dCp = (torch.empty(b, nblk, s, n, **f32) for _ in range(2))
    dAp, dDp, dbp = (torch.empty(b, d, n, **f32), torch.empty(b, d, **f32),
                     torch.empty(b, d, **f32))
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = fn(u.data_ptr(), dt_raw.data_ptr(), bias.data_ptr(),
                 bm.data_ptr(), cm.data_ptr(), a.data_ptr(), dskip.data_ptr(),
                 z.data_ptr(), z.stride(1), 1, dout.data_ptr(),
                 states.data_ptr(), None, du.data_ptr(), ddt.data_ptr(),
                 dz.data_ptr(), dBp.data_ptr(), dCp.data_ptr(),
                 dAp.data_ptr(), dDp.data_ptr(), dbp.data_ptr(), b, s, d, n,
                 nblk, 0, stream)
        if err != 0:
            raise RuntimeError(f"launch refused: CUDA error {err}")

    def sums():
        return (du, ddt, dbp.sum(0), dBp.sum(1), dCp.sum(1), dAp.sum(0),
                dDp.sum(0), dz)

    return launch, sums


def phases(lib, d: int, s: int, b: int) -> dict:
    """The ``probes`` copy's cycles after a launch at (b, s, d): the median
    and mean of each phase over every block and chunk, and of a group of
    states."""
    lib.b6b_probes_read.argtypes = [_P, ctypes.c_longlong]
    channels = source_plan(SOURCE.read_text())[0]
    per = lib.corais_mamba_scan_bwd_block_channels()
    blocks = b * -(-d // per) * (per // channels)  # the Wide plan's grid
    chunks = -(-s // 128)
    buf = (ctypes.c_longlong * (blocks * chunks * SLOTS))()
    if lib.b6b_probes_read(buf, len(buf)) != 0:
        raise RuntimeError("reading the probes failed")
    spans = {name: [] for name in PHASES}
    groups = []
    for blk in range(blocks):
        for it in range(chunks):
            base = (blk * chunks + it) * SLOTS
            c = buf[base:base + 9]
            for k, name in enumerate(PHASES[:-1]):
                spans[name].append(c[k + 1] - c[k])
            if it + 1 < chunks:
                spans["to_next"].append(buf[base + SLOTS] - c[8])
            g = buf[base + 9:base + 9 + 8]
            groups += [g[k + 1] - g[k] for k in range(7)]
    spans["group"] = groups
    return {k: {"median": statistics.median(v), "mean": statistics.fmean(v)}
            for k, v in spans.items() if v}


def state_loop_ops(sass: str) -> dict[str, int]:
    """Opcodes of the Wide plan's bf16 kernel's state loop (the f32 state,
    template flag ``Lb0E``): the backward branch whose body holds a barrier
    and an exponential."""
    for func in re.split(r"\n\s+Function : ", sass)[1:]:
        head = func.split("\n")[0]
        if ("PlanILi32E" not in func or "bfloat16" not in head
                or "Lb0E" not in head):
            continue
        lines = [ln for ln in func.splitlines()
                 if re.match(r"\s+/\*[0-9a-f]{4}\*/", ln)]
        addr = [int(re.search(r"/\*([0-9a-f]{4,})\*/", ln).group(1), 16)
                for ln in lines]
        for i, ln in enumerate(lines):
            m = re.search(r"BRA (0x[0-9a-f]+)", ln)
            if not m or int(m.group(1), 16) >= addr[i]:
                continue
            body = lines[addr.index(int(m.group(1), 16)):i + 1]
            if (any("BAR.SYNC" in x for x in body)
                    and any("MUFU.EX2" in x for x in body)):
                ops = collections.Counter()
                for x in body:
                    op = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(@!?U?P\w+\s+)?"
                                  r"([A-Z][A-Z0-9_.]+)", x)
                    if op:
                        ops[op.group(2).split(".")[0]] += 1
                return dict(ops.most_common())
    return {}


def main() -> int:
    if not torch.cuda.is_available():
        print("b6b_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import card_line, time_ms
    libs = compile_all(variants(SOURCE.read_text()),
                       ROOT / "build" / "b6b_ablation")
    result = {name: {} for name in libs}
    probe_cycles = {}
    for shape_name, (b, s, d, n) in SHAPES.items():
        args, z, dout, states = _inputs(b, s, d, n)
        want = ref.mamba_scan_gated_bwd_torch(*args, z, dout)
        for name, path in libs.items():
            lib, fn = _bind(path)
            launch, sums = _runner(lib, fn, args, z, dout, states)
            row = result[name]
            launch()
            torch.cuda.synchronize()
            if name == "probes" and shape_name == "hymba":
                probe_cycles = phases(lib, d, s, b)
            if name == "full" or name.startswith("plan_"):
                first = [g.clone() for g in sums()]
                launch()
                torch.cuda.synchronize()
                same = all(torch.equal(f, g) for f, g in zip(first, sums()))
                rel = 0.0
                ok = same
                for g, w in zip(first, want):
                    e = float((g.float() - w.float()).abs().max())
                    r = e / max(float(w.float().abs().max()), 1e-30)
                    rel = max(rel, r)
                    ok = ok and r <= TOL[g.dtype]
                row[f"{shape_name}_max_err_of_largest"] = rel
                row[f"{shape_name}_within_tol"] = ok
                row[f"{shape_name}_same_bits"] = same
                row[f"{shape_name}_with_sums"] = time_ms(
                    lambda: (launch(), sums()), 10, 5)
                del first
            row[shape_name] = time_ms(launch, 10, 5)
            print(f"{name} {shape_name}: {json.dumps(row)}", flush=True)
            del launch, sums
            torch.cuda.empty_cache()
        del args, z, dout, states, want
        torch.cuda.empty_cache()
    sass = subprocess.run([str(Path(build._nvcc()).parent / "cuobjdump"),
                           "-sass", str(libs["full"])], capture_output=True,
                          text=True, check=True).stdout
    print(json.dumps({"card": card_line(), "shapes": SHAPES,
                      "plan": source_plan(SOURCE.read_text()),
                      "ms": result, "phases": probe_cycles,
                      "state_loop_ops": state_loop_ops(sass)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
