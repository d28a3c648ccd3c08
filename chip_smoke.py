#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port of CoRaiS.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (``$CUDA_HOME/bin`` or /usr/local/cuda).
Phases, in order; any failure ends the run with a non-zero exit:

1. require CUDA; print the card's name and power limit; TF32 off;
2. build the hand-written kernels from ``src/repro_torch/kernels/csrc``;
3. hold each kernel against its plain PyTorch version on the card at every
   ``DEFAULT_BUCKETS`` shape at d=256, B in {1, 8}, with partial edge masks,
   plus the no-(Z, Q) memory guarantee of the fused decode;
4. drive the serving decision path at full width (``PolicyConfig()``, about
   4M parameters, random weights from a seed) through ``DecisionFastPath``
   at all four buckets: greedy fused decode, then greedy materialized and
   sampled fused decode at 100x1000; the launch counters must show that
   both kernels ran; greedy decisions equal the plain ``"torch"`` backend's;
5. time each kernel and its plain version at 100x1000 (CUDA events) and
   print a ``{"kernels": [...]}`` line and the per-bucket decision latency.

The last line of standard output is the ``{"ok": true, "device": ...}``
summary. Details of every comparison go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
D = 256
ATOL = 2e-5          # f32 sums over d=256, scaled by C=10 through tanh
GAP = 1e-4           # index checks only on rows separated by more than this
F32_FLOPS = 67e12    # H100 SXM f32 (non-tensor) peak, NVIDIA data sheet
HBM_BYTES = 3.35e12  # H100 SXM HBM3 bandwidth, NVIDIA data sheet
ROUNDS = 40          # measured decisions per bucket


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# -- phase 3: kernels against their plain versions ---------------------------


def _inputs(gen, b, q, z, *, valid=None):
    """Random embeddings, init-scale weights and a random valid-edge set
    of ``valid[i]`` edges per instance, on the card."""
    bound = 1.0 / math.sqrt(D)
    c = torch.randn(b, q, D, generator=gen)
    h = torch.randn(b, z, D, generator=gen)
    wx = (2 * torch.rand(D, D, generator=gen) - 1) * bound
    wy = (2 * torch.rand(D, D, generator=gen) - 1) * bound
    mask = torch.zeros(b, q, dtype=torch.bool)
    for i in range(b):
        n = valid[i] if valid is not None else int(torch.randint(1, q + 1, (1,),
                                                                 generator=gen))
        mask[i, torch.randperm(q, generator=gen)[:n]] = True
    return [t.cuda() for t in (c, h, wx, wy, mask)]


def _gapped_rows(vals, mask, k):
    """Rows whose first min(k, valid) sorted valid scores are each more than
    GAP above the next valid one. vals: (B, Z, Q) sorted descending (the
    plain decode with K = Q)."""
    n_valid = mask.sum(-1)  # (B,)
    gaps = vals[..., :-1] - vals[..., 1:]
    idx = torch.arange(gaps.shape[-1], device=vals.device)
    limit = torch.minimum(torch.full_like(n_valid, k), n_valid - 1)
    use = idx[None, None, :] < limit[:, None, None]
    gaps = torch.where(use, gaps, torch.inf)
    return gaps.amin(-1) > GAP  # (B, Z)


def random_cases(buckets):
    """Every bucket shape at B=1 (a third of the edges masked) and B=8
    (one instance with a single valid edge, one full, the rest random)."""
    gen = torch.Generator().manual_seed(1)
    cases = []
    for q, z in buckets:
        for b in (1, 8):
            valid = [max(1, q - q // 3)]
            if b > 1:
                valid = [1, q] + [int(v) for v in torch.randint(
                    1, q + 1, (b - 2,), generator=gen)]
            cases.append(("random", b, q, z,
                          *_inputs(gen, b, q, z, valid=valid)))
    return cases


def compare_kernels(ops, ref, cases, errs):
    """Each kernel against its plain version; raises on a disagreement and
    folds the largest value error of each kernel into ``errs``."""
    report = []
    for name, b, q, z, c, h, wx, wy, mask in cases:
        lp = ops.policy_score(c, h, wx, wy, mask)
        want = ref.policy_score_torch(c, h, wx, wy, mask)
        err = float((lp - want).abs().max())
        check(lp.shape == (b, z, q) and bool(torch.isfinite(lp).all()),
              f"policy_score output malformed at {(b, q, z)}")
        check(err <= ATOL, f"policy_score err {err} > {ATOL} at {(b, q, z)}")
        errs["policy_score"] = max(errs["policy_score"], err)
        row = {"inputs": name, "B": b, "Q": q, "Z": z, "score_err": err,
               "decode": []}
        for normalize in (True, False):
            _, sorted_vals = ref.policy_score_decode_torch(
                c, h, wx, wy, mask, 10.0, q, normalize)
            for k in sorted({1, 8, q}):
                ti, tv = ops.policy_score_decode(c, h, wx, wy, mask, k=k,
                                                 normalize=normalize)
                wi, wv = ref.policy_score_decode_torch(c, h, wx, wy, mask,
                                                       10.0, k, normalize)
                rows = _gapped_rows(sorted_vals, mask, k)
                bad = int(((ti != wi).any(-1) & rows).sum())
                verr = float((tv - wv).abs().max())
                check(ti.shape == (b, z, k) and ti.dtype == torch.int32,
                      f"decode output malformed at {(b, q, z, k)}")
                check(bad == 0, f"decode indices differ on {bad} gapped rows "
                      f"at {(b, q, z, k, normalize)}")
                check(verr <= ATOL, f"decode err {verr} > {ATOL} at "
                      f"{(b, q, z, k, normalize)}")
                errs["policy_score_decode"] = max(
                    errs["policy_score_decode"], verr)
                row["decode"].append({"k": k, "normalize": normalize,
                                      "val_err": verr,
                                      "rows_checked": int(rows.sum()),
                                      "rows": b * z})
        report.append(row)
    torch.cuda.synchronize()
    return report


def memory_check(ops, ref, gen_seed=2):
    """The fused decode never allocates a (B, Z, Q) buffer: peak device
    memory grows by less than B*Z*Q*4 bytes across a call at B=8, 100x1000
    (the plain version, which materializes it, is measured beside it)."""
    b, q, z = 8, 100, 1000
    c, h, wx, wy, mask = _inputs(torch.Generator().manual_seed(gen_seed),
                                 b, q, z)
    zq = b * z * q * 4
    grown = {}
    for name, fn in (("kernel", lambda: ops.policy_score_decode(
            c, h, wx, wy, mask, k=1, normalize=False)),
                     ("plain", lambda: ref.policy_score_decode_torch(
            c, h, wx, wy, mask, 10.0, 1, False))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        grown[name] = torch.cuda.max_memory_allocated() - base
        del out
    check(grown["kernel"] < zq, f"fused decode grew device memory by "
          f"{grown['kernel']} bytes >= B*Z*Q*4 = {zq}")
    return {"zq_bytes": zq, "kernel_growth_bytes": grown["kernel"],
            "plain_growth_bytes": grown["plain"]}


# -- phase 4: the serving decision path at full width ------------------------


def _instances(tinst, q, z, n, seed):
    rng = np.random.default_rng(seed)
    sizes = [(q, z), (q - q // 5, z - z // 4)]
    return [tinst.generate_instance(rng, tinst.InstanceConfig(
        num_edges=sizes[i % 2][0], num_requests=sizes[i % 2][1]))
        for i in range(n)]


def _device_inst(fastpath_mod, inst, bucket):
    padded = fastpath_mod.pad_instance(inst, *bucket)
    return {k: torch.as_tensor(np.asarray(v)).cuda() for k, v in padded.items()}


def drive_main_path(pol, obj, fpm, tinst, policy_score, param_count):
    """Greedy fused serving at all buckets, then greedy materialized and
    sampled fused serving at 100x1000, with the launch counters set to 0
    just before and read just after. Returns the summary and the encoder
    outputs of one 100x1000 instance."""
    cfg = pol.PolicyConfig()
    policy = pol.CoRaiSPolicy(cfg, generator=torch.Generator().manual_seed(0),
                              device="cuda")
    n_params = param_count(policy)
    pools = {b: _instances(tinst, *b, n=8, seed=10 + i)
             for i, b in enumerate(fpm.DEFAULT_BUCKETS)}
    big = fpm.DEFAULT_BUCKETS[-1]

    policy_score.reset_launch_counts()
    t0 = time.perf_counter()
    fused = fpm.DecisionFastPath(policy)
    warm = fused.warmup()
    decisions, latency = {}, {}
    for bucket, pool in pools.items():
        before = len(fused.latencies_ms)
        decisions[bucket] = [fused.decide(pool[i % len(pool)])
                             for i in range(ROUNDS)]
        latency[bucket] = fused.latencies_ms[before:]
    mat = fpm.DecisionFastPath(policy, fused_decode=False, buckets=(big,))
    mat.warmup()
    mat_out = [mat.decide(inst) for inst in pools[big]]
    samp = fpm.DecisionFastPath(policy, mode="sample", num_samples=64,
                                buckets=(big,), seed=3)
    samp.warmup()
    samp_out = [samp.decide(inst) for inst in pools[big]]
    torch.cuda.synchronize()
    launches = dict(policy_score.LAUNCHES)
    main_path_s = time.perf_counter() - t0
    check(launches["policy_score"] > 0 and launches["policy_score_decode"] > 0,
          f"main path did not launch both kernels: {launches}")

    # greedy decisions against the plain "torch" backend on the card
    plain = fpm.DecisionFastPath(policy, backend="torch")
    excluded = 0
    for bucket, pool in pools.items():
        for i, inst in enumerate(pool):
            want = plain.decide(inst)
            dev = _device_inst(fpm, inst, bucket)
            with torch.inference_mode():
                c, h = pol.corais_encode(policy, dev)
                _, tv = pol.corais_score_decode(policy, c, h, dev["edge_mask"],
                                                k=2, normalize=False,
                                                backend="torch")
            z = len(want)
            gapped = ((tv[:, 0] - tv[:, 1]) > GAP).cpu().numpy()[:z]
            excluded += int((~gapped).sum())
            got = decisions[bucket][i]
            check(got.shape == (z,), f"decision shape {got.shape} != ({z},)")
            check(bool((got[gapped] == want[gapped]).all()),
                  f"fused greedy decision differs from the plain backend at "
                  f"bucket {bucket}")
            if bucket == big:
                check(bool((mat_out[i][gapped] == want[gapped]).all()),
                      "materialized greedy decision differs from the plain "
                      "backend")
                q = int(inst["edge_mask"].sum())
                s = samp_out[i]
                check(s.shape == (z,) and s.min() >= 0 and s.max() < q,
                      "sampled decision out of range")
                dev_s = {k: torch.as_tensor(np.asarray(v)).cuda()
                         for k, v in inst.items()}
                cost_s = float(obj.makespan(dev_s, torch.as_tensor(s).cuda()))
                cost_g = float(obj.makespan(dev_s, torch.as_tensor(got).cuda()))
                check(math.isfinite(cost_s) and cost_s <= cost_g + 1e-4,
                      f"best-of-64 makespan {cost_s} above greedy {cost_g}")

    profiles = {f"{q}x{z}": profile_decisions(fused, pools[(q, z)][0])
                for (q, z) in (fpm.DEFAULT_BUCKETS[0], big)}

    # real encoder outputs at 100x1000 for the kernel comparisons and timing
    dev = _device_inst(fpm, pools[big][0], big)
    with torch.inference_mode():
        c, h = pol.corais_encode(policy, dev)
    enc = (1, big[0], big[1], c[None].clone(), h[None].clone(),
           policy.w_px.detach(), policy.w_py.detach(), dev["edge_mask"][None])
    summary = {
        "params": n_params,
        "launches": launches,
        "main_path_s": main_path_s,
        "warmup_ms": {f"{q}x{z}": ms for (q, z), ms in warm.items()},
        "decision_ms": {
            f"{q}x{z}": {"p50": float(np.percentile(v, 50)),
                         "p95": float(np.percentile(v, 95)), "n": len(v)}
            for (q, z), v in latency.items()},
        "materialized_100x1000_p50_ms": float(np.percentile(
            mat.latencies_ms, 50)),
        "sampled_100x1000_p50_ms": float(np.percentile(samp.latencies_ms, 50)),
        "greedy_rows_excluded_by_gap": excluded,
        "profile": profiles,
    }
    return summary, enc


def profile_decisions(fastpath, inst, n=5):
    """Device busy time per greedy fused decision from a torch.profiler
    trace of ``n`` decisions, beside their wall time: the device's idle
    share, the kernel launches per decision and the heaviest kernels."""
    from torch.profiler import ProfilerActivity, profile
    fastpath.decide(inst)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fastpath.decide(inst)
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy_ms = sum(dev_us(e) for e in kernels) / 1e3 / n
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
            "kernels_per_decision": sum(e.count for e in kernels) / n,
            "top": [{"kernel": e.key[:80], "us": dev_us(e) / n,
                     "calls": e.count / n} for e in top]}


# -- phase 5: timing ------------------------------------------------------


def time_ms(fn, reps=25, inner=20):
    """Median device time of one call, CUDA events around ``inner`` calls.
    A sleep kernel queued first keeps the card busy while the host enqueues
    the calls, so host overhead does not leak into the device time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    cycles = 20_000_000
    while True:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(cycles)
        b.record()
        torch.cuda.synchronize()
        if a.elapsed_time(b) > 2 * host_ms:
            break
        cycles *= 2
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def bound(flops, nbytes):
    t_ops, t_bytes = flops / F32_FLOPS, nbytes / HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def timings(ops, ref, enc, launches, errs):
    c, h, wx, wy, mask = enc[3:]
    b, q, d = c.shape
    z = h.shape[1]
    k = 1
    in_bytes = 4 * (b * q * d + b * z * d + 2 * d * d) + b * q
    b1_flops = 2 * b * (q * d * d + z * d * d + z * q * d)
    b3_flops = 2 * b * (q * d * d + d * d * q + z * d * q)
    rows = []
    for name, kern, plain, flops, out_bytes, line in (
            ("policy_score",
             lambda: ops.policy_score(c, h, wx, wy, mask),
             lambda: ref.policy_score_torch(c, h, wx, wy, mask),
             b1_flops, 4 * b * z * q, 51),
            ("policy_score_decode",
             lambda: ops.policy_score_decode(c, h, wx, wy, mask, k=k,
                                             normalize=False),
             lambda: ref.policy_score_decode_torch(c, h, wx, wy, mask, 10.0,
                                                   k, False),
             b3_flops, 8 * b * z * k, 180)):
        plain_a = time_ms(plain)
        kern_a = time_ms(kern)
        kern_b = time_ms(kern)
        plain_b = time_ms(plain)
        bound_ms, bound_by = bound(flops, in_bytes + out_bytes)
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/policy_score.cu",
            "replaces": f"src/repro/kernels/policy_score.py:{line}",
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": min(kern_a, kern_b), "plain_ms": min(plain_a, plain_b),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "shape": f"B={b} Q={q} Z={z} d={d}" + (f" K={k}" if "decode" in name else ""),
            "ms_runs": [kern_a, kern_b], "plain_ms_runs": [plain_a, plain_b],
        })
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import instances as tinst
    from repro_torch.core import objective as obj
    from repro_torch.core import policy as pol
    from repro_torch.kernels import ops, policy_score, ref
    from repro_torch.nn import param_count
    from repro_torch.serving import fastpath as fpm

    # phase 1: the card
    card = card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2: build
    t0 = time.perf_counter()
    reports = policy_score.build(force=True)
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s", flush=True)
    for src, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}", flush=True)

    # phase 3: kernels against their plain versions
    errs = {"policy_score": 0.0, "policy_score_decode": 0.0}
    cases = compare_kernels(ops, ref, random_cases(fpm.DEFAULT_BUCKETS), errs)
    mem = memory_check(ops, ref)
    print(f"compare: max_abs_err {json.dumps(errs)} over {len(cases)} shapes; "
          f"memory {json.dumps(mem)}", flush=True)

    # phase 4: the serving decision path at full width
    summary, enc = drive_main_path(pol, obj, fpm, tinst, policy_score,
                                   param_count)
    print(f"main path: {json.dumps(summary)}", flush=True)
    # the kernels again, on the real encoder outputs of a 100x1000 round
    cases += compare_kernels(ops, ref, [("encoder", *enc)], errs)

    # phase 5: timing at the serving shape
    kernels = timings(ops, ref, enc, summary["launches"], errs)

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "card": card, "build_s": build_s, "main_path": summary,
        "compare": cases, "memory": mem, "kernels": kernels}, indent=1))

    print(json.dumps({"decision_ms": summary["decision_ms"], "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
