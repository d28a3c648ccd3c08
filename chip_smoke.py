#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port of CoRaiS.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (``$CUDA_HOME/bin`` or /usr/local/cuda).
Phases, in order; any failure ends the run with a non-zero exit:

1. require CUDA; print the card's name and power limit; TF32 off;
2. build the hand-written kernels from ``src/repro_torch/kernels/csrc``;
3. hold each kernel against its plain PyTorch version on the card at every
   ``DEFAULT_BUCKETS`` shape at d=256, B in {1, 8}, with partial edge masks,
   plus the no-(Z, Q) memory guarantee of the fused decode; the backward
   (B2) also at the training shape B=128, Q=5, Z=50;
4. drive the serving decision path at full width (``PolicyConfig()``, about
   4M parameters, random weights from a seed) through ``DecisionFastPath``
   at all four buckets: greedy fused decode, then greedy materialized and
   sampled fused decode at 100x1000; the launch counters must show that
   both forward kernels ran; greedy decisions equal the plain ``"torch"``
   backend's;
5. gradient parity: one REINFORCE loss and its gradients through the
   kernels (backend ``"cuda"``) and through plain autograd (``"torch"``) on
   two copies of one full-width policy with the same injected samples;
6. drive static REINFORCE training (``train``) at full width with the
   paper's ``RLConfig()`` (batch 128, S=64, Q=5, Z=50, lr 1e-5) for
   ``TRAIN_STEPS`` steps; B1 and B2 must launch every step, every metric be
   finite with ``cost_best <= cost_mean``, and the parameters move; B2 is
   checked again on the encoder outputs of a training batch;
7. time each kernel and its plain version (CUDA events; B1 and B3 at the
   serving shape 100x1000, B2 at the training shape) and print a
   ``{"kernels": [...]}`` line, the per-bucket decision latency and the
   training step's numbers.

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
TRAIN_STEPS = 22     # full-width training steps; the first two are warm-up
TRAIN_WARMUP = 2
# B2 tolerances, relative to each output's largest entry: dc and dh sum
# over d and Q in another order; dW sums over B*Z = 6400 rows at the
# training shape, in partials, so its rounding grows with the row count.
BWD_TOL = {"dc": 2e-5, "dh": 2e-5, "dw_px": 1e-4, "dw_py": 1e-4}


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


def train_shape_case(seed=4, b=128, q=5, z=50):
    """The training shape with random partial masks (one instance with a
    single valid edge, one full)."""
    gen = torch.Generator().manual_seed(seed)
    valid = [1, q] + [int(v) for v in torch.randint(1, q + 1, (b - 2,),
                                                     generator=gen)]
    return ("random", b, q, z, *_inputs(gen, b, q, z, valid=valid))


def compare_backward(policy_score, ref, cases, errs):
    """B2 against its plain version on each case, with a random cotangent
    and the plain forward's log-probs; two calls must give the same bits.
    Folds the largest absolute and relative errors into ``errs``."""
    report = []
    gen = torch.Generator().manual_seed(5)
    for name, b, q, z, c, h, wx, wy, mask in cases:
        maskf = mask.to(torch.float32)
        out = ref.policy_score_torch(c, h, wx, wy, mask)
        g = torch.randn(out.shape, generator=gen).cuda()
        got = policy_score.policy_score_bwd_cuda(g, out, c, h, wx, wy, maskf)
        again = policy_score.policy_score_bwd_cuda(g, out, c, h, wx, wy, maskf)
        want = ref.policy_score_bwd_torch(g, out, c, h, wx, wy, maskf)
        row = {"inputs": name, "B": b, "Q": q, "Z": z}
        for key, x, y, w in zip(BWD_TOL, got, again, want):
            check(x.shape == w.shape and bool(torch.isfinite(x).all()),
                  f"policy_score_bwd {key} malformed at {(b, q, z)}")
            check(torch.equal(x, y), f"policy_score_bwd {key} differs "
                  f"between two calls at {(b, q, z)}")
            abs_err = float((x - w).abs().max())
            rel = abs_err / max(float(w.abs().max()), 1e-30)
            check(rel <= BWD_TOL[key], f"policy_score_bwd {key} relative "
                  f"err {rel} > {BWD_TOL[key]} at {(b, q, z)}")
            row[f"{key}_rel_err"] = rel
            errs["policy_score_bwd"] = max(errs["policy_score_bwd"], abs_err)
            errs["policy_score_bwd_rel"] = max(errs["policy_score_bwd_rel"],
                                               rel)
        report.append(row)
    torch.cuda.synchronize()
    return report


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


def _device_summary(prof, n, wall_ms):
    """Device busy ms, idle share, kernels and the heaviest kernels per unit
    of work (a decision or a step) from a torch.profiler trace of ``n``."""
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy_ms = sum(dev_us(e) for e in kernels) / 1e3 / n
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
            "kernels_per_unit": sum(e.count for e in kernels) / n,
            "top": [{"kernel": e.key[:80], "us": dev_us(e) / n,
                     "calls": e.count / n} for e in top]}


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
    return _device_summary(prof, n, wall_ms)


# -- phase 5: gradient parity ------------------------------------------------


def gradient_parity(pol, tr, tinst):
    """One REINFORCE loss and its gradients on two copies of one full-width
    policy, head through the kernels ("cuda") and through plain autograd
    ("torch"), same batch, same injected samples. Loss to 1e-5 relative;
    gradients to rtol 1e-4 plus 1e-5 of the model's largest gradient entry
    (a bias just ahead of a BatchNorm has a true gradient of 0, so only
    rounding noise, which no relative bound holds)."""
    cfg = tr.RLConfig()
    batch = tr.to_device(tinst.generate_batch(np.random.default_rng(7),
                                              cfg.instance, cfg.batch_size),
                         "cuda")
    q = int(batch["edge_mask"].shape[-1])
    samples = torch.randint(0, q, (cfg.num_samples, cfg.batch_size,
                                   batch["req_mask"].shape[-1]),
                            generator=torch.Generator().manual_seed(8)).cuda()
    out = {}
    for backend in ("cuda", "torch"):
        pcfg = pol.PolicyConfig(score_backend=backend)
        policy = pol.CoRaiSPolicy(pcfg, generator=torch.Generator().manual_seed(0),
                                  device="cuda")
        loss, _, grads = tr.loss_and_grads(
            policy, batch, tr.RLConfig(policy=pcfg), samples=samples)
        out[backend] = (float(loss), grads)  # loss comes detached
    (loss_k, gk), (loss_p, gp) = out["cuda"], out["torch"]
    gmax = max(float(g.abs().max()) for g in gp.values())
    worst, worst_key = 0.0, None
    for key, g in gp.items():
        excess = float(((gk[key] - g).abs() - 1e-4 * g.abs()).max())
        if excess > worst:
            worst, worst_key = excess, key
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    check(loss_rel <= 1e-5, f"loss through kernels {loss_k} != plain {loss_p}")
    check(worst <= 1e-5 * gmax, f"gradient of {worst_key} differs by "
          f"{worst} > 1e-5 * {gmax} beyond rtol 1e-4")
    for key in ("edge_proj/w", "req_proj/w", "ctx_mha/wq"):
        check(float(gk[key].abs().max()) > 1e-3 * gmax,
              f"no gradient reached {key} through the kernels")
    return {"loss_cuda": loss_k, "loss_torch": loss_p, "loss_rel_err": loss_rel,
            "grad_max": gmax, "grad_excess_over_rtol": worst,
            "grad_excess_leaf": worst_key}


# -- phase 6: static REINFORCE training at full width ----------------------


def drive_training(pol, tr, tinst, policy_score, profiler_steps=3):
    """``train`` at the paper's full width for TRAIN_STEPS steps, the launch
    counters set to 0 just before and read just after. Returns the summary,
    the trained policy and a training batch's encoder outputs."""
    cfg = tr.RLConfig()
    policy = pol.CoRaiSPolicy(cfg.policy,
                              generator=torch.Generator().manual_seed(cfg.seed),
                              device="cuda")
    before = {k: p.detach().clone() for k, p in policy.named_parameters()}
    policy_score.reset_launch_counts()
    t0 = time.perf_counter()
    policy, opt_state, hist = tr.train(cfg, num_batches=TRAIN_STEPS,
                                       policy=policy)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(policy_score.LAUNCHES)
    for name in ("policy_score", "policy_score_bwd"):
        check(launches[name] >= TRAIN_STEPS, f"training launched {name} "
              f"{launches[name]} times in {TRAIN_STEPS} steps")
    for row in hist:
        check(all(math.isfinite(row[k]) for k in
                  ("loss", "grad_norm", "cost_mean", "cost_best", "entropy")),
              f"non-finite training metrics at batch {row['batch']}: {row}")
        check(row["cost_best"] <= row["cost_mean"] + 1e-6,
              f"cost_best above cost_mean at batch {row['batch']}")
    moved = sum(not torch.equal(p.detach(), before[k])
                for k, p in policy.named_parameters())
    check(moved > 0, "no parameter changed in training")
    step_ms = [row["sec"] * 1e3 for row in hist[TRAIN_WARMUP:]]
    data_ms = [row["data_sec"] * 1e3 for row in hist[TRAIN_WARMUP:]]
    p50 = float(np.percentile(step_ms, 50))

    # device busy and idle share from a trace of a few more steps
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        tr.train(cfg, num_batches=profiler_steps, policy=policy,
                 opt_state=opt_state, start_batch=TRAIN_STEPS)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t1) * 1e3 / profiler_steps
    trace = _device_summary(prof, profiler_steps, prof_wall_ms)

    batch = tr.to_device(tinst.generate_batch(np.random.default_rng(11),
                                              cfg.instance, cfg.batch_size),
                         "cuda")
    with torch.no_grad():
        c, h = pol.corais_encode(policy, batch)
    enc = (cfg.batch_size, c.shape[1], h.shape[1], c.contiguous(),
           h.contiguous(), policy.w_px.detach(), policy.w_py.detach(),
           batch["edge_mask"])
    summary = {
        "config": {"d_model": cfg.policy.d_model, "batch": cfg.batch_size,
                   "samples": cfg.num_samples, "Q": enc[1], "Z": enc[2],
                   "lr": cfg.lr, "c1": cfg.c1, "c2": cfg.c2},
        "steps": len(hist), "launches": launches, "wall_s": wall_s,
        "params_moved": moved,
        "step_ms": {"p50": p50, "p95": float(np.percentile(step_ms, 95)),
                    "n": len(step_ms), "first": hist[0]["sec"] * 1e3},
        "data_ms": {"p50": float(np.percentile(data_ms, 50)),
                    "p95": float(np.percentile(data_ms, 95))},
        "batch_wall_ms": wall_s * 1e3 / len(hist),
        "instances_per_s": cfg.batch_size / (p50 / 1e3),
        "first_last": {k: [hist[0][k], hist[-1][k]] for k in
                       ("loss", "cost_mean", "cost_best", "entropy",
                        "grad_norm")},
        "profile": trace,
    }
    return summary, enc


# -- phase 7: timing ------------------------------------------------------


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


def _row(name, line, kern, plain, flops, nbytes, launches, err, shape):
    """One kernel's entry of the ``{"kernels": [...]}`` line, timed in the
    order plain, kernel, kernel, plain."""
    plain_a = time_ms(plain)
    kern_a = time_ms(kern)
    kern_b = time_ms(kern)
    plain_b = time_ms(plain)
    bound_ms, bound_by = bound(flops, nbytes)
    return {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/policy_score.cu",
        "replaces": f"src/repro/kernels/policy_score.py:{line}",
        "launches": sum(launches.values()), "max_abs_err": err,
        "ms": min(kern_a, kern_b), "plain_ms": min(plain_a, plain_b),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "shape": shape, "launches_by_path": launches,
        "ms_runs": [kern_a, kern_b], "plain_ms_runs": [plain_a, plain_b],
    }


def _head_counts(c, h):
    b, q, d = c.shape
    z = h.shape[1]
    in_bytes = 4 * (b * q * d + b * z * d + 2 * d * d) + 4 * b * q
    return b, q, z, d, in_bytes


def timings(ops, ref, policy_score, enc, enc_train, launches, errs):
    """B1 and B3 at the serving shape (100x1000, one instance; B1 also at
    the training shape), B2 at the training shape (B=128, Q=5, Z=50), each
    beside its plain version and its bound. ``launches``: {kernel: {path:
    count}} from the main-path runs."""
    c, h, wx, wy, mask = enc[3:]
    b, q, z, d, in_bytes = _head_counts(c, h)
    k = 1
    b1_flops = 2 * b * (q * d * d + z * d * d + z * q * d)
    b3_flops = 2 * b * (q * d * d + d * d * q + z * d * q)
    shape = f"B={b} Q={q} Z={z} d={d}"
    rows = [
        _row("policy_score", 51,
             lambda: ops.policy_score(c, h, wx, wy, mask),
             lambda: ref.policy_score_torch(c, h, wx, wy, mask),
             b1_flops, in_bytes + 4 * b * z * q, launches["policy_score"],
             errs["policy_score"], shape),
        _row("policy_score_decode", 180,
             lambda: ops.policy_score_decode(c, h, wx, wy, mask, k=k,
                                             normalize=False),
             lambda: ref.policy_score_decode_torch(c, h, wx, wy, mask, 10.0,
                                                   k, False),
             b3_flops, in_bytes + 8 * b * z * k,
             launches["policy_score_decode"], errs["policy_score_decode"],
             shape + f" K={k}"),
    ]

    # the training shape: B1 forward, then B2 on its output
    c, h, wx, wy, mask = enc_train[3:]
    b, q, z, d, in_bytes = _head_counts(c, h)
    maskf = mask.to(torch.float32)
    out = ops.policy_score(c, h, wx, wy, mask)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(12)
                    ).cuda()
    shape = f"B={b} Q={q} Z={z} d={d}"
    b1_train = _row("policy_score", 51,
                    lambda: policy_score.policy_score_cuda(c, h, wx, wy, maskf),
                    lambda: ref.policy_score_torch(c, h, wx, wy, mask),
                    2 * b * (q * d * d + z * d * d + z * q * d),
                    in_bytes + 4 * b * z * q, {}, None, shape)
    rows[0]["train_shape"] = {k_: b1_train[k_] for k_ in
                              ("shape", "ms", "plain_ms", "bound_ms",
                               "bound_by", "ms_runs", "plain_ms_runs")}
    # recomputed px, py and u, then dpy, dpx, dc, dh, dWpx, dWpy
    b2_flops = 2 * b * (3 * q * d * d + 3 * z * d * d + 3 * z * q * d)
    b2_bytes = in_bytes + 8 * b * z * q + 4 * (b * q * d + b * z * d + 2 * d * d)
    rows.append(_row(
        "policy_score_bwd", 65,
        lambda: policy_score.policy_score_bwd_cuda(g, out, c, h, wx, wy, maskf),
        lambda: ref.policy_score_bwd_torch(g, out, c, h, wx, wy, maskf),
        b2_flops, b2_bytes, launches["policy_score_bwd"],
        errs["policy_score_bwd"], shape))
    rows[-1]["max_rel_err"] = errs["policy_score_bwd_rel"]
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import instances as tinst
    from repro_torch.core import objective as obj
    from repro_torch.core import policy as pol
    from repro_torch.core import train as tr
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
    errs = {"policy_score": 0.0, "policy_score_decode": 0.0,
            "policy_score_bwd": 0.0, "policy_score_bwd_rel": 0.0}
    random = random_cases(fpm.DEFAULT_BUCKETS)
    cases = compare_kernels(ops, ref, random, errs)
    bwd = compare_backward(policy_score, ref, random + [train_shape_case()],
                           errs)
    mem = memory_check(ops, ref)
    print(f"compare: max_abs_err {json.dumps(errs)} over {len(cases)} "
          f"forward and {len(bwd)} backward shapes; memory {json.dumps(mem)}",
          flush=True)

    # phase 4: the serving decision path at full width
    summary, enc = drive_main_path(pol, obj, fpm, tinst, policy_score,
                                   param_count)
    print(f"main path: {json.dumps(summary)}", flush=True)
    # the kernels again, on the real encoder outputs of a 100x1000 round
    cases += compare_kernels(ops, ref, [("encoder", *enc)], errs)

    # phase 5: gradients through the kernels against plain autograd
    parity = gradient_parity(pol, tr, tinst)
    print(f"gradient parity: {json.dumps(parity)}", flush=True)

    # phase 6: static REINFORCE training at full width
    training, enc_train = drive_training(pol, tr, tinst, policy_score)
    print(f"training: {json.dumps(training)}", flush=True)
    bwd += compare_backward(policy_score, ref, [("encoder", *enc_train)],
                            errs)

    # phase 7: timing
    launches = {name: {"serving": summary["launches"].get(name, 0),
                       "training": training["launches"].get(name, 0)}
                for name in policy_score.LAUNCHES}
    launches["policy_score_decode"].pop("training")
    launches["policy_score_bwd"].pop("serving")
    kernels = timings(ops, ref, policy_score, enc, enc_train, launches, errs)

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "card": card, "build_s": build_s, "main_path": summary,
        "gradient_parity": parity, "training": training,
        "compare": cases, "compare_backward": bwd, "memory": mem,
        "kernels": kernels}, indent=1))

    print(json.dumps({"decision_ms": summary["decision_ms"],
                      "train_step_ms": training["step_ms"],
                      "train_data_ms": training["data_ms"],
                      "train_instances_per_s": training["instances_per_s"],
                      "train_profile": {k: training["profile"][k] for k in
                                        ("wall_ms", "device_busy_ms",
                                         "idle_share", "kernels_per_unit")},
                      "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
