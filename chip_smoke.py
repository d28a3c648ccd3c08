#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port of CoRaiS.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (``$CUDA_HOME/bin`` or /usr/local/cuda).
Phases, in order; any failure ends the run with a non-zero exit:

1. require CUDA; print the card's name and power limit; TF32 off;
2. build the hand-written kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all started together);
3. hold each policy-head kernel against its plain PyTorch version on the
   card at every ``DEFAULT_BUCKETS`` shape at d=256, B in {1, 8}, with
   partial edge masks, and at ``EDGE_CASES`` (Q = 1, 5 and 128, Z = 1 and
   37); the fused decode (B3) at K = 1, 8 and Q, normalized and not, the
   same bits across two calls, and on exact-arithmetic inputs with
   duplicated edges (``TIE_CASES``), whose indices must equal the plain
   version's on every row; at each bucket with B = 1, B1's values at
   B3's normalized top-K indices equal B3's bit for bit, and B1's row
   arg-max is B3's K = 1 index; plus the
   no-(Z, Q) memory guarantee of the fused decode; the backward (B2) also
   at the training shape B=128, Q=5, Z=50; B1 and B3 also at the rollout
   engine's shapes, B = 256, Q = 100, Z = the scale run's round width
   (phase 6b) and B = 64, Q = 5, Z = 32, each the same bits on two calls;
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
6a. the batched rollout engine on the card against the same engine on the
   CPU (``engine_parity``): Q = 5, B = 64, 12 rounds of 0.25 s, ``local``
   and ``greedy``, on uniform_iid, hotspot_skew, chaos-rolling-failure
   (its faults, a breaker, slo_threshold admission, retry backoff) and
   cloud-cache-churn (the cloud node and service caches): counts and
   per-edge completions equal, floats within 1e-4, ``summarize`` the same;
6b. the rollout engine's scale run (``drive_rollout``): ``PolicyConfig()``
   (random weights from a seed) schedules 256 instances of a 100-edge
   cluster (uniform_iid at 4 requests/s per edge, about 100 arrivals a
   round) for 12 rounds and drains, through ``"policy-fused"`` (B3) and
   then ``"policy"`` (B1): each round's decisions equal the plain
   ``"torch"`` backend's above the gap, the head's kernel launches once
   per round for the whole batch (and no plain head is reached), every
   request is accounted for; rollout wall ms, ms per round,
   request-rounds/s, peak device memory, and a profile of its last two
   rounds (device busy, idle share, launches per round, the head's device
   ms against the lane recursion, the features and ``commit``);
7. hold the attention kernels B4 (flash attention) and B5 (decode
   attention) against their plain versions at qwen3-4b, olmo-1b and
   hymba-1.5b head shapes, bf16 and f32, ragged lengths (S = 1, 63, 65),
   bf16 head widths 16 to 128, windows causal and not, rolling caches
   (hymba's 4-lane cache past its 2048 window), a lane with no valid
   slot, one lane over 4096 slots and W = 1; each bit for bit across two
   calls; and
   the selective scan B6 against its plain version at falcon-mamba's and
   hymba's prefill shapes, a ragged one and the reference sweep's, within
   the reference's 5e-4 and bit for bit across two calls; and B6's gated
   entry (dt's softplus, the scan, the D skip and the SiLU gate) against
   its plain version at falcon-mamba's and hymba's prefill shapes and a
   ragged one, z a strided view of in_proj's output in bf16 (5e-4 plus
   half a bf16 ulp of the plain f32 value) and in f32 (5e-4), bit for bit
   across two calls;
8. drive the LM edge servers at full width, the flow of
   ``examples/serve_multi_edge.py``: three ``LMEdgeBackend`` edges (lanes
   1, 2, 4; 4096-slot caches) serving qwen3-4b in bf16 with random weights
   from a seed, untimed prefills at the phi warm-up's sizes, then the
   phi warm-up of eight prefills per edge (256-2560 tokens), after which
   each edge's phi must have accepted a fit (a flat history fits a = 0,
   as where the host's launches bound the prefill), greedy
   dispatch of 18 requests (256-2560 prompt tokens, 32
   generated each) over ``snapshot_instance``; all must be served, the
   4-lane edge get no fewer than the 1-lane edge, and B4 launch 36 times
   per admission, B5 36 times per decode step and B6 never; the plain
   versions of B4-B6 (and of B6's gated entry) and B6's bare entry must
   not be reached;
9. one request (1500 prompt tokens, 16 teacher-forced decode steps)
   through the kernel path and the plain path with the same weights:
   logits within 1e-3 of the largest |logit| with the weights in f32, and
   within 0.1 in bf16, where 1-ulp rounding differences compound over 36
   layers;
10. trace one prefill and five decode steps with ``torch.profiler``: device
    busy ms, idle share, kernels per step and device ms by kind (B6,
    element-wise, GEMM, other); then free qwen3-4b;
11. the same serving flow with falcon-mamba-7b ``CONFIG`` (64 SSM layers,
    bf16, random weights from a seed): B6 launches exactly 64 times per
    admission, all through its gated entry, and B4/B5 never; a profiled
    2048-token prefill and 4-lane decode step; one 512-token request with
    16 teacher-forced steps through the kernel path and the plain path
    (logits within 1e-3 of the largest |logit| in f32, 0.1 in bf16, beside
    the reading that one f32 ulp of B6's y gives, through B6's bare entry
    and the gated entry's plain prologue and epilogue); then free it;
12. the same with hymba-1.5b ``CONFIG`` (32 hybrid layers, a 2048-token
    attention window, so prompts above 2048 tokens take the rolling
    cache): B4 and B6 launch 32 times per admission, B5 32 times per
    decode step; the same profile; a 2300-token request through the
    kernel and the plain path (1e-3 in f32, 0.1 in bf16);
13. print the device time per launch of B1 (the serving and training
    shapes), B3 (K = 1 and the sampled path's K = Q = 100) and B2
    (``launch_split``, a torch.profiler trace); then
    time each kernel, its plain version and, for B4 and B5, PyTorch's
    ``scaled_dot_product_attention`` (CUDA events; B1 and B3 at the serving
    shape 100x1000, B1 also at the training shape under ``train_shape``,
    B3 also at K = Q = 100 normalized under ``sampled``, B2
    at the training shape, B4 at qwen3-4b's and
    hymba-1.5b's 2048-token prefills, B5 at the 4-lane qwen3-4b edge's
    cache after serving and at hymba's rolled 4-lane cache, B6's gated
    entry (the one the main paths launch) and its bare entry at
    falcon-mamba's prefill shape) beside their bounds, and print the
    ``{"kernels": [...]}`` line (six rows, each with its launches on every
    main path above, the rollout's included).

The last line of standard output is the ``{"ok": true, "device": ...}``
summary. Details of every comparison go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import dataclasses
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
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak, NVIDIA data sheet
# B4/B5 against their plain versions: the reference's bars
# (tests/test_kernels.py), as allclose with atol = rtol
ATTN_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
LM_ARCH = "qwen3-4b"   # the LM each edge serves, full width, bf16
LM_MAX_SEQ = 4096      # KV-cache slots per lane
LM_REQUESTS = 18       # dispatched requests (examples/serve_multi_edge.py)
LM_GEN = 32            # generated tokens per dispatched request
LM_WARM = 100_000      # request ids of the phi warm-up start here
# phi warm-up prompts (the example's sizes times 32)
PHI_PROMPTS = tuple(32 * n for n in (8, 16, 32, 48, 64, 80, 24, 40))
LM_SEED = 0
# kernel vs plain path at full width, of each row's largest |logit|: f32
# sums in another order (f32); in bf16 one kernel output rounded 1 ulp
# apart from its plain version's compounds over the layers to percents of
# the logits (measured on an H100, PERF.md: qwen3-4b's attention outputs
# 3-4 %, hymba's 2-3 %; one f32 ulp added to all of B6's y moves
# falcon-mamba's by 1.6 %), so bf16 gets a sanity bar above those
LM_LOGIT_TOL_F32 = 1e-3
LM_LOGIT_TOL_BF16 = 0.1
LM_GAP = 2e-2          # argmax compared where the top-2 gap exceeds this
LM_SSM_ARCH = "falcon-mamba-7b"  # SSM edge serving, full width, bf16
LM_HYBRID_ARCH = "hymba-1.5b"    # hybrid (attention window 2048 + SSM)
# kernel vs plain for the SSM model: a 512-token prompt, since the plain
# scan is a Python loop over S in each of the 64 layers; for the hybrid
# one a prompt past its 2048-token window, so the rolling fill and B5's
# window run at full width
LM_SSM_PROMPT = 512
LM_HYBRID_PROMPT = 2300
# hymba-1.5b's 4-lane decode cache (B, W, H, KV, hd, dtype, fills,
# rolling_from, window): two lanes rolled past the 2048 window (a
# 2560-token prompt plus a step; 2049 tokens), one partly filled, one with
# a single slot; G*hd = 320. Compared in phase 7, timed in phase 13.
HYMBA_CACHE = (4, 2048, 25, 5, 64, torch.bfloat16, (0, 0, 700, 1),
               (513, 1, None, None), 2048)
SCAN_TOL = 5e-4        # B6 against its plain version (tests/test_kernels.py)
# B6 cases (B, S, d, N): falcon-mamba's prefill, hymba's four lanes, a
# ragged one and the reference sweep's; the first is also timed
SCAN_CASES = ((1, 2048, 8192, 16), (4, 1000, 3200, 16), (1, 37, 200, 4),
              (2, 128, 64, 8))
# B6's gated entry (B, S, d, N): falcon-mamba's and hymba's prefills and a
# ragged one (some dt above softplus's threshold 20); z a strided view of
# in_proj's (B, S, 2d) output, bf16 and f32. The bf16 output is held
# against the plain version's f32 value within SCAN_TOL plus bf16's own
# rounding, half an ulp: 2^-8 of the value.
SCAN_GATED_CASES = ((1, 2048, 8192, 16), (4, 1000, 3200, 16), (1, 37, 200, 4))
BF16_HALF_ULP = 2.0 ** -8
# policy-head shapes beside the buckets (B, Q, Z, valid edges per
# instance): one edge, the training Q, the widest Q, one request row
EDGE_CASES = ((2, 1, 37, (1, 1)), (3, 5, 1, (5, 1, 3)), (1, 5, 50, (4,)),
              (2, 128, 37, (128, 90)))
# B3 on exact-arithmetic inputs with duplicated edges (B, Q, Z)
TIE_CASES = ((2, 5, 45), (1, 100, 1000), (2, 128, 37))
# the rollout engine's scale run: the paper's largest cluster (Q = 100),
# the largest batch of benchmarks/rollout_throughput.py (B = 256),
# uniform_iid at the default scenario's 4 requests/s per edge, 12 rounds
# of 0.25 s, the slot table as wide as the busiest round
ROLLOUT_EDGES = 100
ROLLOUT_BATCH = 256
ROLLOUT_RATE_PER_EDGE = 4.0
ROLLOUT_ROUNDS = 12
ROLLOUT_DT = 0.25
ROLLOUT_PROFILE_ROUNDS = 2
ROLLOUT_TIMED_RUNS = 3   # the host's clock varies: the median of three
# B1 and B3 also at the parity runs' shape (B, Q, Z)
ROLLOUT_SMALL_SHAPE = (64, 5, 32)
# the engine on the card against the engine on the CPU: Q = 5 edges (plus
# the cloud node in cloud-cache-churn), B = 64 instances, 12 rounds;
# chaos-rolling-failure with its faults, a breaker, admission and backoff
PARITY_SCENARIOS = ("uniform_iid", "hotspot_skew", "chaos-rolling-failure",
                    "cloud-cache-churn")
PARITY_EDGES = 5
PARITY_BATCH = 64
PARITY_RESILIENCE = dict(admission="slo_threshold", breaker=True,
                         retry_backoff_rounds=1.0)
PARITY_TOL = 1e-4      # floats, card against CPU (ROADMAP "How parity is held")


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
    if gaps.shape[-1] == 0:  # one edge: nothing to tell apart
        return torch.ones(vals.shape[:-1], dtype=torch.bool,
                          device=vals.device)
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


def edge_cases():
    """EDGE_CASES with random inputs and their valid-edge counts."""
    gen = torch.Generator().manual_seed(6)
    return [("random", b, q, z, *_inputs(gen, b, q, z, valid=list(valid)))
            for b, q, z, valid in EDGE_CASES]


def _exact_inputs(b, q, z, seed=0):
    """Small multiples of 2^-6 (embeddings) and 2^-7 (weights): every score
    is exact in f32 whatever the summation order, so ties are exact; edge 1
    duplicates edge 0 and edge 3 edge 2. Every third edge from the fifth
    on is masked."""
    rng = np.random.default_rng(seed)
    c = rng.integers(-3, 4, size=(b, q, D)) / 64.0
    h = rng.integers(-3, 4, size=(b, z, D)) / 64.0
    wx = rng.integers(-2, 3, size=(D, D)) / 128.0
    wy = rng.integers(-2, 3, size=(D, D)) / 128.0
    for src, dst in ((0, 1), (2, 3)):
        if dst < q:
            c[:, dst] = c[:, src]
    mask = np.ones((b, q), bool)
    mask[:, 4::3] = False
    return [torch.from_numpy(a.astype(np.float32)).cuda()
            for a in (c, h, wx, wy)] + [torch.from_numpy(mask).cuda()]


def compare_decode_ties(ops, ref):
    """B3 on TIE_CASES at K = 1, 3 and Q, normalized and not: indices equal
    the plain version's on every row, values within ATOL, the same bits
    across two calls. Returns a report per case."""
    report = []
    for b, q, z in TIE_CASES:
        c, h, wx, wy, mask = _exact_inputs(b, q, z)
        for normalize in (True, False):
            for k in sorted({1, 3, q}):
                ti, tv = ops.policy_score_decode(c, h, wx, wy, mask, k=k,
                                                 normalize=normalize)
                ti2, tv2 = ops.policy_score_decode(c, h, wx, wy, mask, k=k,
                                                   normalize=normalize)
                wi, wv = ref.policy_score_decode_torch(c, h, wx, wy, mask,
                                                       10.0, k, normalize)
                where = f"tie case {(b, q, z, k, normalize)}"
                check(torch.equal(ti, ti2) and torch.equal(tv, tv2),
                      f"decode differs between two calls at {where}")
                bad = int((ti != wi).any(-1).sum())
                check(bad == 0, f"decode indices differ on {bad} rows at "
                      f"{where}")
                err = float((tv - wv).abs().max())
                check(err <= ATOL, f"decode err {err} > {ATOL} at {where}")
                report.append({"B": b, "Q": q, "Z": z, "k": k,
                               "normalize": normalize, "val_err": err})
    torch.cuda.synchronize()
    return report


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
            for k in sorted({1, min(8, q), q}):
                ti, tv = ops.policy_score_decode(c, h, wx, wy, mask, k=k,
                                                 normalize=normalize)
                ti2, tv2 = ops.policy_score_decode(c, h, wx, wy, mask, k=k,
                                                   normalize=normalize)
                check(torch.equal(ti, ti2) and torch.equal(tv, tv2),
                      f"decode differs between two calls at "
                      f"{(b, q, z, k, normalize)}")
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


def compare_score_decode_bits(policy_score, cases):
    """B1 against B3 at shapes where both take one plan (the buckets at
    B = 1): B1's row arg-max is B3's K = 1 normalized index on every row,
    and B1's values at B3's normalized top-K indices (K = 1, 8, Q) are
    B3's values, bit for bit. Returns a report per case."""
    report = []
    for name, b, q, z, c, h, wx, wy, mask in cases:
        maskf = mask.to(torch.float32)
        scores = policy_score.policy_score_cuda(c, h, wx, wy, maskf)
        for k in sorted({1, min(8, q), q}):
            ti, tv = policy_score.policy_score_decode_cuda(
                c, h, wx, wy, maskf, k=k, normalize=True)
            where = f"{(name, b, q, z, k)}"
            if k == 1:
                bad = int((scores.argmax(-1) != ti[..., 0].long()).sum())
                check(bad == 0, f"B1's arg-max differs from B3's index on "
                      f"{bad} rows at {where}")
            bad = int((scores.gather(-1, ti.long()) != tv).sum())
            check(bad == 0, f"B1's values differ from B3's normalized "
                  f"values in {bad} places at {where}")
        report.append({"inputs": name, "B": b, "Q": q, "Z": z,
                       "k": sorted({1, min(8, q), q}), "bit_equal": True})
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


# device ms per unit by kind of kernel, from the trace's kernel names: the
# port's scan (B6, both entries), PyTorch's element-wise kernels, and the
# library GEMMs (bf16 nvjet and f32 cutlass SGEMM)
KERNEL_KINDS = (("B6", ("scan_chunked",)),
                ("elementwise", ("elementwise_kernel",)),
                ("gemm", ("gemm", "nvjet", "xmma", "cutlass")))


def _device_summary(prof, n, wall_ms, skip=()):
    """Device busy ms, idle share, kernels, device ms by kind
    (KERNEL_KINDS) and the heaviest kernels per unit of work (a decision or
    a step) from a torch.profiler trace of ``n``. ``skip``: names of
    ``record_function`` ranges, whose spans the trace also lists on the
    device."""
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA") and e.key not in skip]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    def kind(e):
        return next((k for k, marks in KERNEL_KINDS
                     if any(m in e.key for m in marks)), "other")

    busy_ms = sum(dev_us(e) for e in kernels) / 1e3 / n
    by_kind = {k: 0.0 for k, _ in KERNEL_KINDS + (("other", ()),)}
    for e in kernels:
        by_kind[kind(e)] += dev_us(e) / 1e3 / n
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
            "kernels_per_unit": sum(e.count for e in kernels) / n,
            "device_ms_by_kind": by_kind,
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


# -- phases 6a-6b: the batched rollout engine -----------------------------


def rollout_arrivals(wl, edges=ROLLOUT_EDGES, batch=ROLLOUT_BATCH,
                     rounds=ROLLOUT_ROUNDS):
    """The scale run's arrivals (host numpy): uniform_iid at
    ROLLOUT_RATE_PER_EDGE requests/s per edge, one seed per instance, the
    width the busiest round's. Returns (arrivals, seconds to make them)."""
    t0 = time.perf_counter()
    arr = wl.materialize_round_batch(
        wl.scenario("uniform_iid", rate=ROLLOUT_RATE_PER_EDGE * edges), edges,
        rounds, ROLLOUT_DT, batch, base_seed=0)
    return arr, time.perf_counter() - t0


def compare_rollout_shapes(ops, ref, width, errs, batch=ROLLOUT_BATCH,
                           edges=ROLLOUT_EDGES):
    """B1 and B3 against their plain versions at the rollout's shapes: the
    scale run's (B = 256, Q = 100, Z = its round width) and the parity
    runs' (ROLLOUT_SMALL_SHAPE); B3 at K = 1, 8 and Q, normalized and not
    (compare_kernels), and each kernel the same bits on two calls.
    Returns the report and the cases' inputs."""
    gen = torch.Generator().manual_seed(13)
    cases = []
    for b, q, z in ((batch, edges, width), ROLLOUT_SMALL_SHAPE):
        valid = [q] * (b - 2) + [1, max(1, q - q // 3)]
        cases.append(("rollout", b, q, z, *_inputs(gen, b, q, z,
                                                   valid=valid)))
    report = compare_kernels(ops, ref, cases, errs)
    for _, b, q, z, c, h, wx, wy, mask in cases:
        check(torch.equal(ops.policy_score(c, h, wx, wy, mask),
                          ops.policy_score(c, h, wx, wy, mask)),
              f"policy_score differs between two calls at {(b, q, z)}")
    torch.cuda.synchronize()
    return report, cases


def _host_tree(tree):
    return {k: v.cpu() for k, v in tree.items()}


def _parity_errors(got, want, where):
    """Counts equal, floats within PARITY_TOL; returns the largest float
    error."""
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{where}: {k} has {g.dtype} {tuple(g.shape)}, the CPU "
              f"{w.dtype} {tuple(w.shape)}")
        if w.is_floating_point():
            err = float((g - w).abs().max()) if w.numel() else 0.0
            check(err <= PARITY_TOL, f"{where}: {k} differs by {err} > "
                  f"{PARITY_TOL} from the CPU")
            worst = max(worst, err)
        else:
            check(torch.equal(g, w), f"{where}: {k} differs from the CPU")
    return worst


def engine_parity(engine, wl, faults, resilience, device="cuda"):
    """The engine on the card against the engine on the CPU, same
    arrivals, at Q = 5 and B = 64 for 12 rounds, with ``local`` and
    ``greedy`` on PARITY_SCENARIOS: counts and per-edge completions equal,
    floats within PARITY_TOL, ``summarize`` the same dict (floats within
    PARITY_TOL)."""
    report = {}
    for name in PARITY_SCENARIOS:
        cloud, cache = wl.scenario_cloud_spec(name)
        arr = wl.materialize_round_batch(
            wl.scenario(name), PARITY_EDGES, ROLLOUT_ROUNDS, ROLLOUT_DT,
            PARITY_BATCH, base_seed=0)
        spec = wl.scenario_fault_spec(name)
        res = None
        if spec is not None:
            arr = faults.attach_fault_batch(arr, spec, PARITY_EDGES,
                                            seeds=range(PARITY_BATCH))
            res = resilience.ResilienceConfig(**PARITY_RESILIENCE)
        cfg = engine.EngineConfig(
            num_edges=PARITY_EDGES, num_rounds=ROLLOUT_ROUNDS,
            round_interval=ROLLOUT_DT, max_per_round=arr["mask"].shape[-1],
            resilience=res, cloud=cloud, cache=cache)
        for backend in ("local", "greedy"):
            run = engine.make_rollout(cfg, engine.ASSIGN_FNS[backend],
                                      batch=True)
            out, ms = {}, {}
            for dev in (device, "cpu"):
                state = engine.init_batch(cfg, range(PARITY_BATCH),
                                          device=dev)
                t0 = time.perf_counter()
                final, infos = run(state, arr)
                if dev != "cpu":
                    torch.cuda.synchronize()
                ms[str(dev)] = (time.perf_counter() - t0) * 1e3
                out[str(dev)] = (_host_tree(final), _host_tree(infos))
            where = f"engine parity {name}/{backend}"
            (card_f, card_i), (cpu_f, cpu_i) = out[str(device)], out["cpu"]
            err = max(_parity_errors(card_f, cpu_f, where),
                      _parity_errors(card_i, cpu_i, where))
            s_card, s_cpu = engine.summarize(card_f), engine.summarize(cpu_f)
            for k, w in s_cpu.items():
                same = (abs(s_card[k] - w) <= PARITY_TOL
                        if isinstance(w, float) else s_card[k] == w)
                check(same, f"{where}: summarize {k} {s_card[k]} on the card, "
                      f"{w} on the CPU")
            check(s_cpu["completed"] > 0, f"{where}: nothing completed")
            report[f"{name}/{backend}"] = {
                "width": cfg.max_per_round, "max_float_err": err,
                "card_ms": ms[str(device)], "cpu_ms": ms["cpu"],
                **{k: s_cpu[k] for k in (
                    "submitted", "completed", "shed_requests",
                    "retried_requests", "cache_hits", "cache_misses",
                    "cloud_completed", "mean_response")}}
    return report


# the policy head's kernels in a trace (policy_score.cu's kernels live in
# an anonymous namespace; PyTorch's carry at:: in their names)
HEAD_KERNELS = ("gemm", "decode_rows", "score_rows", "score_flat")
ROLLOUT_RANGES = ("rollout.advance", "rollout.instance", "rollout.policy",
                  "rollout.commit")


def _is_head_kernel(name):
    return "at::" not in name and any(
        f"(anonymous namespace)::{k}" in name for k in HEAD_KERNELS)


@contextlib.contextmanager
def _rollout_ranges(engine):
    """Name the engine's pieces in a torch.profiler trace: its lane
    recursion (``advance``), the round's features and instance
    (``round_instance``) and ``commit``; the policy's range is opened by
    the caller's assign fn."""
    from torch.profiler import record_function
    saved = {n: getattr(engine, n) for n in ("advance", "round_instance",
                                             "commit")}
    labels = {"advance": "rollout.advance", "round_instance":
              "rollout.instance", "commit": "rollout.commit"}

    def wrap(name, fn):
        def ranged(*args, **kwargs):
            with record_function(labels[name]):
                return fn(*args, **kwargs)
        return ranged

    try:
        for n, fn in saved.items():
            setattr(engine, n, wrap(n, fn))
        yield
    finally:
        for n, fn in saved.items():
            setattr(engine, n, fn)


def profile_rollout(engine, cfg, fn, state, arr, rounds=ROLLOUT_PROFILE_ROUNDS):
    """A torch.profiler trace of the last ``rounds`` rounds of the batched
    rollout (the heaviest: the queues are longest), from the state the
    rollout reached before them, no drain: device busy ms and idle share
    per round, kernel launches per round, the head kernels' device ms (B3
    or B1) against the rest, and the device ms of each named piece
    (ROLLOUT_RANGES)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def ranged(generator, inst):
        with record_function("rollout.policy"):
            return fn(generator, inst)

    start = arr["size"].shape[1] - rounds
    if start > 0:
        state, _ = engine.make_rollout(cfg, fn, batch=True, drain_to=None)(
            state, {k: v[:, :start] for k, v in arr.items()})
    tail = {k: v[:, start:] for k, v in arr.items()}
    run = engine.make_rollout(cfg, ranged, batch=True, drain_to=None)
    with _rollout_ranges(engine):
        run(state, tail)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(state, tail)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / rounds
    out = _device_summary(prof, rounds, wall_ms, skip=ROLLOUT_RANGES)

    def dev_us(e, total=False):
        names = (("device_time_total", "cuda_time_total") if total else
                 ("self_device_time_total", "self_cuda_time_total"))
        return next((getattr(e, n) for n in names if hasattr(e, n)), 0.0)

    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")
               and e.key not in ROLLOUT_RANGES]
    head_ms = sum(dev_us(e) for e in kernels if _is_head_kernel(e.key))
    out["head_device_ms"] = head_ms / 1e3 / rounds
    out["rest_device_ms"] = out["device_busy_ms"] - out["head_device_ms"]
    out["head_launches_per_round"] = sum(
        e.count for e in kernels if _is_head_kernel(e.key)) / rounds
    # each piece's kernels: the device time of the ops its host-side range
    # launched (FunctionEvent.device_time_total counts the children)
    pieces = dict.fromkeys(ROLLOUT_RANGES, 0.0)
    for e in prof.events():
        if e.name in pieces and str(e.device_type).endswith("CPU"):
            pieces[e.name] += dev_us(e, total=True) / 1e3 / rounds
    pieces["other"] = out["device_busy_ms"] - sum(pieces.values())
    out["device_ms_by_piece"] = pieces
    return out


def drive_rollout(pol, engine, policy_score, ref, arr, *, device="cuda",
                  policy_cfg=None, edges=ROLLOUT_EDGES,
                  rounds=ROLLOUT_ROUNDS):
    """The slice's full-width path: ``PolicyConfig()`` (random weights from
    a seed) schedules B instances of a Q-edge cluster for ``rounds``
    rounds and drains, through ``"policy-fused"`` (B3) and then
    ``"policy"`` (B1), greedy. For each backend:

    1. a checked rollout: every round, the same instance is also decided
       by the plain ``"torch"`` backend on the card, and the decisions
       must be equal on every request whose top-2 gap exceeds GAP;
    2. the main path: the launch counters set to 0, the rollout (the plain
       heads patched to raise), the counters read: the head's kernel must
       have launched once per round for the whole batch and no other
       kernel of the port; every request accounted for, makespans and
       responses finite; then the same rollout again, ROLLOUT_TIMED_RUNS
       in all: wall ms (the median), ms per round, request-rounds/s and
       peak device memory;
    3. a torch.profiler trace of ROLLOUT_PROFILE_ROUNDS rounds.

    Returns {backend: report} and {backend: launch counts}."""
    from unittest import mock
    policy = pol.CoRaiSPolicy(policy_cfg or pol.PolicyConfig(),
                              generator=torch.Generator().manual_seed(0),
                              device=device)
    batch, width = arr["mask"].shape[0], arr["mask"].shape[-1]
    cfg = engine.EngineConfig(num_edges=edges, num_rounds=rounds,
                              round_interval=ROLLOUT_DT, max_per_round=width)
    state = engine.init_batch(cfg, range(batch), device=device)
    arr = {k: torch.as_tensor(v).to(device) for k, v in arr.items()}
    requests = int(arr["mask"].sum())
    reports, counts = {}, {}
    for backend, kernel in (("policy-fused", "policy_score_decode"),
                            ("policy", "policy_score")):
        fn = engine.resolve_assign_fn(backend, policy=policy)
        stats = {"gapped": 0, "requests": 0, "lane_steps": []}
        lane = engine._lane_recursion

        def steps_seen(st, keys, order, t_new, steps, cfg_):
            stats["lane_steps"].append(steps)
            return lane(st, keys, order, t_new, steps, cfg_)

        def checked(generator, inst):
            got = fn(generator, inst)
            with torch.inference_mode():
                c, h = pol.corais_encode(policy, inst, per_instance=True)
                ti, tv = pol.corais_score_decode(
                    policy, c, h, inst["edge_mask"], k=2, normalize=False,
                    backend="torch")
            gapped = ((tv[..., 0] - tv[..., 1]) > GAP) & inst["req_mask"]
            bad = int(((got != ti[..., 0]) & gapped).sum())
            check(bad == 0, f"{backend} rollout: {bad} decisions differ from "
                  f"the plain backend above the gap")
            stats["gapped"] += int(gapped.sum())
            stats["requests"] += int(inst["req_mask"].sum())
            return got

        with mock.patch.object(engine, "_lane_recursion", steps_seen):
            engine.make_rollout(cfg, checked, batch=True)(state, arr)
        check(stats["gapped"] > 0, f"{backend} rollout: no request above "
              f"the gap")

        run = engine.make_rollout(cfg, fn, batch=True)
        guard = [_refuse(ref, n, "the plain") for n in (
            "policy_score_torch", "policy_score_decode_torch")]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        walls = []
        with contextlib.ExitStack() as stack:
            for g in guard:
                stack.enter_context(g)
            for rep in range(ROLLOUT_TIMED_RUNS):
                if rep == 0:
                    policy_score.reset_launch_counts()
                t0 = time.perf_counter()
                final, infos = run(state, arr)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                if rep == 0:
                    launched = dict(policy_score.LAUNCHES)
        wall_s = float(np.median(walls))
        peak = torch.cuda.max_memory_allocated()
        check(launched[kernel] == rounds and sum(launched.values()) == rounds,
              f"{backend} rollout launched {launched} in {rounds} rounds; "
              f"{kernel} must launch once per round for the whole batch")
        m = engine.summarize(final)
        accounted = (m["completed"] + m["stranded_requests"]
                     + m["shed_requests"] + m["dropped_requests"])
        check(accounted == m["submitted"] == requests,
              f"{backend} rollout: {accounted} accounted, {m['submitted']} "
              f"submitted, {requests} arrived")
        check(bool(torch.isfinite(infos["makespan"]).all())
              and all(math.isfinite(m[k]) for k in (
                  "makespan", "mean_response", "p95_response",
                  "max_response")),
              f"{backend} rollout: non-finite makespan or responses")
        profile = profile_rollout(engine, cfg, fn, state, arr)
        counts[backend] = launched
        reports[backend] = {
            "config": {"B": batch, "Q": edges, "rounds": rounds,
                       "round_interval": ROLLOUT_DT, "width": width,
                       "slots": cfg.num_slots, "d_model": policy.cfg.d_model},
            "launches": launched,
            "rollout_wall_ms": wall_s * 1e3,
            "rollout_wall_ms_runs": [w * 1e3 for w in walls],
            "ms_per_round": wall_s * 1e3 / rounds,
            "request_rounds_per_s": m["submitted"] * rounds / wall_s,
            "submitted": m["submitted"], "completed": m["completed"],
            "mean_response": m["mean_response"],
            "p95_response": m["p95_response"], "makespan": m["makespan"],
            "transferred_frac": m["transferred_frac"],
            "checked_requests": stats["requests"],
            "gapped_requests": stats["gapped"],
            "lane_steps_per_advance": stats["lane_steps"],
            "peak_memory_bytes": peak,
            "peak_memory_over_state_bytes": peak - base_mem,
            "profile": profile,
        }
    return reports, counts


# -- phase 13: timing ------------------------------------------------------


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


def launch_split(fn, n=20):
    """Device us per call of each kernel that ``fn`` launches, heaviest
    first, from a torch.profiler trace of ``n`` calls after a warm-up:
    {"total_us", "kernels": [{"kernel", "us", "launches"}]}. A launch is
    charged from the later of its start and the end of the launch before
    it to its own end: a programmatic dependent launch starts while its
    predecessor runs and waits for it, and that wait is the predecessor's
    time. The trace may miss a few launches of the window, so us is the
    mean over the launches it holds times the launches per call,
    rounded; a trace with no device events at all is taken again, up to
    three times."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then holds no device events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        kernels = sorted((e for e in prof.events()
                          if str(e.device_type).endswith("CUDA")),
                         key=lambda e: e.time_range.start)
        if kernels:
            break
    stats, prev_end = {}, -math.inf
    for e in kernels:
        own = e.time_range.end - max(e.time_range.start, prev_end)
        prev_end = max(prev_end, e.time_range.end)
        total, count = stats.get(e.name, (0.0, 0))
        stats[e.name] = (total + max(own, 0.0), count + 1)
    rows = []
    for name, (total, count) in stats.items():
        per_call = max(1, round(count / n))
        rows.append({"kernel": name[:80], "us": total / count * per_call,
                     "launches": per_call})
    rows.sort(key=lambda r: -r["us"])
    check(rows and sum(r["us"] for r in rows) > 0,
          "the profiler saw no device time")
    return {"total_us": sum(r["us"] for r in rows), "kernels": rows}


def bound(flops, nbytes, peak=F32_FLOPS):
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _row(name, line, kern, plain, flops, nbytes, launches, err, shape, *,
         source="policy_score.cu", replaces="policy_score.py", library=None,
         peak=F32_FLOPS, reps=25, inner=20):
    """One kernel's entry of the ``{"kernels": [...]}`` line, timed in the
    order plain, kernel, kernel, plain (then the library call, if any)."""
    plain_a = time_ms(plain, reps, inner)
    kern_a = time_ms(kern, reps, inner)
    kern_b = time_ms(kern, reps, inner)
    plain_b = time_ms(plain, reps, inner)
    library_ms = time_ms(library, reps, inner) if library else None
    bound_ms, bound_by = bound(flops, nbytes, peak)
    return {
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{source}",
        "replaces": f"src/repro/kernels/{replaces}:{line}",
        "launches": sum(launches.values()), "max_abs_err": err,
        "ms": min(kern_a, kern_b), "plain_ms": min(plain_a, plain_b),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        "shape": shape, "launches_by_path": launches,
        "ms_runs": [kern_a, kern_b], "plain_ms_runs": [plain_a, plain_b],
    }


def _head_counts(c, h):
    b, q, d = c.shape
    z = h.shape[1]
    in_bytes = 4 * (b * q * d + b * z * d + 2 * d * d) + 4 * b * q
    return b, q, z, d, in_bytes


def policy_head_split(ops, policy_score, enc, enc_train):
    """Device us per launch of B1 and B3 on the real encoder outputs at
    100x1000 (B3 at K = 1 as greedy serving, and K = Q normalized as the
    sampled path), and of B1 and B2 at the training shape
    (``launch_split``)."""
    c, h, wx, wy, mask = enc[3:]
    maskf = mask.to(torch.float32)
    q = c.shape[1]
    split = {"policy_score": launch_split(
        lambda: policy_score.policy_score_cuda(c, h, wx, wy, maskf))}
    for k, normalize in ((1, False), (q, True)):
        split[f"policy_score_decode K={k}" + " normalized" * normalize] = \
            launch_split(lambda: policy_score.policy_score_decode_cuda(
                c, h, wx, wy, maskf, k=k, normalize=normalize))
    c, h, wx, wy, mask = enc_train[3:]
    maskf = mask.to(torch.float32)
    split["policy_score train_shape"] = launch_split(
        lambda: policy_score.policy_score_cuda(c, h, wx, wy, maskf))
    out = ops.policy_score(c, h, wx, wy, mask)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(12)
                    ).cuda()
    split["policy_score_bwd"] = launch_split(
        lambda: policy_score.policy_score_bwd_cuda(g, out, c, h, wx, wy,
                                                   maskf))
    return split


def _b1_unfolded_ms(b, q, z, d, in_bytes):
    """B1's bound by its first design's work (py = h Wpy recomputed)."""
    return bound(2 * b * (q * d * d + z * d * d + z * q * d),
                 in_bytes + 4 * b * z * q)[0]


SHAPE_ROW_KEYS = ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "ms_runs",
                  "plain_ms_runs")


def timings(ops, ref, policy_score, enc, enc_train, launches, errs,
            rollout_case=None):
    """B1 and B3 at the serving shape (100x1000, one instance; B1 also at
    the training shape, B3 also at K = Q = 100 normalized, the sampled
    path's call, under ``sampled``), B2 at the training shape (B=128, Q=5,
    Z=50), each beside its plain version and its bound. B1's and B3's
    operations are the reference decode's fold, which both kernels take
    (px, pxy = Wpy px^T, h pxy); B2's are its kernel's fold (px, pxy^T, u,
    dh, ghx, dpx, dc and the two weight gradients: six B*Q x d x d
    products and three B*Z x Q x d ones). B1 and B2 keep the unfolded
    count they were bounded by before (py = h Wpy recomputed) as
    ``bound_ms_unfolded``. ``rollout_case``: B1 and B3 (K = 1,
    normalized, as ``"policy-fused"`` calls it) also at the rollout's
    shape, under ``rollout_shape``. ``launches``: {kernel: {path: count}}
    from the main-path runs."""
    c, h, wx, wy, mask = enc[3:]
    b, q, z, d, in_bytes = _head_counts(c, h)
    k = 1
    b3_flops = 2 * b * (q * d * d + d * d * q + z * d * q)
    shape = f"B={b} Q={q} Z={z} d={d}"
    rows = [
        _row("policy_score", 51,
             lambda: ops.policy_score(c, h, wx, wy, mask),
             lambda: ref.policy_score_torch(c, h, wx, wy, mask),
             b3_flops, in_bytes + 4 * b * z * q, launches["policy_score"],
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
    sampled = _row("policy_score_decode", 180,
                   lambda: ops.policy_score_decode(c, h, wx, wy, mask, k=q,
                                                   normalize=True),
                   lambda: ref.policy_score_decode_torch(c, h, wx, wy, mask,
                                                         10.0, q, True),
                   b3_flops, in_bytes + 8 * b * z * q, {}, None,
                   shape + f" K={q} normalized")
    rows[1]["sampled"] = {k_: sampled[k_] for k_ in SHAPE_ROW_KEYS}
    if rollout_case is not None:
        # B1 and B3 as the rollout engine calls them: one launch a round
        # for B = 256 instances of Q = 100 edges
        c, h, wx, wy, mask = rollout_case[4:]
        b, q, z, d, in_bytes = _head_counts(c, h)
        flops = 2 * b * (q * d * d + d * d * q + z * d * q)
        shape = f"B={b} Q={q} Z={z} d={d}"
        for i, (kern, plain, out_bytes, tag) in enumerate((
                (lambda: ops.policy_score(c, h, wx, wy, mask),
                 lambda: ref.policy_score_torch(c, h, wx, wy, mask),
                 4 * b * z * q, ""),
                (lambda: ops.policy_score_decode(c, h, wx, wy, mask, k=1,
                                                 normalize=True),
                 lambda: ref.policy_score_decode_torch(c, h, wx, wy, mask,
                                                       10.0, 1, True),
                 8 * b * z, " K=1 normalized"))):
            row = _row(rows[i]["name"], 0, kern, plain, flops,
                       in_bytes + out_bytes, {}, None, shape + tag)
            rows[i]["rollout_shape"] = {k_: row[k_] for k_ in SHAPE_ROW_KEYS}
    rows[0]["bound_ms_unfolded"] = _b1_unfolded_ms(b, q, z, d, in_bytes)

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
                    2 * b * (q * d * d + d * d * q + z * d * q),
                    in_bytes + 4 * b * z * q, {}, None, shape)
    rows[0]["train_shape"] = {k_: b1_train[k_] for k_ in SHAPE_ROW_KEYS}
    rows[0]["train_shape"]["bound_ms_unfolded"] = _b1_unfolded_ms(
        b, q, z, d, in_bytes)
    b2_flops = 2 * b * (6 * q * d * d + 3 * z * q * d)
    b2_bytes = in_bytes + 8 * b * z * q + 4 * (b * q * d + b * z * d + 2 * d * d)
    rows.append(_row(
        "policy_score_bwd", 65,
        lambda: policy_score.policy_score_bwd_cuda(g, out, c, h, wx, wy, maskf),
        lambda: ref.policy_score_bwd_torch(g, out, c, h, wx, wy, maskf),
        b2_flops, b2_bytes, launches["policy_score_bwd"],
        errs["policy_score_bwd"], shape))
    rows[-1]["max_rel_err"] = errs["policy_score_bwd_rel"]
    rows[-1]["bound_ms_unfolded"] = bound(
        2 * b * (3 * q * d * d + 3 * z * d * d + 3 * z * q * d), b2_bytes)[0]
    return rows


# -- phases 7-12: the LM edge servers (kernels B4, B5 and B6) --------------


def _attn_err(got, want, dtype):
    """(largest |got - want|, largest excess over allclose's atol + rtol
    |want| with atol = rtol = ATTN_TOL[dtype])."""
    diff = (got.float() - want.float()).abs()
    tol = ATTN_TOL[dtype]
    return float(diff.max()), float((diff - tol * want.float().abs()).max())


def _slot_cache(gen, b, w, kv, hd, dtype, fills=None, rolling_from=None):
    """K/V caches (B, W, KV, hd) with lane i holding positions
    0..fills[i]-1 (the rest empty, ``pos`` the last one), or, where
    ``rolling_from[i]`` is not None, positions p0..p0+W-1 at their slots
    p % W."""
    kc, vc = (torch.randn(b, w, kv, hd, generator=gen).to("cuda", dtype)
              for _ in range(2))
    slot_pos = torch.full((b, w), -1, dtype=torch.int32)
    pos = torch.zeros(b, dtype=torch.int32)
    for i in range(b):
        if rolling_from is None or rolling_from[i] is None:
            n = fills[i]
            slot_pos[i, :n] = torch.arange(n, dtype=torch.int32)
            pos[i] = max(n - 1, 0)
        else:
            tail = torch.arange(rolling_from[i], rolling_from[i] + w,
                                dtype=torch.int32)
            slot_pos[i, (tail % w).long()] = tail
            pos[i] = rolling_from[i] + w - 1
    return kc, vc, slot_pos.cuda(), pos.cuda()


def compare_attention(ops, ref, errs):
    """B4 and B5 against their plain versions on the card at the listed
    cases, among them the shapes the qwen3-4b and hymba-1.5b edges give
    them; raises on a disagreement beyond the reference's bars (2e-4 f32,
    2e-2 bf16) or when two calls differ in a bit, and folds the largest
    errors into ``errs``."""
    gen = torch.Generator().manual_seed(21)
    bf16, f32 = torch.bfloat16, torch.float32
    report = []
    for b, s, h, kv, hd, dtype, causal, window in (
            (1, 37, 32, 8, 128, bf16, True, None),     # qwen3 heads
            (1, 2048, 32, 8, 128, bf16, True, None),
            (2, 300, 16, 16, 128, f32, True, None),    # olmo heads
            (1, 1024, 32, 8, 128, bf16, True, 256),    # G=4, window 256
            (1, 1024, 32, 8, 128, bf16, False, None),  # non-causal
            # hymba heads (G=5, hd=64) and window: prompts past it and not
            (1, 2560, 25, 5, 64, bf16, True, 2048),
            (1, 1000, 25, 5, 64, bf16, True, 2048),
            # bf16 tensor-core tiles: ragged S at hymba's window, head
            # widths 16 and 32, a non-causal window
            (1, 1, 25, 5, 64, bf16, True, 2048),
            (1, 63, 25, 5, 64, bf16, True, 2048),
            (1, 65, 25, 5, 64, bf16, True, 2048),
            (2, 200, 4, 2, 16, bf16, True, None),
            (1, 150, 8, 4, 32, bf16, True, None),
            (1, 300, 16, 4, 128, bf16, False, 70)):
        q, k, v = (torch.randn(b, s, n, hd, generator=gen).to("cuda", dtype)
                   for n in (h, kv, kv))
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        again = ops.flash_attention(q, k, v, causal=causal, window=window)
        want = ref.flash_attention_torch(q, k, v, causal=causal,
                                         window=window)
        err, excess = _attn_err(got, want, dtype)
        check(got.shape == q.shape and got.dtype == dtype
              and bool(torch.isfinite(got).all()),
              f"flash_attention output malformed at {(b, s, h, kv, hd)}")
        check(excess <= ATTN_TOL[dtype], f"flash_attention err {err} beyond "
              f"allclose({ATTN_TOL[dtype]}) at "
              f"{(b, s, h, kv, hd, str(dtype), causal, window)}")
        check(torch.equal(got, again), "flash_attention differs between two "
              f"calls at {(b, s, h, kv, hd, str(dtype), causal, window)}")
        errs["flash_attention"] = max(errs["flash_attention"], err)
        report.append({"kernel": "flash_attention", "B": b, "S": s, "H": h,
                       "KV": kv, "hd": hd, "dtype": str(dtype),
                       "causal": causal, "window": window, "err": err})
    for b, w, h, kv, hd, dtype, fills, roll, window in (
            (4, 4096, 32, 8, 128, bf16, (1, 700, 2600, 4096), None, None),
            # as served (4,506 valid slots): 22 splits of 3 tiles, the
            # last of 1
            (4, 4096, 32, 8, 128, bf16, (2303, 1100, 600, 503), None, None),
            (2, 256, 32, 8, 128, bf16, None, (900, 4000), 256),  # rolling
            (3, 96, 32, 8, 128, bf16, (5, 60, 96), None, None),  # W=96
            (2, 96, 16, 16, 128, f32, (30, 96), None, 20),
            HYMBA_CACHE,
            # split-W: a lane with no valid slot and no roll (the mean of
            # V), one lane over 4096 slots (64 splits), W = 1
            (3, 300, 32, 8, 128, bf16, (0, 120, 300), None, None),
            (1, 4096, 32, 8, 128, bf16, (3000,), None, None),
            (2, 1, 32, 8, 128, bf16, (1, 0), None, None)):
        kc, vc, slot_pos, pos = _slot_cache(gen, b, w, kv, hd, dtype, fills,
                                            roll)
        q = torch.randn(b, h, hd, generator=gen).to("cuda", dtype)
        got = ops.decode_attention(q, kc, vc, slot_pos, pos, window=window)
        again = ops.decode_attention(q, kc, vc, slot_pos, pos, window=window)
        want = ref.decode_attention_torch(q, kc, vc, slot_pos, pos,
                                          window=window)
        err, excess = _attn_err(got, want, dtype)
        check(got.shape == q.shape and got.dtype == dtype
              and bool(torch.isfinite(got).all()),
              f"decode_attention output malformed at {(b, w, h, kv, hd)}")
        check(excess <= ATTN_TOL[dtype], f"decode_attention err {err} beyond "
              f"allclose({ATTN_TOL[dtype]}) at "
              f"{(b, w, h, kv, hd, str(dtype), fills, roll, window)}")
        check(torch.equal(got, again), "decode_attention differs between two "
              f"calls at {(b, w, h, kv, hd, str(dtype), fills, roll, window)}")
        errs["decode_attention"] = max(errs["decode_attention"], err)
        report.append({"kernel": "decode_attention", "B": b, "W": w, "H": h,
                       "KV": kv, "hd": hd, "dtype": str(dtype),
                       "fills": fills, "rolling_from": roll,
                       "window": window, "err": err})
    torch.cuda.synchronize()
    return report


def _scan_inputs(gen, b, s, d, n):
    """As ``tests/test_kernels.py`` makes them: u, B, C normal, dt =
    softplus(normal) * 0.1, A = -exp(0.2 * normal); f32 on the card."""
    u = torch.randn(b, s, d, generator=gen)
    dt = torch.nn.functional.softplus(torch.randn(b, s, d, generator=gen))
    bm = torch.randn(b, s, n, generator=gen)
    cm = torch.randn(b, s, n, generator=gen)
    a = -torch.exp(0.2 * torch.randn(d, n, generator=gen))
    return [t.cuda() for t in (u, dt * 0.1, bm, cm, a)]


def _gated_inputs(gen, b, s, d, n, over_threshold=False):
    """u normal, dt_raw = 0.5 * normal, dt_bias the inverse softplus of a
    dt log-uniform in [1e-3, 0.1] (the model's initialisation), B, C
    normal, A as ``_scan_inputs``, D = 1 + 0.1 * normal, and uz (B, S, 2d)
    normal in bf16, whose second half is z; f32 on the card."""
    u = torch.randn(b, s, d, generator=gen)
    dt_raw = 0.5 * torch.randn(b, s, d, generator=gen)
    if over_threshold:  # softplus(x) = x above 20
        dt_raw[..., ::7] = 25.0
    dt0 = torch.exp(torch.rand(d, generator=gen) * (math.log(0.1)
                                                   - math.log(1e-3))
                    + math.log(1e-3))
    bias = dt0 + torch.log(-torch.expm1(-dt0))
    bm = torch.randn(b, s, n, generator=gen)
    cm = torch.randn(b, s, n, generator=gen)
    a = -torch.exp(0.2 * torch.randn(d, n, generator=gen))
    dskip = 1 + 0.1 * torch.randn(d, generator=gen)
    uz = torch.randn(b, s, 2 * d, generator=gen).to(torch.bfloat16)
    return [t.cuda() for t in (u, dt_raw, bias, bm, cm, a, dskip)], uz.cuda()


def _within(name, got, want, tol, where, rel_extra=0.0):
    """Largest |got - want|; raises beyond allclose(atol = rtol = tol),
    plus ``rel_extra`` of |want|."""
    want = want.float()
    diff = (got.float() - want).abs()
    excess = float((diff - (tol + rel_extra) * want.abs()).max())
    err = float(diff.max())
    check(excess <= tol, f"{where} {name} err {err} beyond allclose({tol})"
          + (f" + {rel_extra} of |want|" if rel_extra else ""))
    return err


def compare_scan(ops, ref, errs):
    """B6 against its plain version on the card: the bare entry at
    SCAN_CASES (y and h_last within allclose(atol = rtol = SCAN_TOL)), the
    gated entry at SCAN_GATED_CASES with z a strided bf16 view (the output
    within SCAN_TOL plus half a bf16 ulp of the plain version's f32 value)
    and a strided f32 view (within SCAN_TOL); each entry twice, bit for
    bit. Folds each entry's largest error into ``errs``; returns the
    report and the first case's inputs of each entry (falcon-mamba's
    prefill shape, timed later)."""
    gen = torch.Generator().manual_seed(41)
    report, first, first_gated = [], None, None
    for b, s, d, n in SCAN_CASES:
        args = _scan_inputs(gen, b, s, d, n)
        y, h = ops.mamba_scan(*args)
        y2, h2 = ops.mamba_scan(*args)
        wy, wh = ref.mamba_scan_torch(*args)
        torch.cuda.synchronize()
        where = f"mamba_scan at {(b, s, d, n)}"
        check(y.shape == (b, s, d) and h.shape == (b, d, n)
              and bool(torch.isfinite(y).all() and torch.isfinite(h).all()),
              f"{where}: output malformed")
        check(torch.equal(y, y2) and torch.equal(h, h2),
              f"{where}: two calls differ")
        row = {"kernel": "mamba_scan", "B": b, "S": s, "d": d, "N": n,
               "y_err": _within("y", y, wy, SCAN_TOL, where),
               "h_last_err": _within("h_last", h, wh, SCAN_TOL, where)}
        errs["mamba_scan"] = max(errs["mamba_scan"], row["y_err"],
                                 row["h_last_err"])
        report.append(row)
        if first is None:
            first = args
    for b, s, d, n in SCAN_GATED_CASES:
        args, uz = _gated_inputs(gen, b, s, d, n, over_threshold=s < 100)
        z16, z32 = uz[..., d:], uz.float()[..., d:]
        want, wh = ref.mamba_scan_gated_torch(*args, z32)
        row = {"kernel": "mamba_scan_gated", "B": b, "S": s, "d": d, "N": n}
        for z in (z16, z32):
            o, h = ops.mamba_scan_gated(*args, z)
            o2, h2 = ops.mamba_scan_gated(*args, z)
            torch.cuda.synchronize()
            name = str(z.dtype).split(".")[-1]
            where = f"mamba_scan_gated ({name} z) at {(b, s, d, n)}"
            check(o.shape == (b, s, d) and o.dtype == z.dtype
                  and h.shape == (b, d, n)
                  and bool(torch.isfinite(o).all()
                           and torch.isfinite(h).all()),
                  f"{where}: output malformed")
            check(torch.equal(o, o2) and torch.equal(h, h2),
                  f"{where}: two calls differ")
            row[f"out_err_{name}"] = _within(
                "out", o, want, SCAN_TOL, where,
                BF16_HALF_ULP if z.dtype == torch.bfloat16 else 0.0)
            row[f"h_last_err_{name}"] = _within("h_last", h, wh, SCAN_TOL,
                                               where)
            errs["mamba_scan_gated"] = max(errs["mamba_scan_gated"],
                                           row[f"out_err_{name}"],
                                           row[f"h_last_err_{name}"])
            if z.dtype == torch.bfloat16:
                row["bf16_equal_share"] = float(
                    (o == want.to(torch.bfloat16)).float().mean())
        report.append(row)
        if first_gated is None:
            first_gated = (args, z16)
    return report, first, first_gated


def _refuse(module, name, what):
    """A patch that makes ``module.name`` raise: a main path must not reach
    it."""
    from unittest import mock

    def fn(*args, **kwargs):
        raise RuntimeError(f"the main path reached {what} {name}")
    return mock.patch.object(module, name, fn)


def _plain_guard(ref, ops):
    """Patches that make the plain versions of B4-B6 raise, B6's gated
    entry's too, and B6's bare entry: the main path on the card must reach
    only the kernels, and the SSM block only B6's gated entry."""
    return [_refuse(ref, n, "the plain") for n in (
        "flash_attention_torch", "decode_attention_torch",
        "mamba_scan_torch", "mamba_scan_gated_torch")] + [
        _refuse(ops, "mamba_scan", "B6's bare entry")]


def drive_lm_serving(cfg, params, lm, batching, state, heuristics, build,
                     ref, ops):
    """The example's flow (examples/serve_multi_edge.py) at full width: three
    ``LMEdgeBackend`` edges with lanes [1, 2, 4] share one weight set; a phi
    warm-up of eight prefills per edge, after which each edge's phi must
    have accepted a fit (a flat or falling history fits a = 0, which keeps
    a host-bound edge in the dispatch); ``snapshot_instance`` + greedy
    dispatch of LM_REQUESTS requests; drain. Untimed prefills at the
    warm-up's sizes come first, so that first-call costs do not land in
    phi. The launch counters are set to 0 just before the edges serve and
    read just after; each family's kernels must launch exactly once per
    layer that runs them (B4 and B6 per admission, B5 per decode step), the
    plain versions never, and B6 only through its gated entry. Returns the
    summary and the edges."""
    lanes = [1, 2, 4]
    edges = [batching.LMEdgeBackend(cfg, params, lanes=n, max_seq=LM_MAX_SEQ,
                                    seed=i) for i, n in enumerate(lanes)]
    for plen in PHI_PROMPTS:  # the model warm, as before serving traffic
        lm.prefill(params, {"tokens": torch.zeros(
            (1, plen), dtype=torch.int32, device=edges[0].device)}, cfg,
            max_seq=LM_MAX_SEQ, head=edges[0]._head)
    torch.cuda.synchronize()
    steps = {"admit_ms": [], "decode_ms": [], "decode_tokens": 0,
             "decode_steps": 0}

    def step(be):
        n_phi = len(be.phi._xs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        active = be.step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if active:
            steps["decode_steps"] += 1
            if len(be.phi._xs) == n_phi:  # no admission in this step
                steps["decode_ms"].append(ms)
                steps["decode_tokens"] += active

    guard = contextlib.ExitStack()
    for patch in _plain_guard(ref, ops):
        guard.enter_context(patch)
    build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t_start = time.perf_counter()
    prior = state.PhiEstimator().coefficients  # phi before any accepted fit
    for i, be in enumerate(edges):  # phi warm-up (paper Fig. 4 fit)
        for j, plen in enumerate(PHI_PROMPTS):
            be.submit(LM_WARM + 1000 * i + j, plen, 1)
        while be._queue or any(s.remaining for s in be._lane_states):
            step(be)
        check(be.phi.coefficients != prior, f"edge {i}'s phi accepted no fit "
              f"from its warm-up: {be.phi._xs}, {be.phi._ys}")
    warm_s = time.perf_counter() - t_start

    rng = np.random.default_rng(LM_SEED)
    reqs = [state.QueuedRequest(rid=rid, data_size=float(rng.integers(
        256, 2561)), source_edge=int(rng.integers(0, 3)))
        for rid in range(LM_REQUESTS)]
    states = [state.EdgeServiceState(edge_id=i, coords=(float(i), 0.0),
                                     phi=be.phi, replicas=be.lanes)
              for i, be in enumerate(edges)]
    w = np.abs(np.arange(3)[:, None] - np.arange(3)[None]).astype(
        np.float32) * 1e-4
    inst = state.snapshot_instance(states, reqs, w, ct=1.0)
    assign = heuristics.solve_greedy(inst)
    share = {i: int(np.sum(assign[:len(reqs)] == i)) for i in range(3)}
    t0 = time.perf_counter()
    for r, target in zip(reqs, assign):
        edges[int(target)].submit(r.rid, int(r.data_size), gen_len=LM_GEN)

    def real_done():
        return sum(len([r for r in be.finished if r < LM_WARM])
                   for be in edges)

    rounds = 0
    while real_done() < len(reqs) and rounds < 10_000:
        for be in edges:
            step(be)
        rounds += 1
    serve_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {k: build.LAUNCHES[k] for k in ("flash_attention",
                                               "decode_attention",
                                               "mamba_scan")}
    guard.close()
    admissions = sum(len(be.phi._xs) for be in edges)
    check(real_done() == len(reqs), f"served {real_done()} of {len(reqs)}")
    check(share[2] >= share[0], f"dispatch share {share}: the 4-lane edge "
          "got fewer requests than the 1-lane edge")
    for be in edges:
        for rid, n in be.finished.items():
            want = 1 if rid >= LM_WARM else LM_GEN
            check(n == want, f"request {rid} generated {n} tokens, not {want}")
    attn = int(cfg.family != "ssm")
    scan = int(cfg.family in ("ssm", "hybrid"))
    want = {"flash_attention": cfg.num_layers * admissions * attn,
            "decode_attention": cfg.num_layers * steps["decode_steps"] * attn,
            "mamba_scan": cfg.num_layers * admissions * scan}
    for name, n in want.items():
        check(launches[name] == n, f"{name} launched {launches[name]} times, "
              f"not {n}: {admissions} admissions and {steps['decode_steps']} "
              f"decode steps of {cfg.num_layers} {cfg.family} layers")
    dec = steps["decode_ms"]
    summary = {
        "arch": cfg.name, "family": cfg.family, "dtype": cfg.dtype,
        "layers": cfg.num_layers,
        "params": sum(t.numel() for t in _leaves(params)),
        "lanes": lanes, "max_seq": LM_MAX_SEQ, "requests": len(reqs),
        "gen_len": LM_GEN, "dispatch_share": share,
        "served": {i: len([r for r in be.finished if r < LM_WARM])
                   for i, be in enumerate(edges)},
        "admissions": admissions,
        "decode_steps": steps["decode_steps"],
        "launches": launches, "warmup_s": warm_s, "serve_s": serve_s,
        "phi": {i: {"a": be.phi.a, "b": be.phi.b,
                    "prompt_tokens": list(be.phi._xs),
                    "prefill_ms": [y * 1e3 for y in be.phi._ys]}
                for i, be in enumerate(edges)},
        "decode_step_ms": {"p50": float(np.percentile(dec, 50)),
                           "p95": float(np.percentile(dec, 95)),
                           "n": len(dec)},
        "decode_tokens_per_s": steps["decode_tokens"] / (sum(dec) / 1e3),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    }
    return summary, edges


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def profile_lm(cfg, params, lm, edge, prompt_len=2048, n_decode=5):
    """Device busy ms, idle share and kernels per unit from torch.profiler
    traces of one prefill (``prompt_len`` tokens) and of ``n_decode`` decode
    steps over ``edge``'s batch cache (all its lanes)."""
    from torch.profiler import ProfilerActivity, profile
    head = lm.head_f32(params, cfg)
    tokens = torch.randint(0, cfg.vocab_size, (1, prompt_len),
                           generator=torch.Generator().manual_seed(5),
                           dtype=torch.int32).cuda()
    lm.prefill(params, {"tokens": tokens}, cfg, max_seq=LM_MAX_SEQ, head=head)
    torch.cuda.synchronize()
    out = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lm.prefill(params, {"tokens": tokens}, cfg, max_seq=LM_MAX_SEQ,
                   head=head)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out["prefill"] = {"prompt_tokens": prompt_len,
                      **_device_summary(prof, 1, wall_ms)}
    token = torch.zeros(edge.lanes, dtype=torch.int32, device=edge.device)
    cache = edge._cache
    cache, _ = lm.decode_step(params, cache, {"token": token}, cfg, head=head)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_decode):
            cache, _ = lm.decode_step(params, cache, {"token": token}, cfg,
                                      head=head)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_decode
    out["decode"] = {"lanes": edge.lanes,
                     "pos": cache["pos"].tolist(),
                     **_device_summary(prof, n_decode, wall_ms)}
    return out


def _to_f32(tree):
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_f32(v) for v in tree]
    return tree.float()


def lm_kernel_vs_plain(cfg, params, lm, ops, ref, prompt_len=1500,
                       n_decode=16, scan_ulp=False):
    """One request through the kernel path (B4, B5, B6) and the plain path
    (their plain versions on the card), same weights, teacher-forced on the
    same tokens, in bf16 (the serving path) and with the same weights in
    f32. Each logits row's largest difference is taken relative to its
    largest |logit|: f32 must agree to LM_LOGIT_TOL_F32, bf16 to
    LM_LOGIT_TOL_BF16 (1-ulp rounding differences compound over the
    layers; PERF.md). Reports the share of steps with equal argmax among those
    whose top-2 gap exceeds LM_GAP of the largest |logit|. With
    ``scan_ulp``, also reports (and does not check) how far the bf16
    logits move when B6's y is nudged by one f32 ulp everywhere: the
    reading that shows LM_LOGIT_TOL_BF16 admits a B6 rounded 1 ulp apart
    from its plain version. The gated entry never exposes its f32 y, so
    the nudged run takes the gated entry's plain version with B6's bare
    entry in place of its plain scan."""
    from unittest import mock
    gen = torch.Generator().manual_seed(6)
    prompt = torch.randint(0, cfg.vocab_size, (1, prompt_len), generator=gen,
                           dtype=torch.int32).cuda()
    forced = torch.randint(0, cfg.vocab_size, (n_decode, 1), generator=gen,
                           dtype=torch.int32).cuda()

    def run(cfg, params, head):
        cache, logits = lm.prefill(params, {"tokens": prompt}, cfg,
                                   max_seq=prompt_len + n_decode, head=head)
        rows = [logits]
        for tok in forced:
            cache, logits = lm.decode_step(params, cache, {"token": tok}, cfg,
                                           head=head)
            rows.append(logits)
        return torch.cat(rows)[:, :cfg.vocab_size]

    def rel_err(got, plain):
        return (got - plain).abs().amax(-1) / plain.abs().amax(-1)

    def compare(cfg, params, tol, nudge=False):
        head = lm.head_f32(params, cfg)
        kern = run(cfg, params, head)
        with mock.patch.object(ops, "flash_attention",
                               lambda q, k, v, *, causal, window:
                               ref.flash_attention_torch(
                                   q, k, v, causal=causal, window=window)), \
                mock.patch.object(ops, "decode_attention",
                                  lambda q, kc, vc, sp, pos, *, window:
                                  ref.decode_attention_torch(
                                      q, kc, vc, sp, pos, window=window)), \
                mock.patch.object(ops, "mamba_scan", ref.mamba_scan_torch), \
                mock.patch.object(ops, "mamba_scan_gated",
                                  ref.mamba_scan_gated_torch):
            plain = run(cfg, params, head)
        torch.cuda.synchronize()
        scale = plain.abs().amax(-1)
        err = rel_err(kern, plain)
        top = plain.topk(2, dim=-1).values
        gapped = (top[:, 0] - top[:, 1]) > LM_GAP * scale
        same = kern.argmax(-1) == plain.argmax(-1)
        check(bool(torch.isfinite(kern).all()),
              f"non-finite kernel-path logits ({cfg.dtype})")
        check(float(err.max()) <= tol, f"kernel-path logits ({cfg.dtype}) "
              f"differ from the plain path's by {float(err.max())} of the "
              f"largest |logit|, above {tol} (PERF.md section 6 says how "
              f"each bar was set)")
        out = {}
        if nudge:
            kernel_scan = ops.mamba_scan

            def nudged(*args):
                y, h = kernel_scan(*args)
                return torch.nextafter(y, torch.full_like(y, math.inf)), h

            with mock.patch.object(ops, "mamba_scan_gated",
                                   ref.mamba_scan_gated_torch), \
                    mock.patch.object(ref, "mamba_scan_torch", nudged):
                out["one_ulp_of_y_rel_err"] = float(rel_err(
                    run(cfg, params, head), plain).max())
        return {**out, "tol": tol, "max_rel_err": float(err.max()),
                "rel_err_prefill": float(err[0]),
                "rel_err_steps": [float(e) for e in err],
                "gapped_steps": int(gapped.sum()),
                "argmax_equal_share_gapped": (
                    float(same[gapped].float().mean())
                    if bool(gapped.any()) else None),
                "argmax_equal_share_all": float(same.float().mean())}

    out = {"prompt_tokens": prompt_len, "decode_steps": n_decode,
           "bf16": compare(cfg, params, LM_LOGIT_TOL_BF16,
                           nudge=scan_ulp)}
    params32 = _to_f32(params)
    out["f32"] = compare(dataclasses.replace(cfg, dtype="float32"), params32,
                         LM_LOGIT_TOL_F32)
    del params32
    torch.cuda.empty_cache()
    return out


def edge_cache(edge):
    """Layer 0's K and V, the slot positions and positions of ``edge``'s
    batch cache, copied so that they outlive the model."""
    c = edge._cache
    return tuple(t.clone() for t in (c["layers"]["k"][0], c["layers"]["v"][0],
                                     c["slot_pos"], c["pos"]))


SHAPE_KEYS = ("shape", "max_abs_err", "ms", "plain_ms", "library_ms",
              "bound_ms", "bound_by", "ms_runs", "plain_ms_runs")
SPLIT_SWEEP = (1, 2, 3, 4, 7, 16)  # B5's tiles per split, timed


def _timed_err(kern, plain, where):
    """The largest |kernel - plain| on the inputs a row times; raises beyond
    the bf16 bar (ATTN_TOL) or when two calls differ in a bit."""
    got, again, want = kern(), kern(), plain()
    err, excess = _attn_err(got, want, torch.bfloat16)
    check(bool(torch.isfinite(got).all()) and got.shape == want.shape,
          f"{where}: output malformed")
    check(excess <= ATTN_TOL[torch.bfloat16], f"{where}: err {err} beyond "
          f"allclose({ATTN_TOL[torch.bfloat16]})")
    check(torch.equal(got, again), f"{where}: two calls differ")
    return err


def _flash_row(ops, ref, gen, b, s, h, kv, hd, window, launches):
    """B4 at (b, s, h, kv, hd) bf16, causal with ``window``, held against
    its plain version on the inputs it is timed on, beside that version,
    SDPA and its bound: the (row, column) pairs the mask keeps on the bf16
    tensor cores against q, k, v read and o written."""
    import torch.nn.functional as F
    q, k, v = (torch.randn(b, s, n, hd, generator=gen).to("cuda",
                                                         torch.bfloat16)
               for n in (h, kv, kv))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    w = s if window is None else min(window, s)
    pairs = b * (w * (w + 1) // 2 + (s - w) * w)
    mask = None
    if w < s:  # SDPA takes a window only as a mask
        i = torch.arange(s, device="cuda")
        mask = (i[None] <= i[:, None]) & (i[None] > i[:, None] - w)
    shape = (f"B={b} S={s} H={h} KV={kv} hd={hd} bf16 causal"
             + (f" window {window}" if window else ""))

    def kern():
        return ops.flash_attention(q, k, v, causal=True, window=window)

    def plain():
        return ref.flash_attention_torch(q, k, v, causal=True, window=window)

    err = _timed_err(kern, plain, f"flash_attention at {shape}")
    return _row("flash_attention", 26, kern, plain, 4 * h * hd * pairs,
                2 * (2 * b * s * h * hd + 2 * b * s * kv * hd), launches, err,
                shape,
                source="flash_attention.cu", replaces="flash_attention.py",
                library=lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, is_causal=mask is None,
                    enable_gqa=True),
                peak=BF16_FLOPS, reps=10, inner=5)


def _decode_row(ops, ref, da, gen, cache, h, window, launches):
    """B5 over ``cache`` (k, v, slot positions, positions) with ``h`` query
    heads and random q, held against its plain version on those inputs,
    beside that version, SDPA and its bound: the valid slots' K and V rows
    against the tensor-core peak. ``split_sweep``: the kernel's time and
    error at SPLIT_SWEEP tiles per split (module ``da`` launched with an
    explicit plan), each checked like the plan's own choice."""
    import torch.nn.functional as F
    kc, vc, slot_pos, pos = cache
    b, w, kv, hd = kc.shape
    qd = torch.randn(b, h, hd, generator=gen).to("cuda", torch.bfloat16)
    valid = (slot_pos >= 0) & (slot_pos <= pos[:, None])
    if window is not None:
        valid &= slot_pos > pos[:, None] - window
    n_valid = int(valid.sum())
    kct, vct = (t.transpose(1, 2).contiguous() for t in (kc, vc))
    mask = valid[:, None, None, :]
    shape = (f"B={b} W={w} H={h} KV={kv} hd={hd} bf16"
             + (f" window {window}" if window else "")
             + f", {n_valid} valid slots")

    def kern(plan=None):
        if plan is None:
            return ops.decode_attention(qd, kc, vc, slot_pos, pos,
                                        window=window)
        return da.decode_attention_cuda(qd, kc, vc, slot_pos, pos,
                                        window=window, plan=plan)

    def plain():
        return ref.decode_attention_torch(qd, kc, vc, slot_pos, pos,
                                          window=window)

    err = _timed_err(kern, plain, f"decode_attention at {shape}")
    row = _row(
        "decode_attention", 25, kern, plain, 4 * h * hd * n_valid,
        2 * n_valid * kv * hd * 2 + 2 * 2 * b * h * hd + 4 * b * w + 4 * b,
        launches, err, shape,
        source="decode_attention.cu", replaces="decode_attention.py",
        library=lambda: F.scaled_dot_product_attention(
            qd[:, :, None], kct, vct, attn_mask=mask, enable_gqa=True),
        peak=BF16_FLOPS)
    row["valid_slot_share"] = n_valid / (b * w)
    row["split_plan"] = da.split_plan(
        w, b, kv, torch.cuda.get_device_properties(0).multi_processor_count)
    row["split_sweep"] = []
    for per in SPLIT_SWEEP:
        plan = (-(-w // (da.TILE * per)), per)
        row["split_sweep"].append({
            "splits": plan[0], "tiles_per_split": per,
            "max_abs_err": _timed_err(lambda: kern(plan), plain,
                                      f"decode_attention at {shape}, "
                                      f"plan {plan}"),
            "ms": time_ms(lambda: kern(plan))})
    return row


def attention_timings(ops, ref, da, cache, launches, errs):
    """B4 and B5 at the main paths' shapes, each held against its plain
    version on the inputs it is timed on (that error is the row's
    ``max_abs_err``; ``compare_max_abs_err`` is compare_attention's), beside
    that version, SDPA and its bound (bf16 tensor-core peak against the
    memory rate):
    B4 at qwen3-4b's (1, 2048, 32, 8, 128) causal prefill, and at
    hymba-1.5b's (1, 2048, 25, 5, 64) with its 2048 window; B5 at the
    4-lane qwen3-4b edge's batch cache after serving (``edge_cache``:
    W=4096, 8 KV heads, 32 query heads, its slot positions; random q), and
    at hymba's rolled 4-lane cache (HYMBA_CACHE). The hymba readings go
    into each row under ``hymba_shape``."""
    gen = torch.Generator().manual_seed(31)
    b4 = _flash_row(ops, ref, gen, 1, 2048, 32, 8, 128, None,
                    launches["flash_attention"])
    hymba = _flash_row(ops, ref, gen, 1, 2048, 25, 5, 64, 2048, {})
    b4["hymba_shape"] = {k: hymba[k] for k in SHAPE_KEYS}
    b4["compare_max_abs_err"] = errs["flash_attention"]
    b5 = _decode_row(ops, ref, da, gen, cache, 32, None,
                     launches["decode_attention"])
    b, w, h, kv, hd, dtype, fills, roll, window = HYMBA_CACHE
    hymba = _decode_row(ops, ref, da, gen, _slot_cache(
        gen, b, w, kv, hd, dtype, fills, roll), h, window, {})
    b5["hymba_shape"] = {k: hymba[k] for k in SHAPE_KEYS + (
        "valid_slot_share", "split_plan", "split_sweep")}
    b5["compare_max_abs_err"] = errs["decode_attention"]
    return [b4, b5]


def scan_timing(ops, ref, args, gated, launches, errs):
    """B6 at falcon-mamba's prefill shape (B=1, S=2048, d=8192, N=16). The
    row is the gated entry's, the one the main paths launch, held against
    its plain version on the inputs it times as compare_scan holds it
    (that error is the row's ``max_abs_err``; compare_scan's largest is
    kept as ``compare_max_abs_err``), beside that version and its bound:
    u and dt_raw f32
    and z bf16 read and the output bf16 written, 12 bytes per (t, c), and
    B, C, A, dt_bias and D read and h_last written once; 8 f32 operations
    per (t, c, n), the exponential counted as one, and 9 more per (t, c)
    for the softplus, the D skip and the gate. The bare entry, which no
    main path launches, under ``bare``, held and timed the same way: u and
    dt read and y written, the same 12 bytes per (t, c), and the 8
    operations per (t, c, n). No single
    PyTorch call computes a selective scan, so no library time. The plain
    versions are Python loops of S steps, so few repetitions."""
    u, _, _, _, a = args
    b, s, d = u.shape
    n = a.shape[-1]
    gargs, z = gated
    where = f"timed mamba_scan_gated at {(b, s, d, n)}"
    got, again, want = (ops.mamba_scan_gated(*gargs, z),
                        ops.mamba_scan_gated(*gargs, z),
                        ref.mamba_scan_gated_torch(*gargs, z.float()))
    torch.cuda.synchronize()
    check(all(map(torch.equal, got, again)), f"{where}: two calls differ")
    err = max(_within("out", got[0], want[0], SCAN_TOL, where,
                      BF16_HALF_ULP),
              _within("h_last", got[1], want[1], SCAN_TOL, where))
    where = f"timed mamba_scan at {(b, s, d, n)}"
    got, again, want = (ops.mamba_scan(*args), ops.mamba_scan(*args),
                        ref.mamba_scan_torch(*args))
    torch.cuda.synchronize()
    check(all(map(torch.equal, got, again)), f"{where}: two calls differ")
    bare_err = max(_within("y", got[0], want[0], SCAN_TOL, where),
                   _within("h_last", got[1], want[1], SCAN_TOL, where))
    del got, again, want
    row = _row("mamba_scan", 21, lambda: ops.mamba_scan_gated(*gargs, z),
               lambda: ref.mamba_scan_gated_torch(*gargs, z),
               (8 * n + 9) * b * s * d,
               b * s * d * (4 + 4 + 2 + 2) + 4 * (2 * b * s * n + d * n
                                                  + 2 * d + b * d * n),
               launches, err, f"B={b} S={s} d={d} N={n} f32, z and out bf16",
               source="mamba_scan.cu", replaces="mamba_scan.py", reps=5,
               inner=2)
    bare = _row("mamba_scan", 21, lambda: ops.mamba_scan(*args),
                lambda: ref.mamba_scan_torch(*args), 8 * b * s * d * n,
                4 * (3 * b * s * d + 2 * b * s * n + d * n + b * d * n), {},
                bare_err, f"B={b} S={s} d={d} N={n} f32",
                source="mamba_scan.cu", replaces="mamba_scan.py", reps=5,
                inner=2)
    row["compare_max_abs_err"] = errs["mamba_scan_gated"]
    row["bare"] = {k: bare[k] for k in SHAPE_KEYS}
    row["bare"]["compare_max_abs_err"] = errs["mamba_scan"]
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.core import heuristics, state
    from repro_torch.core import instances as tinst
    from repro_torch.core import objective as obj
    from repro_torch.core import policy as pol
    from repro_torch.core import train as tr
    from repro_torch.kernels import build, ops, policy_score, ref
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models import lm
    from repro_torch.nn import param_count
    from repro_torch import resilience
    from repro_torch import workloads as wl
    from repro_torch.resilience import faults
    from repro_torch.serving import batching
    from repro_torch.serving import engine
    from repro_torch.serving import fastpath as fpm

    # phase 1: the card
    card = card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2: build (one nvcc per source, all started together)
    t0 = time.perf_counter()
    reports = build.build(force=True)
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s", flush=True)
    for src, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}", flush=True)

    # phase 3: policy-head kernels against their plain versions
    errs = {"policy_score": 0.0, "policy_score_decode": 0.0,
            "policy_score_bwd": 0.0, "policy_score_bwd_rel": 0.0,
            "flash_attention": 0.0, "decode_attention": 0.0,
            "mamba_scan": 0.0, "mamba_scan_gated": 0.0}
    buckets = random_cases(fpm.DEFAULT_BUCKETS)
    random = buckets + edge_cases()
    cases = compare_kernels(ops, ref, random, errs)
    bits = compare_score_decode_bits(policy_score,
                                     [x for x in buckets if x[1] == 1])
    ties = compare_decode_ties(ops, ref)
    bwd = compare_backward(policy_score, ref, random + [train_shape_case()],
                           errs)
    mem = memory_check(ops, ref)
    # B1 and B3 at the rollout's shapes: the scale run's round width first
    rollout_arr, arrivals_s = rollout_arrivals(wl)
    width = int(rollout_arr["mask"].shape[-1])
    rollout_cases, rollout_inputs = compare_rollout_shapes(ops, ref, width,
                                                           errs)
    cases += rollout_cases
    print(f"compare: max_abs_err {json.dumps(errs)} over {len(cases)} "
          f"forward and {len(bwd)} backward shapes ({len(rollout_cases)} at "
          f"the rollout's, Z = {width}), {len(ties)} exact-tie "
          f"decodes, B1 = B3 bits at {len(bits)} shapes; memory "
          f"{json.dumps(mem)}", flush=True)

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

    # phase 7: the attention and scan kernels against their plain versions
    attn_cases = compare_attention(ops, ref, errs)
    print(f"compare attention: max_abs_err flash "
          f"{errs['flash_attention']}, decode {errs['decode_attention']} "
          f"over {len(attn_cases)} cases", flush=True)
    scan_cases, scan_args, gated_args = compare_scan(ops, ref, errs)
    print(f"compare scan: {json.dumps(scan_cases)}", flush=True)

    # {kernel: {path: launches}} from each main-path run
    launches = {}

    def record(path, counts):
        for name, n in counts.items():
            if n:
                launches.setdefault(name, {})[path] = n

    record("serving", summary["launches"])
    record("training", training["launches"])

    # phase 6a: the rollout engine on the card against the CPU at Q = 5
    t0 = time.perf_counter()
    eng_parity = engine_parity(engine, wl, faults, resilience)
    eng_parity_s = time.perf_counter() - t0
    print(f"engine parity ({eng_parity_s:.1f} s): {json.dumps(eng_parity)}",
          flush=True)

    # phase 6b: the scale run, B3 and then B1 once per round for 256
    # instances of a 100-edge cluster at full policy width
    t0 = time.perf_counter()
    rollout, rollout_counts = drive_rollout(pol, engine, policy_score, ref,
                                            rollout_arr)
    rollout_s = time.perf_counter() - t0
    for backend, r in rollout.items():
        print(f"rollout {backend}: {json.dumps(r)}", flush=True)
        record("rollout", rollout_counts[backend])
    del rollout_arr
    torch.cuda.empty_cache()

    # phase 8: the LM edge servers at full width (qwen3-4b, bf16)
    cfg = get_config(LM_ARCH)
    params = lm.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(LM_SEED))
    lm_serving, edges = drive_lm_serving(cfg, params, lm, batching, state,
                                         heuristics, build, ref, ops)
    print(f"lm serving: {json.dumps(lm_serving)}", flush=True)
    record("lm_serving", lm_serving["launches"])

    # phase 9: the kernel path against the plain path at full width
    lm_parity = lm_kernel_vs_plain(cfg, params, lm, ops, ref)
    print(f"lm kernel vs plain: {json.dumps(lm_parity)}", flush=True)

    # phase 10: device busy and idle share of the LM steps; then free it,
    # keeping the 4-lane edge's cache for B5's timing
    lm_profile = profile_lm(cfg, params, lm, edges[2])
    print(f"lm profile: {json.dumps(lm_profile)}", flush=True)
    qwen3_cache = edge_cache(edges[2])
    del params, edges
    torch.cuda.empty_cache()

    def serve_lm(label, arch, prompt_len, scan_ulp=False):
        """Serve, profile and check one model's kernel path against its
        plain path, then free it."""
        cfg = get_config(arch)
        params = lm.init_params(cfg, generator=torch.Generator(
            device="cuda").manual_seed(LM_SEED))
        served, edges = drive_lm_serving(cfg, params, lm, batching, state,
                                         heuristics, build, ref, ops)
        print(f"{label} lm serving: {json.dumps(served)}", flush=True)
        record(f"{label}_lm_serving", served["launches"])
        profiled = profile_lm(cfg, params, lm, edges[2])
        print(f"{label} lm profile: {json.dumps(profiled)}", flush=True)
        del edges
        torch.cuda.empty_cache()
        parity = lm_kernel_vs_plain(cfg, params, lm, ops, ref,
                                    prompt_len=prompt_len, scan_ulp=scan_ulp)
        print(f"{label} lm kernel vs plain: {json.dumps(parity)}", flush=True)
        del params
        torch.cuda.empty_cache()
        return {"serving": served, "profile": profiled,
                "kernel_vs_plain": parity}

    # phase 11: SSM edge serving (falcon-mamba-7b, B6 in every layer)
    ssm_lm = {LM_SSM_ARCH: serve_lm("ssm", LM_SSM_ARCH, LM_SSM_PROMPT,
                                    scan_ulp=True)}
    # phase 12: hybrid edge serving (hymba-1.5b: B4, B5 windowed; B6)
    ssm_lm[LM_HYBRID_ARCH] = serve_lm("hybrid", LM_HYBRID_ARCH,
                                      LM_HYBRID_PROMPT)

    # phase 13: the policy head's device time per launch; every kernel timed
    # beside its plain version; the kernels line
    head_split = policy_head_split(ops, policy_score, enc, enc_train)
    print(f"policy head launch split: {json.dumps(head_split)}", flush=True)
    kernels = timings(ops, ref, policy_score, enc, enc_train, launches, errs,
                      rollout_inputs[0])
    kernels += attention_timings(ops, ref, da, qwen3_cache, launches, errs)
    kernels.append(scan_timing(ops, ref, scan_args, gated_args,
                               launches["mamba_scan"], errs))

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "card": card, "build_s": build_s, "main_path": summary,
        "gradient_parity": parity, "training": training,
        "compare": cases, "compare_score_decode_bits": bits,
        "compare_decode_ties": ties,
        "compare_backward": bwd, "memory": mem,
        "policy_head_split": head_split,
        "compare_attention": attn_cases, "lm_serving": lm_serving,
        "lm_kernel_vs_plain": lm_parity, "lm_profile": lm_profile,
        "compare_scan": scan_cases, "ssm_lm": ssm_lm,
        "engine_parity": eng_parity, "rollout": rollout,
        "rollout_arrivals_s": arrivals_s, "engine_parity_s": eng_parity_s,
        "rollout_s": rollout_s,
        "kernels": kernels}, indent=1))

    print(json.dumps({"decision_ms": summary["decision_ms"],
                      "train_step_ms": training["step_ms"],
                      "train_data_ms": training["data_ms"],
                      "train_instances_per_s": training["instances_per_s"],
                      "train_profile": {k: training["profile"][k] for k in
                                        ("wall_ms", "device_busy_ms",
                                         "idle_share", "kernels_per_unit")},
                      "lm_decode_step_ms": lm_serving["decode_step_ms"],
                      "lm_decode_tokens_per_s":
                          lm_serving["decode_tokens_per_s"],
                      "lm_max_memory_allocated_bytes":
                          lm_serving["max_memory_allocated_bytes"],
                      "lm_profile": {k: {m: v[m] for m in
                                         ("wall_ms", "device_busy_ms",
                                          "idle_share", "kernels_per_unit")}
                                     for k, v in lm_profile.items()},
                      "ssm_lm": {arch: {
                          "decode_step_ms": r["serving"]["decode_step_ms"],
                          "decode_tokens_per_s":
                              r["serving"]["decode_tokens_per_s"],
                          "max_memory_allocated_bytes":
                              r["serving"]["max_memory_allocated_bytes"]}
                          for arch, r in ssm_lm.items()},
                      "rollout": {backend: {
                          k: r[k] for k in ("rollout_wall_ms", "ms_per_round",
                                            "request_rounds_per_s",
                                            "peak_memory_bytes")}
                          | {k: r["profile"][k] for k in (
                              "device_busy_ms", "idle_share",
                              "kernels_per_unit", "head_device_ms")}
                          for backend, r in rollout.items()},
                      "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
