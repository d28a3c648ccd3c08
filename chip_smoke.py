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
6c. temporal REINFORCE on engine rollouts (``temporal_train``) at full
   policy width, B1 forward and B2 backward once per round of every update:
   (a) the host loop at ``TemporalRLConfig()``'s defaults (``PolicyConfig()``,
   Q = 5, 12 rounds of 0.25 s, 16 slots a round, B = 16, uniform_iid);
   (b) the same on device episodes, two epochs of 8 updates; (c) the
   resilient trainer's config (chaos-rolling-failure, the admit head,
   64 slots a round, SLO 3 s with penalty 10, dispatch frozen, B = 8) on
   device episodes; (d) three updates on 16 of 6b's 256 instances (Q =
   100) with 6b's arrivals. On each path B1 and B2 launch 12 times per
   update and nothing else of the head, no plain head is reached, every
   metric is finite, requests complete and the parameters move (on (c)
   only the admit head's). Also: B1 (and B3) and B2 against their plain
   versions at (16, 5, 16), (8, 5, 64) and (16, 100, 6b's width), the
   same bits on two calls; one update of (a) through the kernels against
   plain autograd with the same injected actions (phase 5's tolerances);
   the device samplers' laws on the card (Poisson count moments against
   the law and the host sampler, the sizes' KS test, the exact clip
   contract, MMPP's transient round means, scripted fault rows equal to
   the host's, fail/recover rates); host against device episode time; a
   torch.profiler trace of two updates (device busy, idle share, launches
   per update, B1's and B2's device ms); and a save -> resume on the card
   (epoch path, K = 3, checkpoints every 2) bit-identical to the
   uninterrupted run;
6d. the serving host side, the paper's Fig. 2 loop (``drive_serving_host``):
   ``launch.train corais`` at ``RLConfig()``'s full width for 4 batches
   with checkpoints every 2, then again on the same directory, resuming
   at the batch after the last checkpoint: B1 and B2 once per batch, the
   manifest holding every leaf of ``train_tree``, the resumed parameters
   bit-identical to the same batches run in memory; ``launch.serve
   --scheduler corais`` on that checkpoint over a 100-edge cluster (2,000
   requests in 5 s, edge 0 failing at 2 s, edge 1 a straggler at 8x):
   every request completes and B1 launches once per non-empty round; the
   same flow in process through B1, through B3 (``fused_decode=True``,
   K = 1) and ``"corais-sample"`` (B3 at K = Q), each round's padded
   snapshot recorded: greedy decisions equal the plain head's above the
   gap and a sampled decision costs no more than its greedy candidate;
   decision mean, p95 and max, rounds, simulator wall per arrival round
   and a round's split between ``snapshot_instance``, staging and the
   decision; chaos-rolling-failure's fault rows at Q = 100 pushed by
   ``schedule_into_sim`` with nothing lost; and the port's engine on the
   card against the port's simulator as its oracle (``ORACLE_CASES``:
   finish times and features within 1e-4, completions per round exact);
6e. the fleet and data parallelism (``drive_fleet_data_parallel``): a
   world of one on NCCL through ``make_fleet_mesh()`` (the backend must be
   ``nccl``); the fleet rollout (``make_fleet_rollout``) at 6b's shape
   through B3 and then B1, each once per round for the batch with no
   plain head reached, its all-reduced partials held to 6b's
   single-device rollout (integers exact, floats within 1e-5 relative),
   wall ms (median of 3) beside 6b's; the sharded epoch step
   (``make_temporal_epoch_step(mesh=)``) at path (d)'s shape (Q = 100,
   B = 16, 6b's width, K = 2, device episodes) against the meshless one
   on the same seeds: B1 and B2 once per round of each update, parameters
   within 1e-5, metrics within 1e-4, per-update ms p50 of both;
7. hold the attention kernels B4 (flash attention) and B5 (decode
   attention) against their plain versions at qwen3-4b, olmo-1b,
   hymba-1.5b, mixtral-8x7b (a 4500-token prompt past its 4096 window, its
   rolled 4-lane cache) and qwen2-vl-72b (64 query heads) head shapes,
   bf16 and f32, ragged lengths (S = 1, 63, 65),
   bf16 head widths 16 to 128, windows causal and not, rolling caches
   (hymba's 4-lane cache past its 2048 window), a lane with no valid
   slot, one lane over 4096 slots and W = 1; each bit for bit across two
   calls; at every B5 case (qwen3-4b's 4-lane cache and the empty lane
   among them) B5 asked for its log-sum-exp (``compare_decode_lse``): the
   output the same bits, the lse within 1e-5 of the largest |lse| of its
   plain version and -1e30 exactly on an empty lane; whisper's shapes
   (``compare_cross_attention``): B4 non-causal over its encoder's (8,
   1500, 6, 64), and with keys of their own length (Sq in 1, 4, 65, 448
   against Sk in 63, 1500), bf16 and f32, its lse
   against the plain one, ``FlashAttention``'s gradients at (16, 448 |
   1500, 6, 64) and (16, 1500 | 1500) against autograd through the plain
   version (12b's bars), and the one-token cross attention through B5 on
   the frames' slot map against the plain unmasked attention; and
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
   dispatch of 18 requests (256-2560 prompt tokens, 16
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
12b. LM pretraining (``drive_lm_training``): (a) B4's log-sum-exp against
    its plain version within 1e-5 of max |lse| and its output with the lse
    store the same bits as without, and (b) ``FlashAttention``'s gradients
    (B4 forward, the reference's pair-scan backward) against autograd
    through the plain version (f32 1e-4, bf16 2^-6 of each gradient's
    largest entry), at olmo-1b's training heads (8, 1024, 16, 16, 128) in
    bf16 and f32, qwen3-4b's GQA heads and a ragged S = 65, causal and
    windowed, every reading the same bits twice; (c) ``launch.train lm
    --arch olmo-1b --scale full`` (16 layers, d = 2048, bf16, remat
    "full", random weights from the seed) for 12 steps of 8 x 1024
    tokens in process: losses and grad norms finite, the last three steps'
    mean below step 0's, B4 exactly 32 times a step, B5 and B6 never, no
    plain version of B4-B6 reached; step wall p50/p95 over steps 2-11,
    tokens/s, peak memory and one profiled step (device ms by kind and by
    piece: the pair-scan backward, the clip, Adam); (d) olmo-1b's widths
    at 2 layers in f32, ``train_loss`` through the kernel path against the
    plain path (loss 1e-5 relative, every gradient 1e-4 of its largest
    entry); (e) the same widths at 2 layers in bf16: 6 steps, and 4 with a
    checkpoint after step 3, dropped, restored bit for bit and resumed to
    step 6 within 1e-3 of the uninterrupted losses (under the git-ignored
    ``build/chip_smoke_lm_ckpt/``, removed after);
12c. SSM and hybrid LM training (``drive_ssm_training``): (a) B6b, the
    backward of B6's gated entry, from the chunk states B6 stores, against
    its plain version (every gradient within 1e-4 of its largest entry in
    f32, 2^-6 for dz in bf16) at hymba-1.5b's (8, 1024, 3200, 16) and
    falcon-mamba-7b's (8, 1024, 8192, 16) training shapes, a ragged S = 65
    and N = 4, z in bf16 and f32, dh_last zero and seeded, some dt_raw
    above softplus's threshold; the same bits twice; B6's output the same
    bits with the state store and without; (b) ``launch.train lm --arch
    hymba-1.5b --scale full`` (32 layers, d = 1600, bf16, remat "full") for
    12 steps of 8 x 1024 tokens in process: losses and grad norms finite,
    the last three steps' mean below step 0's, per step B6 64, B6b 32 and
    B4 64 launches, B5 none, no plain version of B4-B6 or B6b reached; step
    p50/p95, tokens/s, peak memory and a profiled step (device ms by kind:
    B4, B6, B6b, GEMM, element-wise); (c) the same for falcon-mamba-7b at
    full width cut to 8 of its 64 layers (B6 16, B6b 8, B4 none a step);
    (d) both at their widths and 2 layers in f32: ``train_loss`` through
    the kernels against the plain path (loss 1e-5 relative, every gradient
    1e-4 of its largest entry);
12d. mixtral-8x7b (``drive_moe_lm``): ``CONFIG`` cut to 24 of its 32
    layers (35.1 B parameters, bf16, random weights from the seed), served
    with phase 8's flow and sizes (16 generated tokens a request), then
    one 4500-token request on a fourth edge with 8192 slots a lane, whose
    cache must be the rolling one: B4 24 times per admission, B5 24 times
    per decode step, B6 never, no plain version reached; a profiled
    2048-token prefill and 4-lane decode step (device ms by kind: B4, B5,
    index, GEMM, element-wise; and the MoE layer's expert products apart
    from its routing, dispatch and combine); a 1500-token request with 16
    teacher-forced steps through the kernel and the plain path, the plain
    run's routes forced on the kernel run: bf16 logits within 0.1 at full
    depth (the routes that would differ reported), at the widths with 2 layers
    in bf16 (0.1; a differing route's plain gap within 0.03 of its token's
    largest |router logit|) and with 8 layers in f32 (1e-3; GAP);
12e. the qwen2-vl-72b backbone (``drive_vlm_lm``): ``CONFIG`` cut to 32 of
    its 80 layers (bf16), one prefill of two 2048-token prompts of patch
    embeddings (128 text tokens, a 40 x 44 image, text) with (3, B, S)
    M-RoPE positions whose rows differ, then 16 greedy decode steps with
    their position rows: B4 32 times in the prefill, B5 32 times a step,
    B6 never, no plain version reached; the same profile; the kernel path
    against the plain path on a 1500-token prompt with a 30 x 40 image
    (bf16 0.1 at full depth; f32 1e-3 at 8 layers);
12f. whisper-tiny (``drive_whisper_lm``): ``CONFIG`` (4 encoder and 4
    decoder layers, d 384, bf16, random weights from the seed; nothing
    cut): ``build_prefill`` on 8 utterances of 1,500 random frame
    embeddings and a 4-token prompt into 448-slot caches, then 64 greedy
    ``build_decode_step``s: B4 12 times in the prefill (4 encoder, 4
    decoder self, 4 cross), B5 8 times a step (4 self, 4 cross over the
    frames), B6 never, no plain version reached; prefill ms, step p50/p95,
    a profiled prefill and 5 steps; kernel vs plain at full depth over the
    prefill and 16 teacher-forced steps (f32 1e-3, bf16 0.1 of the largest
    |logit|); ``build_train_step`` (Adam, remat "full") for 12 steps of 16
    utterances x (1,500 frames, 448 tokens): losses and grad norms finite,
    the loss falling, B4 24 times a step, step p50/p95, utterances/s, peak
    memory, a profiled step; in f32 at full width ``train_loss`` through
    the kernels against the plain path (loss 1e-5 relative, every gradient
    1e-4 of its largest entry);
12g. MoE training (``drive_moe_training``): ``launch.train lm --arch
    mixtral-8x7b --scale full`` cut to 2 of its 32 layers (3.2 B
    parameters) for 12 steps of 8 x 1024 tokens: losses, aux losses and
    grad norms finite, the loss falling, B4 4 times a step, B5 and B6
    never, no plain version reached; step p50/p95, tokens/s, peak memory,
    a profiled step with the MoE layer's pieces; three steps run twice
    from the seed give the same bits in every parameter; at 2 layers in f32
    on 2 x 256 tokens, the plain run's routes forced, ``train_loss``
    through the kernels against the plain path (loss 1e-5 relative,
    ``aux_loss`` and every gradient 1e-4);
12h. the LM's sharding (``drive_sharded_lm``): ``make_host_mesh(1)``, a
    ("data", "model") mesh of (1, 1) over phase 6e's NCCL world of one;
    olmo-1b ``CONFIG`` trained 3 steps of 8 x 1024 tokens (Adam, remat
    "full") meshless and through the sharded ``build_train_step`` from the
    same weights and batches: every parameter, Adam slot and loss the same
    bits, B4 twice per layer a step; qwen3-4b ``CONFIG`` with
    ``decode_flash_shardmap``: a 2048-token prefill on 4 lanes and 16
    decode steps through the sharded ``build_prefill`` and
    ``build_decode_step`` against the meshless ones (the logits within
    1e-3 of the largest |logit|, the largest difference printed), B4 once
    per layer in the prefill and B5 with its lse once per layer a step
    (the flash-decode on every layer, no redistribution of the cache for
    B5); ``sharded_decode_attention`` on the last cache's layer 0 against
    its plain version (the reference's local body) and B5's; step p50 and
    host ms beside the meshless path's, DTensor's host cost a step and the
    redistributions a step makes; the launches go under ``sharded_lm``;
15. (run after 12h, before 13, whose kernels line counts its launches)
    elastic restart and the example twins (``drive_elastic``): (a)
    ``repro_torch.launch.elastic.run_phase`` at olmo-1b ``CONFIG`` (bf16)
    cut to 2 of its 16 layers with the reference's elastic batch of 8 x 32
    tokens and Adam at 1e-3, each phase a subprocess of this script
    (``--elastic-child``) on a (1, 1) NCCL mesh of its own: phase A 4 steps
    from the seed and a checkpoint (~3.4 GB under the git-ignored
    ``build/chip_smoke_elastic/``), phase B restoring it in a fresh
    process (every leaf the saved bits) and 4 more steps, and a third
    process, beside phase B (phase A runs alone), 8 steps without a
    break: the 8 losses and every parameter and
    Adam slot of the final checkpoints the same bits; B4 twice per layer a
    step, no other kernel, no plain version of B4-B6 or of B4's and B5's
    lse; (b) phase A's checkpoint restored onto 4 gloo CPU ranks on a
    (2, 2) mesh (subprocesses with no card in view, one thread each,
    420 s, started beside phase A, restoring beside phase B): each rank's
    blocks its spec's slice of
    the file bit for bit, one step's loss finite, the same on every rank
    and within 1e-2 relative of phase B's first (the reading printed
    beside the bar); (c) the four example twins in process at their
    reference defaults (quickstart, workload_replay, train_lm,
    serve_multi_edge), each ending on its own line, B1, B2, B4 and B5
    launched and no plain version reached, after phase B; prints
    the checkpoint's bytes, the save (gather + write) and restore (read +
    place) seconds and the step p50 before and after the restore beside
    the card's name and power limit; the launches go under ``elastic``
    (phases A and B) and ``examples``;
13. print the device time per launch of B1 (the serving and training
    shapes), B3 (K = 1 and the sampled path's K = Q = 100) and B2
    (``launch_split``, a torch.profiler trace); then
    time each kernel, its plain version and, for B4 and B5, PyTorch's
    ``scaled_dot_product_attention`` (CUDA events; B1 and B3 at the serving
    shape 100x1000, B1 also at the training shape under ``train_shape``,
    B3 also at K = Q = 100 normalized under ``sampled``, B2
    at the training shape, B4 at qwen3-4b's and
    hymba-1.5b's 2048-token prefills and, storing its lse, olmo-1b's
    training shape (with the pair-scan backward beside SDPA's backward
    there), at mixtral-8x7b's 2048-token prefill and a 4500-token one past
    its window and at qwen2-vl-72b's (2, 2048) prefill, B5 at the 4-lane
    qwen3-4b edge's cache after serving (there also with its lse, beside
    B5 without it, under ``with_lse``), at hymba's and mixtral's rolled
    4-lane caches and at phase 12e's cache, B4 at whisper's encoder and
    cross shapes (the prefill's 4 rows and training's 448, with lse) and
    B5 on its frames' slot map, B6's gated
    entry (the one the main paths launch) and its bare entry at
    falcon-mamba's prefill shape, and storing its chunk states at
    hymba-1.5b's training shape, and B6b there) beside their bounds, and
    print the ``{"kernels": [...]}`` line (seven rows, each with its
    launches on every main path above, the rollout's, temporal training's,
    the serving host side's, phase 6e's (``fleet``, ``data_parallel``)
    and phases 12d's to 12h's (``moe_lm_serving``, ``vlm_lm``,
    ``whisper_lm_serving``, ``whisper_lm_training``, ``moe_lm_training``,
    ``sharded_lm``) and phase 15's (``elastic``, ``examples``; every row
    names both, 0 where the path does not launch it) included;
    B1 and B2 also timed at the temporal shapes, under
    ``temporal_shapes``).

The last line of standard output is the ``{"ok": true, "device": ...}``
summary. Details of every comparison go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
# the kernels' torch.library ops (registered when repro_torch.kernels is
# imported): every kernel-against-plain comparison of B4-B6b calls them
LIB = torch.ops.repro_torch
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
LM_GEN = 16            # generated tokens per dispatched request
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
# mixtral-8x7b's 4-lane decode cache (its window 4096 = W): three lanes
# rolled past the window (positions 404-4499, 4097-8192 and 1-4096), one
# partly filled; G*hd = 512. Compared in phase 7, timed in phase 13.
MIXTRAL_CACHE = (4, 4096, 32, 8, 128, torch.bfloat16, (0, 0, 1500, 0),
                 (404, 4097, None, 1), 4096)
# phase 12d: mixtral-8x7b CONFIG cut to 24 of its 32 layers (24 x 2.90 GB
# of bf16 weights, with the embedding, lm_head and each edge's f32 head
# about 72 GB of the card's 80), served with phase 8's flow and sizes,
# MOE_GEN generated tokens a request (the decode steps are what the phase's
# time is taken from); one MOE_LONG_PROMPT-token request on a fourth edge
# with MOE_LONG_MAX_SEQ slots a lane takes the rolling cache
MOE_ARCH = "mixtral-8x7b"
MOE_LAYERS = 24
MOE_GEN = 16
MOE_LONG_PROMPT = 4500
MOE_LONG_MAX_SEQ = 8192
# kernel vs plain at full width, bf16; then at the widths with
# LM_F32_LAYERS layers in f32 (f32 at 24 layers would be 139 GB; at 8 it
# is 46 GB, in place of the bf16 layers) and, for mixtral, MOE_ROUTE_LAYERS
# layers in bf16. The plain run's routes are forced on the kernel run (as
# tokens are teacher-forced), and in the cut runs a (token, layer) route
# that the kernel run would choose otherwise must be a near-tie: the plain
# run's logit gap between the two experts within MOE_ROUTE_GAP of the
# token's largest |router logit|. In f32 that is GAP. In bf16 at 2 layers
# it is 0.03, twice the largest gap read there on an H100 (0.0143, 18 of
# 3,032 routes) and below the 90th percentile at full depth (0.063;
# PERF.md §6). At full depth in bf16 the routes are reported, not barred:
# the bf16 hidden states drift apart over the layers (9.4 % of the logits
# on an H100), so flips there are not confined to near-ties; PyTorch's
# scaled_dot_product_attention in place of B4 and B5 drifts as far (10.3 %,
# PERF.md §6), so the drift is bf16's, not the kernels'
LM_F32_LAYERS = 8
MOE_ROUTE_LAYERS = 2
MOE_ROUTE_GAP = {"float32": GAP, "bfloat16": 0.03}
# phase 12e: qwen2-vl-72b's backbone CONFIG cut to 32 of its 80 layers (32 x
# 1.76 GB, with the embedding, lm_head and the f32 head 66 GB); VLM_BATCH
# prompts of VLM_TEXT text tokens, a VLM_GRID image of patch embeddings and
# the rest text, then VLM_DECODE decode steps
VLM_ARCH = "qwen2-vl-72b"
VLM_LAYERS = 32
VLM_BATCH = 2
VLM_PROMPT = 2048
VLM_TEXT = 128
VLM_GRID = (40, 44)
VLM_DECODE = 16
VLM_PARITY_GRID = (30, 40)   # kernel vs plain: a 1500-token prompt
# phase 12f: whisper-tiny CONFIG (4 encoder and 4 decoder layers, d 384, 6
# heads of 64, vocab 51,865, bf16, random weights from the seed; nothing
# cut): WHISPER_BATCH utterances of WHISPER_FRAMES random frame embeddings
# and a WHISPER_PROMPT-token prompt into caches of WHISPER_SLOTS slots
# (whisper's text context), WHISPER_DECODE greedy decode steps; kernel vs
# plain on WHISPER_PARITY_BATCH utterances and 16 teacher-forced steps;
# training: WHISPER_TRAIN_BATCH utterances x (WHISPER_FRAMES frames,
# WHISPER_SLOTS tokens) a step for TRAIN_LM_STEPS steps, Adam, remat
# "full"; kernel vs plain ``train_loss`` in f32 on WHISPER_PARITY_BATCH
WHISPER_ARCH = "whisper-tiny"
WHISPER_BATCH = 8
WHISPER_FRAMES = 1500
WHISPER_PROMPT = 4
WHISPER_SLOTS = 448
WHISPER_DECODE = 64
WHISPER_PARITY_BATCH = 2
WHISPER_TRAIN_BATCH = 16
# phase 7: whisper's cross attention, decoder rows against frames, and its
# training shapes for FlashAttention's gradients (B, Sq, Sk, dtype)
WHISPER_CROSS_SQ = (1, 4, 65, 448)
WHISPER_CROSS_SK = (63, 1500)
WHISPER_BWD_CASES = ((16, 448, 1500, torch.float32),
                     (16, 448, 1500, torch.bfloat16),
                     (16, 1500, 1500, torch.bfloat16))
# phase 12g: mixtral-8x7b CONFIG trained through ``train lm`` cut to
# MOE_TRAIN_LAYERS of its 32 layers (3.2 B parameters; bf16 weights and
# gradients and f32 Adam moments ~38 GB: the 32 layers need ~600 GB);
# MOE_RERUN_STEPS steps twice from the seed, the parameters compared bit
# for bit; kernel vs plain in f32 at MOE_TRAIN_LAYERS layers on
# MOE_PARITY_BATCH x MOE_PARITY_SEQ tokens, the plain run's routes forced
MOE_TRAIN_LAYERS = 2
MOE_RERUN_STEPS = 3
MOE_PARITY_BATCH, MOE_PARITY_SEQ = 2, 256
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
# phase 6c, temporal training: path (a) host-loop updates (the first a
# warm-up), path (b) two epochs of TEMPORAL_EPOCH_LEN updates on device
# episodes, path (c) the resilient config's epochs, path (d) updates on 16
# of 6b's 256 instances; B1 and B2 also at the trainer's (B, Q, Z) shapes
TEMPORAL_HOST_UPDATES = 6
TEMPORAL_EPOCH_LEN = 8
TEMPORAL_CHAOS_EPOCH_LEN = 4
TEMPORAL_EPOCHS = 2
TEMPORAL_SCALE_BATCH = 16
TEMPORAL_SCALE_UPDATES = 3
TEMPORAL_PROFILE_UPDATES = 2
TEMPORAL_SHAPES = ((16, 5, 16), (8, 5, 64))
# the device samplers' laws on the card: batch, and the band in standard
# errors of the samples' own spread
SAMPLER_BATCH = 4096
SAMPLER_SE = 5.0
# phase 6d, the serving host side (the paper's Fig. 2 loop): ``train
# corais`` at RLConfig()'s full width for SERVE_TRAIN_BATCHES batches with
# checkpoints every SERVE_CKPT_EVERY, run twice on one directory (the
# second resumes); then ``serve --scheduler corais`` over the paper's
# largest cluster at phase 6b's rate (4 requests/s per edge: SERVE_REQUESTS
# over SERVE_WINDOW s, ~100 briefs in each of 20 arrival rounds of 0.25 s)
# with edge 0 failing at 2 s and edge 1 a straggler at 8x. SERVE_UNTIL is
# the simulated horizon H: a CPU run of this flow and seed (the port's
# simulator; PolicyConfig() untrained, and greedy) completed every request
# by 108.4 s and 63.1 s of simulated time.
SERVE_EDGES = 100
SERVE_REQUESTS = 2000
SERVE_WINDOW = 5.0
SERVE_DT = 0.25
SERVE_UNTIL = 240.0
SERVE_FAIL = (0, 2.0)
SERVE_STRAGGLE = (1, 8.0)
SERVE_TRAIN_BATCHES = 4
SERVE_CKPT_EVERY = 2
SERVE_FAULT_SCENARIO = "chaos-rolling-failure"
# the port's engine on the card against the port's simulator as its oracle
# (phi pinned, no execution noise), the scripted hash assignment:
# tests/test_engine.py's four trace scenarios, one chaos scenario and
# cloud-cache-churn (4 edges + the cloud, 16 rounds, seed 3, as
# tests/test_cloud.py), finish times within 1e-4 (+1e-5 relative),
# completion buckets exact, workload features within 1e-4
ORACLE_CASES = (("uniform_iid", 5, 12, 0), ("flash_crowd_10x", 5, 12, 0),
                ("mmpp_bursty", 5, 12, 0), ("heavy_tail_pareto", 5, 12, 0),
                ("chaos-rolling-failure", 5, 12, 0),
                ("cloud-cache-churn", 4, 16, 3))
ORACLE_DRAIN = 120.0   # simulated s: every case drains by then (checked)
ORACLE_TOL = 1e-4
# phase 6e, the fleet and data parallelism on a world of one (NCCL): the
# fleet rollout at 6b's shape through B3 and B1, held to 6b's single-device
# rollout (counts and histograms exact, floats to FLEET_TOL relative); the
# sharded epoch step at path (d)'s shape (Q = 100, B = 16, 6b's width),
# DP_EPOCH_LEN updates a call, held to the meshless epoch step on the same
# seeds (parameters to DP_PARAM_TOL, metrics to DP_METRIC_TOL), timed over
# DP_TIMED_CALLS calls
FLEET_TOL = 1e-5
DP_EPOCH_LEN = 2
DP_TIMED_CALLS = 3
DP_PARAM_TOL = 1e-5
DP_METRIC_TOL = 1e-4


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


def _device_summary(prof, n, wall_ms, skip=(), kinds=KERNEL_KINDS):
    """Device busy ms, idle share, kernels, device ms by kind (``kinds``)
    and the heaviest kernels per unit of work (a decision or a step) from a
    torch.profiler trace of ``n``. ``skip``: names of ``record_function``
    ranges, whose spans the trace also lists on the device."""
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA") and e.key not in skip]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    def kind(e):
        return next((k for k, marks in kinds
                     if any(m in e.key for m in marks)), "other")

    busy_ms = sum(dev_us(e) for e in kernels) / 1e3 / n
    by_kind = {k: 0.0 for k, _ in kinds + (("other", ()),)}
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
                  rounds=ROLLOUT_ROUNDS, partials=None):
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

    Returns {backend: report} and {backend: launch counts}; with a dict
    ``partials``, each backend's final state's ``summarize_partials`` goes
    there (phase 6e holds the fleet rollout to them)."""
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
        if partials is not None:
            partials[backend] = engine.summarize_partials(final)
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


# -- phase 6c: temporal training on engine rollouts --------------------------


def temporal_cases(width):
    """B1 and B2 at the temporal trainer's shapes (TEMPORAL_SHAPES, the
    scale path's Z the 6b round width), random inputs and partial masks."""
    gen = torch.Generator().manual_seed(17)
    cases = []
    for b, q, z in TEMPORAL_SHAPES + ((TEMPORAL_SCALE_BATCH, ROLLOUT_EDGES,
                                       width),):
        valid = [q] * (b - 2) + [1, max(1, q - q // 3)]
        cases.append(("temporal", b, q, z, *_inputs(gen, b, q, z,
                                                    valid=valid)))
    return cases


def compare_temporal_shapes(ops, ref, policy_score, cases, errs):
    """B1 (and B3, compare_kernels) and B2 against their plain versions at
    the temporal shapes, each the same bits on two calls."""
    fwd = compare_kernels(ops, ref, cases, errs)
    for _, b, q, z, c, h, wx, wy, mask in cases:
        check(torch.equal(ops.policy_score(c, h, wx, wy, mask),
                          ops.policy_score(c, h, wx, wy, mask)),
              f"policy_score differs between two calls at {(b, q, z)}")
    return {"forward": fwd,
            "backward": compare_backward(policy_score, ref, cases, errs)}


def _chaos_config(tr, pol, engine):
    """Path (c): the resilient trainer's config (benchmarks/common.py:
    150-166) on device episodes, TEMPORAL_CHAOS_EPOCH_LEN updates an
    epoch."""
    return tr.TemporalRLConfig(
        policy=pol.PolicyConfig(admit_head=True, admit_bias=1.0),
        engine=engine.EngineConfig(max_per_round=64),
        scenario="chaos-rolling-failure", batch_size=8, lr=1e-3,
        admission=True, slo=3.0, slo_penalty=10.0, freeze_dispatch=True,
        device_episodes=True, epoch_len=TEMPORAL_CHAOS_EPOCH_LEN)


def _plain_head_guard(ref):
    """Patches that make the policy head's plain versions raise."""
    return [_refuse(ref, n, "the plain") for n in (
        "policy_score_torch", "policy_score_bwd_torch",
        "policy_score_decode_torch")]


TEMPORAL_METRICS = ("loss", "grad_norm", "cost_mean", "cost_best", "entropy",
                    "completed", "shed")


def _temporal_checks(label, hist, launched, updates, rounds, moved,
                     admit_only=False):
    """Phase 6c's checks on one path's run: B1 and B2 launched once per
    round of every update and nothing else of the head, every metric
    finite, requests completed, the parameters moved (only the admit head
    where dispatch is frozen)."""
    want = updates * rounds
    check(launched["policy_score"] == want
          and launched["policy_score_bwd"] == want
          and sum(launched.values()) == 2 * want,
          f"temporal {label}: launched {launched} in {updates} updates of "
          f"{rounds} rounds; B1 and B2 must launch once per round")
    check(len(hist) == updates, f"temporal {label}: {len(hist)} history rows "
          f"for {updates} updates")
    for row in hist:
        check(all(math.isfinite(v) for v in row.values()),
              f"temporal {label}: non-finite metrics at batch "
              f"{row['batch']}: {row}")
        check(row["completed"] > 0, f"temporal {label}: nothing completed "
              f"at batch {row['batch']}")
    names = [k for k in moved if moved[k]]
    check(bool(names), f"temporal {label}: no parameter moved")
    if admit_only:
        check(all(k.startswith("admit/") for k in names)
              and any(k.startswith("admit/") for k in moved),
              f"temporal {label}: parameters outside the admit head moved: "
              f"{[k for k in names if not k.startswith('admit/')]}")
    return len(names)


def drive_temporal(pol, tr, ref, policy_score, cfg, label, num_batches,
                   device="cuda"):
    """One temporal path through ``temporal_train`` at full policy width:
    the launch counters set to 0 just before and read just after, the
    plain heads patched to raise. Returns (report, launches, policy)."""
    from repro_torch.nn import param_tree
    policy = pol.CoRaiSPolicy(cfg.policy,
                              generator=torch.Generator().manual_seed(cfg.seed),
                              device=device)
    before = {k: p.detach().clone() for k, p in param_tree(policy).items()}
    with contextlib.ExitStack() as stack:
        for guard in _plain_head_guard(ref):
            stack.enter_context(guard)
        policy_score.reset_launch_counts()
        t0 = time.perf_counter()
        policy, _, hist = tr.temporal_train(cfg, num_batches=num_batches,
                                            policy=policy)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launched = dict(policy_score.LAUNCHES)
    moved = {k: not torch.equal(p.detach(), before[k])
             for k, p in param_tree(policy).items()}
    n_moved = _temporal_checks(label, hist, launched, num_batches,
                               cfg.engine.num_rounds, moved,
                               admit_only=cfg.freeze_dispatch)
    sec = [row["sec"] * 1e3 for row in hist]
    steady = sec[1:] if len(sec) > 1 else sec
    return {
        "config": {"B": cfg.batch_size, "Q": cfg.engine.num_edges,
                   "rounds": cfg.engine.num_rounds,
                   "width": cfg.engine.max_per_round,
                   "d_model": cfg.policy.d_model,
                   "scenario": cfg.scenario,
                   "device_episodes": cfg.device_episodes,
                   "epoch_len": cfg.epoch_len,
                   "freeze_dispatch": cfg.freeze_dispatch},
        "updates": num_batches, "launches": launched,
        "wall_s": wall_s, "updates_per_s": num_batches / wall_s,
        "update_ms": {"p50": float(np.percentile(steady, 50)),
                      "p95": float(np.percentile(steady, 95)),
                      "first": sec[0], "n": len(steady)},
        "params_moved": n_moved,
        "first_last": {k: [hist[0][k], hist[-1][k]] for k in
                       TEMPORAL_METRICS},
        "rows": hist,
    }, launched, policy


def temporal_scale(pol, tr, engine, ref, policy_score, arr, device="cuda"):
    """(d): TEMPORAL_SCALE_UPDATES updates (``make_temporal_train_step``)
    on the first TEMPORAL_SCALE_BATCH instances of phase 6b's 100-edge
    clusters and arrivals at full policy width."""
    from repro_torch.nn import param_tree
    from repro_torch.optim import adam_init
    width = arr["mask"].shape[-1]
    cfg = tr.TemporalRLConfig(engine=engine.EngineConfig(
        num_edges=ROLLOUT_EDGES, num_rounds=ROLLOUT_ROUNDS,
        round_interval=ROLLOUT_DT, max_per_round=width),
        batch_size=TEMPORAL_SCALE_BATCH)
    policy = pol.CoRaiSPolicy(cfg.policy,
                              generator=torch.Generator().manual_seed(0),
                              device=device)
    before = {k: p.detach().clone() for k, p in param_tree(policy).items()}
    step, adam_cfg = tr.make_temporal_train_step(cfg)
    opt = adam_init(param_tree(policy), adam_cfg)
    arrivals = {k: torch.as_tensor(v[:TEMPORAL_SCALE_BATCH]).to(device)
                for k, v in arr.items()}
    rows, walls = [], []
    with contextlib.ExitStack() as stack:
        for guard in _plain_head_guard(ref):
            stack.enter_context(guard)
        policy_score.reset_launch_counts()
        for b in range(TEMPORAL_SCALE_UPDATES):
            sim0 = engine.init_batch(cfg.engine, range(TEMPORAL_SCALE_BATCH),
                                     device=device)
            gen = torch.Generator(device=device).manual_seed(b)
            t0 = time.perf_counter()
            opt, metrics = step(policy, opt, sim0, arrivals, generator=gen)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            rows.append({k: float(v) for k, v in metrics.items()}
                        | {"batch": b})
        launched = dict(policy_score.LAUNCHES)
    moved = {k: not torch.equal(p.detach(), before[k])
             for k, p in param_tree(policy).items()}
    n_moved = _temporal_checks("scale", rows, launched,
                               TEMPORAL_SCALE_UPDATES, ROLLOUT_ROUNDS, moved)
    return {"config": {"B": TEMPORAL_SCALE_BATCH, "Q": ROLLOUT_EDGES,
                       "rounds": ROLLOUT_ROUNDS, "width": width,
                       "d_model": cfg.policy.d_model},
            "updates": TEMPORAL_SCALE_UPDATES, "launches": launched,
            "update_ms": {"p50": float(np.percentile(walls[1:], 50)),
                          "p95": float(np.percentile(walls[1:], 95)),
                          "first": walls[0], "runs": walls},
            "updates_per_s": 1e3 / float(np.percentile(walls[1:], 50)),
            "params_moved": n_moved, "rows": rows}, launched


def temporal_gradient_parity(pol, tr, engine, wl, device="cuda"):
    """One update of path (a) through the kernels ("cuda") and plain
    autograd ("torch") on two copies of one policy: the same clusters,
    host episode and injected actions; phase 5's tolerances."""
    cfg = tr.TemporalRLConfig()
    ecfg = cfg.engine
    arrivals = tr._host_episode(cfg, None, wl.scenario(cfg.scenario), 0)
    seeds = tr._cluster_seeds(cfg, 0)
    actions = torch.randint(0, ecfg.num_edges, (ecfg.num_rounds,
                                                cfg.batch_size,
                                                ecfg.max_per_round),
                            generator=torch.Generator().manual_seed(9)
                            ).to(device)
    out = {}
    for backend in ("cuda", "torch"):
        pcfg = pol.PolicyConfig(score_backend=backend)
        policy = pol.CoRaiSPolicy(pcfg,
                                  generator=torch.Generator().manual_seed(0),
                                  device=device)
        loss, aux, grads = tr.temporal_loss_and_grads(
            policy, engine.init_batch(ecfg, seeds, device=device), arrivals,
            dataclasses.replace(cfg, policy=pcfg), actions=actions)
        out[backend] = (float(loss), {k: float(v) for k, v in aux.items()},
                        grads)
    (loss_k, aux_k, gk), (loss_p, aux_p, gp) = out["cuda"], out["torch"]
    gmax = max(float(g.abs().max()) for g in gp.values())
    worst, worst_key = 0.0, None
    for key, g in gp.items():
        check(bool(torch.isfinite(gk[key]).all()),
              f"temporal gradient of {key} not finite through the kernels")
        excess = float(((gk[key] - g).abs() - 1e-4 * g.abs()).max())
        if excess > worst:
            worst, worst_key = excess, key
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    check(loss_rel <= 1e-5, f"temporal loss through kernels {loss_k} != "
          f"plain {loss_p}")
    check(aux_k["completed"] == aux_p["completed"] > 0,
          f"temporal episodes differ: {aux_k} against {aux_p}")
    check(worst <= 1e-5 * gmax, f"temporal gradient of {worst_key} differs "
          f"by {worst} > 1e-5 * {gmax} beyond rtol 1e-4")
    for key in ("edge_proj/w", "req_proj/w", "ctx_mha/wq"):
        check(float(gk[key].abs().max()) > 1e-3 * gmax,
              f"no temporal gradient reached {key} through the kernels")
    return {"loss_cuda": loss_k, "loss_torch": loss_p,
            "loss_rel_err": loss_rel, "grad_max": gmax,
            "grad_excess_over_rtol": worst, "grad_excess_leaf": worst_key,
            "aux": aux_k}


def _ks_two_sample(a, b):
    a, b = np.sort(a), np.sort(b)
    grid = np.concatenate([a, b])
    return float(np.max(np.abs(np.searchsorted(a, grid, side="right") / a.size
                               - np.searchsorted(b, grid, side="right")
                               / b.size)))


def _within_se(name, got, want, se):
    check(abs(got - want) <= SAMPLER_SE * se, f"device sampler {name}: "
          f"{got} against {want}, more than {SAMPLER_SE} standard errors "
          f"({se})")
    return {"device": got, "want": want, "se": se}


def device_sampler_laws(wl, faults, device="cuda"):
    """The device episode and fault samplers on the card, on large batches,
    against the laws and the port's host samplers: count moments, the
    sizes' two-sample KS test, the exact clip contract, MMPP's transient
    means per round, the scripted fault rows and the fail/recover rates.
    Bands: SAMPLER_SE standard errors of the samples' own spread; KS at
    c = 1.95 (alpha ~ 1e-3), as tests/test_torch_device_episodes.py."""
    gen = torch.Generator(device=device).manual_seed(21)
    b, r, dt = SAMPLER_BATCH, 8, ROLLOUT_DT
    report = {}

    def draw(workload, width, q=4, rounds=r, batch=b):
        out = wl.materialize_round_batch_device(
            workload, q, rounds, dt, batch, generator=gen,
            max_per_round=width)
        check(all(v.device.type == gen.device.type for v in out.values()),
              "device sampler output left the generator's device")
        return {k: v.cpu().numpy() for k, v in out.items()}

    # Poisson count moments against the law and the host sampler
    d = draw(wl.PoissonArrivals(rate=30.0), 64)
    counts = d["mask"].sum(-1).astype(np.float64)
    per = counts.mean(1)
    report["poisson_mean"] = _within_se("Poisson mean", float(per.mean()),
                                        30.0 * dt,
                                        float(per.std() / np.sqrt(b)))
    h = wl.materialize_round_batch(wl.PoissonArrivals(rate=30.0), 4, r, dt,
                                   256, base_seed=0, max_per_round=64)
    hc = h["mask"].sum(-1).mean(1)
    report["poisson_vs_host"] = _within_se(
        "Poisson mean vs host", float(per.mean()), float(hc.mean()),
        float(np.sqrt(per.var() / b + hc.var() / hc.size)))
    check(abs(counts.var() / (30.0 * dt) - 1.0) < 0.05,
          f"device sampler Poisson variance {counts.var()}")
    # the sizes' law against the host sampler
    report["sizes_ks"] = {}
    for spec in (wl.SizeSpec("pareto", (1.5, 0.05)),
                 wl.SizeSpec("lognormal", (-1.5, 0.8)),
                 wl.SizeSpec("uniform", (0.2, 0.9))):
        dev = draw(wl.PoissonArrivals(rate=40.0, sizes=spec), 64,
                   batch=512)
        x = dev["size"][dev["mask"]].astype(np.float64)
        y = spec.sample(np.random.default_rng(7), 50_000)
        stat = _ks_two_sample(x, y)
        band = 1.95 * np.sqrt((x.size + y.size) / (x.size * y.size))
        check(stat < band, f"device sampler sizes {spec}: KS {stat} >= "
              f"{band}")
        report["sizes_ks"][spec.dist] = {"stat": stat, "band": band,
                                         "n": int(x.size)}
    # the clip contract, exactly
    c = draw(wl.PoissonArrivals(rate=120.0), 8, rounds=6, batch=512)
    kept = c["mask"].sum(-1)
    total = kept + c["dropped"]
    starts = np.cumsum(total, -1) - total
    check(bool((c["dropped"] > 0).any())
          and np.array_equal(c["mask"], np.arange(8) < kept[..., None])
          and np.array_equal(c["rid"], np.where(
              c["mask"], starts[..., None] + np.arange(8), 0)),
          "device sampler: the clip contract (mask prefix, rids, dropped) "
          "does not hold")
    report["clip_rounds"] = int((c["dropped"] > 0).sum())
    # MMPP: per-round transient means of the chain started in state 0
    mm = wl.scenario("mmpp_bursty")
    m = draw(mm, 64, rounds=12)["mask"].sum(-1).astype(np.float64)
    leave = 1.0 / np.asarray(mm.mean_sojourn)
    k = leave.sum()
    t0 = np.arange(12) * dt
    mass = leave[0] / k * (dt - (np.exp(-k * t0) - np.exp(-k * (t0 + dt)))
                           / k)
    want = mm.rates[0] * dt + (mm.rates[1] - mm.rates[0]) * mass
    se = m.std(0) / np.sqrt(b)
    check(bool(np.all(np.abs(m.mean(0) - want) <= SAMPLER_SE * se)),
          f"device sampler MMPP round means {m.mean(0)} against {want}")
    report["mmpp_round_means"] = {"device": m.mean(0).tolist(),
                                  "want": want.tolist(), "se": se.tolist()}
    # faults: scripted rows exactly, Markov rates against the law
    spec = faults.FaultSpec(rolling=(2, 2), scripted_stragglers=(
        (1, 3, 6, 4.0),), min_alive=2)
    ev = faults.materialize_faults_device(spec, 5, 12, batch=64,
                                          generator=gen)
    host = faults.materialize_faults(spec, 5, 12, seed=0)
    check(all(np.array_equal(ev["alive"][i].cpu().numpy(), host["alive"])
              and np.array_equal(ev["speed"][i].cpu().numpy(),
                                 host["speed"]) for i in range(64)),
          "device fault rows differ from the host's scripted rows")
    churn = faults.FaultSpec(fail_prob=0.15, recover_prob=0.3)
    up = faults.materialize_faults_device(churn, 8, 24, batch=b,
                                          generator=gen)["alive"].cpu().numpy()
    prev, nxt = up[:, :-1], up[:, 1:]
    n_up, n_down = prev.sum(), (~prev).sum()
    fail, rec = (prev & ~nxt).sum() / n_up, (~prev & nxt).sum() / n_down
    report["fail_rate"] = _within_se("fail rate", float(fail), 0.15,
                                     float(np.sqrt(0.15 * 0.85 / n_up)))
    report["recover_rate"] = _within_se("recover rate", float(rec), 0.3,
                                        float(np.sqrt(0.3 * 0.7 / n_down)))
    torch.cuda.synchronize()
    return report


def episode_materialization(tr, wl, faults, device="cuda", reps=5):
    """Host (numpy samplers, then the copy to the card) against device
    (the torch samplers on the card) episode time, ms per update's batch,
    for path (a)'s and path (c)'s configs: the median of ``reps``."""
    out = {}
    for label, cfg, spec in (
            ("uniform_iid B=16 A=16", tr.TemporalRLConfig(), None),
            ("chaos-rolling-failure B=8 A=64",
             tr.TemporalRLConfig(scenario="chaos-rolling-failure",
                                 batch_size=8, engine=dataclasses.replace(
                                     tr.EngineConfig(), max_per_round=64)),
             wl.scenario_fault_spec("chaos-rolling-failure"))):
        ecfg = cfg.engine
        workload = wl.scenario(cfg.scenario)
        host, dev = [], []
        for b in range(reps + 1):
            t0 = time.perf_counter()
            arr = tr._host_episode(cfg, spec, workload, b)
            arr = {k: torch.as_tensor(v).to(device) for k, v in arr.items()}
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            gen = torch.Generator(device=device).manual_seed(b)
            arr = wl.materialize_round_batch_device(
                workload, ecfg.num_edges, ecfg.num_rounds,
                ecfg.round_interval, cfg.batch_size, generator=gen,
                max_per_round=ecfg.max_per_round)
            if spec is not None:
                arr = faults.attach_fault_batch_device(arr, spec,
                                                       ecfg.num_edges, gen)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if b:   # the first of each is a warm-up
                host.append((t1 - t0) * 1e3)
                dev.append((t2 - t1) * 1e3)
        out[label] = {"host_ms": float(np.median(host)),
                      "device_ms": float(np.median(dev)),
                      "host_ms_runs": host, "device_ms_runs": dev}
    return out


def _head_call_ms(prof):
    """Device ms of B1's and B2's calls in a trace: the port's head kernels
    in launch order, grouped into calls (a B1 call's launches end with its
    row kernel, a B2 call's with ``bwd_weights``), each call charged from
    its first launch's start to its last launch's end. The wrappers launch
    through ctypes, so no profiler range holds their kernels."""
    kernels = sorted((e for e in prof.events()
                      if str(e.device_type).endswith("CUDA")
                      and (_is_head_kernel(e.name)
                           or "(anonymous namespace)::bwd_" in e.name)),
                     key=lambda e: e.time_range.start)
    total = {"B1": 0.0, "B2": 0.0}
    calls = {"B1": 0, "B2": 0}
    first = None
    for e in kernels:
        first = e.time_range.start if first is None else first
        kind = ("B1" if any(f"::{k}" in e.name for k in ("score_rows",
                                                        "score_flat"))
                else "B2" if "::bwd_weights" in e.name else None)
        if kind is not None:
            total[kind] += (e.time_range.end - first) / 1e3
            calls[kind] += 1
            first = None
    return total, calls


def profile_temporal(tr, policy, n=TEMPORAL_PROFILE_UPDATES):
    """A torch.profiler trace of ``n`` host-loop updates of path (a)'s
    config, continuing from ``policy``: device busy ms, idle share and
    launches per update, and B1's and B2's device ms and calls per update
    (``_head_call_ms``)."""
    from torch.profiler import ProfilerActivity, profile
    cfg = tr.TemporalRLConfig()
    tr.temporal_train(cfg, num_batches=1, policy=policy,
                      start_batch=TEMPORAL_HOST_UPDATES)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.temporal_train(cfg, num_batches=n, policy=policy,
                          start_batch=TEMPORAL_HOST_UPDATES + 1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    out = _device_summary(prof, n, wall_ms)
    ms, calls = _head_call_ms(prof)
    out["b1_device_ms"], out["b2_device_ms"] = ms["B1"] / n, ms["B2"] / n
    out["b1_calls"], out["b2_calls"] = calls["B1"] / n, calls["B2"] / n
    return out


def temporal_resume(pol, tr, checkpoint, device="cuda"):
    """Save -> resume on the card is bit-identical to the uninterrupted run:
    the epoch path (device episodes, K = 3), four batches straight against
    two with ``every=2`` checkpoints and two more restored from them."""
    import shutil
    cfg = tr.TemporalRLConfig(device_episodes=True, epoch_len=3)
    root = ROOT / "build" / "chip_smoke_temporal_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    p_full, o_full, h_full = tr.temporal_train(cfg, num_batches=4,
                                               device=device)
    tr.temporal_train(cfg, num_batches=2, device=device,
                      checkpointer=checkpoint.Checkpointer(str(root),
                                                           every=2))
    p_res, o_res, h_res = tr.temporal_train(
        cfg, num_batches=2, device=device,
        checkpointer=checkpoint.Checkpointer(str(root), every=2))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    shutil.rmtree(root, ignore_errors=True)
    check([r["batch"] for r in h_res] == [2, 3],
          f"resume replayed batches {[r['batch'] for r in h_res]}")
    sd_full, sd_res = p_full.state_dict(), p_res.state_dict()
    same = (all(torch.equal(sd_full[k], sd_res[k]) for k in sd_full)
            and torch.equal(o_full["step"], o_res["step"])
            and all(torch.equal(o_full[m][k], o_res[m][k])
                    for m in ("m", "v") for k in o_full[m]))
    check(same, "temporal resume is not bit-identical to the uninterrupted "
          "run (parameters or optimizer state)")
    tail = [r for r in h_full if r["batch"] >= 2]
    check(all(a["loss"] == b["loss"] and a["cost_mean"] == b["cost_mean"]
              for a, b in zip(tail, h_res)),
          "temporal resume's history differs from the uninterrupted run's")
    return {"batches": [r["batch"] for r in h_res], "bit_identical": True,
            "loss": [r["loss"] for r in h_res], "wall_s": wall_s}


# -- phase 6d: the serving host side ------------------------------------------


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _cli_device(device):
    return [] if torch.device(device).type == "cuda" else ["--device",
                                                           str(device)]


def _launch_check(label, launched, kernel, want):
    check(launched[kernel] == want and sum(launched.values()) == want,
          f"{label} launched {launched}; {kernel} must launch {want} times "
          f"and nothing else of the port")


def _tree_equal(a, b):
    return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


def serve_train(tr, checkpoint, launch_train, policy_score, ref, root,
                device="cuda"):
    """``train corais`` at RLConfig()'s full width, SERVE_TRAIN_BATCHES
    batches with checkpoints every SERVE_CKPT_EVERY, twice on one
    directory: the second run resumes from the first's last checkpoint at
    the batch after it (the reference's ``step + 1``). B1 and B2 launch
    once per batch and no plain head is reached; the manifest lists every
    leaf of ``train_tree``; the resumed run's parameters, norm buffers and
    Adam state equal, bit for bit, the same batches run in memory."""
    import io
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    argv = ["corais", "--batches", str(SERVE_TRAIN_BATCHES), "--ckpt-every",
            str(SERVE_CKPT_EVERY), "--ckpt", str(root)] + _cli_device(device)
    runs, counts, logs = [], {}, []
    for _ in range(2):
        with contextlib.ExitStack() as stack:
            for guard in _plain_head_guard(ref):
                stack.enter_context(guard)
            out = stack.enter_context(contextlib.redirect_stdout(io.StringIO()))
            policy_score.reset_launch_counts()
            t0 = time.perf_counter()
            policy, opt, hist = launch_train.main(argv)
            _sync(device)
            wall_s = time.perf_counter() - t0
            launched = dict(policy_score.LAUNCHES)
        logs.append(out.getvalue())
        n = len(hist)
        check(n == SERVE_TRAIN_BATCHES, f"train corais ran {n} batches")
        check(launched["policy_score"] == n
              and launched["policy_score_bwd"] == n
              and sum(launched.values()) == 2 * n,
              f"train corais launched {launched} in {n} batches; B1 and B2 "
              f"must launch once per batch")
        for row in hist:
            check(all(math.isfinite(row[k]) for k in
                      ("loss", "grad_norm", "cost_mean", "cost_best",
                       "entropy")), f"train corais: non-finite {row}")
        for k, v in launched.items():
            counts[k] = counts.get(k, 0) + v
        runs.append({"batches": [row["batch"] for row in hist],
                     "wall_s": wall_s, "launches": launched,
                     "step_ms": [row["sec"] * 1e3 for row in hist],
                     "cost_mean": [row["cost_mean"] for row in hist]})
    first_end = SERVE_TRAIN_BATCHES
    want = list(range(first_end + 1, 2 * first_end + 1))
    check(runs[1]["batches"] == want, f"the resumed run took batches "
          f"{runs[1]['batches']}, not {want}")
    ck = checkpoint.Checkpointer(str(root))
    step = ck.latest_step()
    with open(Path(ck._dir(step)) / "manifest.json") as f:
        keys = {e["key"] for e in json.load(f)["leaves"]}
    leaves = set(checkpoint.flatten_tree(checkpoint.train_tree(policy, opt)))
    check(keys == leaves, f"the checkpoint's manifest misses "
          f"{sorted(leaves - keys)[:5]} and adds {sorted(keys - leaves)[:5]}")
    # the same batches in memory: 0..3, then 5..8
    cfg = tr.RLConfig()
    p_mem, o_mem, _ = tr.train(cfg, num_batches=first_end, device=device)
    p_mem, o_mem, _ = tr.train(cfg, num_batches=first_end, policy=p_mem,
                               opt_state=o_mem, start_batch=first_end + 1)
    _sync(device)
    same = (_tree_equal(dict(p_mem.state_dict()), dict(policy.state_dict()))
            and torch.equal(o_mem["step"], opt["step"])
            and all(_tree_equal(o_mem[m], opt[m]) for m in ("m", "v")))
    check(same, "the resumed train corais is not bit-identical to the same "
          "batches run in memory")
    return {"runs": runs, "latest_step": step, "leaves": len(keys),
            "bit_identical": True, "log_tail": logs[1][-400:]}, counts


def _serve_sim(sim_mod, cc, edges=SERVE_EDGES):
    """``launch/serve.py``'s flow at phase 6d's flags, on controller
    ``cc``."""
    sim = sim_mod.MultiEdgeSim(sim_mod.SimConfig(num_edges=edges, seed=0), cc)
    rng = np.random.default_rng(0)
    for _ in range(SERVE_REQUESTS):
        sim.submit(int(rng.integers(0, edges)), float(rng.uniform(0.05, 1.0)),
                   t=float(rng.uniform(0, SERVE_WINDOW)))
    sim.fail_edge(SERVE_FAIL[0], t=SERVE_FAIL[1])
    sim.set_straggler(SERVE_STRAGGLE[0], SERVE_STRAGGLE[1], t=0.0)
    return sim


def _decision_stats(m):
    return {k: m[k] for k in ("decision_rounds", "decision_mean_s",
                              "decision_p95_s", "decision_max_s")}


def serve_cli(launch_serve, policy_score, ref, root, device="cuda"):
    """``serve --scheduler corais`` on the trained checkpoint at phase 6d's
    flags: every request completes (the command line's own check) and B1
    launches once per non-empty round, no plain head reached."""
    import io
    argv = ["--scheduler", "corais", "--policy-ckpt", str(root), "--edges",
            str(SERVE_EDGES), "--requests", str(SERVE_REQUESTS),
            "--arrival-window", str(SERVE_WINDOW), "--fail-edge",
            str(SERVE_FAIL[0]), "--fail-at", str(SERVE_FAIL[1]),
            "--straggle", f"{SERVE_STRAGGLE[0]}:{SERVE_STRAGGLE[1]:g}",
            "--until", str(SERVE_UNTIL)] + _cli_device(device)
    with contextlib.ExitStack() as stack:
        for guard in _plain_head_guard(ref):
            stack.enter_context(guard)
        stack.enter_context(contextlib.redirect_stdout(io.StringIO()))
        policy_score.reset_launch_counts()
        t0 = time.perf_counter()
        m = launch_serve.main(argv)
        wall_s = time.perf_counter() - t0
        launched = dict(policy_score.LAUNCHES)
    check(m["completed"] == m["submitted"] == SERVE_REQUESTS,
          f"serve completed {m['completed']} of {m['submitted']}")
    _launch_check("serve --scheduler corais", launched, "policy_score",
                  m["decision_rounds"])
    return {"argv": argv, "wall_s": wall_s, "launches": launched,
            **_decision_stats(m),
            **{k: m[k] for k in ("completed", "submitted", "retried_requests",
                                 "mean_response", "p95_response", "makespan",
                                 "transferred_frac")}}, launched


def _recorded_run(sim, cc, controller_mod, device):
    """Run ``sim`` to SERVE_UNTIL with ``cc`` recording each round's padded
    snapshot and decision, and timing ``snapshot_instance``, the staging
    (to a synchronise) and the decision."""
    from unittest import mock
    rec = {"snapshots": [], "assign": [], "snapshot_s": [], "stage_s": []}
    stage, decide = cc._stage, cc._policy_assign
    snapshot = controller_mod.snapshot_instance

    def timed_snapshot(*args, **kwargs):
        t0 = time.perf_counter()
        out = snapshot(*args, **kwargs)
        rec["snapshot_s"].append(time.perf_counter() - t0)
        return out

    def timed_stage(inst):
        t0 = time.perf_counter()
        out = stage(inst)
        _sync(device)
        rec["stage_s"].append(time.perf_counter() - t0)
        rec["snapshots"].append(inst)
        return out

    def recorded(inst):
        out = decide(inst)
        rec["assign"].append(out)
        return out

    cc._stage, cc._policy_assign = timed_stage, recorded
    with mock.patch.object(controller_mod, "snapshot_instance",
                           timed_snapshot):
        t0 = time.perf_counter()
        m = sim.run(until=SERVE_UNTIL)
        rec["wall_s"] = time.perf_counter() - t0
    return m, rec


def _plain_greedy(pol, policy, inst, device):
    """The plain ``"torch"`` head's greedy decision on a padded snapshot,
    the rows whose top-2 gap exceeds GAP, and the staged instance."""
    tinst = {k: torch.as_tensor(np.asarray(v)).to(device)
             for k, v in inst.items()}
    with torch.inference_mode():
        c, h = pol.corais_encode(policy, tinst)
        ti, tv = pol.corais_score_decode(policy, c, h, tinst["edge_mask"],
                                         k=2, normalize=False,
                                         backend="torch")
    gapped = ((tv[:, 0] - tv[:, 1]) > GAP) & tinst["req_mask"]
    return ti[:, 0].cpu().numpy(), gapped.cpu().numpy(), tinst


def serve_in_process(pol, obj, sim_mod, controller_mod, policy_score, ref,
                     policy, device="cuda"):
    """The serve flow in process with the trained policy: ``"corais"``
    materialized (B1), fused (B3 at K = 1) and ``"corais-sample"`` fused
    (B3 at K = Q, ``topk_sampling_decode``), each launching its kernel
    once per non-empty round and no plain head, every request completed.
    On each round's recorded snapshot a greedy decision, and the sampled
    decode's greedy candidate, equal the plain head's wherever the top-2
    gap exceeds GAP, and a sampled decision costs no more than its greedy
    candidate. Decision mean, p95 and max, rounds, simulator wall per arrival
    round, and a round's split between ``snapshot_instance``, staging and
    the decision."""
    report, counts = {}, {}
    arrival_rounds = SERVE_WINDOW / SERVE_DT
    for label, scheduler, fused, kernel in (
            ("corais", "corais", False, "policy_score"),
            ("corais_fused", "corais", True, "policy_score_decode"),
            ("corais_sample_fused", "corais-sample", True,
             "policy_score_decode")):
        cc = sim_mod.CentralController(scheduler=scheduler, policy=policy,
                                       fused_decode=fused)
        sim = _serve_sim(sim_mod, cc)
        with contextlib.ExitStack() as stack:
            for guard in _plain_head_guard(ref):
                stack.enter_context(guard)
            policy_score.reset_launch_counts()
            m, rec = _recorded_run(sim, cc, controller_mod, device)
            launched = dict(policy_score.LAUNCHES)
        rounds = len(sim.decision_times)
        check(m["completed"] == m["submitted"] == SERVE_REQUESTS
              and m["stranded_requests"] == 0,
              f"serving {label}: {m['completed']} of {m['submitted']} done")
        _launch_check(f"serving {label}", launched, kernel, rounds)
        for k, v in launched.items():
            counts[k] = counts.get(k, 0) + v
        gapped_n = checked = compared = 0
        for inst, got in zip(rec["snapshots"], rec["assign"]):
            want, gapped, tinst = _plain_greedy(pol, policy, inst, device)
            if scheduler == "corais":
                bad = int((got[gapped] != want[gapped]).sum())
                check(bad == 0, f"serving {label}: {bad} decisions differ "
                      f"from the plain head above the gap")
            else:
                # the greedy candidate of the sampled decode: B3 at K = Q,
                # the call the controller made, the same bits
                with torch.inference_mode():
                    c, h = pol.corais_encode(policy, tinst)
                    ti, _ = pol.corais_score_decode(
                        policy, c, h, tinst["edge_mask"],
                        k=int(tinst["edge_mask"].shape[-1]))
                cand = ti[:, 0].cpu().numpy()
                bad = int((cand[gapped] != want[gapped]).sum())
                check(bad == 0, f"serving {label}: {bad} greedy candidates "
                      f"differ from the plain head above the gap")
                cost = [float(obj.makespan(tinst, torch.as_tensor(a).to(
                    device))) for a in (got, cand)]
                check(cost[0] <= cost[1] * (1 + 1e-6), f"serving {label}: "
                      f"a sampled decision costs {cost[0]}, its greedy "
                      f"candidate {cost[1]}")
                checked += 1
                compared += cost[0] < cost[1]
            gapped_n += int(gapped.sum())
        check(gapped_n > 0, f"serving {label}: no request above the gap")
        dec = np.asarray(sim.decision_times)
        stage = np.asarray(rec["stage_s"])
        report[label] = {
            "scheduler": scheduler, "fused_decode": fused,
            "launches": launched, "rounds_scheduled": rounds,
            **_decision_stats(m),
            "sim_wall_s": rec["wall_s"],
            "sim_wall_ms_per_arrival_round":
                rec["wall_s"] * 1e3 / arrival_rounds,
            "round_split_ms": {
                "snapshot_instance": float(np.mean(rec["snapshot_s"])) * 1e3,
                "staging": float(stage.mean()) * 1e3,
                "decision": float((dec - stage).mean()) * 1e3},
            "width": [int(np.asarray(i["req_mask"]).shape[0])
                      for i in rec["snapshots"][:3]],
            "gapped_requests": gapped_n, "sampled_rounds_checked": checked,
            "sampled_rounds_cheaper": compared,
            **{k: m[k] for k in ("completed", "retried_requests",
                                 "mean_response", "p95_response",
                                 "makespan", "transferred_frac")}}
    return report, counts


def serve_faults(wl, faults, sim_mod, policy_score, ref, policy,
                 device="cuda"):
    """SERVE_FAULT_SCENARIO's fault rows at Q = SERVE_EDGES pushed by
    ``schedule_into_sim`` under the policy controller (B1): nothing lost."""
    rounds = ROLLOUT_ROUNDS
    spec = wl.scenario_fault_spec(SERVE_FAULT_SCENARIO)
    ev = faults.materialize_faults(spec, SERVE_EDGES, rounds, seed=0)
    jit = faults.jitter_table(spec, 1 << 16) if spec.jitter_sigma else None
    cc = sim_mod.CentralController(scheduler="corais", policy=policy)
    sim = sim_mod.MultiEdgeSim(sim_mod.SimConfig(
        num_edges=SERVE_EDGES, round_interval=SERVE_DT, seed=0), cc)
    faults.schedule_into_sim(sim, ev, SERVE_DT, jit)
    with contextlib.ExitStack() as stack:
        for guard in _plain_head_guard(ref):
            stack.enter_context(guard)
        policy_score.reset_launch_counts()
        t0 = time.perf_counter()
        m = sim.drive(wl.scenario(SERVE_FAULT_SCENARIO),
                      until=rounds * SERVE_DT, run_until=SERVE_UNTIL, seed=0)
        wall_s = time.perf_counter() - t0
        launched = dict(policy_score.LAUNCHES)
    check(m["completed"] == m["submitted"] > 0
          and m["stranded_requests"] == 0,
          f"serving under {SERVE_FAULT_SCENARIO}: {m['completed']} of "
          f"{m['submitted']} done, {m['stranded_requests']} stranded")
    _launch_check(f"serving under {SERVE_FAULT_SCENARIO}", launched,
                  "policy_score", m["decision_rounds"])
    failures = int((~ev["alive"]).any(0).sum())
    return {"scenario": SERVE_FAULT_SCENARIO, "edges": SERVE_EDGES,
            "edges_failed": failures, "wall_s": wall_s, "launches": launched,
            **_decision_stats(m),
            **{k: m[k] for k in ("completed", "submitted",
                                 "stranded_requests", "retried_requests",
                                 "mean_response", "makespan")}}, launched


class _HashController:
    """The oracle's twin of the scripted hash: request rid goes to node
    (7 rid + 3) mod n; with ``sim`` set, fresh requests fail over to the
    nearest alive edge and re-admitted orphans retry at their source (the
    engine's fault-mode rules). Records each round's workload features."""

    last_decision_time = 0.0

    def __init__(self, n, snapshot_instance, nearest_alive_edge, sim=None):
        self.n, self.sim = n, sim
        self.snapshot, self.nearest = snapshot_instance, nearest_alive_edge
        self.seen, self.features = set(), {}

    def schedule(self, edges, pending, w, ct):
        inst = self.snapshot([e.state for e in edges], pending, w, ct)
        if self.sim is not None:
            r_idx = int(round(self.sim.now / SERVE_DT)) - 1
        else:
            r_idx = int(np.ceil(min(r.submit_time for r in pending)
                                / SERVE_DT)) - 1
        self.features[r_idx] = inst["workload"].copy()
        if self.sim is None:
            return [(r, (r.rid * 7 + 3) % self.n) for r in pending]
        alive = [e.alive for e in edges]
        out = []
        for r in pending:
            if r.rid in self.seen:
                out.append((r, r.source_edge))
            else:
                self.seen.add(r.rid)
                out.append((r, self.nearest(self.sim.w, (r.rid * 7 + 3)
                                            % self.n, alive)))
        return out


def engine_vs_oracle(engine, wl, faults, sim_mod, state, topology,
                     device="cuda"):
    """The port's engine on the card (scripted hash) against the port's
    simulator with phi pinned and no noise on ORACLE_CASES: finish times,
    completion buckets and workload features (rounds untouched by an alive
    transition, under faults)."""
    report = {}
    for name, q, rounds, seed in ORACLE_CASES:
        cloud, cache = wl.scenario_cloud_spec(name)
        spec = wl.scenario_fault_spec(name)
        n = q + (1 if cloud is not None else 0)
        arr = wl.materialize_rounds(wl.scenario(name), q, rounds, SERVE_DT,
                                    seed=seed, max_per_round=64)
        ev = jit = None
        if spec is not None:
            ev = faults.materialize_faults(spec, q, rounds, seed=seed)
            jit = (faults.jitter_table(spec, int(arr["rid"].max()) + 1,
                                       seed=seed)
                   if spec.jitter_sigma else None)
            arr = faults.attach_faults(arr, ev, jit)
        cfg = engine.EngineConfig(num_edges=q, num_rounds=rounds,
                                  round_interval=SERVE_DT, max_per_round=64,
                                  cloud=cloud, cache=cache)
        t0 = time.perf_counter()
        final, infos = engine.make_rollout(
            cfg, lambda g, inst: (inst["req_rid"] * 7 + 3) % n)(
            engine.init_state(cfg, seed=seed, device=device), arr)
        _sync(device)
        engine_ms = (time.perf_counter() - t0) * 1e3
        final = {k: v.cpu().numpy() for k, v in final.items()}
        feats = infos["features"].cpu().numpy()
        sim = sim_mod.MultiEdgeSim(sim_mod.SimConfig(
            num_edges=q, round_interval=SERVE_DT, seed=seed, exec_noise=0.0,
            phi_oracle=True, cloud=cloud, cache=cache), None)
        sim.cc = _HashController(n, state.snapshot_instance,
                                 topology.nearest_alive_edge,
                                 sim if spec is not None else None)
        if ev is not None:
            faults.schedule_into_sim(sim, ev, SERVE_DT, jit)
        m = sim.drive(wl.scenario(name), until=rounds * SERVE_DT,
                      run_until=ORACLE_DRAIN, seed=seed)
        rids = np.asarray(arr["rid"]).ravel()[np.asarray(arr["mask"]).ravel()]
        committed = final["slot_edge"].ravel() >= 0
        fin_e = final["slot_finish"].ravel()[committed]
        done = {r.rid: r.finish_time for e in sim.edges for r in e.completed}
        where = f"engine vs oracle {name}"
        check(m["completed"] == m["submitted"] == len(rids) == len(fin_e) > 0,
              f"{where}: {m['completed']} of {m['submitted']} done, "
              f"{len(rids)} arrived, {len(fin_e)} committed")
        fin_o = np.array([done[r] for r in rids])
        err = np.abs(fin_e - fin_o)
        check(bool((err <= ORACLE_TOL + 1e-5 * np.abs(fin_o)).all()),
              f"{where}: finish times differ by up to {err.max()}")
        bounds = (np.arange(rounds) + 1) * SERVE_DT + 1e-6
        check(np.array_equal((fin_e[None] <= bounds[:, None]).sum(-1),
                             (fin_o[None] <= bounds[:, None]).sum(-1)),
              f"{where}: completions per round differ")
        quiet = np.ones(rounds, bool)
        if ev is not None:
            prev = np.ones(q, bool)
            for r in range(rounds):
                quiet[r] = bool((ev["alive"][r] == prev).all())
                prev = ev["alive"][r]
        feat_err, compared = 0.0, 0
        if cloud is None:
            for r, want in sim.cc.features.items():
                if quiet[r] and (r == 0 or quiet[r - 1]):
                    e = np.abs(feats[r] - want)
                    check(bool((e <= ORACLE_TOL + ORACLE_TOL
                                * np.abs(want)).all()),
                          f"{where}: round {r} features differ by {e.max()}")
                    feat_err = max(feat_err, float(e.max()))
                    compared += 1
            check(compared > 0, f"{where}: no round's features compared")
        report[name] = {"edges": q, "rounds": rounds, "seed": seed,
                        "requests": len(rids),
                        "max_finish_err": float(err.max()),
                        "max_feature_err": feat_err,
                        "feature_rounds": compared,
                        "retried": int(final["retried"]),
                        "engine_ms": engine_ms}
    return report


def drive_serving_host(card, m, device="cuda"):
    """Phase 6d's five steps on the modules ``m`` (a namespace of the
    port's modules): train and resume, serve from the command line, the
    in-process decode variants, faults at full width, and the engine
    against its oracle. Prints each step's line beside the card and
    returns (report, launch counts over the steps' main paths)."""
    root = ROOT / "build" / "chip_smoke_serving_ckpt"
    counts = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v

    report = {"card": card}
    t0 = time.perf_counter()
    report["train"], c = serve_train(m.tr, m.checkpoint, m.launch_train,
                                     m.policy_score, m.ref, root, device)
    add(c)
    print(f"serving host train corais ({card}): "
          f"{json.dumps({k: v for k, v in report['train'].items() if k != 'log_tail'})}",
          flush=True)
    report["serve_cli"], c = serve_cli(m.launch_serve, m.policy_score, m.ref,
                                       root, device)
    add(c)
    print(f"serving host serve --scheduler corais ({card}): "
          f"{json.dumps(report['serve_cli'])}", flush=True)
    policy = m.pol.CoRaiSPolicy(m.pol.PolicyConfig(), device=device)
    m.checkpoint.load_train_state(
        policy, m.checkpoint.Checkpointer(str(root)).restore_latest()["tree"])
    report["in_process"], c = serve_in_process(
        m.pol, m.obj, m.serving, m.controller, m.policy_score, m.ref, policy,
        device)
    add(c)
    for label, r in report["in_process"].items():
        print(f"serving host {label} ({card}): {json.dumps(r)}", flush=True)
    report["faults"], c = serve_faults(m.wl, m.faults, m.serving,
                                       m.policy_score, m.ref, policy, device)
    add(c)
    print(f"serving host faults ({card}): {json.dumps(report['faults'])}",
          flush=True)
    report["engine_vs_oracle"] = engine_vs_oracle(
        m.engine, m.wl, m.faults, m.serving, m.state, m.topology, device)
    print(f"serving host engine vs oracle ({card}): "
          f"{json.dumps(report['engine_vs_oracle'])}", flush=True)
    report["wall_s"] = time.perf_counter() - t0
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    return report, counts


# -- phase 6e: the fleet and data parallelism --------------------------------


def _partials_err(got, want, where):
    """Integer partials equal, float partials within FLEET_TOL relative;
    returns the largest relative float error."""
    worst = 0.0
    check(set(got) == set(want), f"{where}: keys {sorted(got)} against "
          f"{sorted(want)}")
    for k, w in want.items():
        g = got[k]
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"{where}: {k} is {g.dtype} {tuple(g.shape)}, single-device "
              f"{w.dtype} {tuple(w.shape)}")
        if w.is_floating_point():
            err = float(((g - w).abs() / w.abs().clamp(min=1e-30)).max())
            check(err <= FLEET_TOL, f"{where}: {k} {g.tolist()} differs from "
                  f"the single-device {w.tolist()} by {err} relative")
            worst = max(worst, err)
        else:
            check(torch.equal(g, w), f"{where}: {k} differs from the "
                  f"single-device rollout")
    return worst


def fleet_rollout(m, mesh, arr, single, single_ms, device="cuda"):
    """The fleet rollout at 6b's shape through ``"policy-fused"`` (B3) and
    ``"policy"`` (B1) on ``mesh``: the launch counters set to 0 just before
    the first run and read just after (the head's kernel once per round
    for the whole batch, no plain head reached), the reduced partials held
    to 6b's single-device ``single``, wall ms the median of
    ROLLOUT_TIMED_RUNS beside 6b's. Returns (report, launch counts)."""
    policy = m.pol.CoRaiSPolicy(m.pol.PolicyConfig(),
                                generator=torch.Generator().manual_seed(0),
                                device=device)
    batch, width = arr["mask"].shape[0], arr["mask"].shape[-1]
    cfg = m.engine.EngineConfig(num_edges=ROLLOUT_EDGES,
                                num_rounds=ROLLOUT_ROUNDS,
                                round_interval=ROLLOUT_DT, max_per_round=width)
    state = m.engine.init_batch(cfg, range(batch), device=device)
    arr = {k: torch.as_tensor(v).to(device) for k, v in arr.items()}
    report, counts = {}, {}
    for backend, kernel in (("policy-fused", "policy_score_decode"),
                            ("policy", "policy_score")):
        run = m.fleet.make_fleet_rollout(
            cfg, m.engine.resolve_assign_fn(backend, policy=policy), mesh)
        walls = []
        with contextlib.ExitStack() as stack:
            for guard in _plain_head_guard(m.ref):
                stack.enter_context(guard)
            for rep in range(ROLLOUT_TIMED_RUNS):
                if rep == 0:
                    m.policy_score.reset_launch_counts()
                t0 = time.perf_counter()
                partials = run(state, arr)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                if rep == 0:
                    launched = dict(m.policy_score.LAUNCHES)
                    first = partials
        check(launched.get(kernel) == ROLLOUT_ROUNDS
              and sum(launched.values()) == ROLLOUT_ROUNDS,
              f"fleet {backend} launched {launched} in {ROLLOUT_ROUNDS} "
              f"rounds; {kernel} must launch once per round for the batch")
        err = _partials_err(first, single[backend], f"fleet {backend}")
        got = m.fleet.fleet_summary(first)
        want = m.engine.partials_to_summary(single[backend])
        check(set(got) == set(want), f"fleet {backend}: summary keys")
        for k, w in want.items():
            same = (abs(got[k] - w) <= FLEET_TOL * abs(w)
                    if isinstance(w, float) else got[k] == w)
            check(same, f"fleet {backend}: summary {k} {got[k]} against the "
                  f"single-device {w}")
        check(got["completed"] > 0, f"fleet {backend}: nothing completed")
        counts[backend] = launched
        report[backend] = {
            "launches": launched, "max_float_rel_err": err,
            "wall_ms": float(np.median(walls)), "wall_ms_runs": walls,
            "single_device_wall_ms": single_ms[backend],
            "completed": got["completed"], "submitted": got["submitted"],
            "mean_response": got["mean_response"],
            "p95_response": got["p95_response"]}
    return report, counts


def sharded_epoch_step(m, mesh, width, device="cuda"):
    """The sharded epoch step at path (d)'s shape (Q = 100, B = 16, 6b's
    width; ``PolicyConfig()``, uniform_iid on device episodes), K =
    DP_EPOCH_LEN updates a call, against the meshless epoch step on the
    same seeds and initial parameters: the launch counters set to 0 just
    before the first sharded call and read just after (B1 and B2 once per
    round of each update, no plain head reached); parameters within
    DP_PARAM_TOL and metrics within DP_METRIC_TOL of the meshless step's;
    then DP_TIMED_CALLS calls of each, alternating, per-update ms; then a
    torch.profiler trace (the device's activity only: a trace of the host's
    ops too takes a minute to read) of one update of each: device busy
    ms, idle share, kernel launches and NCCL kernels.
    Returns (report, launch counts)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.nn import param_tree
    from repro_torch.optim import adam_init
    cfg = m.tr.TemporalRLConfig(
        engine=m.engine.EngineConfig(
            num_edges=ROLLOUT_EDGES, num_rounds=ROLLOUT_ROUNDS,
            round_interval=ROLLOUT_DT, max_per_round=width),
        batch_size=TEMPORAL_SCALE_BATCH, device_episodes=True,
        epoch_len=DP_EPOCH_LEN)
    k_len, b = DP_EPOCH_LEN, TEMPORAL_SCALE_BATCH
    sim0 = m.engine.init_batch(cfg.engine, np.concatenate(
        [m.tr._cluster_seeds(cfg, i) for i in range(k_len)]), device=device)
    sim0 = {k: v.reshape(k_len, b, *v.shape[1:]) for k, v in sim0.items()}
    seeds = np.stack([m.tr._episode_seeds(cfg, i) for i in range(k_len)])
    runs = {}
    for label, kw in (("meshless", {}), ("sharded", {"mesh": mesh})):
        policy = m.pol.CoRaiSPolicy(cfg.policy,
                                    generator=torch.Generator().manual_seed(0),
                                    device=device)
        init = {k: p.detach().clone() for k, p in param_tree(policy).items()}
        step, adam_cfg = m.tr.make_temporal_epoch_step(cfg, **kw)
        runs[label] = [policy, step, adam_init(param_tree(policy), adam_cfg),
                       None, []]
    rounds = cfg.engine.num_rounds
    with contextlib.ExitStack() as stack:
        for guard in _plain_head_guard(m.ref):
            stack.enter_context(guard)
        for call in range(DP_TIMED_CALLS):
            for label in ("meshless", "sharded"):
                policy, step, opt, _, walls = runs[label]
                if call == 0 and label == "sharded":
                    m.policy_score.reset_launch_counts()
                t0 = time.perf_counter()
                opt, mets = step(policy, opt, sim0, seeds)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3 / k_len)
                runs[label][2] = opt
                if call == 0:
                    runs[label][3] = (
                        {k: p.detach().clone()
                         for k, p in param_tree(policy).items()},
                        {k: v.detach().cpu().numpy() for k, v in mets.items()})
                    if label == "sharded":
                        launched = dict(m.policy_score.LAUNCHES)
    want = k_len * rounds
    check(launched.get("policy_score") == want
          and launched.get("policy_score_bwd") == want
          and sum(launched.values()) == 2 * want,
          f"sharded epoch step launched {launched} in {k_len} updates of "
          f"{rounds} rounds; B1 and B2 must launch once per round")
    (p_plain, m_plain), (p_mesh, m_mesh) = (runs["meshless"][3],
                                            runs["sharded"][3])
    param_err = max(float((p_mesh[k] - v).abs().max())
                    for k, v in p_plain.items())
    check(param_err <= DP_PARAM_TOL, f"sharded epoch step parameters differ "
          f"from the meshless step's by {param_err}")
    check(set(m_mesh) == set(m_plain), f"sharded epoch step metrics "
          f"{sorted(m_mesh)} against {sorted(m_plain)}")
    metric_err = 0.0
    for k, v in m_plain.items():
        check(np.isfinite(m_mesh[k]).all(), f"sharded epoch step: {k} "
              f"not finite: {m_mesh[k]}")
        err = float(np.max(np.abs(m_mesh[k] - v) / np.maximum(np.abs(v), 1)))
        check(err <= DP_METRIC_TOL, f"sharded epoch step metric {k} "
              f"{m_mesh[k]} against the meshless {v}")
        metric_err = max(metric_err, err)
    check(bool((m_mesh["completed"] > 0).all()), "sharded epoch step: "
          "nothing completed")
    moved = sum(not torch.equal(p_mesh[k], v) for k, v in init.items())
    check(moved > 0, "sharded epoch step: no parameter moved")
    ms = {label: runs[label][4] for label in runs}
    profiles = {}
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for guard in _plain_head_guard(m.ref):
            stack.enter_context(guard)
        for label in ("meshless", "sharded"):
            policy, step, opt, _, _ = runs[label]
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                runs[label][2], _ = step(
                    policy, opt, {k: v[:1] for k, v in sim0.items()},
                    seeds[:1])
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t1) * 1e3
            kernels = [e for e in prof.key_averages()
                       if str(e.device_type).endswith("CUDA")]
            busy_ms = sum(getattr(e, "self_device_time_total", getattr(
                e, "self_cuda_time_total", 0.0)) for e in kernels) / 1e3
            profiles[label] = {
                "wall_ms": wall_ms, "device_busy_ms": busy_ms,
                "idle_share": 1.0 - busy_ms / wall_ms,
                "kernels_per_unit": sum(e.count for e in kernels),
                "nccl_kernels_per_unit": sum(
                    e.count for e in kernels if "nccl" in e.key.lower())}
    profiles["profile_s"] = time.perf_counter() - t0
    return {"config": {"B": b, "Q": ROLLOUT_EDGES, "rounds": rounds,
                       "width": width, "K": k_len,
                       "d_model": cfg.policy.d_model,
                       "scenario": cfg.scenario},
            "launches": launched, "max_param_err": param_err,
            "max_metric_rel_err": metric_err, "params_moved": moved,
            "update_ms": {label: {"p50": float(np.median(v)), "runs": v}
                          for label, v in ms.items()},
            "profile": profiles,
            "metrics": {k: v.tolist() for k, v in m_mesh.items()}}, launched


def drive_fleet_data_parallel(card, m, arr, single, single_ms,
                              device="cuda"):
    """Phase 6e: a world of one on NCCL through ``make_fleet_mesh()``, the
    fleet rollout (``fleet_rollout``) and the sharded epoch step
    (``sharded_epoch_step``). Returns (report, {path: launch counts})."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    mesh = m.launch_mesh.make_fleet_mesh()
    group = mesh.get_group("fleet")
    backend = str(dist.get_backend(group))
    check(backend == "nccl", f"the fleet mesh runs {backend}, not nccl")
    world = dist.get_world_size()
    check(world == 1 and mesh.shape == (1,) and mesh.device_type == "cuda",
          f"a world of {world}, mesh {mesh}; one card wants a world of one")
    probe = torch.ones(3, device=device)
    dist.all_reduce(probe, group=group)   # NCCL's communicator starts here
    check(probe.tolist() == [1.0] * 3, f"all_reduce on one rank gave "
          f"{probe.tolist()}")
    report = {"card": card, "backend": backend, "world": world,
              "mesh_s": time.perf_counter() - t0}
    report["fleet"], fleet_counts = fleet_rollout(m, mesh, arr, single,
                                                  single_ms, device)
    for backend_name, r in report["fleet"].items():
        print(f"fleet {backend_name} ({card}): {json.dumps(r)}", flush=True)
    report["sharded_epoch"], dp_counts = sharded_epoch_step(
        m, mesh, int(arr["mask"].shape[-1]), device)
    shown = {k: v for k, v in report["sharded_epoch"].items()
             if k != "metrics"}
    print(f"sharded epoch step ({card}): {json.dumps(shown)}", flush=True)
    dist.destroy_process_group()
    report["wall_s"] = time.perf_counter() - t0
    counts = {}
    for c in fleet_counts.values():
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    return report, {"fleet": counts, "data_parallel": dp_counts}


# -- phase 14: the dry run (launch/dryrun.py) on the card's machine ----------

# the production cells traced on fake CUDA tensors, each in a process of its
# own (a fake world of 256 or 512 ranks), with the kernel ops each must show
DRYRUN_CELLS = (
    ("olmo-1b", "train_4k", "single", ("flash_attention_lse",)),
    ("qwen3-4b", "decode_32k", "single", ("decode_attention",)),
    ("falcon-mamba-7b", "prefill_32k", "single", ("mamba_scan_gated",)),
    ("mixtral-8x7b", "train_4k", "single", ("flash_attention_lse",)),
    ("olmo-1b", "train_4k", "multi", ("flash_attention_lse",)))
DRYRUN_TIMEOUT_S = 130
DRYRUN_PEAK_TOL = 0.10    # predicted peak against the card's, relative
DRYRUN_TIMED_STEPS = 5    # the real step's p50, after two warm-ups


def _dryrun_proc(out, args, device):
    """``python -m repro_torch.launch.dryrun`` with ``args``, writing its
    cells to ``out`` and its output beside it."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    log = open(out.with_suffix(".log"), "w")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
         "--device", device, "--out", str(out)],
        env=env, stdout=log, stderr=subprocess.STDOUT), log


def _dryrun_results(procs, deadline):
    """The cells each process wrote, after it exits (killed at
    ``deadline``); a process that failed or wrote no ``ok`` cell fails the
    phase with its log's tail."""
    cells = {}
    for label, (proc, log, out) in procs.items():
        try:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()
        tail = out.with_suffix(".log").read_text()[-3000:]
        check(proc.returncode == 0 and out.exists(),
              f"dry run {label} exited {proc.returncode}:\n{tail}")
        cells[label] = json.loads(out.read_text())
    return cells


def dryrun_against_card(m, device="cuda"):
    """14 (b), the card's side: olmo-1b ``CONFIG`` (remat "full", Adam) at
    phase 12b's shape on the (1, 1) mesh of phase 6e's world of one: two
    steps, then one counted by the dry run's counter with the peak memory
    statistics reset before it, then DRYRUN_TIMED_STEPS timed. The peak is
    ``max_memory_allocated`` less what was allocated before the step's
    parameters, optimizer state and batch were made."""
    from repro_torch.roofline.trace import DeviceCounter, kernel_ops
    cfg = m.get_config(TRAIN_LM_ARCH)
    knobs = m.steps.TrainKnobs()
    shape = m.ShapeConfig("train_4k", TRAIN_LM_SEQ, TRAIN_LM_BATCH, "train")
    mesh = m.launch_mesh.make_host_mesh(1, device=device)
    step = m.steps.build_train_step(cfg, mesh, knobs, shape)
    pspecs, ospecs, bspecs = step.in_specs
    _, opt_init, _ = m.steps.make_optimizer(cfg, knobs)
    _sync(device)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    params = m.lm.init_params(cfg, generator=torch.Generator(
        device=device).manual_seed(LM_SEED), device=device)
    opt = m.steps.place(opt_init(m.named_leaves(params)), ospecs, mesh)
    params = m.steps.place(params, pspecs, mesh)
    pipe = m.SyntheticTokens(cfg.vocab_size, TRAIN_LM_BATCH, TRAIN_LM_SEQ,
                             seed=LM_SEED)
    batch = m.steps.place({k: torch.from_numpy(v).to(device)
                           for k, v in next(pipe).items()}, bspecs, mesh)
    for _ in range(2):
        params, opt, _ = step(params, opt, batch)
    _sync(device)
    torch.cuda.reset_peak_memory_stats()
    counter = DeviceCounter()
    m.build.reset_launch_counts()
    with counter:
        counter.hold((params, opt, batch))
        params, opt, _ = step(params, opt, batch)
    _sync(device)
    peak = torch.cuda.max_memory_allocated() - base
    launched = dict(m.build.LAUNCHES)
    times = []
    for _ in range(DRYRUN_TIMED_STEPS):
        _sync(device)
        t0 = time.perf_counter()
        params, opt, _ = step(params, opt, batch)
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    out = {"flops": counter.flops, "bytes": counter.bytes,
           "counted_peak_bytes": counter.peak_bytes,
           "max_memory_allocated_bytes": peak, "base_bytes": base,
           "kernel_ops": kernel_ops(counter), "launches": launched,
           "step_ms": times, "step_p50_ms": float(np.median(times))}
    del params, opt, batch, step
    torch.cuda.empty_cache()
    return out


def drive_dryrun(m, card, device="cuda", cells=DRYRUN_CELLS):
    """Phase 14: ``launch/dryrun.py`` on the card's machine. Each in a
    process of its own and all at once: the production ``cells`` on fake
    tensors of ``device`` (nothing launched, each ``ok``, its kernel ops
    present) and olmo-1b's 8 x 1024 step on a fake world of one; while they
    trace on the host, the card's side of the check
    (:func:`dryrun_against_card`; its step times are taken beside them).
    The trace's FLOPs must equal the card step's, exactly; its predicted
    peak be within DRYRUN_PEAK_TOL of the card's; its roofline bound (H100
    datasheet figures) no more than the card step's p50. Returns (report,
    the card step's launches)."""
    t_phase = time.perf_counter()
    out_dir = ROOT / "chiprun_out" / "dryrun"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for arch, shape, mesh, _ in cells:
        label = f"{arch} {shape} {mesh}"
        out = out_dir / f"{arch}_{shape}_{mesh}.json"
        out.unlink(missing_ok=True)
        proc, log = _dryrun_proc(out, ["--arch", arch, "--shape", shape,
                                       "--mesh", mesh], device)
        procs[label] = (proc, log, out)
    out = out_dir / "against_card.json"
    out.unlink(missing_ok=True)
    proc, log = _dryrun_proc(out, [
        "--arch", TRAIN_LM_ARCH, "--shape", "train_4k", "--mesh", "one",
        "--batch", str(TRAIN_LM_BATCH), "--seq", str(TRAIN_LM_SEQ)], device)
    procs["against_card"] = (proc, log, out)
    deadline = time.monotonic() + DRYRUN_TIMEOUT_S
    card_side = dryrun_against_card(m, device)
    print(f"dry run, the card's step: {json.dumps(card_side)}", flush=True)
    results = _dryrun_results(procs, deadline)
    report = {"card": card, "cells": {}}
    for arch, shape, mesh, kernels in cells:
        cell, = results[f"{arch} {shape} {mesh}"]
        ok = cell["status"] == "ok"
        check(ok, f"dry run {arch} {shape} {mesh}: "
              f"{cell.get('error') or cell.get('reason')}")
        if not ok:  # reached only where check records rather than raises
            continue
        check(cell["kernel_launches"] == 0 and all(
            cell["kernel_ops"].get(k, 0) > 0 for k in kernels),
              f"dry run {arch} {shape} {mesh}: kernel ops "
              f"{cell['kernel_ops']}, launches {cell['kernel_launches']}")
        report["cells"][f"{arch} {shape} {mesh}"] = {k: cell[k] for k in (
            "chips", "num_layers", "hlo_flops_per_device",
            "hlo_bytes_per_device", "wire_bytes_per_device",
            "collective_ops", "terms", "memory_analysis",
            "peak_bytes_per_device", "kernel_ops", "compile_seconds",
            "lower_seconds", "model_flops", "collective_breakdown",
            "largest_collectives")}
    trace, = results["against_card"]
    check(trace["status"] == "ok", f"dry run at 8 x 1024 on a world of one: "
          f"{trace.get('error')}")
    if trace["status"] != "ok":
        return report, card_side["launches"]
    predicted = trace["peak_bytes_per_device"]
    measured = card_side["max_memory_allocated_bytes"]
    peak_err = abs(predicted - measured) / measured
    bound_ms = trace["terms"]["bound_s"] * 1e3
    report["against_card"] = {
        "trace_flops": trace["hlo_flops_per_device"],
        "card_flops": card_side["flops"],
        "trace_bytes": trace["hlo_bytes_per_device"],
        "card_bytes": card_side["bytes"],
        "predicted_peak_bytes": predicted, "card_peak_bytes": measured,
        "card_counted_peak_bytes": card_side["counted_peak_bytes"],
        "peak_rel_err": peak_err, "bound_ms": bound_ms,
        "dominant": trace["terms"]["dominant"], "terms": trace["terms"],
        "card_step_p50_ms": card_side["step_p50_ms"],
        "card_step_ms": card_side["step_ms"],
        "trace_seconds": trace["compile_seconds"],
        "trace_kernel_ops": trace["kernel_ops"],
        "card_kernel_ops": card_side["kernel_ops"]}
    check(trace["hlo_flops_per_device"] == card_side["flops"],
          f"the dry run's FLOPs {trace['hlo_flops_per_device']} are not the "
          f"card step's {card_side['flops']}")
    check(peak_err <= DRYRUN_PEAK_TOL, f"the dry run's peak {predicted} is "
          f"{peak_err:.3f} off the card's {measured}")
    check(bound_ms <= card_side["step_p50_ms"], f"the roofline bound "
          f"{bound_ms:.1f} ms exceeds the measured step "
          f"{card_side['step_p50_ms']:.1f} ms")
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"dry run: {json.dumps(report)}", flush=True)
    return report, card_side["launches"]


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
    order plain, kernel, kernel, plain (then the library call, if any). The
    plain versions, a yardstick, take a fifth of the repetitions (at least
    two): the slow ones are host-bound loops, and each repetition waits
    behind a sleep twice their host time."""
    plain_reps = max(2, reps // 5)
    plain_a = time_ms(plain, plain_reps, inner)
    kern_a = time_ms(kern, reps, inner)
    kern_b = time_ms(kern, reps, inner)
    plain_b = time_ms(plain, plain_reps, inner)
    library_ms = time_ms(library, reps, inner) if library else None
    bound_ms, bound_by = bound(flops, nbytes, peak)
    return {
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{source}",
        "replaces": (f"src/repro/{replaces}:{line}" if "/" in replaces
                     else f"src/repro/kernels/{replaces}:{line}"),
        "launches": sum(launches.values()), "max_abs_err": err,
        "ms": min(kern_a, kern_b), "plain_ms": min(plain_a, plain_b),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        "shape": shape, "launches_by_path": launches,
        "ms_runs": [kern_a, kern_b], "plain_ms_runs": [plain_a, plain_b],
    }


def _head_shape(c, h):
    b, q, d = c.shape
    return b, q, h.shape[1], d


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


def _b1_unfolded_ms(b, q, z, d):
    """B1's bound by its first design's work (py = h Wpy recomputed)."""
    from repro_torch.kernels.counts import policy_score_counts
    return bound(*policy_score_counts(b, q, z, d, folded=False))[0]


SHAPE_ROW_KEYS = ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "ms_runs",
                  "plain_ms_runs")


def timings(ops, ref, policy_score, enc, enc_train, launches, errs,
            rollout_case=None, temporal=()):
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
    shape, under ``rollout_shape``. ``temporal``: cases at the temporal
    trainer's shapes, where B1 and B2 are timed too, under
    ``temporal_shapes``. ``launches``: {kernel: {path: count}} from the
    main-path runs."""
    from repro_torch.kernels import counts
    c, h, wx, wy, mask = enc[3:]
    b, q, z, d = _head_shape(c, h)
    k = 1
    shape = f"B={b} Q={q} Z={z} d={d}"
    rows = [
        _row("policy_score", 51,
             lambda: ops.policy_score(c, h, wx, wy, mask),
             lambda: ref.policy_score_torch(c, h, wx, wy, mask),
             *counts.policy_score_counts(b, q, z, d),
             launches["policy_score"], errs["policy_score"], shape),
        _row("policy_score_decode", 180,
             lambda: ops.policy_score_decode(c, h, wx, wy, mask, k=k,
                                             normalize=False),
             lambda: ref.policy_score_decode_torch(c, h, wx, wy, mask, 10.0,
                                                   k, False),
             *counts.policy_score_decode_counts(b, q, z, d, k),
             launches["policy_score_decode"], errs["policy_score_decode"],
             shape + f" K={k}"),
    ]
    sampled = _row("policy_score_decode", 180,
                   lambda: ops.policy_score_decode(c, h, wx, wy, mask, k=q,
                                                   normalize=True),
                   lambda: ref.policy_score_decode_torch(c, h, wx, wy, mask,
                                                         10.0, q, True),
                   *counts.policy_score_decode_counts(b, q, z, d, q), {},
                   None, shape + f" K={q} normalized")
    rows[1]["sampled"] = {k_: sampled[k_] for k_ in SHAPE_ROW_KEYS}
    if rollout_case is not None:
        # B1 and B3 as the rollout engine calls them: one launch a round
        # for B = 256 instances of Q = 100 edges
        c, h, wx, wy, mask = rollout_case[4:]
        b, q, z, d = _head_shape(c, h)
        shape = f"B={b} Q={q} Z={z} d={d}"
        for i, (kern, plain, work, tag) in enumerate((
                (lambda: ops.policy_score(c, h, wx, wy, mask),
                 lambda: ref.policy_score_torch(c, h, wx, wy, mask),
                 counts.policy_score_counts(b, q, z, d), ""),
                (lambda: ops.policy_score_decode(c, h, wx, wy, mask, k=1,
                                                 normalize=True),
                 lambda: ref.policy_score_decode_torch(c, h, wx, wy, mask,
                                                       10.0, 1, True),
                 counts.policy_score_decode_counts(b, q, z, d, 1),
                 " K=1 normalized"))):
            row = _row(rows[i]["name"], 0, kern, plain, *work, {}, None,
                       shape + tag)
            rows[i]["rollout_shape"] = {k_: row[k_] for k_ in SHAPE_ROW_KEYS}
    rows[0]["bound_ms_unfolded"] = _b1_unfolded_ms(b, q, z, d)

    # the training shape: B1 forward, then B2 on its output
    c, h, wx, wy, mask = enc_train[3:]
    b, q, z, d = _head_shape(c, h)
    maskf = mask.to(torch.float32)
    out = ops.policy_score(c, h, wx, wy, mask)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(12)
                    ).cuda()
    shape = f"B={b} Q={q} Z={z} d={d}"
    b1_train = _row("policy_score", 51,
                    lambda: policy_score.policy_score_cuda(c, h, wx, wy, maskf),
                    lambda: ref.policy_score_torch(c, h, wx, wy, mask),
                    *counts.policy_score_counts(b, q, z, d), {}, None, shape)
    rows[0]["train_shape"] = {k_: b1_train[k_] for k_ in SHAPE_ROW_KEYS}
    rows[0]["train_shape"]["bound_ms_unfolded"] = _b1_unfolded_ms(b, q, z, d)
    rows.append(_row(
        "policy_score_bwd", 65,
        lambda: policy_score.policy_score_bwd_cuda(g, out, c, h, wx, wy, maskf),
        lambda: ref.policy_score_bwd_torch(g, out, c, h, wx, wy, maskf),
        *counts.policy_score_bwd_counts(b, q, z, d),
        launches["policy_score_bwd"], errs["policy_score_bwd"], shape))
    rows[-1]["max_rel_err"] = errs["policy_score_bwd_rel"]
    rows[-1]["bound_ms_unfolded"] = bound(*counts.policy_score_bwd_counts(
        b, q, z, d, folded=False))[0]
    rows[0]["temporal_shapes"], rows[-1]["temporal_shapes"] = [], []
    for _, b, q, z, c, h, wx, wy, mask in temporal:
        b1, b2 = _head_pair_rows(ops, ref, policy_score, c, h, wx, wy, mask)
        rows[0]["temporal_shapes"].append(b1)
        rows[-1]["temporal_shapes"].append(b2)
    return rows


def _head_pair_rows(ops, ref, policy_score, c, h, wx, wy, mask):
    """B1 and then B2 on B1's output at one shape, each timed beside its
    plain version and bounded by its fold's operations (timings)."""
    from repro_torch.kernels import counts
    b, q, z, d = _head_shape(c, h)
    maskf = mask.to(torch.float32)
    shape = f"B={b} Q={q} Z={z} d={d}"
    b1 = _row("policy_score", 51,
              lambda: policy_score.policy_score_cuda(c, h, wx, wy, maskf),
              lambda: ref.policy_score_torch(c, h, wx, wy, mask),
              *counts.policy_score_counts(b, q, z, d), {}, None, shape)
    out = ops.policy_score(c, h, wx, wy, mask)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(12)
                    ).cuda()
    b2 = _row("policy_score_bwd", 65,
              lambda: policy_score.policy_score_bwd_cuda(g, out, c, h, wx, wy,
                                                         maskf),
              lambda: ref.policy_score_bwd_torch(g, out, c, h, wx, wy, maskf),
              *counts.policy_score_bwd_counts(b, q, z, d), {}, None, shape)
    return ({k: b1[k] for k in SHAPE_ROW_KEYS},
            {k: b2[k] for k in SHAPE_ROW_KEYS})


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


def compare_decode_lse(ops, ref, out, q, kc, vc, slot_pos, pos, window,
                       where):
    """B5 asked for its log-sum-exp: the output the same bits as ``out``
    (the call without it); the lse (B, H) f32 finite, within LSE_TOL of
    the largest |lse| of its plain version on lanes with a valid slot, and
    exactly the plain version's -1e30 on a lane with none. Returns the
    largest |lse - plain| over the lanes with a valid slot."""
    o, lse = ops.decode_attention(q, kc, vc, slot_pos, pos, window=window,
                                  with_lse=True)
    want = ref.decode_attention_lse_torch(q, kc, slot_pos, pos,
                                          window=window)
    check(torch.equal(o, out), f"decode_attention's output changed when "
          f"asked for its lse at {where}")
    check(lse.shape == want.shape and lse.dtype == torch.float32
          and bool(torch.isfinite(lse).all()),
          f"decode_attention's lse malformed at {where}")
    empty = want <= -1e29
    check(torch.equal(lse[empty], want[empty]), f"decode_attention's lse of "
          f"a lane with no valid slot is not -1e30 at {where}")
    if bool(empty.all()):
        return 0.0
    err = float((lse - want)[~empty].abs().max())
    check(err <= LSE_TOL * float(want[~empty].abs().max()),
          f"decode_attention's lse err {err} at {where}")
    return err


def compare_attention(ops, ref, errs):
    """B4 and B5 against their plain versions on the card at the listed
    cases, among them the shapes the qwen3-4b, hymba-1.5b, mixtral-8x7b
    and qwen2-vl-72b models give them; raises on a disagreement beyond
    the reference's bars (2e-4 f32,
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
            (1, 300, 16, 4, 128, bf16, False, 70),
            # mixtral heads (G=4) and its 4096 window, a prompt past it;
            # qwen2-vl heads (G=8)
            (1, 4500, 32, 8, 128, bf16, True, 4096),
            (1, 4500, 32, 8, 128, f32, True, 4096),
            (1, 2048, 64, 8, 128, bf16, True, None),
            (2, 700, 64, 8, 128, f32, True, None),
            # whisper's encoder self attention over 1,500 frames
            (8, 1500, 6, 6, 64, bf16, False, None),
            (8, 1500, 6, 6, 64, f32, False, None)):
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
            (2, 1, 32, 8, 128, bf16, (1, 0), None, None),
            # mixtral's rolled 4-lane cache, and in f32; qwen2-vl's heads
            MIXTRAL_CACHE,
            (2, 4096, 32, 8, 128, f32, (0, 3000), (404, None), 4096),
            (4, 4096, 64, 8, 128, bf16, (1, 700, 2600, 4096), None, None),
            (2, 512, 64, 8, 128, f32, (100, 512), None, None)):
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
        lse_err = compare_decode_lse(ops, ref, got, q, kc, vc, slot_pos, pos,
                                     window, (b, w, h, kv, hd, str(dtype),
                                              fills, roll, window))
        errs["decode_attention"] = max(errs["decode_attention"], err)
        errs["decode_attention_lse"] = max(errs["decode_attention_lse"],
                                           lse_err)
        report.append({"kernel": "decode_attention", "B": b, "W": w, "H": h,
                       "KV": kv, "hd": hd, "dtype": str(dtype),
                       "fills": fills, "rolling_from": roll,
                       "window": window, "err": err, "lse_err": lse_err})
    torch.cuda.synchronize()
    return report


def compare_cross_attention(ops, ref, attention, errs):
    """Whisper's attention shapes on the card, against the plain versions:
    B4 non-causal at Sq in WHISPER_CROSS_SQ against Sk in WHISPER_CROSS_SK
    (the decoder's cross attention over the frames), 8 utterances, bf16
    and f32, at the reference's bars, with its lse against the plain one
    (LSE_TOL of max |lse|) and the output the same bits with the lse store;
    ``FlashAttention``'s gradients (B4 forward, the pair-scan backward) at
    WHISPER_BWD_CASES against autograd through the plain version
    (ATTN_BWD_TOL); the one-token cross attention
    (``attention.cross_decode_attention``: B5 over the frames' slot map)
    against the plain unmasked attention at (8, 1500, 6, 64). Every reading
    the same bits on two calls; the largest errors fold into ``errs``."""
    gen = torch.Generator().manual_seed(22)
    report = {"cross": [], "backward": [], "decode": []}
    h, hd, b = 6, 64, WHISPER_BATCH
    for dtype in (torch.bfloat16, torch.float32):
        for sk in WHISPER_CROSS_SK:
            k, v = (torch.randn(b, sk, h, hd, generator=gen).to("cuda", dtype)
                    for _ in range(2))
            for sq in WHISPER_CROSS_SQ:
                where = (b, sq, sk, h, hd, str(dtype))
                q = torch.randn(b, sq, h, hd, generator=gen).to("cuda", dtype)
                got = ops.flash_attention(q, k, v, causal=False)
                again, lse = LIB.flash_attention_lse(q, k, v, False, None)
                want = ref.flash_attention_torch(q, k, v, causal=False)
                want_lse = ref.flash_attention_lse_torch(q, k, causal=False)
                err, excess = _attn_err(got, want, dtype)
                lse_err = float((lse - want_lse).abs().max())
                check(got.shape == q.shape and bool(torch.isfinite(got).all()),
                      f"cross flash_attention malformed at {where}")
                check(excess <= ATTN_TOL[dtype], f"cross flash_attention err "
                      f"{err} beyond allclose({ATTN_TOL[dtype]}) at {where}")
                check(lse.shape == (b, h, sq) and lse_err <= LSE_TOL * float(
                    want_lse.abs().max()), f"cross lse err {lse_err} at "
                      f"{where}")
                check(torch.equal(got, again), "cross flash_attention differs "
                      f"with the lse store or between two calls at {where}")
                errs["flash_attention"] = max(errs["flash_attention"], err)
                report["cross"].append({"B": b, "Sq": sq, "Sk": sk,
                                        "dtype": str(dtype), "err": err,
                                        "lse_err": lse_err})
    for bb, sq, sk, dtype in WHISPER_BWD_CASES:
        where = (bb, sq, sk, h, hd, str(dtype))
        q, dout = (torch.randn(bb, sq, h, hd, generator=gen).to("cuda", dtype)
                   for _ in range(2))
        k, v = (torch.randn(bb, sk, h, hd, generator=gen).to("cuda", dtype)
                for _ in range(2))

        def grads(fn):
            leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
            fn(*leaves).backward(dout)
            return [x.grad for x in leaves]

        got = grads(lambda *x: ops.flash_attention(*x, causal=False))
        again = grads(lambda *x: ops.flash_attention(*x, causal=False))
        plain = grads(lambda *x: ref.flash_attention_torch(*x, causal=False))
        row = {"B": bb, "Sq": sq, "Sk": sk, "dtype": str(dtype)}
        for name, g, a, p in zip(("dq", "dk", "dv"), got, again, plain):
            rel = float((g.float() - p.float()).abs().max()) / max(
                float(p.float().abs().max()), 1e-30)
            check(g.shape == p.shape and bool(torch.isfinite(g).all()),
                  f"{name} malformed at {where}")
            check(rel <= ATTN_BWD_TOL[dtype], f"{name} at {where}: {rel} of "
                  f"its largest entry, beyond {ATTN_BWD_TOL[dtype]}")
            check(torch.equal(g, a), f"{name} differs between two calls at "
                  f"{where}")
            row[f"{name}_of_largest"] = rel
        report["backward"].append(row)
        del q, k, v, dout, got, again, plain
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn(b, 1, h, hd, generator=gen).to("cuda", dtype)
        k, v = (torch.randn(b, WHISPER_FRAMES, h, hd, generator=gen).to(
            "cuda", dtype) for _ in range(2))
        got = attention.cross_decode_attention(q, k, v)
        again = attention.cross_decode_attention(q, k, v)
        want = ref.flash_attention_torch(q, k, v, causal=False)
        err, excess = _attn_err(got, want, dtype)
        where = (b, WHISPER_FRAMES, h, hd, str(dtype))
        check(got.shape == q.shape and excess <= ATTN_TOL[dtype],
              f"cross decode attention (B5 on the frames) err {err} at "
              f"{where}")
        check(torch.equal(got, again), f"cross decode attention differs "
              f"between two calls at {where}")
        errs["decode_attention"] = max(errs["decode_attention"], err)
        report["decode"].append({"B": b, "frames": WHISPER_FRAMES,
                                 "dtype": str(dtype), "err": err})
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
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
                     ref, ops, gen_len=LM_GEN, long_request=None):
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
    plain versions never, and B6 only through its gated entry. Each
    dispatched request generates ``gen_len`` tokens. ``long_request``
    (prompt tokens, slots a lane) serves one more request, on a fourth,
    1-lane edge, after the others, in the same count: with a prompt past
    the window its cache must be the rolling one (every slot holding one of
    the last W positions). Returns the summary and the edges."""
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
        edges[int(target)].submit(r.rid, int(r.data_size), gen_len=gen_len)

    def real_done():
        return sum(len([r for r in be.finished if r < LM_WARM])
                   for be in edges)

    rounds = 0
    while real_done() < len(reqs) and rounds < 10_000:
        for be in edges:
            step(be)
        rounds += 1
    serve_s = time.perf_counter() - t0
    long = None
    if long_request is not None:
        plen, max_seq = long_request
        long_edge = batching.LMEdgeBackend(cfg, params, lanes=1,
                                           max_seq=max_seq, seed=len(lanes))
        long_edge.submit(len(reqs), plen, gen_len)
        while long_edge._queue or long_edge._lane_states[0].remaining:
            step(long_edge)
        check(long_edge.finished == {len(reqs): gen_len},
              f"the long request finished as {long_edge.finished}")
        sp = long_edge._cache["slot_pos"][0]
        w, last = sp.shape[0], plen + gen_len - 1
        check(w < plen and int(sp.min()) == last - w + 1
              and int(sp.max()) == last,
              f"the {plen}-token request's cache (W = {w}) holds positions "
              f"{int(sp.min())}..{int(sp.max())}, not the rolling "
              f"{last - w + 1}..{last}")
        long = {"prompt_tokens": plen, "max_seq": max_seq, "window": w,
                "generated": gen_len, "slot_pos_min": int(sp.min()),
                "slot_pos_max": int(sp.max()),
                "prefill_ms": long_edge.phi._ys[0] * 1e3}
    torch.cuda.synchronize()
    launches = {k: build.LAUNCHES[k] for k in ("flash_attention",
                                               "decode_attention",
                                               "mamba_scan")}
    guard.close()
    admissions = sum(len(be.phi._xs) for be in edges) + (long is not None)
    check(real_done() == len(reqs), f"served {real_done()} of {len(reqs)}")
    check(share[2] >= share[0], f"dispatch share {share}: the 4-lane edge "
          "got fewer requests than the 1-lane edge")
    for be in edges:
        for rid, n in be.finished.items():
            want = 1 if rid >= LM_WARM else gen_len
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
        "gen_len": gen_len, "dispatch_share": share, "long_request": long,
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


def profile_lm(cfg, params, lm, edge=None, prompt_len=2048, n_decode=5, *,
               kinds=KERNEL_KINDS, ranges=None, prefill_batch=None,
               decode_cache=None, decode_batch=None, max_seq=LM_MAX_SEQ):
    """Device busy ms, idle share and kernels per unit from torch.profiler
    traces of one prefill (``prompt_len`` random tokens, or
    ``prefill_batch``) and of ``n_decode`` decode steps over ``edge``'s
    batch cache (all its lanes; or ``decode_cache`` with ``decode_batch``);
    device ms by kind (``kinds``). ``ranges``: a context manager that names
    pieces in the trace with ``record_function`` and yields their names;
    their device ms go under ``device_ms_by_piece``. The prefill's cache
    has ``max_seq`` slots; its prompt length is its ``tokens``'."""
    from torch.profiler import ProfilerActivity, profile
    head = lm.head_f32(params, cfg)
    if prefill_batch is None:
        prefill_batch = {"tokens": torch.randint(
            0, cfg.vocab_size, (1, prompt_len),
            generator=torch.Generator().manual_seed(5),
            dtype=torch.int32).cuda()}
    prompt_len = prefill_batch.get(
        "tokens", next(iter(prefill_batch.values()))).shape[1]
    lm.prefill(params, prefill_batch, cfg, max_seq=max_seq, head=head)
    torch.cuda.synchronize()
    out = {}

    def traced(fn, n):
        with contextlib.ExitStack() as stack:
            names = stack.enter_context(ranges()) if ranges else ()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3 / n
        res = _device_summary(prof, n, wall_ms, skip=names, kinds=kinds)
        if names:
            res["device_ms_by_piece"] = _range_device_ms(prof, names, n)
        return res

    out["prefill"] = {"prompt_tokens": prompt_len, **traced(
        lambda: lm.prefill(params, prefill_batch, cfg, max_seq=max_seq,
                           head=head), 1)}
    if decode_cache is None:
        decode_cache = edge._cache
        decode_batch = {"token": torch.zeros(edge.lanes, dtype=torch.int32,
                                             device=edge.device)}
    cache, _ = lm.decode_step(params, decode_cache, decode_batch, cfg,
                              head=head)
    torch.cuda.synchronize()

    def steps():
        for _ in range(n_decode):
            lm.decode_step(params, cache, decode_batch, cfg, head=head)

    out["decode"] = {"lanes": int(cache["pos"].shape[0]),
                     **traced(steps, n_decode),
                     "pos": cache["pos"].tolist()}
    return out


def _range_device_ms(prof, names, n):
    """Device ms per unit under each ``record_function`` range ``names``."""
    pieces = dict.fromkeys(names, 0.0)
    for e in prof.events():
        if e.name in pieces and str(e.device_type).endswith("CPU"):
            pieces[e.name] += next(
                (getattr(e, a) for a in ("device_time_total",
                                         "cuda_time_total")
                 if hasattr(e, a)), 0.0) / 1e3 / n
    return pieces


def _to_f32(tree):
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_f32(v) for v in tree]
    return tree.float()


class _RouteForcing:
    """Routes of the MoE layers (``moe.route``) recorded on the plain run
    and forced on the kernel run, call for call, as the tokens are
    teacher-forced: the kernel run keeps its own router logits and gates
    (the softmax of its logits at the forced experts) and counts the
    (token, layer) routes where its own top k differs from the forced one,
    in its experts or only in their order. A differing route's margin is
    the plain run's logit gap, at the first place the two lists differ,
    between the expert the plain run chose and the one the kernel run
    chose instead, relative to the token's largest |router logit|: the
    near-tie that the two runs broke either way."""

    def __init__(self, moe):
        self.moe, self.route = moe, moe.route
        self.calls, self.next, self.margins, self.where = [], 0, [], []
        self.routes = self.sets = 0

    def recording(self):
        from unittest import mock

        def route(x, router, k):
            logits, idx, gates = self.route(x, router, k)
            self.calls.append((logits, idx))
            return logits, idx, gates
        return mock.patch.object(self.moe, "route", route)

    def forcing(self):
        from unittest import mock

        def route(x, router, k):
            logits, own, _ = self.route(x, router, k)
            plain_logits, idx = self.calls[self.next]
            self.next += 1
            neq = own != idx
            differ = neq.any(-1)
            j = neq.int().argmax(-1, keepdim=True)  # the first difference
            gap = (plain_logits.gather(-1, idx.gather(-1, j))
                   - plain_logits.gather(-1, own.gather(-1, j)))[..., 0]
            rel = gap / plain_logits.abs().amax(-1)
            self.margins.append(rel[differ])
            self.where.extend([self.next - 1] * int(differ.sum()))
            self.sets += int((own.sort(-1).values
                              != idx.sort(-1).values).any(-1).sum())
            self.routes += differ.numel()
            return logits, idx, torch.softmax(logits.gather(-1, idx), -1)
        return mock.patch.object(self.moe, "route", route)

    def report(self, gap):
        """{"routes", "differing", "experts_differing", "max_rel_margin"};
        raises where a differing route's margin exceeds ``gap`` (None: no
        bar)."""
        check(self.next == len(self.calls), f"the kernel run routed "
              f"{self.next} times, the plain run {len(self.calls)}")
        margins = torch.cat(self.margins) if self.margins else torch.zeros(0)
        worst = float(margins.max()) if margins.numel() else None
        quantiles = ([float(q) for q in margins.float().quantile(
            torch.tensor([0.5, 0.9, 0.99], device=margins.device))]
            if margins.numel() else None)
        worst_call = (self.where[int(margins.argmax())]
                      if margins.numel() else None)
        check(worst is None or gap is None or worst <= gap,
              f"a route that differs between the kernel and plain paths "
              f"has a plain logit gap of {worst} of the token's largest "
              f"|router logit|, above {gap}")
        return {"routes": self.routes, "differing": int(margins.numel()),
                "experts_differing": self.sets, "max_rel_margin": worst,
                "rel_margin_quantiles_50_90_99": quantiles,
                "worst_call": worst_call, "calls": len(self.calls),
                "gap": gap}


def lm_kernel_vs_plain(cfg, params, lm, ops, ref, prompt_len=1500,
                       n_decode=16, scan_ulp=False, *, inputs=None, moe=None,
                       f32_layers=None):
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
    entry in place of its plain scan.

    ``inputs``: {"prefill": batch, "decode": [batch per step]} in place of
    a random ``prompt_len``-token prompt and ``n_decode`` random tokens
    (embeddings are cast to each run's dtype). ``moe``: the MoE module,
    whose routes the kernel run takes from the plain run
    (:class:`_RouteForcing`, checked against MOE_ROUTE_GAP).
    ``f32_layers``: run f32 at the model's widths with only its first
    ``f32_layers`` layers; the others are dropped from ``params`` first and
    the rest made f32 in place, so the caller's model is spent. With
    ``moe`` too, the full-depth bf16 routes are reported without a bar, and
    the first MOE_ROUTE_LAYERS layers are compared in bf16 as well
    (``bf16_cut``), their routes barred. The prompt's length is its
    ``tokens``' (whisper's prefill also takes its frames, ``embeds``)."""
    from unittest import mock
    if inputs is None:
        gen = torch.Generator().manual_seed(6)
        prompt = torch.randint(0, cfg.vocab_size, (1, prompt_len),
                               generator=gen, dtype=torch.int32).cuda()
        forced = torch.randint(0, cfg.vocab_size, (n_decode, 1),
                               generator=gen, dtype=torch.int32).cuda()
        inputs = {"prefill": {"tokens": prompt},
                  "decode": [{"token": t} for t in forced]}
    prompt = inputs["prefill"]
    prompt_len = prompt.get("tokens", next(iter(prompt.values()))).shape[1]
    n_decode = len(inputs["decode"])

    def run(cfg, params, head):
        cache, logits = lm.prefill(params, inputs["prefill"], cfg,
                                   max_seq=prompt_len + n_decode, head=head)
        rows = [logits]
        for batch in inputs["decode"]:
            cache, logits = lm.decode_step(params, cache, batch, cfg,
                                           head=head)
            rows.append(logits)
        return torch.cat(rows)[:, :cfg.vocab_size]

    def rel_err(got, plain):
        return (got - plain).abs().amax(-1) / plain.abs().amax(-1)

    def compare(cfg, params, tol, nudge=False, route_bar=True):
        head = lm.head_f32(params, cfg)
        routes = _RouteForcing(moe) if moe is not None else None
        with contextlib.ExitStack() as stack:
            if routes is not None:
                stack.enter_context(routes.recording())
            for patch in (
                    mock.patch.object(ops, "flash_attention",
                                      lambda q, k, v, *, causal, window,
                                      chunk: ref.flash_attention_torch(
                                          q, k, v, causal=causal,
                                          window=window)),
                    mock.patch.object(ops, "decode_attention",
                                      lambda q, kc, vc, sp, pos, *, window:
                                      ref.decode_attention_torch(
                                          q, kc, vc, sp, pos,
                                          window=window)),
                    mock.patch.object(ops, "mamba_scan",
                                      ref.mamba_scan_torch),
                    mock.patch.object(ops, "mamba_scan_gated",
                                      ref.mamba_scan_gated_torch)):
                stack.enter_context(patch)
            plain = run(cfg, params, head)
        with contextlib.ExitStack() as stack:
            if routes is not None:
                stack.enter_context(routes.forcing())
            kern = run(cfg, params, head)
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
        if routes is not None:
            out["routes"] = routes.report(MOE_ROUTE_GAP[cfg.dtype]
                                          if route_bar else None)
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
           "bf16": compare(cfg, params, LM_LOGIT_TOL_BF16, nudge=scan_ulp,
                           route_bar=f32_layers is None)}
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    if f32_layers is not None:
        layers = params["layers"]
        del layers[f32_layers:]
        torch.cuda.empty_cache()
        cfg32 = dataclasses.replace(cfg32, num_layers=f32_layers)
        out["f32_layers"] = f32_layers
        if moe is not None:
            check(MOE_ROUTE_LAYERS <= f32_layers, "the bf16 route cut is "
                  "taken from the f32 cut's layers")
            out["bf16_cut_layers"] = MOE_ROUTE_LAYERS
            out["bf16_cut"] = compare(
                dataclasses.replace(cfg, num_layers=MOE_ROUTE_LAYERS),
                {**params, "layers": layers[:MOE_ROUTE_LAYERS]},
                LM_LOGIT_TOL_BF16)
        for i, layer in enumerate(layers):  # each bf16 layer goes as its
            layers[i] = _to_f32(layer)      # f32 copy comes
    params32 = _to_f32(params)
    out["f32"] = compare(cfg32, params32, LM_LOGIT_TOL_F32)
    del params32
    torch.cuda.empty_cache()
    return out


# -- phase 12b: LM pretraining (B4 with its log-sum-exp, the flash backward) --

TRAIN_LM_ARCH = "olmo-1b"
TRAIN_LM_BATCH = 8
TRAIN_LM_SEQ = 1024
TRAIN_LM_STEPS = 12
TRAIN_LM_TIMED = 2       # steps 2-11 are timed; 0-1 warm the allocator
TRAIN_LM_LAYERS = 2      # (d) and (e): olmo-1b's widths at 2 layers
TRAIN_LM_CKPT_AT = 3     # (e): a checkpoint after step 3, of 6
TRAIN_LM_RESUME_TOL = 1e-3
# (a) and (b): (B, S, H, KV, hd, dtype, causal, window, chunk): olmo-1b's
# training heads in bf16 and f32 (chunk = its attn_chunk), qwen3-4b's GQA
# heads, a ragged S causal and windowed (chunk 16: S pads to 80)
TRAIN_ATTN_CASES = (
    (8, 1024, 16, 16, 128, torch.bfloat16, True, None, 512),
    (8, 1024, 16, 16, 128, torch.float32, True, None, 512),
    (2, 1024, 32, 8, 128, torch.bfloat16, True, None, 512),
    (2, 65, 32, 8, 128, torch.bfloat16, True, None, 16),
    (2, 65, 32, 8, 128, torch.float32, True, 48, 16),
)
LSE_TOL = 1e-5           # of max |lse|: f32 sums in another order
# the backward against autograd through the plain version, of each
# gradient's largest |entry|: f32 sums in another order; in bf16 the
# forward's bf16 output enters delta = rowsum(dO * O) and the gradients are
# rounded to bf16
ATTN_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -6}
TRAIN_LOSS_TOL = 1e-5    # (d), relative
TRAIN_GRAD_TOL = 1e-4    # (d), of each gradient's largest |entry|
# device ms by kind in the training step's trace: B4's forward kernel, the
# library GEMMs, PyTorch's element-wise and reduction kernels
TRAIN_KERNEL_KINDS = (("B4", ("flash_fwd",)),
                      ("gemm", ("gemm", "nvjet", "xmma", "cutlass")),
                      ("elementwise", ("elementwise_kernel",)),
                      ("reduce", ("reduce_kernel",)))
# host ranges named in the profiled step: the pair-scan backward, the clip
# and Adam
TRAIN_RANGES = ("lm_train.attention_backward", "lm_train.clip",
                "lm_train.adam")


def _train_lm_argv(device, steps=None, *extra, arch=TRAIN_LM_ARCH):
    return ["lm", "--arch", arch, "--scale", "full", "--batch-size",
            str(TRAIN_LM_BATCH), "--seq", str(TRAIN_LM_SEQ), "--steps",
            str(steps or TRAIN_LM_STEPS), "--log-every", "1", "--device",
            device, *extra]


def compare_training_attention(ops, ref, device="cuda"):
    """(a) B4's lse against its plain version (LSE_TOL of max |lse|), the
    output with the lse store the same bits as without it; (b) the
    gradients of ``FlashAttention`` (B4 forward, the pair-scan backward)
    against autograd through the plain version (ATTN_BWD_TOL of each
    gradient's largest |entry|). Every reading the same bits on two
    calls."""
    gen = torch.Generator().manual_seed(41)
    report = []
    for b, s, h, kv, hd, dtype, causal, window, chunk in TRAIN_ATTN_CASES:
        where = (b, s, h, kv, hd, str(dtype), causal, window)
        q, k, v, dout = (torch.randn(b, s, n, hd, generator=gen).to(
            device, dtype) for n in (h, kv, kv, h))
        out, lse = LIB.flash_attention_lse(q, k, v, causal, window)
        out2, lse2 = LIB.flash_attention_lse(q, k, v, causal, window)
        bare = LIB.flash_attention(q, k, v, causal, window)
        want = ref.flash_attention_lse_torch(q, k, causal=causal,
                                             window=window)
        lse_err = float((lse - want).abs().max())
        check(lse.shape == (b, h, s) and bool(torch.isfinite(lse).all()),
              f"lse malformed at {where}")
        check(lse_err <= LSE_TOL * float(want.abs().max()),
              f"lse err {lse_err} beyond {LSE_TOL} of max |lse| at {where}")
        check(torch.equal(out, bare), f"B4's output changes with the lse "
              f"store at {where}")
        check(torch.equal(out, out2) and torch.equal(lse, lse2),
              f"B4 with lse differs between two calls at {where}")
        del want, out2, lse2, bare

        def grads(fn):
            leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
            fn(*leaves).backward(dout)
            return [x.grad for x in leaves]

        def kernel(*x):
            return ops.flash_attention(*x, causal=causal, window=window,
                                       chunk=chunk)

        got, again = grads(kernel), grads(kernel)
        plain = grads(lambda *x: ref.flash_attention_torch(
            *x, causal=causal, window=window))
        bwd = {}
        for name, g, a, p in zip(("dq", "dk", "dv"), got, again, plain):
            err = float((g.float() - p.float()).abs().max())
            rel = err / max(float(p.float().abs().max()), 1e-30)
            bwd[name] = {"max_abs_err": err, "of_largest": rel}
            check(g.dtype == dtype and bool(torch.isfinite(g).all()),
                  f"{name} malformed at {where}")
            check(rel <= ATTN_BWD_TOL[dtype], f"{name} err {err} ({rel} of "
                  f"its largest entry) beyond {ATTN_BWD_TOL[dtype]} at "
                  f"{where}")
            check(torch.equal(g, a), f"{name} differs between two calls at "
                  f"{where}")
        report.append({"B": b, "S": s, "H": h, "KV": kv, "hd": hd,
                       "dtype": str(dtype), "causal": causal,
                       "window": window, "chunk": chunk,
                       "lse_max_abs_err": lse_err, "backward": bwd})
        del q, k, v, dout, got, again, plain
        torch.cuda.empty_cache()
    return report


@contextlib.contextmanager
def _train_ranges(m):
    """Name the training step's pieces in a torch.profiler trace: the
    pair-scan backward (``models.attention.flash_bwd``, which
    ``FlashAttention.backward`` looks up at each call), and the clip and
    Adam that ``launch.steps`` binds when a step is built."""
    from unittest import mock
    from torch.profiler import record_function

    def ranged(label, fn):
        def wrapped(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return wrapped

    with contextlib.ExitStack() as stack:
        for module, name, label in (
                (m.attention, "flash_bwd", "lm_train.attention_backward"),
                (m.steps, "clip_by_global_norm", "lm_train.clip"),
                (m.steps, "adam_update", "lm_train.adam")):
            stack.enter_context(mock.patch.object(
                module, name, ranged(label, getattr(module, name))))
        yield


def profile_training(m, run, device="cuda", kinds=TRAIN_KERNEL_KINDS, *,
                     batch=None, ranges=None):
    """One more step of ``run``'s model under torch.profiler: device busy
    ms, idle share, kernels per step, device ms by kind (``kinds``) and by
    named piece (TRAIN_RANGES, and the names ``ranges``, a context manager
    like :func:`_moe_ranges`, yields). The step's batch is the run's next
    (or ``batch``)."""
    from torch.profiler import ProfilerActivity, profile
    cfg = dataclasses.replace(run["cfg"], num_microbatches=1,
                              optimizer="adam")
    params, opt_state, pipe = run["params"], run["opt_state"], run["pipeline"]
    with _train_ranges(m), (ranges() if ranges
                            else contextlib.nullcontext(())) as extra:
        names = TRAIN_RANGES + tuple(extra)
        step = m.steps.build_train_step(cfg, knobs=m.steps.TrainKnobs(
            lr=3e-4, grad_clip=1.0))
        if batch is None:
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in next(pipe).items()}
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, opt_state, metrics = step(params, opt_state, batch)
            float(metrics["loss_total"])
            wall_ms = (time.perf_counter() - t0) * 1e3
    out = _device_summary(prof, 1, wall_ms, skip=names, kinds=kinds)
    out["device_ms_by_piece"] = _range_device_ms(prof, names, 1)
    return out


def _loss_aux_grads(m, params, batch, cfg):
    """(total, aux_loss, {path: gradient}) of ``lm.train_loss``."""
    leaves = m.named_leaves(params)
    for t in leaves.values():
        t.requires_grad_(True)
    total, metrics = m.lm.train_loss(params, batch, cfg)
    grads = torch.autograd.grad(total, list(leaves.values()),
                                allow_unused=True)
    return (float(total.detach()), float(metrics["aux_loss"].detach()),
            dict(zip(leaves, grads)))


def train_loss_vs_plain(m, ref, cfg, params, batch, want, routes=None):
    """``train_loss`` and its gradients through the kernels (B4 with its
    lse and the pair-scan backward; B6's gated entry and B6b) against the
    plain path (autograd through the plain versions of B4 and of B6's gated
    entry), the plain path first, the same weights and batch: the loss
    within TRAIN_LOSS_TOL relative, ``aux_loss`` and every gradient within
    TRAIN_GRAD_TOL (relative; of the gradient's largest |entry|); the
    launches of both runs are ``want`` ({kernel: launches} on the kernel
    path; nothing on the plain path) and B5 none. ``routes``: a
    :class:`_RouteForcing` whose plain-run routes the kernel run takes
    (reported, barred at GAP)."""
    from unittest import mock

    def plain(q, k, v, *, causal=True, window=None, chunk=512):
        return ref.flash_attention_torch(q, k, v, causal=causal,
                                         window=window)

    m.build.reset_launch_counts()
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(m.ops, "flash_attention",
                                              plain))
        stack.enter_context(mock.patch.object(m.ops, "mamba_scan_gated",
                                              ref.mamba_scan_gated_torch))
        if routes is not None:
            stack.enter_context(routes.recording())
        plain_loss, plain_aux, plain_grads = _loss_aux_grads(m, params,
                                                             batch, cfg)
    with (routes.forcing() if routes is not None
          else contextlib.nullcontext()):
        loss, aux, grads = _loss_aux_grads(m, params, batch, cfg)
    torch.cuda.synchronize()
    launched = {k: m.build.LAUNCHES[k] for k in want}
    check(launched == want and m.build.LAUNCHES["decode_attention"] == 0,
          f"{cfg.name}: launched {dict(m.build.LAUNCHES)} in a kernel and a "
          f"plain loss, want {want} and no B5 (remat {cfg.remat!r})")
    loss_rel = abs(loss - plain_loss) / abs(plain_loss)
    aux_rel = abs(aux - plain_aux) / max(abs(plain_aux), 1e-30)
    check(loss_rel <= TRAIN_LOSS_TOL, f"{cfg.name}: loss {loss} against "
          f"the plain path's {plain_loss}")
    check(aux_rel <= TRAIN_GRAD_TOL, f"{cfg.name}: aux_loss {aux} against "
          f"the plain path's {plain_aux}")
    worst, worst_key = 0.0, None
    for key, g in grads.items():
        p = plain_grads[key]
        check((g is None) == (p is None), f"{key}: gradient on one path only")
        if g is None or not g.numel():
            continue
        rel = float((g - p).abs().max()) / max(float(p.abs().max()), 1e-30)
        if rel > worst:
            worst, worst_key = rel, key
    check(worst <= TRAIN_GRAD_TOL, f"gradient of {worst_key} differs by "
          f"{worst} of its largest entry from the plain path's")
    out = {"layers": cfg.num_layers, "dtype": cfg.dtype,
           "batch": {k: list(v.shape) for k, v in batch.items()},
           "loss": loss, "plain_loss": plain_loss, "loss_rel_err": loss_rel,
           "aux_loss": aux, "aux_rel_err": aux_rel,
           "worst_grad_rel_err": worst, "worst_grad_leaf": worst_key,
           "launches": launched}
    if routes is not None:
        out["routes"] = routes.report(MOE_ROUTE_GAP["float32"])
    return out


def training_kernel_vs_plain(m, ref, device="cuda", arch=TRAIN_LM_ARCH,
                             batch_size=TRAIN_LM_BATCH):
    """(d) ``arch``'s widths at TRAIN_LM_LAYERS layers in f32: one batch of
    ``batch_size`` x TRAIN_LM_SEQ tokens through :func:`train_loss_vs_plain`;
    under remat 'full' B4 and B6 twice per layer of theirs, B6b once."""
    cfg = dataclasses.replace(m.get_config(arch),
                              num_layers=TRAIN_LM_LAYERS, dtype="float32")
    params = m.lm.init_params(cfg, generator=torch.Generator(
        device=device).manual_seed(LM_SEED))
    pipe = m.SyntheticTokens(cfg.vocab_size, batch_size, TRAIN_LM_SEQ,
                             seed=1)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in next(pipe).items()}
    attn = cfg.family != "ssm"
    ssm = cfg.family in ("ssm", "hybrid")
    want = {"flash_attention": 2 * TRAIN_LM_LAYERS * attn,
            "mamba_scan": 2 * TRAIN_LM_LAYERS * ssm,
            "mamba_scan_bwd": TRAIN_LM_LAYERS * ssm}
    return {"arch": arch, **train_loss_vs_plain(m, ref, cfg, params, batch,
                                                want)}


def _bits(a):
    """The bytes of a host array (bf16 leaves are 2-byte void)."""
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def training_resume(m, root, device="cuda"):
    """(e) olmo-1b's widths at TRAIN_LM_LAYERS layers (cut: depth; a
    full-depth checkpoint is ~12 GB), bf16, through ``launch.train lm``: six
    steps uninterrupted; four with a checkpoint after step
    TRAIN_LM_CKPT_AT; every object dropped; the checkpoint restored (the
    parameters and Adam's moments equal those saved, bit for bit; the
    pipeline at the saved step); the rerun resumes there and runs to step
    6: its losses within TRAIN_LM_RESUME_TOL relative of the uninterrupted
    run's. Removes the directory."""
    import shutil
    from unittest import mock
    real = m.launch_train.get_config
    ckpt = root / "build" / "chip_smoke_lm_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    args = ("--ckpt", str(ckpt), "--ckpt-every", str(TRAIN_LM_CKPT_AT))
    with mock.patch.object(m.launch_train, "get_config", lambda arch: (
            dataclasses.replace(real(arch), num_layers=TRAIN_LM_LAYERS))):
        whole = m.launch_train.main(_train_lm_argv(device, 6))
        whole_losses = whole["losses"]
        del whole
        first = m.launch_train.main(_train_lm_argv(device, 4, *args))
        saved = {k: m.checkpoint.convert.host_array(t) for k, t in
                 m.checkpoint.lm_train_tree(first["params"],
                                            first["opt_state"]).items()}
        pipe_step = first["pipeline"].step
        del first
        torch.cuda.empty_cache()
        restored = m.checkpoint.Checkpointer(str(ckpt)).restore_latest()
        check(restored["step"] == TRAIN_LM_CKPT_AT
              and restored["extras"]["pipeline"]["step"] == pipe_step
              == TRAIN_LM_CKPT_AT + 1, "the checkpoint is not the step-3 "
              f"one: {restored['step']}, {restored['extras']}")
        check(set(restored["tree"]) == set(saved), "the checkpoint's leaves "
              "are not the saved ones")
        for key, arr in saved.items():
            check(np.array_equal(_bits(restored["tree"][key]), _bits(arr)),
                  f"restored {key} differs from the saved one")
        del restored, saved
        resumed = m.launch_train.main(_train_lm_argv(device, 2, *args))
    check(resumed["start"] == TRAIN_LM_CKPT_AT, "the rerun did not resume "
          f"at step {TRAIN_LM_CKPT_AT}")
    want = whole_losses[TRAIN_LM_CKPT_AT + 1:]
    got = resumed["losses"]
    del resumed
    shutil.rmtree(ckpt, ignore_errors=True)
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    check(len(got) == len(want) and max(rel) <= TRAIN_LM_RESUME_TOL,
          f"resumed losses {got} against the uninterrupted {want}")
    return {"layers": TRAIN_LM_LAYERS, "uninterrupted_losses": whole_losses,
            "resumed_losses": got, "resumed_rel_err": rel,
            "bit_identical": max(rel) == 0.0}


def drive_lm_training(m, card, root=ROOT, device="cuda"):
    """Phase 12b. (a) and (b): ``compare_training_attention``; (c) ``launch.
    train lm`` at olmo-1b ``CONFIG`` (16 layers, d = 2048, bf16, remat
    "full", random weights from the seed) for TRAIN_LM_STEPS steps of
    8 x 1024 tokens in process, the launch counters set to 0 just before
    and read just after: every loss and grad norm finite, the last three
    steps' mean loss below step 0's, B4 exactly twice per layer per step
    (forward and recompute), B5 and B6 never, no plain version of B4-B6
    reached; the step wall p50 and p95 over steps 2-11, tokens/s, the peak
    memory, one profiled step; (d) ``training_kernel_vs_plain``; (e)
    ``training_resume``. Returns (summary, launches of (c))."""
    t_phase = time.perf_counter()
    out = {"card": card}
    out["attention"] = compare_training_attention(m.ops, m.ref, device)
    print(f"lm training attention: {json.dumps(out['attention'])}",
          flush=True)

    guard = contextlib.ExitStack()
    for patch in _plain_guard(m.ref, m.ops) + [
            _refuse(m.ref, "flash_attention_lse_torch", "the plain")]:
        guard.enter_context(patch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with guard:
        m.build.reset_launch_counts()
        run = m.launch_train.main(_train_lm_argv(device))
        counts = dict(m.build.LAUNCHES)
    cfg = run["cfg"]
    losses, norms = run["losses"], run["grad_norms"]
    check(len(losses) == TRAIN_LM_STEPS
          and all(math.isfinite(x) for x in losses + norms),
          f"non-finite losses or grad norms: {losses}, {norms}")
    check(float(np.mean(losses[-3:])) < losses[0], f"the loss did not "
          f"fall: {losses}")
    want = 2 * cfg.num_layers * TRAIN_LM_STEPS
    check(counts["flash_attention"] == want, f"B4 launched "
          f"{counts['flash_attention']} times in {TRAIN_LM_STEPS} steps, "
          f"not {want}")
    check(counts["decode_attention"] == 0 and counts["mamba_scan"] == 0
          and counts["mamba_scan_bwd"] == 0,
          f"B5, B6 or B6b launched while training: {counts}")
    timed = run["step_ms"][TRAIN_LM_TIMED:]
    p50 = float(np.percentile(timed, 50))
    out["full_width"] = {
        "arch": TRAIN_LM_ARCH, "layers": cfg.num_layers,
        "d_model": cfg.d_model, "dtype": cfg.dtype, "remat": cfg.remat,
        "batch": TRAIN_LM_BATCH, "seq": TRAIN_LM_SEQ,
        "params": sum(t.numel() for t in m.named_leaves(
            run["params"]).values()),
        "losses": losses, "grad_norms": norms, "step_ms": run["step_ms"],
        "step_p50_ms": p50,
        "step_p95_ms": float(np.percentile(timed, 95)),
        "tokens_per_s": TRAIN_LM_BATCH * TRAIN_LM_SEQ / p50 * 1e3,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "b4_launches_per_step": counts["flash_attention"] / TRAIN_LM_STEPS}
    out["full_width"]["profile"] = profile_training(m, run, device)
    print(f"lm training: {json.dumps(out['full_width'])}", flush=True)
    del run
    torch.cuda.empty_cache()

    out["kernel_vs_plain"] = training_kernel_vs_plain(m, m.ref, device)
    print(f"lm training kernel vs plain: "
          f"{json.dumps(out['kernel_vs_plain'])}", flush=True)
    torch.cuda.empty_cache()
    out["resume"] = training_resume(m, root, device)
    print(f"lm training resume: {json.dumps(out['resume'])}", flush=True)
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"lm training phase: {out['phase_s']:.1f} s", flush=True)
    return out, counts


# -- phase 12c: SSM and hybrid LM training (B6 with its states, B6b) --------

TRAIN_HYBRID_ARCH = "hymba-1.5b"
TRAIN_SSM_ARCH = "falcon-mamba-7b"
# (c): falcon-mamba-7b at full width cut from 64 to 8 layers: its 7.3 B
# parameters with Adam's two f32 moments (~88 GB) do not fit one H100
TRAIN_SSM_LAYERS = 8
# (d): the plain path differentiates the gated scan's Python loop over S,
# whose autograd graph holds every step's (B, d_inner, N) tensors
TRAIN_SSM_PARITY_BATCH = 2
# (a): B6b against its plain version, (B, S, d, N, z dtype, dh_last seeded,
# some dt_raw above softplus's threshold): hymba-1.5b's and
# falcon-mamba-7b's training shapes, a ragged S = 65 in f32 and bf16, N = 4
SCAN_BWD_CASES = (
    (8, 1024, 3200, 16, torch.bfloat16, False, False),
    (8, 1024, 8192, 16, torch.bfloat16, True, False),
    (2, 65, 200, 16, torch.float32, True, True),
    (2, 65, 200, 16, torch.bfloat16, False, True),
    (1, 37, 200, 4, torch.float32, True, True),
)
# of each gradient's largest |entry|: f32 sums in another order (the
# exponentials, the softplus and the SiLU the kernels' short forms); dz in
# bf16 rounded from two f32 values that may round apart
SCAN_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -6}
SCAN_BWD_NAMES = ("du", "ddt_raw", "ddt_bias", "dB", "dC", "dA", "dD", "dz")
# device ms by kind in the SSM training steps' trace
TRAIN_SSM_KERNEL_KINDS = (("B4", ("flash_fwd",)), ("B6", ("scan_chunked",)),
                          ("B6b", ("scan_bwd",))) + TRAIN_KERNEL_KINDS[1:]


def compare_scan_backward(ref, device="cuda"):
    """(a) B6b (the op ``mamba_scan_gated_bwd``, from the chunk states B6
    stores) against its plain version on the same inputs at
    SCAN_BWD_CASES: every gradient within SCAN_BWD_TOL of its largest
    |entry|, the same bits on two calls; B6's output and h_last the same
    bits with the state store and without."""
    gen = torch.Generator().manual_seed(43)
    report = []
    for b, s, d, n, zdtype, seeded, over in SCAN_BWD_CASES:
        args, uz = _gated_inputs(gen, b, s, d, n, over_threshold=over)
        z = (uz if zdtype == torch.bfloat16 else uz.float())[..., d:]
        dout = torch.randn(b, s, d, generator=gen).to(device, zdtype)
        dh = torch.randn(b, d, n, generator=gen).to(device) if seeded else None
        where = f"B6b at {(b, s, d, n)}, z {str(zdtype)[6:]}, " + (
            "dh_last seeded" if seeded else "dh_last zero")
        out, h, states = LIB.mamba_scan_gated_states(*args, z)
        bare, bare_h = LIB.mamba_scan_gated(*args, z)
        check(torch.equal(out, bare) and torch.equal(h, bare_h),
              f"{where}: B6's output changes with the state store")
        got = LIB.mamba_scan_gated_bwd(*args, z, states, dout, dh)
        again = LIB.mamba_scan_gated_bwd(*args, z, states, dout, dh)
        want = ref.mamba_scan_gated_bwd_torch(*args, z, dout, dh)
        torch.cuda.synchronize()
        row = {"B": b, "S": s, "d": d, "N": n, "z": str(zdtype),
               "dh_last_seeded": seeded, "over_threshold": over}
        for name, g, a, w in zip(SCAN_BWD_NAMES, got, again, want):
            check(g.shape == w.shape and g.dtype == w.dtype
                  and bool(torch.isfinite(g).all()), f"{where}: {name} "
                  "malformed")
            err = float((g.float() - w.float()).abs().max())
            rel = err / max(float(w.float().abs().max()), 1e-30)
            check(rel <= SCAN_BWD_TOL[g.dtype], f"{where}: {name} err {err} "
                  f"({rel} of its largest entry) beyond "
                  f"{SCAN_BWD_TOL[g.dtype]}")
            check(torch.equal(g, a), f"{where}: {name} differs between two "
                  "calls")
            row[name] = {"max_abs_err": err, "of_largest": rel}
        report.append(row)
        del args, uz, z, dout, dh, out, states, bare, got, again, want
        torch.cuda.empty_cache()
    return report


def _train_family(m, arch, want, layers=None, device="cuda", *,
                  kinds=TRAIN_SSM_KERNEL_KINDS, ranges=None):
    """``launch.train lm --arch arch --scale full`` (cut to ``layers``
    layers when given) for TRAIN_LM_STEPS steps of TRAIN_LM_BATCH x
    TRAIN_LM_SEQ tokens in process, the launch counters set to 0 just
    before and read just after, with every plain version of B4-B6 and B6b
    refused: losses and grad norms finite, the last three steps' mean below
    step 0's, each kernel's launches per step ``want[kernel]`` and B5 none;
    step wall p50/p95 over steps 2-11, tokens/s, peak memory, one profiled
    step (``kinds`` and ``ranges`` as :func:`profile_training` takes them);
    the MoE load-balance losses finite too. Returns (summary, launches)."""
    from unittest import mock
    guard = contextlib.ExitStack()
    for patch in _plain_guard(m.ref, m.ops) + [
            _refuse(m.ref, n, "the plain") for n in (
                "flash_attention_lse_torch", "mamba_scan_gated_bwd_torch")]:
        guard.enter_context(patch)
    if layers is not None:
        real = m.launch_train.get_config
        guard.enter_context(mock.patch.object(
            m.launch_train, "get_config", lambda a: dataclasses.replace(
                real(a), num_layers=layers)))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with guard:
        m.build.reset_launch_counts()
        run = m.launch_train.main(_train_lm_argv(device, arch=arch))
        counts = dict(m.build.LAUNCHES)
    cfg = run["cfg"]
    losses, norms, aux = run["losses"], run["grad_norms"], run["aux_losses"]
    check(len(losses) == TRAIN_LM_STEPS
          and all(math.isfinite(x) for x in losses + norms + aux),
          f"{arch}: non-finite losses, grad norms or aux losses: {losses}, "
          f"{norms}, {aux}")
    check(float(np.mean(losses[-3:])) < losses[0], f"{arch}: the loss did "
          f"not fall: {losses}")
    per_step = {k: v / TRAIN_LM_STEPS for k, v in counts.items()}
    check(all(per_step[k] == v for k, v in want.items())
          and counts["decode_attention"] == 0, f"{arch}: launches per step "
          f"{per_step}, want {want} and no B5")
    timed = run["step_ms"][TRAIN_LM_TIMED:]
    p50 = float(np.percentile(timed, 50))
    out = {
        "arch": arch, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "d_inner": cfg.d_inner, "dtype": cfg.dtype, "remat": cfg.remat,
        "batch": TRAIN_LM_BATCH, "seq": TRAIN_LM_SEQ,
        "reduced": ([f"num_layers {m.get_config(arch).num_layers} -> "
                     f"{layers}"] if layers is not None else []),
        "params": sum(t.numel() for t in m.named_leaves(
            run["params"]).values()),
        "losses": losses, "aux_losses": aux, "grad_norms": norms,
        "step_ms": run["step_ms"], "step_p50_ms": p50,
        "step_p95_ms": float(np.percentile(timed, 95)),
        "tokens_per_s": TRAIN_LM_BATCH * TRAIN_LM_SEQ / p50 * 1e3,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "launches_per_step": per_step}
    out["profile"] = profile_training(m, run, device, kinds=kinds,
                                      ranges=ranges)
    del run
    torch.cuda.empty_cache()
    return out, counts


def drive_ssm_training(m, card, device="cuda"):
    """Phase 12c. (a) ``compare_scan_backward``; (b) ``launch.train lm``
    at hymba-1.5b ``CONFIG`` (32 layers, d = 1600, bf16, remat "full",
    random weights from the seed): per step B6 64 times (forward and
    recompute), B6b 32, B4 64; (c) falcon-mamba-7b ``CONFIG`` at full width
    cut to TRAIN_SSM_LAYERS layers: B6 16, B6b 8, B4 none; each through
    ``_train_family``; (d) ``training_kernel_vs_plain`` at both families'
    widths and TRAIN_LM_LAYERS layers in f32. Returns (summary,
    {path: launches of (b) and (c)})."""
    t_phase = time.perf_counter()
    out = {"card": card}
    out["scan_backward"] = compare_scan_backward(m.ref, device)
    print(f"ssm training scan backward: {json.dumps(out['scan_backward'])}",
          flush=True)
    counts = {}
    for label, arch, layers in (("hybrid", TRAIN_HYBRID_ARCH, None),
                                ("ssm", TRAIN_SSM_ARCH, TRAIN_SSM_LAYERS)):
        cfg = m.get_config(arch)
        n = layers or cfg.num_layers
        want = {"mamba_scan": 2 * n, "mamba_scan_bwd": n,
                "flash_attention": 2 * n if cfg.family == "hybrid" else 0}
        out[label], counts[f"{label}_lm_training"] = _train_family(
            m, arch, want, layers, device)
        print(f"{label} lm training: {json.dumps(out[label])}", flush=True)
    out["kernel_vs_plain"] = {}
    for arch in (TRAIN_HYBRID_ARCH, TRAIN_SSM_ARCH):
        out["kernel_vs_plain"][arch] = training_kernel_vs_plain(
            m, m.ref, device, arch=arch, batch_size=TRAIN_SSM_PARITY_BATCH)
        torch.cuda.empty_cache()
    print(f"ssm training kernel vs plain: "
          f"{json.dumps(out['kernel_vs_plain'])}", flush=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"ssm training phase: {out['phase_s']:.1f} s", flush=True)
    return out, counts


# -- phases 12d and 12e: the MoE (mixtral) and M-RoPE (qwen2-vl) families --

# device ms by kind in the MoE and VLM traces: B4, B5, the dispatch's and
# routing's index kernels (index store and gather, scatter, cumsum,
# argmax), the library GEMMs (projections and expert products alike; the
# expert products apart under ``device_ms_by_piece``), element-wise
MOE_KERNEL_KINDS = (("B4", ("flash_fwd",)), ("B5", ("decode_split",)),
                    ("index", ("index", "scatter", "gather", "scan",
                               "ArgMax", "cumsum")),
                    ("gemm", ("gemm", "nvjet", "xmma", "cutlass")),
                    ("elementwise", ("elementwise_kernel",)))
MOE_RANGES = ("moe.layer", "moe.expert_gemm")


@contextlib.contextmanager
def _moe_ranges(moe):
    """Name the MoE layer (``moe._dispatch_ffn`` or ``_dense_moe``) and
    its expert products (``moe._bmm``) in a torch.profiler trace; yields
    MOE_RANGES."""
    from unittest import mock
    from torch.profiler import record_function

    def ranged(label, fn):
        def wrapped(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return wrapped

    with contextlib.ExitStack() as stack:
        for name, label in (("_dispatch_ffn", "moe.layer"),
                            ("_dense_moe", "moe.layer"),
                            ("_bmm", "moe.expert_gemm")):
            stack.enter_context(mock.patch.object(
                moe, name, ranged(label, getattr(moe, name))))
        yield MOE_RANGES


def drive_moe_lm(m):
    """Phase 12d: mixtral-8x7b ``CONFIG`` cut to MOE_LAYERS layers, bf16,
    random weights from the seed, served with phase 8's flow and sizes
    (MOE_GEN tokens a request; B4 once per layer and admission, B5 once per
    layer and decode step, B6 never, no plain version reached) plus one
    MOE_LONG_PROMPT-token request through the rolling cache; a profile of a
    2048-token prefill and a 4-lane decode step (device ms by kind and the
    MoE layer's pieces); the kernel path against the plain path on a
    1500-token request (bf16 at full width, bf16 at MOE_ROUTE_LAYERS and
    f32 at LM_F32_LAYERS layers, the routes forced from the plain run).
    Frees the model. Returns the
    report and the serving launches."""
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(m.get_config(MOE_ARCH), num_layers=MOE_LAYERS)
    params = m.lm.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(LM_SEED))
    served, edges = drive_lm_serving(
        cfg, params, m.lm, m.batching, m.state, m.heuristics, m.build, m.ref,
        m.ops, gen_len=MOE_GEN,
        long_request=(MOE_LONG_PROMPT, MOE_LONG_MAX_SEQ))
    print(f"moe lm serving: {json.dumps(served)}", flush=True)
    profiled = profile_lm(cfg, params, m.lm, edges[2],
                          kinds=MOE_KERNEL_KINDS,
                          ranges=lambda: _moe_ranges(m.moe))
    for unit in profiled.values():  # the layer apart from its products
        pieces = unit["device_ms_by_piece"]
        pieces["moe.route_dispatch_combine"] = (pieces["moe.layer"]
                                                - pieces["moe.expert_gemm"])
    print(f"moe lm profile: {json.dumps(profiled)}", flush=True)
    del edges
    torch.cuda.empty_cache()
    parity = lm_kernel_vs_plain(cfg, params, m.lm, m.ops, m.ref, moe=m.moe,
                                f32_layers=LM_F32_LAYERS)
    print(f"moe lm kernel vs plain: {json.dumps(parity)}", flush=True)
    del params
    torch.cuda.empty_cache()
    out = {"serving": served, "profile": profiled, "kernel_vs_plain": parity,
           "phase_s": time.perf_counter() - t_phase}
    print(f"moe lm phase: {out['phase_s']:.1f} s", flush=True)
    return out, served["launches"]


def _vlm_inputs(cfg, batch, prompt_len, grid, n_decode, seed=7,
                device="cuda"):
    """{"prefill": {"embeds", "positions"}, "decode": [{"token",
    "positions"}]}: ``batch`` prompts of random patch embeddings (std 0.02,
    as the embedding table's rows) with qwen2-vl's M-RoPE ids: VLM_TEXT
    text tokens at (p, p, p), an image of ``grid`` patches at t =
    VLM_TEXT, h = VLM_TEXT + row, w = VLM_TEXT + column, then text again
    from one past the largest id; the ``n_decode`` decode steps' random
    tokens continue the text ids, which run behind the sequence position
    (``cache["pos"]``) once an image has been seen."""
    rows, cols = grid
    check(VLM_TEXT + rows * cols <= prompt_len, "the image does not fit")
    t = list(range(VLM_TEXT))
    h, w = list(t), list(t)
    for r in range(rows):
        for c in range(cols):
            t.append(VLM_TEXT)
            h.append(VLM_TEXT + r)
            w.append(VLM_TEXT + c)
    nxt = VLM_TEXT + max(rows, cols)
    while len(t) < prompt_len + n_decode:
        t.append(nxt)
        h.append(nxt)
        w.append(nxt)
        nxt += 1
    ids = torch.tensor([t, h, w], dtype=torch.int32)[:, None].expand(
        3, batch, -1)
    gen = torch.Generator().manual_seed(seed)
    embeds = 0.02 * torch.randn(batch, prompt_len, cfg.d_model, generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (n_decode, batch),
                           generator=gen, dtype=torch.int32)
    return {"prefill": {
        "embeds": embeds.to(device),
        "positions": ids[:, :, :prompt_len].contiguous().to(device)},
        "decode": [{"token": tokens[i].to(device),
                    "positions": ids[:, :, prompt_len + i].contiguous().to(
                        device)} for i in range(n_decode)]}


def drive_vlm_lm(m):
    """Phase 12e: qwen2-vl-72b's backbone ``CONFIG`` cut to VLM_LAYERS
    layers, bf16, random weights from the seed: one prefill of VLM_BATCH
    prompts from patch embeddings with (3, B, S) positions whose rows
    differ, then VLM_DECODE greedy decode steps of text tokens with their
    M-RoPE rows; B4 once per layer in the prefill, B5 once per layer and
    step, B6 never, no plain version reached; the same profile as phase
    12d; the kernel path against the plain path on a 1500-token prompt with
    a VLM_PARITY_GRID image (bf16 at full width, f32 at LM_F32_LAYERS
    layers). Frees the model. Returns the report, the launches and a copy
    of layer 0's cache (B5's timing input)."""
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(m.get_config(VLM_ARCH), num_layers=VLM_LAYERS)
    params = m.lm.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(LM_SEED))
    head = m.lm.head_f32(params, cfg)
    inputs = _vlm_inputs(cfg, VLM_BATCH, VLM_PROMPT, VLM_GRID, VLM_DECODE)
    max_seq = VLM_PROMPT + VLM_DECODE + 8  # the profile's steps fit too
    m.lm.prefill(params, inputs["prefill"], cfg, max_seq=max_seq, head=head)
    torch.cuda.synchronize()
    names = ("flash_attention", "decode_attention", "mamba_scan")
    guard = contextlib.ExitStack()
    for patch in _plain_guard(m.ref, m.ops):
        guard.enter_context(patch)
    m.build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cache, logits = m.lm.prefill(params, inputs["prefill"], cfg,
                                 max_seq=max_seq, head=head)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    after_prefill = {k: m.build.LAUNCHES[k] for k in names}
    step_ms, tokens = [], []
    for batch in inputs["decode"]:
        batch = dict(batch, token=torch.argmax(
            logits[:, :cfg.vocab_size], -1).to(torch.int32))
        t0 = time.perf_counter()
        cache, logits = m.lm.decode_step(params, cache, batch, cfg,
                                         head=head)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        tokens.append(batch["token"].tolist())
    launches = {k: m.build.LAUNCHES[k] for k in names}
    guard.close()
    n_layers = cfg.num_layers
    check(after_prefill == {"flash_attention": n_layers,
                            "decode_attention": 0, "mamba_scan": 0},
          f"the prefill launched {after_prefill}, not B4 {n_layers} times")
    check(launches == {"flash_attention": n_layers,
                       "decode_attention": n_layers * VLM_DECODE,
                       "mamba_scan": 0},
          f"launched {launches}, not B4 {n_layers} and B5 "
          f"{n_layers * VLM_DECODE} times")
    check(bool(torch.isfinite(logits).all())
          and logits.shape == (VLM_BATCH, cfg.padded_vocab),
          "malformed decode logits")
    check(cache["pos"].tolist() == [VLM_PROMPT + VLM_DECODE] * VLM_BATCH,
          f"cache positions {cache['pos'].tolist()}")
    served = {
        "arch": cfg.name, "family": cfg.family, "dtype": cfg.dtype,
        "layers": n_layers,
        "params": sum(t.numel() for t in _leaves(params)),
        "batch": VLM_BATCH, "prompt_tokens": VLM_PROMPT,
        "image_patches": VLM_GRID[0] * VLM_GRID[1],
        "decode_steps": VLM_DECODE, "launches": launches,
        "prefill_ms": prefill_ms,
        "prefill_tokens_per_s": VLM_BATCH * VLM_PROMPT / prefill_ms * 1e3,
        "decode_step_ms": {"p50": float(np.percentile(step_ms, 50)),
                           "p95": float(np.percentile(step_ms, 95)),
                           "n": len(step_ms)},
        "decode_tokens_per_s": VLM_BATCH * len(step_ms) / sum(step_ms) * 1e3,
        "greedy_tokens": tokens,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    print(f"vlm lm: {json.dumps(served)}", flush=True)
    vlm_cache = tuple(t.clone() for t in (
        cache["layers"]["k"][0], cache["layers"]["v"][0], cache["slot_pos"],
        cache["pos"]))
    del head
    profiled = profile_lm(cfg, params, m.lm, prefill_batch=inputs["prefill"],
                          decode_cache=cache, decode_batch=inputs["decode"][0],
                          kinds=MOE_KERNEL_KINDS)
    print(f"vlm lm profile: {json.dumps(profiled)}", flush=True)
    del cache, inputs
    torch.cuda.empty_cache()
    parity = lm_kernel_vs_plain(
        cfg, params, m.lm, m.ops, m.ref, f32_layers=LM_F32_LAYERS,
        inputs=_vlm_inputs(cfg, 1, 1500, VLM_PARITY_GRID, 16, seed=8))
    print(f"vlm lm kernel vs plain: {json.dumps(parity)}", flush=True)
    del params
    torch.cuda.empty_cache()
    out = {"serving": served, "profile": profiled, "kernel_vs_plain": parity,
           "phase_s": time.perf_counter() - t_phase}
    print(f"vlm lm phase: {out['phase_s']:.1f} s", flush=True)
    return out, launches, vlm_cache


# -- phases 12f and 12g: whisper (served and trained) and MoE training ------

# device ms by kind in the training steps of 12f and 12g: B4, the MoE
# layer's index kernels, the library GEMMs, element-wise, reductions
MOE_TRAIN_KINDS = MOE_KERNEL_KINDS[:1] + MOE_KERNEL_KINDS[2:] + (
    ("reduce", ("reduce_kernel",)),)


def _whisper_frames(cfg, batch, seed, device="cuda"):
    """``batch`` utterances of WHISPER_FRAMES random frame embeddings, std
    0.02 as ``data.synthetic.make_batch`` draws them, from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return (0.02 * torch.randn(batch, WHISPER_FRAMES, cfg.d_model,
                               generator=gen)).to(device)


def _whisper_prompt(cfg, batch, n, seed, device="cuda"):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (batch, n), generator=gen,
                         dtype=torch.int32).to(device)


def whisper_serving(m, cfg, params):
    """12f (a): ``build_prefill`` on WHISPER_BATCH utterances of
    WHISPER_FRAMES frames and a WHISPER_PROMPT-token prompt into
    WHISPER_SLOTS-slot caches (after an untimed warm-up prefill), then
    WHISPER_DECODE greedy ``build_decode_step``s, every plain version of
    B4-B6 refused and the launch counters set to 0 just before: B4 once
    per encoder layer and twice per decoder layer (self, cross) in the
    prefill, B5 twice per decoder layer a step (self, and cross over the
    frames), B6 never. Returns (report, the prefill batch, the cache after
    the steps, the last tokens, the launches)."""
    shape = m.ShapeConfig("whisper_serving", WHISPER_SLOTS, WHISPER_BATCH,
                          "prefill")
    prefill = m.steps.build_prefill(cfg, shape=shape)
    decode = m.steps.build_decode_step(cfg)
    batch = {"tokens": _whisper_prompt(cfg, WHISPER_BATCH, WHISPER_PROMPT,
                                       11),
             "embeds": _whisper_frames(cfg, WHISPER_BATCH, 12)}
    prefill(params, batch)
    torch.cuda.synchronize()
    names = ("flash_attention", "decode_attention", "mamba_scan")
    guard = contextlib.ExitStack()
    for patch in _plain_guard(m.ref, m.ops):
        guard.enter_context(patch)
    m.build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cache, logits = prefill(params, batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    after_prefill = {k: m.build.LAUNCHES[k] for k in names}
    step_ms, tokens = [], []
    for _ in range(WHISPER_DECODE):
        token = torch.argmax(logits[:, :cfg.vocab_size], -1).to(torch.int32)
        t0 = time.perf_counter()
        cache, logits = decode(params, cache, {"token": token})
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        tokens.append(token.tolist())
    launches = {k: m.build.LAUNCHES[k] for k in names}
    guard.close()
    b4 = cfg.num_encoder_layers + 2 * cfg.num_layers
    check(after_prefill == {"flash_attention": b4, "decode_attention": 0,
                            "mamba_scan": 0},
          f"whisper's prefill launched {after_prefill}, not B4 {b4} times")
    check(launches == {"flash_attention": b4,
                       "decode_attention": 2 * cfg.num_layers
                       * WHISPER_DECODE, "mamba_scan": 0},
          f"whisper launched {launches}, not B4 {b4} and B5 "
          f"{2 * cfg.num_layers * WHISPER_DECODE} times")
    check(bool(torch.isfinite(logits).all())
          and logits.shape == (WHISPER_BATCH, cfg.padded_vocab),
          "malformed whisper decode logits")
    check(cache["pos"].tolist() == [WHISPER_PROMPT + WHISPER_DECODE]
          * WHISPER_BATCH and tuple(cache["enc_out"].shape) == (
              WHISPER_BATCH, cfg.encoder_len, cfg.d_model),
          f"whisper cache: pos {cache['pos'].tolist()}, enc_out "
          f"{tuple(cache['enc_out'].shape)}")
    served = {
        "arch": cfg.name, "dtype": cfg.dtype,
        "layers": [cfg.num_encoder_layers, cfg.num_layers],
        "params": sum(t.numel() for t in _leaves(params)),
        "batch": WHISPER_BATCH, "frames": WHISPER_FRAMES,
        "prompt_tokens": WHISPER_PROMPT, "slots": WHISPER_SLOTS,
        "decode_steps": WHISPER_DECODE, "launches": launches,
        "prefill_ms": prefill_ms,
        "decode_step_ms": {"p50": float(np.percentile(step_ms, 50)),
                           "p95": float(np.percentile(step_ms, 95)),
                           "n": len(step_ms)},
        "decode_tokens_per_s": WHISPER_BATCH * len(step_ms) / sum(step_ms)
        * 1e3,
        "greedy_tokens_lane0": [t[0] for t in tokens],
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    return served, batch, cache, token, launches


def whisper_training(m, cfg, device="cuda"):
    """12f (c): ``build_train_step`` (Adam, the config's remat "full") for
    TRAIN_LM_STEPS steps of WHISPER_TRAIN_BATCH utterances x
    (WHISPER_FRAMES random frames, WHISPER_SLOTS Zipf tokens), random
    weights from the seed, every plain version refused and the launch
    counters set to 0 just before: losses and grad norms finite, the last
    three steps' mean below step 0's, B4 twice per attention a step
    (forward and recompute: 2 x (4 + 2 x 4) = 24), B5 and B6 never; step
    p50/p95 over steps 2-11, utterances/s, peak memory and one profiled
    step. Returns (report, launches)."""
    tcfg = dataclasses.replace(cfg, num_microbatches=1, optimizer="adam")
    knobs = m.steps.TrainKnobs(lr=3e-4, grad_clip=1.0)
    params = m.lm.init_params(tcfg, generator=torch.Generator(
        device=device).manual_seed(LM_SEED))
    _, opt_init, _ = m.steps.make_optimizer(tcfg, knobs)
    opt_state = opt_init(m.named_leaves(params))
    step = m.steps.build_train_step(tcfg, knobs=knobs, shape=m.ShapeConfig(
        "whisper_train", WHISPER_SLOTS, WHISPER_TRAIN_BATCH, "train"))
    pipe = m.SyntheticTokens(cfg.vocab_size, WHISPER_TRAIN_BATCH,
                             WHISPER_SLOTS, seed=LM_SEED)
    frames = _whisper_frames(cfg, WHISPER_TRAIN_BATCH, 15, device)

    def next_batch():
        return {"embeds": frames, **{k: torch.from_numpy(v).to(device)
                                     for k, v in next(pipe).items()}}

    guard = contextlib.ExitStack()
    for patch in _plain_guard(m.ref, m.ops) + [
            _refuse(m.ref, "flash_attention_lse_torch", "the plain")]:
        guard.enter_context(patch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, step_ms = [], [], []
    with guard:
        m.build.reset_launch_counts()
        for _ in range(TRAIN_LM_STEPS):
            batch = next_batch()
            t0 = time.perf_counter()
            params, opt_state, metrics = step(params, opt_state, batch)
            losses.append(float(metrics["loss_total"]))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            norms.append(float(metrics["grad_norm"]))
        counts = dict(m.build.LAUNCHES)
    check(all(math.isfinite(x) for x in losses + norms),
          f"whisper: non-finite losses or grad norms: {losses}, {norms}")
    check(float(np.mean(losses[-3:])) < losses[0], f"whisper: the loss did "
          f"not fall: {losses}")
    b4 = 2 * (cfg.num_encoder_layers + 2 * cfg.num_layers)
    check(counts["flash_attention"] == b4 * TRAIN_LM_STEPS
          and counts["decode_attention"] == 0 and counts["mamba_scan"] == 0,
          f"whisper training launched {counts}, not B4 {b4} a step")
    timed = step_ms[TRAIN_LM_TIMED:]
    p50 = float(np.percentile(timed, 50))
    out = {"arch": cfg.name, "dtype": cfg.dtype, "remat": tcfg.remat,
           "batch": WHISPER_TRAIN_BATCH, "frames": WHISPER_FRAMES,
           "tokens": WHISPER_SLOTS, "losses": losses, "grad_norms": norms,
           "step_ms": step_ms, "step_p50_ms": p50,
           "step_p95_ms": float(np.percentile(timed, 95)),
           "utterances_per_s": WHISPER_TRAIN_BATCH / p50 * 1e3,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "b4_launches_per_step": counts["flash_attention"]
           / TRAIN_LM_STEPS}
    out["profile"] = profile_training(
        m, {"cfg": tcfg, "params": params, "opt_state": opt_state,
            "pipeline": None}, device, kinds=MOE_TRAIN_KINDS,
        batch=next_batch())
    return out, counts


def drive_whisper_lm(m, card):
    """Phase 12f: whisper-tiny ``CONFIG`` (bf16, random weights from the
    seed), served (:func:`whisper_serving`) and profiled (a prefill and
    five decode steps: device ms by kind, idle share, kernels); the kernel
    path against the plain path at full depth (:func:`lm_kernel_vs_plain`
    on WHISPER_PARITY_BATCH utterances and 16 teacher-forced steps: f32
    within LM_LOGIT_TOL_F32 of the largest |logit|, bf16 within
    LM_LOGIT_TOL_BF16); trained (:func:`whisper_training`); and in f32 at
    full width ``train_loss`` through the kernels against the plain path
    on WHISPER_PARITY_BATCH utterances (:func:`train_loss_vs_plain`).
    Returns (report, {path: launches})."""
    t_phase = time.perf_counter()
    cfg = m.get_config(WHISPER_ARCH)
    params = m.lm.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(LM_SEED))
    out = {"card": card}
    out["serving"], batch, cache, token, served = whisper_serving(m, cfg,
                                                                  params)
    print(f"whisper lm serving: {json.dumps(out['serving'])}", flush=True)
    out["profile"] = profile_lm(cfg, params, m.lm, prefill_batch=batch,
                                decode_cache=cache,
                                decode_batch={"token": token},
                                kinds=MOE_KERNEL_KINDS,
                                max_seq=WHISPER_SLOTS)
    print(f"whisper lm profile: {json.dumps(out['profile'])}", flush=True)
    del batch, cache
    p = WHISPER_PARITY_BATCH
    forced = _whisper_prompt(cfg, 16, p, 14)
    out["kernel_vs_plain"] = lm_kernel_vs_plain(
        cfg, params, m.lm, m.ops, m.ref, inputs={
            "prefill": {"tokens": _whisper_prompt(cfg, p, WHISPER_PROMPT, 13),
                        "embeds": _whisper_frames(cfg, p, 16)},
            "decode": [{"token": t} for t in forced]})
    print(f"whisper lm kernel vs plain: "
          f"{json.dumps(out['kernel_vs_plain'])}", flush=True)
    del params
    torch.cuda.empty_cache()
    out["training"], trained = whisper_training(m, cfg)
    print(f"whisper lm training: {json.dumps(out['training'])}", flush=True)
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = m.lm.init_params(cfg32, generator=torch.Generator(
        device="cuda").manual_seed(LM_SEED))
    tokens = _whisper_prompt(cfg, p, WHISPER_SLOTS + 1, 17)
    out["training_kernel_vs_plain"] = train_loss_vs_plain(
        m, m.ref, cfg32, params32, {
            "embeds": _whisper_frames(cfg, p, 18),
            "tokens": tokens[:, :-1].contiguous(),
            "labels": tokens[:, 1:].contiguous()},
        {"flash_attention": 2 * (cfg.num_encoder_layers + 2 * cfg.num_layers),
         "mamba_scan": 0, "mamba_scan_bwd": 0})
    print(f"whisper lm training kernel vs plain: "
          f"{json.dumps(out['training_kernel_vs_plain'])}", flush=True)
    del params32
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"whisper lm phase: {out['phase_s']:.1f} s", flush=True)
    return out, {"whisper_lm_serving": served,
                 "whisper_lm_training": trained}


def moe_training_rerun(m, device="cuda"):
    """12g (b): ``train lm`` at mixtral's widths cut to MOE_TRAIN_LAYERS
    layers for MOE_RERUN_STEPS steps, twice from the same seed (the first
    run's parameters copied to the host, where the second run's are
    compared, so that the card holds one run at a time): every parameter
    the same bits and the same losses (ROADMAP C7: no float atomics on
    the path, and the dispatch's and combine's index backward in a fixed
    order)."""
    from unittest import mock
    real = m.launch_train.get_config
    with mock.patch.object(m.launch_train, "get_config", lambda a: (
            dataclasses.replace(real(a), num_layers=MOE_TRAIN_LAYERS))):
        first = m.launch_train.main(_train_lm_argv(
            device, MOE_RERUN_STEPS, arch=MOE_ARCH))
        saved = {k: t.detach().cpu()
                 for k, t in m.named_leaves(first["params"]).items()}
        first_losses = first["losses"]
        del first
        torch.cuda.empty_cache()
        second = m.launch_train.main(_train_lm_argv(
            device, MOE_RERUN_STEPS, arch=MOE_ARCH))
    leaves = m.named_leaves(second["params"])
    differ = [k for k, t in leaves.items()
              if not torch.equal(t.detach().cpu(), saved[k])]
    check(not differ and second["losses"] == first_losses,
          f"mixtral training is not bit-identical on a rerun: {len(differ)} "
          f"leaves differ ({differ[:4]}), losses {first_losses} then "
          f"{second['losses']}")
    out = {"steps": MOE_RERUN_STEPS, "layers": MOE_TRAIN_LAYERS,
           "leaves": len(leaves), "leaves_differing": len(differ),
           "losses": first_losses, "aux_losses": second["aux_losses"]}
    del second, saved
    torch.cuda.empty_cache()
    return out


def drive_moe_training(m, card, device="cuda"):
    """Phase 12g: (a) ``launch.train lm --arch mixtral-8x7b --scale full``
    cut to MOE_TRAIN_LAYERS layers through ``_train_family`` (B4 twice per
    layer a step, B5 and B6 never, losses, aux losses and grad norms
    finite, the loss falling; a profiled step with the MoE layer's pieces
    as in 12d); (b) :func:`moe_training_rerun`; (c) at MOE_TRAIN_LAYERS
    layers in f32 on MOE_PARITY_BATCH x MOE_PARITY_SEQ tokens, the kernel
    path against the plain path with the plain run's routes forced
    (:func:`train_loss_vs_plain`). Returns (report, {path: launches})."""
    t_phase = time.perf_counter()
    out = {"card": card}
    n = MOE_TRAIN_LAYERS
    out["full_width"], counts = _train_family(
        m, MOE_ARCH, {"flash_attention": 2 * n, "mamba_scan": 0,
                      "mamba_scan_bwd": 0}, n, device,
        kinds=MOE_TRAIN_KINDS, ranges=lambda: _moe_ranges(m.moe))
    pieces = out["full_width"]["profile"]["device_ms_by_piece"]
    pieces["moe.route_dispatch_combine"] = (pieces["moe.layer"]
                                            - pieces["moe.expert_gemm"])
    print(f"moe lm training: {json.dumps(out['full_width'])}", flush=True)
    out["rerun"] = moe_training_rerun(m, device)
    print(f"moe lm training rerun: {json.dumps(out['rerun'])}", flush=True)
    cfg = dataclasses.replace(m.get_config(MOE_ARCH), num_layers=n,
                              dtype="float32")
    params = m.lm.init_params(cfg, generator=torch.Generator(
        device=device).manual_seed(LM_SEED))
    batch = {k: torch.from_numpy(v).to(device) for k, v in next(
        m.SyntheticTokens(cfg.vocab_size, MOE_PARITY_BATCH, MOE_PARITY_SEQ,
                          seed=1)).items()}
    out["kernel_vs_plain"] = train_loss_vs_plain(
        m, m.ref, cfg, params, batch, {"flash_attention": 2 * n,
                                       "mamba_scan": 0, "mamba_scan_bwd": 0},
        routes=_RouteForcing(m.moe))
    print(f"moe lm training kernel vs plain: "
          f"{json.dumps(out['kernel_vs_plain'])}", flush=True)
    del params
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"moe lm training phase: {out['phase_s']:.1f} s", flush=True)
    return out, {"moe_lm_training": counts}


# -- phase 12h: the LM's sharding (DTensor placements on a (1, 1) mesh) -----

SHARDED_TRAIN_STEPS = 3
SHARDED_LANES = 4
SHARDED_PROMPT = 2048
SHARDED_DECODE = 16
# qwen3-4b's decode logits through the flash-decode (B5 with its lse on the
# rank's block of slots, the blocks combined in f32) against the meshless
# path (B5 alone), of the largest |logit|: the output goes through one
# more bf16 rounding and an f32 rescale
SHARDED_LOGIT_TOL = 1e-3


@contextlib.contextmanager
def _plain_guard_lse(ref, ops):
    """:func:`_plain_guard` with the plain log-sum-exps of B4 and B5
    refused too: the runs of phase 12h reach only the kernels."""
    with contextlib.ExitStack() as guard:
        for patch in _plain_guard(ref, ops) + [
                _refuse(ref, name, "the plain") for name in (
                    "flash_attention_lse_torch",
                    "decode_attention_lse_torch")]:
            guard.enter_context(patch)
        yield


def _bits_differ(meshless: dict, sharded: dict) -> list:
    """The leaves whose local block on the (1, 1) mesh is not the meshless
    leaf bit for bit."""
    return [k for k, t in meshless.items()
            if not torch.equal(t, sharded[k].to_local())]


def sharded_training(m, mesh, device="cuda"):
    """12h (a): olmo-1b ``CONFIG`` (Adam, ``train lm``'s knobs) for
    SHARDED_TRAIN_STEPS steps of TRAIN_LM_BATCH x TRAIN_LM_SEQ tokens,
    meshless and through the sharded ``build_train_step`` on ``mesh``,
    from the same weights and batches: every parameter, Adam slot and loss
    the same bits; B4 twice per layer a step on both. The step times
    (host: until the step returns; wall: until the card is done) and the
    redistributions a sharded step makes."""
    cfg = dataclasses.replace(m.get_config(TRAIN_LM_ARCH),
                              num_microbatches=1, optimizer="adam")
    knobs = m.steps.TrainKnobs(lr=3e-4, grad_clip=1.0)
    shape = m.ShapeConfig("train", TRAIN_LM_SEQ, TRAIN_LM_BATCH, "train")
    init = m.lm.init_params(cfg, generator=torch.Generator(
        device=device).manual_seed(LM_SEED), device=device)
    pipe = m.SyntheticTokens(cfg.vocab_size, TRAIN_LM_BATCH, TRAIN_LM_SEQ,
                             seed=LM_SEED)
    batches = [{k: torch.from_numpy(v).to(device) for k, v in next(
        pipe).items()} for _ in range(SHARDED_TRAIN_STEPS)]
    _, opt_init, _ = m.steps.make_optimizer(cfg, knobs)
    runs = {}
    with _plain_guard_lse(m.ref, m.ops):
        for label, on in (("meshless", None), ("sharded", mesh)):
            params = _clone_tree(init)
            opt = opt_init(m.named_leaves(params))
            step = m.steps.build_train_step(cfg, on, knobs, shape)
            m.build.reset_launch_counts()
            m.ctx.REDISTRIBUTES.clear()
            losses, host_ms, wall_ms = [], [], []
            for batch in batches:
                _sync(device)
                t0 = time.perf_counter()
                params, opt, met = step(params, opt, batch)
                host_ms.append((time.perf_counter() - t0) * 1e3)
                _sync(device)
                wall_ms.append((time.perf_counter() - t0) * 1e3)
                loss = met["loss_total"]
                losses.append(loss.to_local() if on is not None else loss)
            counts = dict(m.build.LAUNCHES)
            runs[label] = {"params": m.named_leaves(params),
                           "opt": m.named_leaves(opt), "losses": losses,
                           "counts": counts, "host_ms": host_ms,
                           "wall_ms": wall_ms,
                           "redistributes": dict(m.ctx.REDISTRIBUTES)}
            want = 2 * cfg.num_layers * SHARDED_TRAIN_STEPS
            check(counts["flash_attention"] == want,
                  f"{label} olmo-1b training launched B4 "
                  f"{counts['flash_attention']} times, not {want}")
    a, b = runs["meshless"], runs["sharded"]
    differ = (_bits_differ(a["params"], b["params"])
              + _bits_differ(a["opt"], b["opt"]))
    same_loss = all(torch.equal(x, y) for x, y in zip(a["losses"],
                                                      b["losses"]))
    check(not differ and same_loss, f"the sharded olmo-1b step on a (1, 1) "
          f"mesh is not the meshless step bit for bit: {len(differ)} leaves "
          f"differ ({differ[:4]}), losses "
          f"{[float(x) for x in a['losses']]} then "
          f"{[float(x) for x in b['losses']]}")
    out = {"arch": TRAIN_LM_ARCH, "layers": cfg.num_layers,
           "batch": TRAIN_LM_BATCH, "seq": TRAIN_LM_SEQ,
           "steps": SHARDED_TRAIN_STEPS,
           "leaves": len(a["params"]) + len(a["opt"]),
           "leaves_differing": len(differ),
           "losses": [float(x) for x in b["losses"]],
           "redistributes_per_step": {
               k: v / SHARDED_TRAIN_STEPS
               for k, v in b["redistributes"].items()}}
    for label, r in runs.items():
        out[label] = {"host_ms": r["host_ms"], "wall_ms": r["wall_ms"],
                      "step_p50_ms": float(np.median(r["wall_ms"])),
                      "host_p50_ms": float(np.median(r["host_ms"]))}
    out["dtensor_host_ms"] = (out["sharded"]["host_p50_ms"]
                              - out["meshless"]["host_p50_ms"])
    counts = b["counts"]
    del runs, a, b, init, batches
    torch.cuda.empty_cache()
    return out, counts


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone_tree(v) for v in tree]
    return tree.clone()


def sharded_serving(m, mesh, device="cuda"):
    """12h (b): qwen3-4b ``CONFIG`` with ``decode_flash_shardmap``: a
    SHARDED_PROMPT-token prefill on SHARDED_LANES lanes and SHARDED_DECODE
    decode steps (fixed tokens), meshless and through the sharded
    ``build_prefill`` and ``build_decode_step`` on ``mesh``, where each
    layer's decode attention is the flash-decode: B5 with its lse on the
    rank's slots, combined over ``model``. The logits within
    SHARDED_LOGIT_TOL of the largest |logit| of the meshless ones; B4 once
    per layer in the prefill and B5 once per layer a step on both; the
    flash-decode taken on every layer, and B5's own redistribution of the
    cache never. Then ``sharded_decode_attention`` on the last cache's
    layer 0 against its plain version and B5's."""
    cfg = dataclasses.replace(m.get_config(LM_ARCH),
                              decode_flash_shardmap=True)
    params = m.lm.init_params(cfg, generator=torch.Generator(
        device=device).manual_seed(LM_SEED), device=device)
    max_seq = SHARDED_PROMPT + SHARDED_DECODE
    rng = np.random.default_rng(LM_SEED)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (SHARDED_LANES, SHARDED_PROMPT)).astype(
            np.int32)).to(device)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (SHARDED_DECODE, SHARDED_LANES)).astype(
            np.int32)).to(device)
    runs = {}
    with _plain_guard_lse(m.ref, m.ops):
        for label, on in (("meshless", None), ("sharded", mesh)):
            prefill = m.steps.build_prefill(cfg, on, m.ShapeConfig(
                "prefill", max_seq, SHARDED_LANES, "prefill"))
            decode = m.steps.build_decode_step(cfg, on, m.ShapeConfig(
                "decode", max_seq, SHARDED_LANES, "decode"))
            held = params if on is None else m.steps.place(
                params, prefill.in_specs[0], on)
            m.build.reset_launch_counts()
            m.ctx.REDISTRIBUTES.clear()
            _sync(device)
            t0 = time.perf_counter()
            cache, logits = prefill(held, {"tokens": prompt})
            _sync(device)
            prefill_ms = (time.perf_counter() - t0) * 1e3
            rows, step_ms, host_ms = [_local(logits)], [], []
            after_prefill = dict(m.build.LAUNCHES)
            for i in range(SHARDED_DECODE):
                t0 = time.perf_counter()
                cache, logits = decode(held, cache, {"token": tokens[i]})
                host_ms.append((time.perf_counter() - t0) * 1e3)
                _sync(device)
                step_ms.append((time.perf_counter() - t0) * 1e3)
                rows.append(_local(logits))
            counts = dict(m.build.LAUNCHES)
            runs[label] = {"logits": rows, "counts": counts,
                           "after_prefill": after_prefill,
                           "prefill_ms": prefill_ms, "step_ms": step_ms,
                           "host_ms": host_ms, "cache": cache,
                           "redistributes": dict(m.ctx.REDISTRIBUTES)}
            n = cfg.num_layers
            check(after_prefill["flash_attention"] == n
                  and counts["decode_attention"] == n * SHARDED_DECODE,
                  f"{label} qwen3-4b serving launched {counts}, not B4 {n} "
                  f"times in the prefill and B5 {n} a step")
            if label == "meshless":
                del cache
    a, b = runs["meshless"], runs["sharded"]
    redis = b["redistributes"]
    check(redis.get("flash_decode", 0) == cfg.num_layers * SHARDED_DECODE
          and "B5" not in redis, f"the sharded decode did not take the "
          f"flash-decode on every layer: {redis}")
    errs = [float((y.float() - x.float()).abs().max()
                  / x.float().abs().max()) for x, y in zip(a["logits"],
                                                          b["logits"])]
    check(max(errs) <= SHARDED_LOGIT_TOL, f"qwen3-4b sharded logits differ "
          f"from the meshless ones by {max(errs)} of the largest |logit| "
          f"(bar {SHARDED_LOGIT_TOL})")
    print(f"sharded qwen3-4b: largest logit difference {max(errs):.3e} of "
          f"the largest |logit| (prefill {errs[0]:.3e})", flush=True)
    out = {"arch": LM_ARCH, "layers": cfg.num_layers,
           "lanes": SHARDED_LANES, "prompt": SHARDED_PROMPT,
           "decode_steps": SHARDED_DECODE, "max_rel_logit_err": max(errs),
           "rel_logit_err_by_step": errs,
           "redistributes_per_decode_step": {
               k: v / SHARDED_DECODE for k, v in redis.items()
               if k not in ("residual", "logits")}}
    for label, r in runs.items():
        out[label] = {"prefill_ms": r["prefill_ms"],
                      "step_p50_ms": float(np.median(r["step_ms"][1:])),
                      "host_p50_ms": float(np.median(r["host_ms"][1:])),
                      "step_ms": r["step_ms"]}
    out["dtensor_host_ms_per_decode_step"] = (
        out["sharded"]["host_p50_ms"] - out["meshless"]["host_p50_ms"])
    out["flash_decode"] = _flash_decode_vs_plain(m, mesh, cfg, b["cache"],
                                                 device)
    counts = b["counts"]
    del runs, a, b, params
    torch.cuda.empty_cache()
    return out, counts


def _local(x):
    return (x.to_local() if hasattr(x, "to_local") else x).detach().clone()


def _flash_decode_vs_plain(m, mesh, cfg, cache, device):
    """``sharded_decode_attention`` (B5 with lse, the combine) on layer 0
    of the sharded cache with random q, against its plain version (the
    reference's local body) and against B5's plain version on the whole
    cache, at the bf16 bar."""
    k, v = cache["layers"]["k"][0], cache["layers"]["v"][0]
    sp, pos = cache["slot_pos"], cache["pos"] - 1
    q = torch.randn(SHARDED_LANES, cfg.num_heads, cfg.head_dim,
                    generator=torch.Generator().manual_seed(5)).to(
        device, torch.bfloat16)
    ctx = m.steps._shard_ctx(mesh, cfg, m.ShapeConfig(
        "decode", SHARDED_PROMPT + SHARDED_DECODE, SHARDED_LANES, "decode"))
    from torch.distributed.tensor.experimental import implicit_replication
    with m.ctx.use_sharding(ctx), implicit_replication():
        got = _local(m.attention.sharded_decode_attention(q, k, v, sp, pos,
                                                          ctx=ctx))
        plain = _local(m.attention.sharded_decode_attention_torch(
            q, k, v, sp, pos, ctx=ctx))
    whole = m.ref.decode_attention_torch(q, k.to_local(), v.to_local(),
                                         sp.to_local(), pos.to_local())
    out = {}
    for name, want in (("plain", plain), ("b5_plain", whole)):
        err, excess = _attn_err(got, want, torch.bfloat16)
        check(excess <= ATTN_TOL[torch.bfloat16], f"sharded_decode_attention "
              f"against its {name} version: err {err}")
        out[f"max_abs_err_vs_{name}"] = err
    return out


def drive_sharded_lm(m, card, device="cuda"):
    """Phase 12h: the LM's sharded steps on a ("data", "model") mesh of
    (1, 1) over the world of one that phase 6e started (NCCL on the card):
    :func:`sharded_training` and :func:`sharded_serving`, the launch
    counters set to 0 before each run and read after, every plain version
    of B4-B6 and of B4's and B5's lse refused. Returns (report, the
    sharded runs' launches)."""
    t_phase = time.perf_counter()
    mesh = m.launch_mesh.make_host_mesh(1, device=device)
    check(tuple(mesh.shape) == (1, 1)
          and mesh.mesh_dim_names == ("data", "model"),
          f"make_host_mesh gave {mesh}")
    if device == "cuda":
        check("nccl" in str(torch.distributed.get_backend()).lower(),
              "the sharded LM steps' world does not run NCCL")
    out = {"card": card}
    out["training"], counts = sharded_training(m, mesh, device)
    print(f"sharded lm training: {json.dumps(out['training'])}", flush=True)
    out["serving"], more = sharded_serving(m, mesh, device)
    print(f"sharded lm serving: {json.dumps(out['serving'])}", flush=True)
    for k, v in more.items():
        counts[k] = counts.get(k, 0) + v
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"sharded lm phase: {out['phase_s']:.1f} s", flush=True)
    return out, counts


# -- phase 15: elastic restart and the examples' twins ----------------------

ELASTIC_ARCH = "olmo-1b"
# olmo-1b CONFIG (bf16) cut to 2 of its 16 layers: ~0.34 B parameters, so a
# checkpoint (bf16 weights, f32 Adam moments) is ~3.4 GB under the
# git-ignored build/ (~12 GB at 16 layers)
ELASTIC_LAYERS = 2
ELASTIC_STEPS = 4          # phase A's, then phase B's; the run without a
#                            break takes both at once
ELASTIC_CPU_MESH = (2, 2)  # (b): the card's checkpoint on 4 gloo CPU ranks
# (b)'s first step against phase B's first loss on the card, relative: the
# CPU forms bf16 products in f32 and rounds once, over two devices' blocks
ELASTIC_CPU_LOSS_TOL = 1e-2
ELASTIC_CPU_THREADS = 1    # a rank's threads: 4 ranks beside phase B on
#                            the card host's 8 cores (2 each ran slower)
ELASTIC_CARD_TIMEOUT_S = 300
ELASTIC_CPU_TIMEOUT_S = 420
ELASTIC_GROUP_TIMEOUT_S = 300
# each example twin at its reference defaults, and the start of the line
# it must end on
EXAMPLES = (("quickstart", "  CoRaiS(256)      makespan="),
            ("workload_replay", "OK"),
            ("train_lm", "OK: checkpoint/restart training converged"),
            ("serve_multi_edge", "OK: more capable edges absorbed more load"))


def _elastic_config(scale: str):
    """Phase 15's model: olmo-1b ``CONFIG`` cut to ELASTIC_LAYERS layers,
    or (a CPU rehearsal) its reduced config."""
    from repro_torch.configs import get_config, get_reduced_config
    if scale == "reduced":
        return get_reduced_config(ELASTIC_ARCH)
    return dataclasses.replace(get_config(ELASTIC_ARCH),
                               num_layers=ELASTIC_LAYERS)


def _elastic_blocks_off(run: dict, directory: str) -> list:
    """The leaves of a restored run whose local block is not its spec's
    slice of the checkpoint in ``directory`` bit for bit, the slice cut
    by hand (equal parts of each dimension over its entry's axes)."""
    from repro_torch.checkpoint.convert import (read_reference_checkpoint,
                                                reference_tensor)
    from repro_torch.nn import named_leaves
    mesh = run["mesh"]
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    flat = read_reference_checkpoint(directory)
    specs = named_leaves({"params": run["pspecs"], "opt_state": run["ospecs"]})
    bad = []
    for path, x in named_leaves({"params": run["params"],
                                 "opt_state": run["opt_state"]}).items():
        parts = path.split("/")
        if "layers" in parts:
            i = parts.index("layers")
            want = reference_tensor(flat["/".join(
                parts[:i + 1] + parts[i + 2:])])[int(parts[i + 1])]
        else:
            want = reference_tensor(flat[path])
        for dim, entry in enumerate(specs[path]):
            if entry is None:
                continue
            parts_n, index = 1, 0
            for a in ((entry,) if isinstance(entry, str) else entry):
                parts_n *= sizes[a]
                index = index * sizes[a] + coord[a]
            n = want.shape[dim] // parts_n
            want = want.narrow(dim, index * n, n)
        local = x.to_local().cpu()
        if local.dtype != want.dtype or not torch.equal(local, want):
            bad.append(path)
    return bad


def _elastic_card_phase(job: dict) -> dict:
    """A card child of phase 15 (a): ``elastic.run_phase`` on a (1, 1)
    mesh over a world of one (NCCL on the card), the launch counters set
    to 0 before and read after, every plain version of B4-B6 and of B4's
    and B5's lse refused; a restored run's leaves held to the file."""
    from unittest import mock
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.kernels import build, ops, ref
    from repro_torch.launch import elastic
    device = job["device"]
    cfg = _elastic_config(job["scale"])
    checked = {}
    real = elastic.restore_phase

    def restore_and_check(*args, **kwargs):
        latest = Checkpointer(job["ckpt"]).latest_step()
        run = real(*args, **kwargs)
        if run["restored"]:
            checked["restored_off"] = _elastic_blocks_off(
                run, os.path.join(job["ckpt"], f"step_{latest:010d}"))
        return run

    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats()
    # a CPU rehearsal runs the plain versions, which the card must not reach
    guard = (_plain_guard_lse(ref, ops) if device == "cuda"
             else contextlib.nullcontext())
    build.reset_launch_counts()
    with mock.patch.object(elastic, "restore_phase", restore_and_check), \
            guard:
        run = elastic.run_phase(job["phase"], (1, 1), job["steps"],
                                job["ckpt"], ELASTIC_ARCH, cfg=cfg,
                                device=device)
    counts = dict(build.LAUNCHES)
    out = {k: run[k] for k in ("losses", "step_ms", "restore_s", "save_s",
                               "start", "restored")}
    out.update(checked, counts=counts, layers=cfg.num_layers,
               backend=str(torch.distributed.get_backend()))
    if device == "cuda":
        out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    return out


def _elastic_cpu_rank(job: dict) -> dict:
    """A rank of phase 15 (b): once phase A's checkpoint is in its view,
    restored onto a (2, 2) mesh of gloo CPU ranks, each rank's blocks held
    to the file, then one step of the elastic step."""
    from repro_torch.launch import elastic
    cfg = _elastic_config(job["scale"])
    deadline = time.monotonic() + ELASTIC_CPU_TIMEOUT_S
    while not os.path.exists(os.path.join(job["ckpt"], "LATEST")):
        check(time.monotonic() < deadline, "phase A's checkpoint never came")
        time.sleep(0.2)
    run = elastic.restore_phase(ELASTIC_CPU_MESH, job["ckpt"], ELASTIC_ARCH,
                                cfg=cfg, device="cpu")
    off = _elastic_blocks_off(run, os.path.join(
        job["ckpt"], f"step_{run['start']:010d}"))
    batch = {k: torch.from_numpy(v) for k, v in next(run["pipe"]).items()}
    t0 = time.perf_counter()
    _, _, loss = elastic.make_step(run)(run["params"], run["opt_state"],
                                        batch)
    return {"blocks_off": off, "loss": float(loss), "start": run["start"],
            "restore_s": run["restore_s"],
            "step_s": time.perf_counter() - t0}


def elastic_child(job: dict) -> int:
    """``python chip_smoke.py --elastic-child JOB``: one process of phase
    15, its result written to ``job["out"]``."""
    sys.path.insert(0, str(ROOT / "src"))
    import datetime
    import torch.distributed as dist
    if job["kind"] == "card":
        out = _elastic_card_phase(job)
    else:
        torch.set_num_threads(job["threads"])
        dist.init_process_group(
            "gloo", store=dist.FileStore(job["store"], job["world"]),
            rank=job["rank"], world_size=job["world"],
            timeout=datetime.timedelta(seconds=ELASTIC_GROUP_TIMEOUT_S))
        try:
            out = _elastic_cpu_rank(job)
        finally:
            dist.destroy_process_group()
    Path(job["out"]).write_text(json.dumps(out))
    return 0


def _elastic_spawn(job: dict, log: Path, env=None):
    with open(log, "w") as f:
        return subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--elastic-child",
             json.dumps(job)], stdout=f, stderr=subprocess.STDOUT,
            env=env)


def _elastic_join(procs: dict, timeout: float) -> list:
    """Wait for {log: process} within ``timeout`` s (all killed after it);
    each must exit 0. Returns their results, read from ``<log>.json``."""
    deadline = time.monotonic() + timeout
    try:
        for p in procs.values():
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs.values():
            p.kill()
            p.wait()
        check(False, f"phase 15's children did not finish within "
              f"{timeout} s: {[str(k) for k in procs]}")
    for log, p in procs.items():
        check(p.returncode == 0, f"{log.name} exited {p.returncode}:\n"
              f"{log.read_text()[-4000:]}")
    return [json.loads(log.with_suffix(".json").read_text())
            for log in procs]


def _dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.iterdir())


def _same_bits(a: Path, b: Path, convert) -> list:
    """The leaves of two checkpoints whose bytes differ."""
    x, y = (convert.read_reference_checkpoint(str(d)) for d in (a, b))
    if set(x) != set(y):
        return sorted(set(x) ^ set(y))
    return [k for k in x if x[k].dtype != y[k].dtype
            or x[k].tobytes() != y[k].tobytes()]


def drive_examples(m, device="cuda") -> tuple:
    """Phase 15 (c): the four example twins in process at their reference
    defaults (train_lm's checkpoints under the git-ignored build/), every
    plain version of B1-B6 refused, the launch counters set to 0 before
    and read after; each must end on its own line. Returns (report,
    launches)."""
    import io
    argv = {"train_lm": ["--ckpt", str(ROOT / "build" /
                                       "chip_smoke_train_lm")]}
    out = {}
    m.build.reset_launch_counts()
    with contextlib.ExitStack() as guard:
        if device == "cuda":  # a CPU rehearsal runs the plain versions
            for patch in _plain_guard(m.ref, m.ops) + _plain_head_guard(
                    m.ref):
                guard.enter_context(patch)
        for name, last in EXAMPLES:
            args = list(argv.get(name, []))
            if name != "workload_replay":
                args += ["--device", device]
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                getattr(m.examples, name).main(args)
            lines = buf.getvalue().splitlines()
            out[name] = {"argv": args, "wall_s": time.perf_counter() - t0,
                         "last_line": lines[-1]}
            print(f"example {name} ({out[name]['wall_s']:.1f} s): "
                  f"{lines[-1]}", flush=True)
            check(lines[-1].startswith(last), f"the {name} twin ended on "
                  f"{lines[-1]!r}, not its own line {last!r}")
    counts = dict(m.build.LAUNCHES)
    if device == "cuda":
        for name in ("policy_score", "policy_score_bwd", "flash_attention",
                     "decode_attention"):
            check(counts[name] > 0, f"the examples launched {name} "
                  f"{counts[name]} times")
    shutil.rmtree(ROOT / "build" / "chip_smoke_train_lm", ignore_errors=True)
    out["launches"] = counts
    return out, counts


def _elastic_launch(base: Path, name: str, phase: str, steps: int,
                    ckpt: Path, device: str, scale: str) -> dict:
    """A card child of phase 15 (a), started: {log: process}."""
    log = base / f"{name}.log"
    job = {"kind": "card", "phase": phase, "steps": steps, "ckpt": str(ckpt),
           "device": device, "scale": scale,
           "out": str(log.with_suffix(".json"))}
    return {log: _elastic_spawn(job, log)}


def drive_elastic(m, card, device="cuda", scale="full") -> tuple:
    """Phase 15: (a) the elastic restart at olmo-1b's widths on the card:
    phase A (ELASTIC_STEPS steps from the seed, then a checkpoint) and
    phase B (restored onto a fresh (1, 1) mesh, every leaf the saved bits,
    then ELASTIC_STEPS more), each a subprocess of its own, phase A alone
    on the card, and a third, beside phase B, that takes all the steps
    without a break: the same losses and the same final parameters and
    Adam slots, bit for bit; B4 twice per layer a step on both phases, no
    plain version reached; (b) phase A's checkpoint restored onto 4 gloo
    CPU ranks on a (2, 2) mesh (started beside phase A, restoring beside
    phase B): each rank's blocks the file's, one step's loss within
    ELASTIC_CPU_LOSS_TOL of phase B's first; (c) the example twins in this
    process (:func:`drive_examples`) after phase B. Returns
    (report, {"elastic": phases A and B's launches, "examples": ...})."""
    t_phase = time.perf_counter()
    base = ROOT / "build" / "chip_smoke_elastic"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    ab, whole, view = base / "ab", base / "whole", base / "cpu_view"
    started = {}
    try:
        # (b)'s ranks start beside phase A, so that their start-up overlaps
        # it, and wait for phase A's checkpoint in a view of their own
        # (phase B moves the real LATEST on); no card in their view
        view.mkdir()
        cpu_env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                       OMP_NUM_THREADS=str(ELASTIC_CPU_THREADS))
        world = math.prod(ELASTIC_CPU_MESH)
        ranks = {}
        for r in range(world):
            log = base / f"cpu_rank{r}.log"
            ranks[log] = _elastic_spawn(
                {"kind": "cpu", "rank": r, "world": world,
                 "threads": ELASTIC_CPU_THREADS,
                 "store": str(base / "cpu_store"), "ckpt": str(view),
                 "scale": scale, "out": str(log.with_suffix(".json"))},
                log, cpu_env)
        started.update(ranks)
        first = _elastic_launch(base, "phase_A", "A", ELASTIC_STEPS, ab,
                                device, scale)
        started.update(first)
        (a,) = _elastic_join(first, ELASTIC_CARD_TIMEOUT_S)
        stages = {"A": time.perf_counter() - t_phase}
        step_a = ab / f"step_{ELASTIC_STEPS:010d}"
        ckpt_bytes = _dir_bytes(step_a)
        (view / step_a.name).symlink_to(step_a)
        (view / "LATEST.tmp").write_text(str(ELASTIC_STEPS))
        os.replace(view / "LATEST.tmp", view / "LATEST")
        # phase B, the run without a break and (b)'s ranks share the card's
        # host; the examples follow phase B, beside the other two
        later = _elastic_launch(base, "phase_B", "B", ELASTIC_STEPS, ab,
                                device, scale)
        third = _elastic_launch(base, "whole", "A", 2 * ELASTIC_STEPS, whole,
                                device, scale)
        started.update(later)
        started.update(third)
        (b,) = _elastic_join(later, ELASTIC_CARD_TIMEOUT_S)
        stages["B"] = time.perf_counter() - t_phase - stages["A"]
        examples, example_counts = drive_examples(m, device)
        (w,) = _elastic_join(third, ELASTIC_CARD_TIMEOUT_S)
        cpu = _elastic_join(ranks, ELASTIC_CPU_TIMEOUT_S)
        stages["rest"] = (time.perf_counter() - t_phase - stages["A"]
                          - stages["B"])
    finally:
        for p in started.values():
            if p.poll() is None:
                p.kill()
                p.wait()

    check(not a["restored"] and a["start"] == 0 and b["restored"]
          and b["start"] == ELASTIC_STEPS and b["restored_off"] == [],
          f"phase B did not restore phase A's checkpoint bit for bit: "
          f"start {b['start']}, leaves differing {b.get('restored_off')}")
    if device == "cuda":
        for label, r in (("A", a), ("B", b), ("whole", w)):
            want = 2 * r["layers"] * len(r["losses"])
            others = {k: v for k, v in r["counts"].items()
                      if v and k != "flash_attention"}
            check(r["counts"]["flash_attention"] == want and not others
                  and "nccl" in r["backend"].lower(), f"elastic {label} "
                  f"launched {r['counts']} on {r['backend']}, not B4 "
                  f"{want} times (twice per layer a step) over NCCL")
    check(a["losses"] + b["losses"] == w["losses"]
          and all(math.isfinite(x) for x in w["losses"]),
          f"phase A then B gave losses {a['losses']} + {b['losses']}, the "
          f"run without a break {w['losses']}")
    final = f"step_{2 * ELASTIC_STEPS:010d}"
    differ = _same_bits(ab / final, whole / final, m.convert)
    check(not differ, f"after phase B, {len(differ)} leaves differ from the "
          f"run without a break: {differ[:4]}")
    losses = [r["loss"] for r in cpu]
    cpu_err = abs(losses[0] - b["losses"][0]) / abs(b["losses"][0])
    check(all(r["blocks_off"] == [] and r["start"] == ELASTIC_STEPS
              for r in cpu) and len(set(losses)) == 1
          and math.isfinite(losses[0]) and cpu_err <= ELASTIC_CPU_LOSS_TOL,
          f"the {ELASTIC_CPU_MESH} CPU restore: blocks differing "
          f"{[r['blocks_off'][:3] for r in cpu]}, losses {losses} against "
          f"phase B's first {b['losses'][0]} (relative {cpu_err}, bar "
          f"{ELASTIC_CPU_LOSS_TOL})")
    report = {
        "card": card, "arch": ELASTIC_ARCH, "layers": a["layers"],
        "steps": ELASTIC_STEPS, "checkpoint_bytes": ckpt_bytes,
        "save_s": a["save_s"], "restore_s": b["restore_s"],
        # p50 of steps 1-3: a process's first step warms its libraries
        "step_p50_ms_before_restore": float(np.median(a["step_ms"][1:])),
        "step_p50_ms_after_restore": float(np.median(b["step_ms"][1:])),
        "step_ms": {"A": a["step_ms"], "B": b["step_ms"]},
        "losses": w["losses"],
        "max_memory_allocated_bytes": {
            k: r.get("max_memory_allocated_bytes") for k, r in
            (("A", a), ("B", b), ("whole", w))},
        "cpu_restore": {"mesh": ELASTIC_CPU_MESH, "loss": losses[0],
                        "phase_b_first_loss": b["losses"][0],
                        "rel_err": cpu_err, "bar": ELASTIC_CPU_LOSS_TOL,
                        "restore_s": [r["restore_s"] for r in cpu],
                        "step_s": [r["step_s"] for r in cpu]},
        "examples": examples, "stages_s": stages}
    print(f"elastic: checkpoint {ckpt_bytes} B, save {a['save_s']:.2f} s "
          f"(gather + write), restore {b['restore_s']:.2f} s (read + place), "
          f"step p50 {report['step_p50_ms_before_restore']:.1f} ms before "
          f"the restore, {report['step_p50_ms_after_restore']:.1f} ms after "
          f"(phase B beside the run without a break and (b)'s {world} CPU "
          f"ranks); {card}", flush=True)
    print(f"elastic (2, 2) CPU restore: loss {losses[0]:.6f} against phase "
          f"B's first {b['losses'][0]:.6f}, relative {cpu_err:.3e} (bar "
          f"{ELASTIC_CPU_LOSS_TOL})", flush=True)
    shutil.rmtree(base, ignore_errors=True)
    counts = {k: a["counts"].get(k, 0) + b["counts"].get(k, 0)
              for k in a["counts"]}
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"elastic phase: {report['phase_s']:.1f} s (A {stages['A']:.1f}, "
          f"B {stages['B']:.1f}, the rest {stages['rest']:.1f})", flush=True)
    return report, {"elastic": counts, "examples": example_counts}


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


def _flash_row(ops, ref, gen, b, s, h, kv, hd, window, launches, *,
               with_lse=False, sk=None, causal=True):
    """B4 at (b, s, h, kv, hd) bf16, causal with ``window`` (or, with
    ``causal`` False, every column: whisper's encoder, and with ``sk`` its
    cross attention over ``sk`` keys), held against its plain version on
    the inputs it is timed on, beside that version, SDPA and its bound:
    the (row, column) pairs the mask keeps on the bf16 tensor cores
    against q, k, v read and o written. With ``with_lse`` the kernel is
    timed storing its log-sum-exp too, as training launches it (the bound
    then counts the lse written)."""
    import torch.nn.functional as F

    from repro_torch.kernels import counts
    sk = s if sk is None else sk
    q = torch.randn(b, s, h, hd, generator=gen).to("cuda", torch.bfloat16)
    k, v = (torch.randn(b, sk, kv, hd, generator=gen).to("cuda",
                                                        torch.bfloat16)
            for _ in range(2))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    mask = None
    if causal and window is not None and window < s:
        # SDPA takes a window only as a mask
        i = torch.arange(s, device="cuda")
        mask = (i[None] <= i[:, None]) & (i[None] > i[:, None] - window)
    shape = (f"B={b} S={s}" + (f" Sk={sk}" if sk != s else "")
             + f" H={h} KV={kv} hd={hd} bf16"
             + (" causal" if causal else " non-causal")
             + (f" window {window}" if window else "")
             + (" with lse" if with_lse else ""))

    def kern():
        if with_lse:
            return LIB.flash_attention_lse(q, k, v, causal, window)[0]
        return ops.flash_attention(q, k, v, causal=causal, window=window)

    def plain():
        return ref.flash_attention_torch(q, k, v, causal=causal,
                                         window=window)

    err = _timed_err(kern, plain, f"flash_attention at {shape}")
    return _row("flash_attention", 26, kern, plain,
                *counts.flash_attention_counts(
                    b, s, sk, h, kv, hd, causal=causal, window=window,
                    with_lse=with_lse),
                launches, err, shape,
                source="flash_attention.cu", replaces="flash_attention.py",
                library=lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask,
                    is_causal=causal and mask is None, enable_gqa=True),
                peak=BF16_FLOPS, reps=10, inner=5)


def _flash_backward_row(attention, gen, b, s, h, kv, hd, chunk):
    """The training attention's backward (the pair-scan ``flash_bwd`` over
    ``chunk``-row blocks, plain PyTorch) at (b, s, h, kv, hd) bf16 causal,
    beside PyTorch's ``scaled_dot_product_attention`` backward on the same
    inputs, a yardstick only, and the bound of the same work: the five
    products of the kept (row, column) pairs (s, dp, dv, dq, dk) on the
    bf16 tensor cores against q, k, v, o, dO and lse read and dq, dk, dv
    written."""
    import torch.nn.functional as F
    q, k, v, dout = (torch.randn(b, s, n, hd, generator=gen).to(
        "cuda", torch.bfloat16) for n in (h, kv, kv, h))
    out, lse = LIB.flash_attention_lse(q, k, v, True, None)

    def pair_scan():
        return attention.flash_bwd(q, k, v, out, lse, dout, chunk=chunk)

    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                       enable_gqa=True)
    dot = dout.transpose(1, 2).contiguous()

    def sdpa():
        return torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True)

    pairs = b * s * (s + 1) // 2
    bound_ms, bound_by = bound(
        5 * 2 * h * hd * pairs,
        2 * (3 * b * s * h * hd + 2 * b * s * kv * hd) + 4 * b * h * s
        + 2 * (b * s * h * hd + 2 * b * s * kv * hd), peak=BF16_FLOPS)
    return {"shape": f"B={b} S={s} H={h} KV={kv} hd={hd} bf16 causal, "
                     f"chunk {chunk}",
            "ms": time_ms(pair_scan, reps=5, inner=3),
            "sdpa_backward_ms": time_ms(sdpa, reps=5, inner=3),
            "bound_ms": bound_ms, "bound_by": bound_by}


def _decode_row(ops, ref, da, gen, cache, h, window, launches,
                with_lse=False):
    """B5 over ``cache`` (k, v, slot positions, positions) with ``h`` query
    heads and random q, held against its plain version on those inputs,
    beside that version, SDPA and its bound: the valid slots' K and V rows
    against the tensor-core peak. ``split_sweep``: the kernel's time and
    error at SPLIT_SWEEP tiles per split (module ``da`` launched with an
    explicit plan), each checked like the plan's own choice. With
    ``with_lse``, ``with_lse``: B5 writing its log-sum-exp too (as the
    flash-decode launches it), checked by ``compare_decode_lse`` and timed
    beside B5 without it (without, with, with, without), with its bound
    (the lse written added)."""
    import torch.nn.functional as F

    from repro_torch.kernels import counts
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
        "decode_attention", 25, kern, plain,
        *counts.decode_attention_counts(b, w, h, kv, hd, n_valid=n_valid),
        launches, err, shape,
        source="decode_attention.cu", replaces="decode_attention.py",
        library=lambda: F.scaled_dot_product_attention(
            qd[:, :, None], kct, vct, attn_mask=mask, enable_gqa=True),
        peak=BF16_FLOPS)
    row["valid_slot_share"] = n_valid / (b * w)
    if with_lse:
        lse_err = compare_decode_lse(ops, ref, kern(), qd, kc, vc, slot_pos,
                                     pos, window, shape)

        def kern_lse():
            return ops.decode_attention(qd, kc, vc, slot_pos, pos,
                                        window=window, with_lse=True)
        runs = [time_ms(f) for f in (kern, kern_lse, kern_lse, kern)]
        row["with_lse"] = {
            "ms": min(runs[1:3]), "ms_without": min(runs[0], runs[3]),
            "ms_runs": runs[1:3], "ms_without_runs": [runs[0], runs[3]],
            "lse_max_abs_err": lse_err,
            "bound_ms": bound(*counts.decode_attention_counts(
                b, w, h, kv, hd, n_valid=n_valid, with_lse=True),
                BF16_FLOPS)[0]}
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


def op_host_cost(ops, da, gen, cache, h, calls=200, runs=5):
    """Host µs per call of B5 over ``cache`` with ``h`` query heads: the
    torch.library op, the wrapper it dispatches to called directly, and
    ``ops.decode_attention``, the model's call; each the sorted means of
    ``runs`` runs of ``calls`` calls, in turns, the card synchronised
    between runs only."""
    kc, vc, slot_pos, pos = cache
    q = torch.randn(kc.shape[0], h, kc.shape[-1], generator=gen).to(
        "cuda", kc.dtype)
    paths = {
        "op": lambda: LIB.decode_attention(q, kc, vc, slot_pos, pos, None),
        "wrapper": lambda: da.decode_attention_cuda(q, kc, vc, slot_pos,
                                                    pos),
        "ops.decode_attention": lambda: ops.decode_attention(
            q, kc, vc, slot_pos, pos)}
    out = {k: [] for k in paths}
    for fn in paths.values():
        for _ in range(20):
            fn()
    for _ in range(runs):
        for label, fn in paths.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            out[label].append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return {k: sorted(v) for k, v in out.items()}


def attention_timings(ops, ref, da, cache, launches, errs, attention,
                      vlm_cache):
    """B4 and B5 at the main paths' shapes, each held against its plain
    version on the inputs it is timed on (that error is the row's
    ``max_abs_err``; ``compare_max_abs_err`` is compare_attention's), beside
    that version, SDPA and its bound (bf16 tensor-core peak against the
    memory rate):
    B4 at qwen3-4b's (1, 2048, 32, 8, 128) causal prefill, and at
    hymba-1.5b's (1, 2048, 25, 5, 64) with its 2048 window; B5 at the
    4-lane qwen3-4b edge's batch cache after serving (``edge_cache``:
    W=4096, 8 KV heads, 32 query heads, its slot positions; random q), and
    at hymba's rolled 4-lane cache (HYMBA_CACHE); B5's host µs a call
    through its op, its wrapper and ``ops`` (:func:`op_host_cost`) under
    ``host_us_per_call``. The hymba readings go
    into each row under ``hymba_shape``; B4 storing its lse at olmo-1b's
    training shape (8, 1024, 16, 16, 128) under ``training_shape``, and the
    pair-scan backward there beside SDPA's under ``training_backward``.
    Under ``mixtral_shapes``: B4 at mixtral-8x7b's 2048-token prefill and
    a 4500-token one past its 4096 window, B5 at its rolled 4-lane cache
    (MIXTRAL_CACHE); under ``qwen2_vl_shape``: B4 at qwen2-vl-72b's
    (2, 2048, 64, 8, 128) prefill, B5 at the phase 12e cache after its
    decode steps (``vlm_cache``)."""
    gen = torch.Generator().manual_seed(31)
    b4 = _flash_row(ops, ref, gen, 1, 2048, 32, 8, 128, None,
                    launches["flash_attention"])
    hymba = _flash_row(ops, ref, gen, 1, 2048, 25, 5, 64, 2048, {})
    b4["hymba_shape"] = {k: hymba[k] for k in SHAPE_KEYS}
    shape = (TRAIN_LM_BATCH, TRAIN_LM_SEQ, 16, 16, 128)
    train = _flash_row(ops, ref, gen, *shape, None, {}, with_lse=True)
    b4["training_shape"] = {k: train[k] for k in SHAPE_KEYS}
    b4["training_backward"] = _flash_backward_row(attention, gen,
                                                  *shape, 512)
    b4["compare_max_abs_err"] = errs["flash_attention"]
    b5 = _decode_row(ops, ref, da, gen, cache, 32, None,
                     launches["decode_attention"], with_lse=True)
    b5["host_us_per_call"] = op_host_cost(ops, da, gen, cache, 32)
    b, w, h, kv, hd, dtype, fills, roll, window = HYMBA_CACHE
    hymba = _decode_row(ops, ref, da, gen, _slot_cache(
        gen, b, w, kv, hd, dtype, fills, roll), h, window, {})
    b5_keys = SHAPE_KEYS + ("valid_slot_share", "split_plan", "split_sweep")
    b5["hymba_shape"] = {k: hymba[k] for k in b5_keys}
    b4["mixtral_shapes"] = {
        label: {k: row[k] for k in SHAPE_KEYS} for label, row in (
            ("prefill_2048", _flash_row(ops, ref, gen, 1, 2048, 32, 8, 128,
                                        4096, {})),
            ("prefill_4500_window", _flash_row(ops, ref, gen, 1, 4500, 32,
                                               8, 128, 4096, {})))}
    b, w, h, kv, hd, dtype, fills, roll, window = MIXTRAL_CACHE
    mixtral = _decode_row(ops, ref, da, gen, _slot_cache(
        gen, b, w, kv, hd, dtype, fills, roll), h, window, {})
    b5["mixtral_shapes"] = {"rolled_4_lanes": {k: mixtral[k]
                                               for k in b5_keys}}
    vlm = _flash_row(ops, ref, gen, VLM_BATCH, VLM_PROMPT, 64, 8, 128, None,
                     {})
    b4["qwen2_vl_shape"] = {k: vlm[k] for k in SHAPE_KEYS}
    vlm = _decode_row(ops, ref, da, gen, vlm_cache, 64, None, {})
    b5["qwen2_vl_shape"] = {k: vlm[k] for k in b5_keys}
    b4["whisper_shapes"] = {
        label: {k: row[k] for k in SHAPE_KEYS} for label, row in (
            ("encoder", _flash_row(ops, ref, gen, WHISPER_BATCH,
                                   WHISPER_FRAMES, 6, 6, 64, None, {},
                                   causal=False)),
            ("cross_prefill", _flash_row(
                ops, ref, gen, WHISPER_BATCH, WHISPER_PROMPT, 6, 6, 64, None,
                {}, sk=WHISPER_FRAMES, causal=False)),
            ("cross_training", _flash_row(
                ops, ref, gen, WHISPER_TRAIN_BATCH, WHISPER_SLOTS, 6, 6, 64,
                None, {}, with_lse=True, sk=WHISPER_FRAMES,
                causal=False)))}
    kc, vc = (torch.randn(WHISPER_BATCH, WHISPER_FRAMES, 6, 64,
                          generator=gen).to("cuda", torch.bfloat16)
              for _ in range(2))
    frames = _decode_row(ops, ref, da, gen, (
        kc, vc, torch.arange(WHISPER_FRAMES, dtype=torch.int32,
                             device="cuda").expand(WHISPER_BATCH,
                                                   -1).contiguous(),
        torch.full((WHISPER_BATCH,), WHISPER_FRAMES - 1, dtype=torch.int32,
                   device="cuda")), 6, None, {})
    b5["whisper_shape"] = {k: frames[k] for k in b5_keys}
    b5["compare_max_abs_err"] = errs["decode_attention"]
    b5["compare_lse_max_abs_err"] = errs["decode_attention_lse"]
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
    from repro_torch.kernels import counts
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
               *counts.mamba_scan_gated_counts(b, s, d, n),
               launches, err, f"B={b} S={s} d={d} N={n} f32, z and out bf16",
               source="mamba_scan.cu", replaces="mamba_scan.py", reps=5,
               inner=2)
    bare = _row("mamba_scan", 21, lambda: ops.mamba_scan(*args),
                lambda: ref.mamba_scan_torch(*args),
                *counts.mamba_scan_counts(b, s, d, n), {},
                bare_err, f"B={b} S={s} d={d} N={n} f32",
                source="mamba_scan.cu", replaces="mamba_scan.py", reps=5,
                inner=2)
    row["compare_max_abs_err"] = errs["mamba_scan_gated"]
    row["bare"] = {k: bare[k] for k in SHAPE_KEYS}
    row["bare"]["compare_max_abs_err"] = errs["mamba_scan"]
    return row


def scan_bwd_timing(ref, launches, errs):
    """B6b's row at hymba-1.5b's training shape (B=8, S=1024, d=3200,
    N=16; z and dout bf16, z a strided view, dh_last none, as the SSM block
    trains), from the chunk states B6 stores there, held against its plain
    version on the inputs it times (the row's ``max_abs_err``, the largest
    |kernel - plain| over the eight gradients, and ``max_err_of_largest``,
    the largest such error against its gradient's largest |entry|;
    ``compare_max_abs_err`` is compare_scan_backward's), beside
    that version and its bound: u and dt_raw f32, z and dout bf16 read,
    du and d dt_raw f32 and dz bf16 written, 22 bytes per (t, c); B and C
    read and dB and dC written, 16 bytes per (t, n); the chunk states read;
    A, D, dt_bias read and their gradients written once; 15 f32 operations
    per (t, c, n) (the state's recompute, the adjoint and the five sums,
    the exponential counted as one) and 30 per (t, c) (softplus, SiLU and
    their derivatives). The timed call is the wrapper, the launch and the
    ``torch.sum`` of its partials. No PyTorch call computes the scan's
    gradient, so no library time. B6b at falcon-mamba-7b's width is read
    from phase 12c's profiled step; its bound there, by the same count, is
    under ``falcon_mamba_shape``. Also returns B6's gated entry storing
    its states at the same shape, as training launches it, held against
    its plain version there as compare_scan holds it, for B6's row under
    ``training_shape``."""
    from repro_torch.kernels import counts
    gen = torch.Generator().manual_seed(47)
    b, s, d, n = TRAIN_LM_BATCH, TRAIN_LM_SEQ, 3200, 16
    args, uz = _gated_inputs(gen, b, s, d, n)
    z = uz[..., d:]
    dout = torch.randn(b, s, d, generator=gen).to("cuda", torch.bfloat16)
    _, _, states = LIB.mamba_scan_gated_states(*args, z)
    where = f"timed B6b at {(b, s, d, n)}"
    got = LIB.mamba_scan_gated_bwd(*args, z, states, dout, None)
    again = LIB.mamba_scan_gated_bwd(*args, z, states, dout, None)
    want = ref.mamba_scan_gated_bwd_torch(*args, z, dout)
    torch.cuda.synchronize()
    check(all(map(torch.equal, got, again)), f"{where}: two calls differ")
    err, err_rel = 0.0, 0.0
    for name, g, w in zip(SCAN_BWD_NAMES, got, want):
        diff = float((g.float() - w.float()).abs().max())
        rel = diff / max(float(w.float().abs().max()), 1e-30)
        check(rel <= SCAN_BWD_TOL[g.dtype], f"{where}: {name} {rel} of its "
              "largest entry")
        err, err_rel = max(err, diff), max(err_rel, rel)
    del got, again, want
    where = f"timed mamba_scan_gated with states at {(b, s, d, n)}"
    got, want = (LIB.mamba_scan_gated_states(*args, z),
                 ref.mamba_scan_gated_torch(*args, z.float()))
    torch.cuda.synchronize()
    states_err = max(_within("out", got[0], want[0], SCAN_TOL, where,
                             BF16_HALF_ULP),
                     _within("h_last", got[1], want[1], SCAN_TOL, where))
    del got, want
    chunks = states.shape[1]
    row = _row("mamba_scan_bwd", "59-120",
               lambda: LIB.mamba_scan_gated_bwd(*args, z, states, dout, None),
               lambda: ref.mamba_scan_gated_bwd_torch(*args, z, dout),
               *counts.mamba_scan_gated_bwd_counts(b, s, d, n, chunks),
               launches, err,
               f"B={b} S={s} d={d} N={n} f32, z and dout bf16",
               source="mamba_scan_bwd.cu", replaces="models/ssm.py", reps=3,
               inner=1)
    row["replaces_note"] = ("no TPU kernel: the reference differentiates its "
                            "jnp scan and tail with jax.grad")
    fd = 8192  # falcon-mamba-7b's d_inner, its training shape's bound
    fm_ms, fm_by = bound(*counts.mamba_scan_gated_bwd_counts(b, s, fd, n,
                                                             chunks))
    row["falcon_mamba_shape"] = {"shape": f"B={b} S={s} d={fd} N={n}",
                                 "bound_ms": fm_ms, "bound_by": fm_by}
    row["max_err_of_largest"] = err_rel
    row["compare_max_abs_err"] = errs["mamba_scan_bwd"]
    states_row = _row(
        "mamba_scan", 21,
        lambda: LIB.mamba_scan_gated_states(*args, z),
        lambda: ref.mamba_scan_gated_torch(*args, z),
        *counts.mamba_scan_gated_counts(b, s, d, n, chunks=chunks),
        {}, states_err,
        f"B={b} S={s} d={d} N={n} f32, z and out bf16, states stored",
        source="mamba_scan.cu", replaces="mamba_scan.py", reps=3, inner=1)
    del args, uz, z, dout, states
    torch.cuda.empty_cache()
    return row, {k: states_row[k] for k in SHAPE_KEYS}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import checkpoint
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import heuristics, state
    from repro_torch.core import instances as tinst
    from repro_torch.core import objective as obj
    from repro_torch.core import policy as pol
    from repro_torch.core import train as tr
    from repro_torch.kernels import build, ops, policy_score, ref
    from repro_torch.data.synthetic import SyntheticTokens
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models import attention as lm_attention
    from repro_torch.models import lm, moe
    from repro_torch.nn import named_leaves, param_count
    from repro_torch import resilience
    from repro_torch import workloads as wl
    from repro_torch.resilience import faults
    from repro_torch import serving
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import steps as launch_steps
    from repro_torch.launch import train as launch_train
    from repro_torch.serving import batching, controller
    from repro_torch.serving import engine, fleet
    from repro_torch.serving import fastpath as fpm
    from repro_torch.serving import topology
    from repro_torch.sharding import ctx as sharding_ctx
    from repro_torch.examples import quickstart as ex_quickstart
    from repro_torch.examples import serve_multi_edge as ex_serve_multi_edge
    from repro_torch.examples import train_lm as ex_train_lm
    from repro_torch.examples import workload_replay as ex_workload_replay

    t_run = time.perf_counter()

    def stamp(phase):
        print(f"[{time.perf_counter() - t_run:.1f} s] phase {phase} done",
              flush=True)

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
    stamp("2")
    for src, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}", flush=True)

    # phase 3: policy-head kernels against their plain versions
    errs = {"policy_score": 0.0, "policy_score_decode": 0.0,
            "policy_score_bwd": 0.0, "policy_score_bwd_rel": 0.0,
            "flash_attention": 0.0, "decode_attention": 0.0,
            "decode_attention_lse": 0.0, "mamba_scan": 0.0,
            "mamba_scan_gated": 0.0, "mamba_scan_bwd": 0.0}
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
    stamp("3")

    # phase 4: the serving decision path at full width
    summary, enc = drive_main_path(pol, obj, fpm, tinst, policy_score,
                                   param_count)
    print(f"main path: {json.dumps(summary)}", flush=True)
    # the kernels again, on the real encoder outputs of a 100x1000 round
    cases += compare_kernels(ops, ref, [("encoder", *enc)], errs)
    stamp("4")

    # phase 5: gradients through the kernels against plain autograd
    parity = gradient_parity(pol, tr, tinst)
    print(f"gradient parity: {json.dumps(parity)}", flush=True)
    stamp("5")

    # phase 6: static REINFORCE training at full width
    training, enc_train = drive_training(pol, tr, tinst, policy_score)
    print(f"training: {json.dumps(training)}", flush=True)
    bwd += compare_backward(policy_score, ref, [("encoder", *enc_train)],
                            errs)
    stamp("6")

    # phase 7: the attention and scan kernels against their plain versions
    attn_cases = compare_attention(ops, ref, errs)
    print(f"compare attention: max_abs_err flash "
          f"{errs['flash_attention']}, decode {errs['decode_attention']} "
          f"over {len(attn_cases)} cases", flush=True)
    whisper_attn = compare_cross_attention(ops, ref, lm_attention, errs)
    print(f"compare whisper attention: {json.dumps(whisper_attn)}",
          flush=True)
    scan_cases, scan_args, gated_args = compare_scan(ops, ref, errs)
    print(f"compare scan: {json.dumps(scan_cases)}", flush=True)
    stamp("7")

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
    stamp("6a")

    # phase 6b: the scale run, B3 and then B1 once per round for 256
    # instances of a 100-edge cluster at full policy width
    t0 = time.perf_counter()
    rollout_partials = {}
    rollout, rollout_counts = drive_rollout(pol, engine, policy_score, ref,
                                            rollout_arr,
                                            partials=rollout_partials)
    rollout_s = time.perf_counter() - t0
    for backend, r in rollout.items():
        print(f"rollout {backend}: {json.dumps(r)}", flush=True)
        record("rollout", rollout_counts[backend])
    stamp("6b")

    # phase 6c: temporal REINFORCE on engine rollouts at full policy width,
    # B1 forward and B2 backward once per round of every update
    t0 = time.perf_counter()
    temporal_inputs = temporal_cases(width)
    temporal = {"compare": compare_temporal_shapes(ops, ref, policy_score,
                                                   temporal_inputs, errs)}
    temporal["samplers"] = device_sampler_laws(wl, faults)
    temporal["materialization"] = episode_materialization(tr, wl, faults)
    temporal["gradient_parity"] = temporal_gradient_parity(pol, tr, engine,
                                                           wl)
    checks = ("samplers", "materialization", "gradient_parity")
    print(f"temporal checks: {json.dumps({k: temporal[k] for k in checks})}",
          flush=True)
    temporal_counts = {}
    for label, cfg, n in (
            ("host", tr.TemporalRLConfig(), TEMPORAL_HOST_UPDATES),
            ("epoch", tr.TemporalRLConfig(device_episodes=True,
                                          epoch_len=TEMPORAL_EPOCH_LEN),
             TEMPORAL_EPOCHS * TEMPORAL_EPOCH_LEN),
            ("chaos", _chaos_config(tr, pol, engine),
             TEMPORAL_EPOCHS * TEMPORAL_CHAOS_EPOCH_LEN)):
        temporal[label], counts, trained = drive_temporal(
            pol, tr, ref, policy_score, cfg, label, n)
        if label == "host":
            host_policy = trained
        for k, v in counts.items():
            temporal_counts[k] = temporal_counts.get(k, 0) + v
        print(f"temporal {label}: {json.dumps(temporal[label])}", flush=True)
    temporal["scale"], counts = temporal_scale(pol, tr, engine, ref,
                                               policy_score, rollout_arr)
    for k, v in counts.items():
        temporal_counts[k] = temporal_counts.get(k, 0) + v
    print(f"temporal scale: {json.dumps(temporal['scale'])}", flush=True)
    record("temporal_training", temporal_counts)
    temporal["profile"] = profile_temporal(tr, host_policy)
    temporal["resume"] = temporal_resume(pol, tr, checkpoint)
    temporal_s = time.perf_counter() - t0
    print(f"temporal ({temporal_s:.1f} s): profile "
          f"{json.dumps(temporal['profile'])}, resume "
          f"{json.dumps(temporal['resume'])}", flush=True)
    del host_policy
    torch.cuda.empty_cache()
    stamp("6c")

    # phase 6d: the serving host side, the paper's Fig. 2 loop on a
    # 100-edge cluster, trained and served through the command lines
    serving_host, counts = drive_serving_host(card, types.SimpleNamespace(
        tr=tr, pol=pol, obj=obj, checkpoint=checkpoint,
        launch_train=launch_train, launch_serve=launch_serve,
        serving=serving, controller=controller, state=state,
        topology=topology, wl=wl, faults=faults, engine=engine,
        policy_score=policy_score, ref=ref))
    record("serving_host", counts)
    torch.cuda.empty_cache()
    stamp("6d")

    # phase 6e: the fleet and data parallelism on a world of one (NCCL):
    # the fleet rollout through B3 and B1 against 6b, the sharded epoch
    # step through B1 and B2 against the meshless one
    fleet_dp, counts = drive_fleet_data_parallel(
        card, types.SimpleNamespace(
            pol=pol, tr=tr, engine=engine, fleet=fleet,
            launch_mesh=launch_mesh, policy_score=policy_score, ref=ref),
        rollout_arr, rollout_partials,
        {b: r["rollout_wall_ms"] for b, r in rollout.items()})
    for path, c in counts.items():
        record(path, c)
    del rollout_arr, rollout_partials
    torch.cuda.empty_cache()
    stamp("6e")

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
    stamp("8-10")

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
    stamp("11")
    # phase 12: hybrid edge serving (hymba-1.5b: B4, B5 windowed; B6)
    ssm_lm[LM_HYBRID_ARCH] = serve_lm("hybrid", LM_HYBRID_ARCH,
                                      LM_HYBRID_PROMPT)
    stamp("12")

    # phase 12b: LM pretraining at full width (olmo-1b, bf16): B4 with its
    # log-sum-exp in every layer's forward and recompute, the pair-scan
    # backward, Adam; the kernel path against the plain one; a resume
    lm_training, counts = drive_lm_training(types.SimpleNamespace(
        ops=ops, ref=ref, build=build, lm=lm, steps=launch_steps,
        attention=lm_attention, launch_train=launch_train,
        checkpoint=checkpoint, get_config=get_config,
        SyntheticTokens=SyntheticTokens, named_leaves=named_leaves), card)
    record("lm_training", counts)
    torch.cuda.empty_cache()
    stamp("12b")

    # phase 12c: SSM and hybrid LM training at full width (hymba-1.5b;
    # falcon-mamba-7b at 8 layers): B6 storing its chunk states in every
    # layer's forward and recompute, B6b in its backward; the kernel path
    # against the plain one
    ssm_training, counts = drive_ssm_training(types.SimpleNamespace(
        ops=ops, ref=ref, build=build, lm=lm, steps=launch_steps,
        attention=lm_attention, launch_train=launch_train,
        get_config=get_config, SyntheticTokens=SyntheticTokens,
        named_leaves=named_leaves), card)
    for path, c in counts.items():
        record(path, c)
    errs["mamba_scan_bwd"] = max(
        row[name]["max_abs_err"] for row in ssm_training["scan_backward"]
        for name in SCAN_BWD_NAMES)
    torch.cuda.empty_cache()
    stamp("12c")

    # phase 12d: mixtral-8x7b at 24 of its 32 layers, full width, bf16:
    # served through B4 and B5 with the MoE layer's capacity dispatch
    lm_ns = types.SimpleNamespace(
        lm=lm, batching=batching, state=state, heuristics=heuristics,
        build=build, ref=ref, ops=ops, moe=moe, get_config=get_config)
    moe_lm, counts = drive_moe_lm(lm_ns)
    record("moe_lm_serving", counts)
    stamp("12d")

    # phase 12e: the qwen2-vl-72b backbone at 32 of its 80 layers: a
    # prefill from patch embeddings with M-RoPE rows, then decode steps
    vlm_lm, counts, vlm_cache = drive_vlm_lm(lm_ns)
    record("vlm_lm", counts)
    stamp("12e")

    # phase 12f: whisper-tiny at full width, bf16: served (B4 over the
    # frames and over the decoder's own tokens, B5 for the self and cross
    # attention of a step) and trained (B4 with its lse, the pair-scan
    # backward); the kernel path against the plain one
    train_ns = types.SimpleNamespace(
        ops=ops, ref=ref, build=build, lm=lm, moe=moe, steps=launch_steps,
        attention=lm_attention, launch_train=launch_train,
        get_config=get_config, SyntheticTokens=SyntheticTokens,
        ShapeConfig=ShapeConfig, named_leaves=named_leaves)
    whisper_lm, counts = drive_whisper_lm(train_ns, card)
    for path, c in counts.items():
        record(path, c)
    stamp("12f")

    # phase 12g: mixtral-8x7b trained at 2 of its 32 layers through
    # ``train lm``: the load-balance term, a bit-identical rerun, the
    # kernel path against the plain one with the routes forced
    moe_training, counts = drive_moe_training(train_ns, card)
    for path, c in counts.items():
        record(path, c)
    stamp("12g")

    # phase 12h: the LM's sharding on a (1, 1) ("data", "model") mesh over
    # NCCL: olmo-1b trained through the sharded build_train_step bit for
    # bit with the meshless step; qwen3-4b served through the sharded
    # prefill and decode with the flash-decode (B5 with its lse) on every
    # layer, against the meshless path
    sharded_lm, counts = drive_sharded_lm(types.SimpleNamespace(
        build=build, lm=lm, ops=ops, steps=launch_steps,
        attention=lm_attention,
        ctx=sharding_ctx, ref=ref, launch_mesh=launch_mesh,
        get_config=get_config, SyntheticTokens=SyntheticTokens,
        ShapeConfig=ShapeConfig, named_leaves=named_leaves), card)
    record("sharded_lm", counts)
    torch.cuda.empty_cache()
    stamp("12h")

    # phase 15 (before 13, whose kernels line counts its launches): the
    # elastic restart of olmo-1b's widths across subprocesses on the card,
    # its checkpoint on a (2, 2) world of CPU ranks, the example twins
    phase15, counts = drive_elastic(types.SimpleNamespace(
        build=build, ops=ops, ref=ref, convert=checkpoint.convert,
        examples=types.SimpleNamespace(
            quickstart=ex_quickstart, workload_replay=ex_workload_replay,
            train_lm=ex_train_lm, serve_multi_edge=ex_serve_multi_edge)),
        card)
    for path, c in counts.items():
        record(path, c)
    torch.cuda.empty_cache()
    stamp("15")

    # phase 13: the policy head's device time per launch; every kernel timed
    # beside its plain version; the kernels line
    head_split = policy_head_split(ops, policy_score, enc, enc_train)
    print(f"policy head launch split: {json.dumps(head_split)}", flush=True)
    kernels = timings(ops, ref, policy_score, enc, enc_train, launches, errs,
                      rollout_inputs[0], temporal_inputs)
    kernels += attention_timings(ops, ref, da, qwen3_cache, launches, errs,
                                 lm_attention, vlm_cache)
    kernels.append(scan_timing(ops, ref, scan_args, gated_args,
                               launches["mamba_scan"], errs))
    b6b, kernels[-1]["training_shape"] = scan_bwd_timing(
        ref, launches["mamba_scan_bwd"], errs)
    kernels.append(b6b)
    for row in kernels:  # every row names phase 15's paths, 0 where unused
        for path in ("elastic", "examples"):
            row["launches_by_path"].setdefault(path, 0)
    stamp("13")

    # phase 14: the dry run on fake CUDA tensors, five production cells
    # and olmo-1b's step on a world of one held against the same step on
    # the card
    dryrun, counts = drive_dryrun(types.SimpleNamespace(
        build=build, lm=lm, steps=launch_steps, launch_mesh=launch_mesh,
        get_config=get_config, SyntheticTokens=SyntheticTokens,
        ShapeConfig=ShapeConfig, named_leaves=named_leaves), card)
    record("dryrun_against_card", counts)
    stamp("14")

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
        "lm_training": lm_training, "ssm_lm_training": ssm_training,
        "moe_lm": moe_lm, "vlm_lm": vlm_lm,
        "compare_whisper_attention": whisper_attn, "whisper_lm": whisper_lm,
        "moe_lm_training": moe_training, "sharded_lm": sharded_lm,
        "dryrun": dryrun, "elastic": phase15,
        "engine_parity": eng_parity, "rollout": rollout,
        "temporal": temporal, "temporal_s": temporal_s,
        "serving_host": serving_host, "fleet_data_parallel": fleet_dp,
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
                      "lm_training": {
                          k: lm_training["full_width"][k] for k in (
                              "step_p50_ms", "step_p95_ms", "tokens_per_s",
                              "max_memory_allocated_bytes")}
                      | {"profile": {k: lm_training["full_width"]["profile"][k]
                                     for k in ("wall_ms", "device_busy_ms",
                                               "idle_share",
                                               "kernels_per_unit",
                                               "device_ms_by_kind",
                                               "device_ms_by_piece")},
                         "phase_s": lm_training["phase_s"]},
                      "ssm_lm_training": {
                          label: {k: ssm_training[label][k] for k in (
                              "step_p50_ms", "step_p95_ms", "tokens_per_s",
                              "max_memory_allocated_bytes")}
                          | {"profile": {k: ssm_training[label]["profile"][k]
                                         for k in ("wall_ms",
                                                   "device_busy_ms",
                                                   "idle_share",
                                                   "device_ms_by_kind")}}
                          for label in ("hybrid", "ssm")}
                      | {"phase_s": ssm_training["phase_s"]},
                      "moe_lm": {
                          k: moe_lm["serving"][k] for k in (
                              "decode_step_ms", "decode_tokens_per_s",
                              "max_memory_allocated_bytes")}
                      | {"profile": {u: {k: moe_lm["profile"][u][k] for k in (
                          "wall_ms", "device_busy_ms", "idle_share",
                          "kernels_per_unit", "device_ms_by_kind",
                          "device_ms_by_piece")}
                          for u in ("prefill", "decode")},
                         "kernel_vs_plain": {
                             d: {k: moe_lm["kernel_vs_plain"][d][k] for k in
                                 ("max_rel_err", "routes")}
                             for d in ("bf16", "bf16_cut", "f32")},
                         "phase_s": moe_lm["phase_s"]},
                      "vlm_lm": {
                          k: vlm_lm["serving"][k] for k in (
                              "prefill_ms", "decode_step_ms",
                              "decode_tokens_per_s",
                              "max_memory_allocated_bytes")}
                      | {"profile": {u: {k: vlm_lm["profile"][u][k] for k in (
                          "wall_ms", "device_busy_ms", "idle_share",
                          "kernels_per_unit", "device_ms_by_kind")}
                          for u in ("prefill", "decode")},
                         "kernel_vs_plain": {
                             d: vlm_lm["kernel_vs_plain"][d]["max_rel_err"]
                             for d in ("bf16", "f32")},
                         "phase_s": vlm_lm["phase_s"]},
                      "whisper_lm": {
                          "serving": {k: whisper_lm["serving"][k] for k in (
                              "prefill_ms", "decode_step_ms",
                              "decode_tokens_per_s",
                              "max_memory_allocated_bytes")},
                          "training": {k: whisper_lm["training"][k] for k in (
                              "step_p50_ms", "step_p95_ms",
                              "utterances_per_s",
                              "max_memory_allocated_bytes")},
                          "kernel_vs_plain": {
                              d: whisper_lm["kernel_vs_plain"][d][
                                  "max_rel_err"] for d in ("bf16", "f32")},
                          "training_kernel_vs_plain": {
                              k: whisper_lm["training_kernel_vs_plain"][k]
                              for k in ("loss_rel_err",
                                        "worst_grad_rel_err")},
                          "phase_s": whisper_lm["phase_s"]},
                      "moe_lm_training": {
                          k: moe_training["full_width"][k] for k in (
                              "step_p50_ms", "step_p95_ms", "tokens_per_s",
                              "max_memory_allocated_bytes")}
                      | {"rerun_leaves_differing": moe_training["rerun"][
                          "leaves_differing"],
                         "kernel_vs_plain": {
                             k: moe_training["kernel_vs_plain"][k] for k in (
                                 "loss_rel_err", "aux_rel_err",
                                 "worst_grad_rel_err")},
                         "phase_s": moe_training["phase_s"]},
                      "sharded_lm": {
                          "training": {k: sharded_lm["training"][k] for k in (
                              "leaves_differing", "dtensor_host_ms",
                              "redistributes_per_step")}
                          | {label: sharded_lm["training"][label][
                              "step_p50_ms"]
                             for label in ("meshless", "sharded")},
                          "serving": {k: sharded_lm["serving"][k] for k in (
                              "max_rel_logit_err",
                              "dtensor_host_ms_per_decode_step",
                              "redistributes_per_decode_step")}
                          | {label: {k: sharded_lm["serving"][label][k]
                                     for k in ("prefill_ms", "step_p50_ms")}
                             for label in ("meshless", "sharded")},
                          "phase_s": sharded_lm["phase_s"]},
                      "elastic": {k: phase15[k] for k in (
                          "checkpoint_bytes", "save_s", "restore_s",
                          "step_p50_ms_before_restore",
                          "step_p50_ms_after_restore", "cpu_restore",
                          "phase_s")}
                      | {"examples_s": {k: v["wall_s"] for k, v in
                                        phase15["examples"].items()
                                        if k != "launches"}},
                      "dryrun": {
                          "against_card": {k: dryrun["against_card"][k] for k
                                           in ("trace_flops", "card_flops",
                                               "predicted_peak_bytes",
                                               "card_peak_bytes", "bound_ms",
                                               "card_step_p50_ms")},
                          "phase_s": dryrun["phase_s"]},
                      "rollout": {backend: {
                          k: r[k] for k in ("rollout_wall_ms", "ms_per_round",
                                            "request_rounds_per_s",
                                            "peak_memory_bytes")}
                          | {k: r["profile"][k] for k in (
                              "device_busy_ms", "idle_share",
                              "kernels_per_unit", "head_device_ms")}
                          for backend, r in rollout.items()},
                      "serving_host": {
                          "serve_cli": _decision_stats(
                              serving_host["serve_cli"]),
                          **{label: {k: r[k] for k in (
                              "decision_mean_s", "decision_p95_s",
                              "decision_max_s", "rounds_scheduled",
                              "sim_wall_ms_per_arrival_round",
                              "round_split_ms")}
                             for label, r in
                             serving_host["in_process"].items()},
                          "wall_s": serving_host["wall_s"]},
                      "fleet": {b: {k: r[k] for k in (
                          "wall_ms", "single_device_wall_ms")}
                          for b, r in fleet_dp["fleet"].items()},
                      "sharded_update_ms": {
                          label: r["p50"] for label, r in
                          fleet_dp["sharded_epoch"]["update_ms"].items()},
                      "temporal": {label: {
                          "update_ms": temporal[label]["update_ms"],
                          "updates_per_s": temporal[label]["updates_per_s"]}
                          for label in ("host", "epoch", "chaos", "scale")}
                      | {"profile": {k: temporal["profile"][k] for k in (
                          "wall_ms", "device_busy_ms", "idle_share",
                          "kernels_per_unit", "b1_device_ms",
                          "b2_device_ms", "b1_calls", "b2_calls")},
                         "materialization": {
                             k: {m: v[m] for m in ("host_ms", "device_ms")}
                             for k, v in temporal["materialization"].items()}},
                      "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--elastic-child"]:
        sys.exit(elastic_child(json.loads(sys.argv[2])))
    sys.exit(main())
