"""The port's CUDA kernels on a card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips without
one. The file imports neither jax nor the reference, so it runs on a GPU
machine that has only torch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance 2e-5: f32 sums in another order, scaled by C=10 through tanh.
The backward (B2) is held relative to each gradient's largest entry: 2e-5
for dc and dh, 1e-4 for the weight gradients, whose sums run over B*Z rows.
The attention kernels (B4, B5) are held at the reference's bars
(``tests/test_kernels.py``): 2e-4 in f32, 2e-2 in bf16 (the output is
rounded to bf16; the plain version computes in f32 from the same bf16
inputs); B5's log-sum-exp within 1e-5 of the largest |lse| of its plain
version (f32 sums in another order), -1e30 exactly on an empty lane.
The selective scan (B6) is held at the reference's 5e-4
(``tests/test_kernels.py:78``), and two calls must give the same bits;
B6's gated entry too, its bf16 output against the plain version's f32
value within 5e-4 plus half a bf16 ulp (2^-8 of the value), the rounding
of the cast itself. The soft cap (B4, B5) is held at the same bars as the
uncapped kernels; the bf16 scan state (B6, B6b) at 1e-2 of the largest
|entry| against the plain versions with it (``SCAN_BF16_BAR``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import instances as tinst
from repro_torch.core.policy import (CoRaiSPolicy, PolicyConfig,
                                     corais_encode, corais_score_decode)
from repro_torch.core import train as ttrain
from repro_torch.core.train import RLConfig, loss_and_grads, to_device
from repro_torch.configs import get_reduced_config
from repro_torch.kernels import (build, decode_attention, ops, policy_score,
                                 ref)
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.mamba_scan import (mamba_scan_cuda,
                                            mamba_scan_gated_bwd_cuda,
                                            mamba_scan_gated_cuda)
from repro_torch.models import lm
from repro_torch.nn import named_leaves
from repro_torch.serving.batching import LMEdgeBackend
from repro_torch.serving import (CentralController, MultiEdgeSim, SimConfig,
                                 engine, rounds)
from repro_torch.serving.fastpath import DecisionFastPath
from repro_torch.resilience import faults
from repro_torch.resilience.policies import ResilienceConfig
from repro_torch.workloads import (PoissonArrivals, materialize_round_batch,
                                   materialize_round_batch_device, scenario,
                                   scenario_fault_spec)

pytestmark = pytest.mark.cuda

ATOL = 2e-5
SMALL = dict(d_model=32, ff_hidden=64, edge_layers=2, request_layers=1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(device, b=3, q=6, q_valid=3, z=37, d=32, seed=0):
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(d)
    c = rng.normal(size=(b, q, d)).astype(np.float32)
    h = rng.normal(size=(b, z, d)).astype(np.float32)
    wx = rng.uniform(-bound, bound, size=(d, d)).astype(np.float32)
    wy = rng.uniform(-bound, bound, size=(d, d)).astype(np.float32)
    mask = np.zeros((b, q), bool)
    mask[:, :q_valid] = True
    return [torch.from_numpy(a).to(device) for a in (c, h, wx, wy, mask)]


@pytest.mark.parametrize("normalize", [True, False])
def test_cuda_kernels_match_plain_versions(cuda_device, normalize):
    c, h, wx, wy, mask = _inputs(cuda_device)
    policy_score.reset_launch_counts()
    lp = ops.policy_score(c, h, wx, wy, mask)
    torch.testing.assert_close(lp, ref.policy_score_torch(c, h, wx, wy, mask),
                               atol=ATOL, rtol=0)
    ti, tv = ops.policy_score_decode(c, h, wx, wy, mask, k=3,
                                     normalize=normalize)
    wi, wv = ref.policy_score_decode_torch(c, h, wx, wy, mask, 10.0, 3,
                                           normalize)
    torch.testing.assert_close(ti, wi)
    torch.testing.assert_close(tv, wv, atol=ATOL, rtol=0)
    assert {k: policy_score.LAUNCHES[k] for k in (
        "policy_score", "policy_score_bwd", "policy_score_decode")} == {
            "policy_score": 1, "policy_score_bwd": 0, "policy_score_decode": 1}


def test_cuda_wrappers_reject_bad_inputs(cuda_device):
    c, h, wx, wy, mask = _inputs(cuda_device)
    maskf = mask.to(torch.float32)
    with pytest.raises(TypeError, match="float32"):
        policy_score.policy_score_cuda(c.double(), h, wx, wy, maskf)
    with pytest.raises(ValueError, match="contiguous"):
        policy_score.policy_score_cuda(c, h, wx.T, wy, maskf)
    with pytest.raises(ValueError, match="k=7"):
        policy_score.policy_score_decode_cuda(c, h, wx, wy, maskf, k=7)


def test_cuda_fast_path_matches_cpu_fast_path(cuda_device):
    """Same weights, same instances: the fast path on the card (kernels)
    returns the CPU fast path's (plain versions) greedy decisions."""
    cfg = PolicyConfig(**SMALL)
    cpu = CoRaiSPolicy(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    gpu = CoRaiSPolicy(cfg, generator=torch.Generator().manual_seed(0),
                       device=cuda_device)
    buckets = ((8, 32),)
    fp_cpu = DecisionFastPath(cpu, buckets=buckets, device="cpu")
    fp_gpu = DecisionFastPath(gpu, buckets=buckets, device=cuda_device)
    rng = np.random.default_rng(1)
    policy_score.reset_launch_counts()
    for _ in range(3):
        inst = tinst.generate_instance(rng, tinst.InstanceConfig(
            num_edges=6, num_requests=20))
        got, want = fp_gpu.decide(inst), fp_cpu.decide(inst)
        with torch.inference_mode():  # rows whose top-2 scores are apart
            t = {k: torch.as_tensor(np.asarray(v)) for k, v in inst.items()}
            c, h = corais_encode(cpu, t)
            _, tv = corais_score_decode(cpu, c, h, t["edge_mask"], k=2,
                                        normalize=False, backend="torch")
        gapped = (tv[:, 0] - tv[:, 1] > 1e-4).numpy()
        assert gapped.mean() > 0.9
        np.testing.assert_array_equal(got[gapped], want[gapped])
    assert policy_score.LAUNCHES["policy_score_decode"] == 3


def _exact_inputs(device, b, q, z, d, seed=0):
    """Small multiples of 2^-6 and 2^-7, so that every score is exact in f32
    whatever the summation order; edge 1 duplicates edge 0 and edge 3 edge
    2 (where they exist): rows hold exact ties."""
    rng = np.random.default_rng(seed)
    c = rng.integers(-3, 4, size=(b, q, d)) / 64.0
    h = rng.integers(-3, 4, size=(b, z, d)) / 64.0
    wx = rng.integers(-2, 3, size=(d, d)) / 128.0
    wy = rng.integers(-2, 3, size=(d, d)) / 128.0
    for src, dst in ((0, 1), (2, 3)):
        if dst < q:
            c[:, dst] = c[:, src]
    mask = np.ones((b, q), bool)
    mask[:, 4::3] = False
    return [torch.from_numpy(a.astype(np.float32)).to(device)
            for a in (c, h, wx, wy)] + [torch.from_numpy(mask).to(device)]


def _gapped_rows(vals, mask, k, gap=1e-4):
    """Rows whose first min(k, valid) sorted scores are each more than gap
    above the next valid one; vals (B, Z, Q) sorted descending."""
    n_valid = mask.sum(-1)
    gaps = vals[..., :-1] - vals[..., 1:]
    idx = torch.arange(gaps.shape[-1], device=vals.device)
    limit = torch.minimum(torch.full_like(n_valid, k), n_valid - 1)
    gaps = torch.where(idx[None, None, :] < limit[:, None, None], gaps,
                       torch.inf)
    if gaps.shape[-1] == 0:  # one edge: nothing to tell apart
        return torch.ones(vals.shape[:-1], dtype=torch.bool,
                          device=vals.device)
    return gaps.amin(-1) > gap


@pytest.mark.parametrize("b,q,q_valid,z,d", [
    (2, 1, 1, 37, 32),      # one edge: QP 32
    (3, 5, 3, 1, 64),       # Z = 1
    (2, 128, 100, 37, 128),  # the widest Q: 4 keys per lane in the sort
    (1, 100, 80, 1000, 256),  # the serving shape, Q padded to 128
    (2, 50, 40, 67, 512),   # QP 64, two 256-deep chunks of d
    (2, 7, 5, 23, 30),      # d not a multiple of 4: 4-byte staging
])
@pytest.mark.parametrize("normalize", [True, False])
def test_decode_kernel_matches_plain_version(cuda_device, b, q, q_valid, z,
                                             d, normalize):
    """B3 at K = 1, 3 and Q (the sampled path's sort): indices equal the
    plain version's on rows whose scores are more than 1e-4 apart, values
    within 2e-5, and two calls give the same bits."""
    c, h, wx, wy, mask = _inputs(cuda_device, b, q, q_valid, z, d, seed=q)
    maskf = mask.to(torch.float32)
    _, sorted_vals = ref.policy_score_decode_torch(c, h, wx, wy, mask, 10.0,
                                                   q, normalize)
    for k in sorted({1, min(3, q), q}):
        got = policy_score.policy_score_decode_cuda(c, h, wx, wy, maskf, k=k,
                                                    normalize=normalize)
        again = policy_score.policy_score_decode_cuda(
            c, h, wx, wy, maskf, k=k, normalize=normalize)
        wi, wv = ref.policy_score_decode_torch(c, h, wx, wy, mask, 10.0, k,
                                               normalize)
        assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
        rows = _gapped_rows(sorted_vals, mask, k)
        assert float(rows.float().mean()) > 0.5
        assert torch.equal(got[0][rows], wi[rows]), k
        torch.testing.assert_close(got[1], wv, atol=ATOL, rtol=0)


@pytest.mark.parametrize("q", [5, 100, 128])
@pytest.mark.parametrize("normalize", [True, False])
def test_decode_kernel_breaks_exact_ties_like_plain_version(cuda_device, q,
                                                            normalize):
    """Exact scores with duplicated edge columns: every row's indices equal
    the plain version's, at K = 1, 3 and Q, ties to the lower edge."""
    c, h, wx, wy, mask = _exact_inputs(cuda_device, 2, q, 45, 64)
    maskf = mask.to(torch.float32)
    for k in (1, 3, q):
        ti, tv = policy_score.policy_score_decode_cuda(
            c, h, wx, wy, maskf, k=k, normalize=normalize)
        wi, wv = ref.policy_score_decode_torch(c, h, wx, wy, mask, 10.0, k,
                                               normalize)
        assert torch.equal(ti, wi), k
        torch.testing.assert_close(tv, wv, atol=ATOL, rtol=0)


def _partial_mask(b, q, device, seed):
    """A random set of valid edges per instance: at B = 1 a third masked;
    else one instance with a single edge, one full, the rest 1..Q."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, q + 1, size=b)
    counts[:2] = (1, q) if b > 1 else (q - q // 3,)
    mask = np.zeros((b, q), bool)
    for i, n in enumerate(counts):
        mask[i, rng.permutation(q)[:n]] = True
    return torch.from_numpy(mask).to(device)


@pytest.mark.parametrize("b,q,z,d", [
    (1, 100, 1000, 256),  # the serving shape (QP 128)
    (128, 5, 50, 256),    # the training shape: the small-Q plan
    (3, 1, 37, 64),       # one edge
    (16, 8, 1, 256),      # Q = kFlatQ, Z = 1: pxy^T rows read in place
    (2, 9, 45, 64),       # Q = kFlatQ + 1: QP 32
    (2, 37, 45, 128),     # QP 64, Q not a multiple of 4
    (2, 128, 20, 512),    # the widest Q and d: two 256-deep chunks
    (3, 7, 23, 30),       # d not a multiple of 4: 4-byte staging (small Q)
    (2, 20, 23, 30),      # the same for QP 32
])
def test_score_kernel_matches_plain_version(cuda_device, b, q, z, d):
    """B1, both plans, against its plain version within 2e-5 on partial
    masks, the same bits across two calls."""
    c, h, wx, wy, _ = _inputs(cuda_device, b, q, q, z, d, seed=q + d)
    mask = _partial_mask(b, q, cuda_device, seed=z)
    maskf = mask.to(torch.float32)
    got = policy_score.policy_score_cuda(c, h, wx, wy, maskf)
    again = policy_score.policy_score_cuda(c, h, wx, wy, maskf)
    assert torch.equal(got, again)
    want = ref.policy_score_torch(c, h, wx, wy, mask)
    assert got.shape == (b, z, q) and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("q,z", [(10, 100), (25, 250), (50, 500), (100, 1000)])
def test_score_kernel_equals_normalized_decode_bits(cuda_device, q, z):
    """At each serving bucket (B = 1, d = 256), where B1 and B3 take one
    plan: B1's row arg-max is B3's K = 1 normalized index on every row,
    and B1's values at B3's top-K indices (K = 1, 8, Q) are B3's
    normalized values, bit for bit."""
    c, h, wx, wy, _ = _inputs(cuda_device, 1, q, q, z, 256, seed=z)
    maskf = torch.ones(1, q, device=cuda_device)  # a third masked
    maskf[0, np.random.default_rng(q).permutation(q)[:q // 3]] = 0.0
    scores = policy_score.policy_score_cuda(c, h, wx, wy, maskf)
    for k in sorted({1, 8, q}):
        ti, tv = policy_score.policy_score_decode_cuda(c, h, wx, wy, maskf,
                                                       k=k, normalize=True)
        if k == 1:
            assert torch.equal(scores.argmax(-1), ti[..., 0].long())
        assert torch.equal(scores.gather(-1, ti.long()), tv), k


def _rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("b,q,q_valid,z,d", [
    (3, 6, 3, 37, 32),      # Z not a multiple of the 16-row tile
    (2, 128, 100, 20, 64),  # every lane holds four edges
    (64, 5, 4, 50, 128),    # B*Z = 3200 rows: split weight-gradient sums
    (1, 7, 7, 5, 512),      # the widest d
    (128, 5, 5, 50, 256),   # the training shape (RLConfig)
    (3, 6, 4, 29, 30),      # d not a multiple of 4: 4-byte staging
])
def test_backward_kernel_matches_plain_version(cuda_device, b, q, q_valid, z,
                                               d):
    c, h, wx, wy, mask = _inputs(cuda_device, b, q, q_valid, z, d, seed=2)
    maskf = mask.to(torch.float32)
    out = ops.policy_score(c, h, wx, wy, mask)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(3)
                    ).to(cuda_device)
    policy_score.reset_launch_counts()
    got = policy_score.policy_score_bwd_cuda(g, out, c, h, wx, wy, maskf)
    again = policy_score.policy_score_bwd_cuda(g, out, c, h, wx, wy, maskf)
    assert policy_score.LAUNCHES["policy_score_bwd"] == 2
    want = ref.policy_score_bwd_torch(g, out, c, h, wx, wy, maskf)
    for name, x, y, w, tol in zip(("dc", "dh", "dw_px", "dw_py"), got, again,
                                  want, (2e-5, 2e-5, 1e-4, 1e-4)):
        assert x.shape == w.shape, name
        assert torch.equal(x, y), f"{name} differs between two calls"
        assert _rel_err(x, w) <= tol, (name, _rel_err(x, w))


def test_loss_backward_through_cuda_head_matches_torch_head(cuda_device):
    """The REINFORCE loss's gradients through the kernels (B1 + B2) equal
    those through the plain autograd head, on two copies of one policy with
    the same injected samples; the encoder receives its gradients (the
    head does not cut the graph)."""
    cfg = RLConfig(policy=PolicyConfig(**SMALL), batch_size=8, num_samples=8,
                   instance=tinst.InstanceConfig(num_edges=5, num_requests=12))
    batch = to_device(tinst.generate_batch(np.random.default_rng(0),
                                           cfg.instance, cfg.batch_size),
                      cuda_device)
    samples = torch.randint(0, 5, (8, 8, 12), generator=torch.Generator(
        ).manual_seed(1)).to(cuda_device)
    results = {}
    for backend in ("cuda", "torch"):
        pcfg = PolicyConfig(**SMALL, score_backend=backend)
        policy = CoRaiSPolicy(pcfg, generator=torch.Generator().manual_seed(0),
                              device=cuda_device)
        policy_score.reset_launch_counts()
        loss, _, grads = loss_and_grads(
            policy, batch, dataclasses.replace(cfg, policy=pcfg),
            samples=samples)
        results[backend] = (loss, grads, dict(policy_score.LAUNCHES))
    (loss_k, grads_k, launches), (loss_p, grads_p, _) = (results["cuda"],
                                                         results["torch"])
    assert launches["policy_score"] == 1 and launches["policy_score_bwd"] == 1
    assert abs(float(loss_k - loss_p)) <= 1e-5 * abs(float(loss_p))
    # rtol 1e-4, plus 1e-5 of the model's largest gradient entry: a bias
    # just ahead of a BatchNorm has a true gradient of 0 and only noise
    gmax = max(float(g.abs().max()) for g in grads_p.values())
    for key, gp in grads_p.items():
        torch.testing.assert_close(grads_k[key], gp, rtol=1e-4,
                                   atol=1e-5 * gmax, msg=key)
    for key in ("edge_proj/w", "req_proj/w", "ctx_mha/wq"):
        assert float(grads_k[key].abs().max()) > 1e-3 * gmax, key


def test_backward_wrapper_rejects_bad_inputs(cuda_device):
    c, h, wx, wy, mask = _inputs(cuda_device)
    maskf = mask.to(torch.float32)
    g = torch.zeros(3, 37, 6, device=cuda_device)
    with pytest.raises(ValueError, match="g has shape"):
        policy_score.policy_score_bwd_cuda(g[:, :5], g, c, h, wx, wy, maskf)
    with pytest.raises(ValueError, match="contiguous"):
        policy_score.policy_score_bwd_cuda(g, g.transpose(0, 1).contiguous(
            ).transpose(0, 1), c, h, wx, wy, maskf)
    with pytest.raises(ValueError, match="is on cpu"):
        policy_score.policy_score_bwd_cuda(g.cpu(), g, c, h, wx, wy, maskf)
    with pytest.raises(ValueError, match="CUDA tensors"):
        policy_score.policy_score_bwd_cuda(g.cpu(), g.cpu(), c.cpu(), h.cpu(),
                                           wx.cpu(), wy.cpu(), maskf.cpu())


def _attn_tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == torch.bfloat16 else \
        dict(atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("b,s,h,kv,hd,dtype,causal,window", [
    (1, 37, 32, 8, 128, torch.bfloat16, True, None),   # qwen3 heads, ragged
    (2, 300, 16, 16, 128, torch.float32, True, None),  # olmo heads
    (1, 520, 32, 8, 128, torch.bfloat16, True, 256),   # a window, dead tiles
    (2, 130, 4, 2, 16, torch.float32, False, None),    # non-causal, hd=16
    (1, 200, 8, 2, 64, torch.float32, False, 50),      # non-causal window
    (1, 300, 25, 5, 64, torch.bfloat16, True, 128),    # hymba heads: G=5
    (2, 100, 25, 5, 64, torch.float32, True, 40),
])
def test_flash_attention_kernel_matches_plain_version(
        cuda_device, b, s, h, kv, hd, dtype, causal, window):
    gen = torch.Generator().manual_seed(s)
    q, k, v = (torch.randn(b, s, n, hd, generator=gen).to(cuda_device, dtype)
               for n in (h, kv, kv))
    build.reset_launch_counts()
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention"] == 1
    want = ref.flash_attention_torch(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **_attn_tol(dtype))


def _cache(b, w, kv, hd, fills, dtype, device, rolling_from=None, seed=0):
    """Caches with lane i holding positions 0..fills[i]-1 (rest empty), or,
    with ``rolling_from`` p0 (one for every lane, or a tuple with None for
    the lanes that keep their fill), positions p0..p0+w-1 at their slots
    p % w."""
    gen = torch.Generator().manual_seed(seed)
    kc, vc = (torch.randn(b, w, kv, hd, generator=gen).to(device, dtype)
              for _ in range(2))
    slot_pos = torch.full((b, w), -1, dtype=torch.int32)
    pos = torch.zeros(b, dtype=torch.int32)
    if not isinstance(rolling_from, tuple):
        rolling_from = (rolling_from,) * b
    for i, (n, p0) in enumerate(zip(fills, rolling_from)):
        if p0 is None:
            slot_pos[i, :n] = torch.arange(n, dtype=torch.int32)
            pos[i] = max(n - 1, 0)
        else:
            tail = torch.arange(p0, p0 + w, dtype=torch.int32)
            slot_pos[i, (tail % w).long()] = tail
            pos[i] = p0 + w - 1
    return kc, vc, slot_pos.to(device), pos.to(device)


@pytest.mark.parametrize("b,w,h,kv,hd,dtype,fills,window,roll", [
    (4, 4096, 32, 8, 128, torch.bfloat16, (1, 700, 2600, 4096), None, None),
    (2, 256, 32, 8, 128, torch.bfloat16, (256, 256), 256, 900),  # rolling
    (3, 96, 16, 16, 128, torch.bfloat16, (5, 60, 96), None, None),
    (2, 96, 4, 1, 16, torch.float32, (30, 96), 20, None),  # G=4, hd=16
    (2, 64, 8, 8, 64, torch.float32, (0, 0), None, None),  # empty caches
    # hymba heads (G*hd = 320, not a multiple of the block's 256 threads):
    # rolled lanes past the window, a partly filled and a one-slot lane
    (4, 64, 25, 5, 64, torch.bfloat16, (0, 0, 10, 1), 64, (100, 65, None,
                                                            None)),
    (4, 64, 25, 5, 64, torch.float32, (0, 50, 10, 1), 40, (100, None, None,
                                                           None)),
])
def test_decode_attention_kernel_matches_plain_version(
        cuda_device, b, w, h, kv, hd, dtype, fills, window, roll):
    kc, vc, slot_pos, pos = _cache(b, w, kv, hd, fills, dtype, cuda_device,
                                   rolling_from=roll)
    q = torch.randn(b, h, hd, generator=torch.Generator().manual_seed(1)
                    ).to(cuda_device, dtype)
    build.reset_launch_counts()
    got = ops.decode_attention(q, kc, vc, slot_pos, pos, window=window)
    torch.cuda.synchronize()
    assert build.LAUNCHES["decode_attention"] == 1
    want = ref.decode_attention_torch(q, kc, vc, slot_pos, pos, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **_attn_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,w,h,kv,hd,fills,window,roll", [
    # qwen3-4b's 4-lane cache as served; a lane with no valid slot among
    # filled ones; a windowed, rolled cache; every lane empty; W = 1
    (4, 4096, 32, 8, 128, (2303, 1100, 600, 503), None, None),
    (3, 300, 32, 8, 128, (0, 120, 300), None, None),
    (2, 256, 32, 8, 128, (256, 40), 96, (900, None)),
    (4, 64, 25, 5, 64, (0, 50, 10, 1), 40, (100, None, None, None)),
    (2, 64, 8, 8, 64, (0, 0), None, None),
    (2, 1, 4, 1, 16, (1, 0), None, None),
])
def test_decode_attention_lse_matches_plain_version(
        cuda_device, b, w, h, kv, hd, fills, window, roll, dtype):
    """B5 asked for its log-sum-exp: the output the same bits as without;
    the lse (B, H) f32 against ``decode_attention_lse_torch`` (1e-5 of the
    largest |lse|: f32 sums in another order), -1e30 exactly on a lane
    with no valid slot, never -inf or NaN."""
    kc, vc, slot_pos, pos = _cache(b, w, kv, hd, fills, dtype, cuda_device,
                                   rolling_from=roll, seed=w + hd)
    q = torch.randn(b, h, hd, generator=torch.Generator().manual_seed(4)
                    ).to(cuda_device, dtype)
    build.reset_launch_counts()
    out = ops.decode_attention(q, kc, vc, slot_pos, pos, window=window)
    got, lse = ops.decode_attention(q, kc, vc, slot_pos, pos, window=window,
                                    with_lse=True)
    torch.cuda.synchronize()
    assert build.LAUNCHES["decode_attention"] == 2
    assert torch.equal(got, out)
    want = ref.decode_attention_lse_torch(q, kc, slot_pos, pos,
                                          window=window)
    assert lse.dtype == torch.float32 and lse.shape == (b, h)
    assert bool(torch.isfinite(lse).all())
    empty = want <= -1e29
    assert torch.equal(lse[empty], want[empty])
    if not bool(empty.all()):
        scale = float(want[~empty].abs().max())
        torch.testing.assert_close(lse[~empty], want[~empty], rtol=0,
                                   atol=1e-5 * scale)


@pytest.mark.parametrize("b,s,h,kv,hd,causal,window", [
    (2, 200, 4, 2, 16, True, None),      # bf16 head widths 16 to 128 (the
    (1, 150, 8, 4, 32, True, None),      # configs use 16, 64 and 128)
    (1, 333, 8, 2, 48, True, 100),
    (1, 257, 25, 5, 64, True, 2048),
    (1, 190, 32, 8, 128, True, None),
    (1, 1, 25, 5, 64, True, 2048),       # hymba heads and window, ragged S
    (1, 63, 25, 5, 64, True, 2048),
    (1, 65, 25, 5, 64, True, 2048),
    (1, 1000, 25, 5, 64, True, 2048),
    (1, 300, 16, 4, 128, False, 70),     # non-causal with a window
    (2, 129, 8, 8, 96, False, None),
])
def test_flash_attention_bf16_tensor_cores_match_plain_version(
        cuda_device, b, s, h, kv, hd, causal, window):
    gen = torch.Generator().manual_seed(s + hd)
    q, k, v = (torch.randn(b, s, n, hd, generator=gen).to(cuda_device,
                                                         torch.bfloat16)
               for n in (h, kv, kv))
    build.reset_launch_counts()
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    again = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention"] == 2
    want = ref.flash_attention_torch(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(),
                               **_attn_tol(torch.bfloat16))
    assert torch.equal(got, again)  # the same bits


@pytest.mark.parametrize("b,w,h,kv,hd,dtype,fills,window", [
    # a lane with no valid slot and no roll: the mean of all W V rows
    (3, 300, 32, 8, 128, torch.bfloat16, (0, 120, 300), None),
    (2, 300, 25, 5, 64, torch.float32, (0, 77), 40),
    (1, 4096, 32, 8, 128, torch.bfloat16, (3000,), None),  # many splits
    (1, 4096, 25, 5, 64, torch.float32, (4096,), 2048),
    (2, 1, 32, 8, 128, torch.bfloat16, (1, 0), None),      # W = 1
    (2, 1, 4, 1, 16, torch.float32, (1, 1), None),
])
def test_decode_attention_split_w_matches_plain_version(
        cuda_device, b, w, h, kv, hd, dtype, fills, window):
    kc, vc, slot_pos, pos = _cache(b, w, kv, hd, fills, dtype, cuda_device,
                                   seed=w)
    q = torch.randn(b, h, hd, generator=torch.Generator().manual_seed(2)
                    ).to(cuda_device, dtype)
    build.reset_launch_counts()
    got = ops.decode_attention(q, kc, vc, slot_pos, pos, window=window)
    again = ops.decode_attention(q, kc, vc, slot_pos, pos, window=window)
    torch.cuda.synchronize()
    assert build.LAUNCHES["decode_attention"] == 2
    want = ref.decode_attention_torch(q, kc, vc, slot_pos, pos, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **_attn_tol(dtype))
    assert torch.equal(got, again)  # the same bits
    # every launch leaves the combine's counters at 0
    stream = torch.cuda.current_stream(q.device).cuda_stream
    assert not bool(decode_attention._COUNTERS[(q.device, stream)].any())


@pytest.mark.parametrize("per", [1, 2, 3, 7, 64])
def test_decode_attention_explicit_split_plans_match_plain_version(
        cuda_device, per):
    # the 4-lane qwen3-4b cache as served (split_plan gives 22 splits of 3
    # tiles there, the last of 1): every tiles-per-split, ragged last splits
    b, w = 4, 4096
    kc, vc, slot_pos, pos = _cache(b, w, 8, 128, (2303, 1100, 600, 503),
                                   torch.bfloat16, cuda_device, seed=per)
    q = torch.randn(b, 32, 128, generator=torch.Generator().manual_seed(3)
                    ).to(cuda_device, torch.bfloat16)
    plan = (-(-w // (decode_attention.TILE * per)), per)
    got = decode_attention_cuda(q, kc, vc, slot_pos, pos, plan=plan)
    again = decode_attention_cuda(q, kc, vc, slot_pos, pos, plan=plan)
    want = ref.decode_attention_torch(q, kc, vc, slot_pos, pos)
    torch.testing.assert_close(got.float(), want.float(),
                               **_attn_tol(torch.bfloat16))
    assert torch.equal(got, again)


def test_decode_attention_on_two_streams_at_once(cuda_device):
    # launches on two streams combine with counters of their own
    caches = [_cache(4, 2048, 8, 128, (2048, 900, 30, 0), torch.bfloat16,
                     cuda_device, seed=i) for i in range(2)]
    qs = [torch.randn(4, 32, 128, generator=torch.Generator().manual_seed(i)
                      ).to(cuda_device, torch.bfloat16) for i in range(2)]
    want = [ref.decode_attention_torch(q, *c) for q, c in zip(qs, caches)]
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(20):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                got[i].append(decode_attention_cuda(qs[i], *caches[i]))
    torch.cuda.synchronize()
    for i in range(2):
        for out in got[i]:
            torch.testing.assert_close(out.float(), want[i].float(),
                                       **_attn_tol(torch.bfloat16))


def test_attention_wrappers_reject_bad_inputs(cuda_device):
    q = torch.randn(1, 40, 8, 64, device=cuda_device)
    k = torch.randn(1, 40, 2, 64, device=cuda_device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention_cuda(q.half(), k.half(), k.half())
    with pytest.raises(TypeError, match="must be torch.float32"):
        flash_attention_cuda(q, k.bfloat16(), k)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_cuda(q, k.transpose(1, 2).contiguous().transpose(1, 2),
                             k)
    with pytest.raises(ValueError, match="hd <= 128"):
        flash_attention_cuda(*(torch.randn(1, 8, 2, 256, device=cuda_device)
                               for _ in range(3)))
    with pytest.raises(ValueError, match="multiple of 4"):  # 16-byte loads
        flash_attention_cuda(*(torch.randn(1, 8, 2, 6, device=cuda_device)
                               for _ in range(3)))
    shifted = torch.randn(k.numel() + 1, device=cuda_device)[1:].view(k.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_cuda(q, shifted, k)
    with pytest.raises(ValueError, match="multiple of 16"):  # bf16: k16 steps
        flash_attention_cuda(*(torch.randn(1, 8, 2, 24, device=cuda_device,
                                           dtype=torch.bfloat16)
                               for _ in range(3)))
    kc, vc, slot_pos, pos = _cache(1, 64, 2, 64, (10,), torch.float32,
                                   cuda_device)
    qd = torch.randn(1, 8, 64, device=cuda_device)
    with pytest.raises(TypeError, match="int32"):
        decode_attention_cuda(qd, kc, vc, slot_pos.long(), pos)
    with pytest.raises(ValueError, match="contiguous"):
        decode_attention_cuda(qd, kc, vc.transpose(1, 2).contiguous(
            ).transpose(1, 2), slot_pos, pos)
    with pytest.raises(TypeError, match="bfloat16"):
        decode_attention_cuda(qd.bfloat16(), kc, vc, slot_pos, pos)
    with pytest.raises(ValueError, match="split plan"):  # a split empty
        decode_attention_cuda(qd, kc, vc, slot_pos, pos, plan=(2, 1))


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.parametrize("arch", ["qwen3-4b", "olmo-1b"])
def test_lm_on_the_card_matches_the_cpu(cuda_device, arch):
    """Reduced f32 model, same weights: prefill and three decode steps on
    the card (B4 in every layer of the prefill, B5 in every layer of each
    step) against the CPU (plain versions), logits to 1e-4."""
    cfg = get_reduced_config(arch)
    cpu = lm.init_params(cfg, generator=torch.Generator().manual_seed(0))
    gpu = _to(cpu, cuda_device)
    tokens = torch.randint(0, cfg.vocab_size, (2, 45),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    build.reset_launch_counts()
    cache_g, lg = lm.prefill(gpu, {"tokens": tokens.to(cuda_device)}, cfg,
                             max_seq=64)
    cache_c, lc = lm.prefill(cpu, {"tokens": tokens}, cfg, max_seq=64)
    torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=0)
    for step in range(3):
        tok = torch.tensor([step + 3, 7 * step], dtype=torch.int32)
        cache_g, lg = lm.decode_step(gpu, cache_g, {"token": tok.to(
            cuda_device)}, cfg)
        cache_c, lc = lm.decode_step(cpu, cache_c, {"token": tok}, cfg)
        torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=0)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention"] == cfg.num_layers
    assert build.LAUNCHES["decode_attention"] == 3 * cfg.num_layers
    torch.testing.assert_close(cache_g["layers"]["k"].cpu(),
                               cache_c["layers"]["k"], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("b,s,h,kv,hd,dtype,window", [
    # mixtral heads (G = 4) with its 4096 window, a prompt past it
    (1, 4500, 32, 8, 128, torch.bfloat16, 4096),
    (1, 4500, 32, 8, 128, torch.float32, 4096),
    # qwen2-vl heads (G = 8)
    (2, 700, 64, 8, 128, torch.bfloat16, None),
    (2, 700, 64, 8, 128, torch.float32, None),
])
def test_flash_attention_at_mixtral_and_qwen2_vl_heads(
        cuda_device, b, s, h, kv, hd, dtype, window):
    """B4 at the MoE and VLM families' head shapes, causal: within the
    bars of its plain version, the same bits on two calls."""
    gen = torch.Generator().manual_seed(s + h)
    q, k, v = (torch.randn(b, s, n, hd, generator=gen).to(cuda_device, dtype)
               for n in (h, kv, kv))
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    again = ops.flash_attention(q, k, v, causal=True, window=window)
    want = ref.flash_attention_torch(q, k, v, causal=True, window=window)
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), **_attn_tol(dtype))


@pytest.mark.parametrize("b,w,h,kv,hd,dtype,fills,window,roll", [
    # mixtral's 4-lane cache rolled past its 4096 window (three lanes),
    # one lane partly filled
    (4, 4096, 32, 8, 128, torch.bfloat16, (0, 0, 1500, 0), 4096,
     (404, 4097, None, 1)),
    (2, 4096, 32, 8, 128, torch.float32, (0, 3000), 4096, (404, None)),
    # qwen2-vl heads: G * hd = 1024
    (4, 4096, 64, 8, 128, torch.bfloat16, (1, 700, 2600, 4096), None, None),
    (2, 512, 64, 8, 128, torch.float32, (100, 512), None, None),
])
def test_decode_attention_at_mixtral_and_qwen2_vl_heads(
        cuda_device, b, w, h, kv, hd, dtype, fills, window, roll):
    """B5 at the MoE and VLM families' head shapes: within the bars of its
    plain version, the same bits on two calls."""
    kc, vc, slot_pos, pos = _cache(b, w, kv, hd, fills, dtype, cuda_device,
                                   rolling_from=roll)
    q = torch.randn(b, h, hd, generator=torch.Generator().manual_seed(2)
                    ).to(cuda_device, dtype)
    got = ops.decode_attention(q, kc, vc, slot_pos, pos, window=window)
    again = ops.decode_attention(q, kc, vc, slot_pos, pos, window=window)
    want = ref.decode_attention_torch(q, kc, vc, slot_pos, pos, window=window)
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), **_attn_tol(dtype))


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen2-vl-72b"])
def test_moe_and_vlm_lm_on_the_card_match_the_cpu(cuda_device, arch):
    """Reduced f32 mixtral (a 45-token prompt past its 16-token window,
    the capacity dispatch in prefill and decode) and qwen2-vl (embeddings
    with three distinct M-RoPE rows): prefill and three decode steps on
    the card against the CPU, logits to 1e-4; B4 once per layer of the
    prefill, B5 once per layer of each step."""
    cfg = get_reduced_config(arch)
    cpu = lm.init_params(cfg, generator=torch.Generator().manual_seed(0))
    gpu = _to(cpu, cuda_device)
    gen = torch.Generator().manual_seed(1)
    s = 45
    if cfg.mrope:
        ids = torch.arange(s, dtype=torch.int32)
        rows = torch.stack([ids, ids // 3, ids % 7])[:, None].expand(3, 2, s)
        batch = {"embeds": torch.randn(2, s, cfg.d_model, generator=gen),
                 "positions": rows.contiguous()}
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, s),
                                         generator=gen, dtype=torch.int32)}
    build.reset_launch_counts()
    cache_g, lg = lm.prefill(gpu, {k: v.to(cuda_device)
                                   for k, v in batch.items()}, cfg, max_seq=64)
    cache_c, lc = lm.prefill(cpu, batch, cfg, max_seq=64)
    torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=0)
    for step in range(3):
        dec = {"token": torch.tensor([step + 3, 7 * step], dtype=torch.int32)}
        if cfg.mrope:
            dec["positions"] = torch.tensor([[s + step] * 2, [20] * 2,
                                             [step] * 2], dtype=torch.int32)
        cache_g, lg = lm.decode_step(gpu, cache_g, {
            k: v.to(cuda_device) for k, v in dec.items()}, cfg)
        cache_c, lc = lm.decode_step(cpu, cache_c, dec, cfg)
        torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=0)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention"] == cfg.num_layers
    assert build.LAUNCHES["decode_attention"] == 3 * cfg.num_layers
    torch.testing.assert_close(cache_g["layers"]["k"].cpu(),
                               cache_c["layers"]["k"], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_dense_decode_on_the_card_matches_the_cpu(cuda_device, dtype):
    """The MoE layer's dense decode path (reduced mixtral, 4 tokens): its
    output product is one GEMM with an f32 result on the card (bf16
    operands in bf16), against the CPU's product on f32 copies: f32 within
    1e-5 of the largest |entry|, bf16 at the bf16 bar."""
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_reduced_config("mixtral-8x7b"),
                              moe_dense_decode=True)
    gen = torch.Generator().manual_seed(5)
    p = moe.moe_init(gen, cfg, dtype)
    x = torch.randn(4, 1, cfg.d_model, generator=gen).to(dtype)
    y_c, aux_c = moe.moe_apply(p, x, cfg)
    y_g, aux_g = moe.moe_apply(_to(p, cuda_device), x.to(cuda_device), cfg)
    assert y_g.dtype == dtype
    torch.testing.assert_close(aux_g.cpu(), aux_c, atol=1e-6, rtol=0)
    scale = float(y_c.float().abs().max())
    if dtype == torch.float32:
        assert float((y_g.cpu() - y_c).abs().max()) <= 1e-5 * scale
    else:
        torch.testing.assert_close(y_g.cpu().float(), y_c.float(),
                                   atol=2e-2 * scale, rtol=2e-2)


def test_lm_edge_backend_on_the_card(cuda_device):
    """The serving loop on the card: every request finishes with its
    generation length; one phi observation per admission."""
    cfg = get_reduced_config("qwen3-4b")
    params = lm.init_params(cfg, generator=torch.Generator(
        device=cuda_device).manual_seed(0))
    be = LMEdgeBackend(cfg, params, lanes=2, max_seq=64)
    build.reset_launch_counts()
    for rid, (plen, glen) in enumerate([(8, 4), (12, 3), (5, 6), (20, 2)]):
        be.submit(rid, plen, glen)
    be.drain()
    assert be.finished == {0: 4, 1: 3, 2: 6, 3: 2}
    assert len(be.phi._xs) == 4
    assert build.LAUNCHES["flash_attention"] == 4 * cfg.num_layers
    assert build.LAUNCHES["decode_attention"] > 0


def _scan_inputs(b, s, d, n, device, seed=0):
    """As ``tests/test_kernels.py`` makes them: u, B, C normal, dt =
    softplus(normal) * 0.1, A = -exp(0.2 * normal); f32 on ``device``."""
    gen = torch.Generator().manual_seed(seed)
    u = torch.randn(b, s, d, generator=gen)
    dt = torch.nn.functional.softplus(torch.randn(b, s, d, generator=gen)) * 0.1
    bm = torch.randn(b, s, n, generator=gen)
    cm = torch.randn(b, s, n, generator=gen)
    a = -torch.exp(0.2 * torch.randn(d, n, generator=gen))
    return [t.to(device) for t in (u, dt, bm, cm, a)]


@pytest.mark.parametrize("b,s,d,n", [
    (1, 256, 512, 16),   # falcon-mamba's N, a short prompt
    (4, 100, 320, 16),   # hymba's lanes, d not a multiple of the block
    (1, 37, 200, 4),     # ragged S and d, N = 4
    (2, 128, 64, 8),     # the reference sweep's shape
    (2, 70, 33, 32),     # the largest N
    (1, 5, 300, 1),
    (3, 9, 17, 3),
])
def test_mamba_scan_kernel_matches_plain_version(cuda_device, b, s, d, n):
    args = _scan_inputs(b, s, d, n, cuda_device, seed=s)
    build.reset_launch_counts()
    y, h = ops.mamba_scan(*args)
    y2, h2 = ops.mamba_scan(*args)
    torch.cuda.synchronize()
    assert build.LAUNCHES["mamba_scan"] == 2
    wy, wh = ref.mamba_scan_torch(*args)
    assert y.shape == (b, s, d) and h.shape == (b, d, n)
    torch.testing.assert_close(y, wy, atol=5e-4, rtol=5e-4)
    torch.testing.assert_close(h, wh, atol=5e-4, rtol=5e-4)
    assert torch.equal(y, y2) and torch.equal(h, h2)  # the same bits


def test_mamba_scan_wrapper_rejects_bad_inputs(cuda_device):
    u, dt, bm, cm, a = _scan_inputs(1, 16, 40, 4, cuda_device)
    with pytest.raises(TypeError, match="float32"):
        mamba_scan_cuda(u.double(), dt, bm, cm, a)
    with pytest.raises(ValueError, match="contiguous"):
        mamba_scan_cuda(u, dt.transpose(1, 2).contiguous().transpose(1, 2),
                        bm, cm, a)
    with pytest.raises(ValueError, match="shape"):
        mamba_scan_cuda(u, dt, bm[:, :8], cm, a)
    with pytest.raises(ValueError, match="N <= 32"):
        mamba_scan_cuda(u, dt, *(torch.randn(1, 16, 33, device=cuda_device)
                                 for _ in range(2)),
                        torch.randn(40, 33, device=cuda_device))
    with pytest.raises(ValueError, match="CUDA tensors"):
        mamba_scan_cuda(u.cpu(), dt, bm, cm, a)


SCAN_SHAPES = [(1, 256, 512, 16), (4, 100, 320, 16), (1, 37, 200, 4),
               (2, 128, 64, 8), (2, 70, 33, 32), (1, 5, 300, 1), (3, 9, 17, 3)]


def _gated_inputs(b, s, d, n, device, zdtype, seed=0):
    """u normal, dt_raw 0.5 * normal (every 7th channel 25, above
    softplus's threshold), dt_bias the inverse softplus of dt in [1e-3,
    0.1], B, C, A as ``_scan_inputs``, D near 1; z the second half of a
    (B, S, 2d) tensor in ``zdtype`` (a strided view)."""
    gen = torch.Generator().manual_seed(seed)
    u = torch.randn(b, s, d, generator=gen)
    dt_raw = 0.5 * torch.randn(b, s, d, generator=gen)
    dt_raw[..., ::7] = 25.0
    dt0 = torch.exp(torch.rand(d, generator=gen) * (np.log(0.1)
                                                   - np.log(1e-3))
                    + np.log(1e-3))
    bias = dt0 + torch.log(-torch.expm1(-dt0))
    bm = torch.randn(b, s, n, generator=gen)
    cm = torch.randn(b, s, n, generator=gen)
    a = -torch.exp(0.2 * torch.randn(d, n, generator=gen))
    dskip = 1 + 0.1 * torch.randn(d, generator=gen)
    uz = torch.randn(b, s, 2 * d, generator=gen).to(device, zdtype)
    args = [t.to(device) for t in (u, dt_raw, bias, bm, cm, a, dskip)]
    return args, uz[..., d:]


@pytest.mark.parametrize("zdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,d,n", SCAN_SHAPES)
def test_mamba_scan_gated_kernel_matches_plain_version(cuda_device, b, s, d,
                                                      n, zdtype):
    """The gated entry (softplus, scan, D skip, SiLU gate, cast) at the
    bare test's shapes, z a strided view of a (B, S, 2d) tensor, against
    its plain version's f32 value: 5e-4, plus half a bf16 ulp in bf16;
    h_last to 5e-4; two calls the same bits; one launch each, counted as
    B6's."""
    args, z = _gated_inputs(b, s, d, n, cuda_device, zdtype, seed=s)
    assert z.stride(-1) == 1 and not z.is_contiguous()
    build.reset_launch_counts()
    out, h = ops.mamba_scan_gated(*args, z)
    out2, h2 = ops.mamba_scan_gated(*args, z)
    torch.cuda.synchronize()
    assert build.LAUNCHES["mamba_scan"] == 2
    want, wh = ref.mamba_scan_gated_torch(*args, z.float())
    assert out.shape == (b, s, d) and out.dtype == zdtype
    assert h.shape == (b, d, n) and h.dtype == torch.float32
    half_ulp = 2.0 ** -8 if zdtype == torch.bfloat16 else 0.0
    diff = (out.float() - want).abs()
    assert float((diff - 5e-4 - (5e-4 + half_ulp) * want.abs()).max()) <= 0
    torch.testing.assert_close(h, wh, atol=5e-4, rtol=5e-4)
    assert torch.equal(out, out2) and torch.equal(h, h2)  # the same bits


def test_mamba_scan_gated_wrapper_rejects_bad_inputs(cuda_device):
    args, z = _gated_inputs(1, 16, 40, 4, cuda_device, torch.bfloat16)
    u, dt_raw, bias, bm, cm, a, dskip = args
    with pytest.raises(TypeError, match="float32"):
        mamba_scan_gated_cuda(u.double(), dt_raw, bias, bm, cm, a, dskip, z)
    with pytest.raises(TypeError, match="bfloat16 or torch.float32"):
        mamba_scan_gated_cuda(u, dt_raw, bias, bm, cm, a, dskip, z.half())
    with pytest.raises(ValueError, match="unit last stride"):
        mamba_scan_gated_cuda(u, dt_raw, bias, bm, cm, a, dskip,
                              z.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="shape"):
        mamba_scan_gated_cuda(u, dt_raw, bias, bm[:, :8], cm, a, dskip, z)
    with pytest.raises(ValueError, match="N <= 32"):
        mamba_scan_gated_cuda(u, dt_raw, bias, *(torch.randn(
            1, 16, 33, device=cuda_device) for _ in range(2)), torch.randn(
            40, 33, device=cuda_device), dskip, z)
    with pytest.raises(ValueError, match="CUDA tensors"):
        mamba_scan_gated_cuda(u.cpu(), dt_raw, bias, bm, cm, a, dskip, z)


# B6b's shapes: the gated test's, a ragged S past two chunks of 128, S = 1,
# and N = 32 over three chunks with d = 200 off B6b's 16-channel blocks and
# its 128-channel clusters
SCAN_BWD_SHAPES = SCAN_SHAPES + [(2, 300, 96, 16), (2, 1, 40, 16),
                                 (2, 300, 200, 32)]


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("zdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,d,n", SCAN_BWD_SHAPES)
def test_mamba_scan_gated_backward_matches_plain_version(cuda_device, b, s, d,
                                                         n, zdtype, seeded):
    """B6b from B6's saved chunk states against its plain version on the
    same inputs: every gradient within 1e-4 of its largest |entry| (dz in
    bf16 within 2^-6), dh_last zero or seeded, some dt_raw above softplus's
    threshold; two calls the same bits; B6's output the same bits with
    the states stored and without; one launch each, counted as B6b's."""
    args, z = _gated_inputs(b, s, d, n, cuda_device, zdtype, seed=s)
    gen = torch.Generator().manual_seed(s + 1)
    dout = torch.randn(b, s, d, generator=gen).to(cuda_device, zdtype)
    dh = (torch.randn(b, d, n, generator=gen).to(cuda_device) if seeded
          else None)
    build.reset_launch_counts()
    out, h, states = mamba_scan_gated_cuda(*args, z, with_states=True)
    bare_out, bare_h = mamba_scan_gated_cuda(*args, z)
    assert torch.equal(out, bare_out) and torch.equal(h, bare_h)
    assert states.shape == (b, -(-s // 128), d, n)
    got = mamba_scan_gated_bwd_cuda(*args, z, states, dout, dh)
    again = mamba_scan_gated_bwd_cuda(*args, z, states, dout, dh)
    torch.cuda.synchronize()
    assert build.LAUNCHES["mamba_scan"] == 2
    assert build.LAUNCHES["mamba_scan_bwd"] == 2
    want = ref.mamba_scan_gated_bwd_torch(*args, z, dout, dh)
    names = ("du", "ddt_raw", "ddt_bias", "dB", "dC", "dA", "dD", "dz")
    for name, g, a, w in zip(names, got, again, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        tol = 2.0 ** -6 if g.dtype == torch.bfloat16 else 1e-4
        err = float((g.float() - w.float()).abs().max())
        assert err <= tol * float(w.float().abs().max()) + 1e-30, (name, err)
        assert torch.equal(g, a), name  # the same bits


def test_mamba_scan_gated_backward_wrapper_rejects_bad_inputs(cuda_device):
    args, z = _gated_inputs(1, 16, 40, 4, cuda_device, torch.float32)
    _, _, states = mamba_scan_gated_cuda(*args, z, with_states=True)
    dout = torch.randn(1, 16, 40, device=cuda_device)
    with pytest.raises(ValueError, match="states has shape"):
        mamba_scan_gated_bwd_cuda(*args, z, states[:, :, :8], dout)
    with pytest.raises(TypeError, match="dout must be torch.float32"):
        mamba_scan_gated_bwd_cuda(*args, z, states, dout.bfloat16())
    with pytest.raises(ValueError, match="dh_last has shape"):
        mamba_scan_gated_bwd_cuda(*args, z, states, dout,
                                  torch.zeros(1, 40, 5, device=cuda_device))
    with pytest.raises(ValueError, match="CUDA tensors"):
        mamba_scan_gated_bwd_cuda(*args, z, states.cpu(), dout)


# -- the reference's refused configurations: the soft cap (B4, B5) and the
# bf16 scan state (B6, B6b) ---------------------------------------------------

SOFTCAP = 1.0  # the inputs' scores are scaled to reach several times it


@pytest.mark.parametrize("b,s,h,kv,hd,dtype,causal,window", [
    (1, 300, 32, 8, 128, torch.bfloat16, True, None),  # qwen3 heads
    (1, 520, 32, 8, 128, torch.bfloat16, True, 256),   # a window, dead tiles
    (2, 130, 16, 16, 128, torch.float32, True, None),  # olmo heads, f32
    (2, 100, 4, 2, 16, torch.float32, False, 40),
    (2, 65, 25, 5, 64, torch.bfloat16, False, None),   # hymba heads
])
def test_flash_attention_with_softcap_matches_plain_version(
        cuda_device, b, s, h, kv, hd, dtype, causal, window):
    """B4 with a cap: the output at the dtype's bar and the lse within
    1e-5 of its largest |entry| against the capped plain versions; the
    capped output differs from the uncapped one beyond the bar."""
    gen = torch.Generator().manual_seed(s + hd)
    q = (4 * torch.randn(b, s, h, hd, generator=gen)).to(cuda_device, dtype)
    k, v = (torch.randn(b, s, kv, hd, generator=gen).to(cuda_device, dtype)
            for _ in range(2))
    build.reset_launch_counts()
    got, lse = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    with_lse=True, softcap=SOFTCAP)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention"] == 1
    want = ref.flash_attention_torch(q, k, v, causal=causal, window=window,
                                     softcap=SOFTCAP)
    tol = _attn_tol(dtype)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    wlse = ref.flash_attention_lse_torch(q, k, causal=causal, window=window,
                                         softcap=SOFTCAP)
    torch.testing.assert_close(lse, wlse, rtol=0,
                               atol=1e-5 * float(wlse.abs().max()))
    uncapped = ref.flash_attention_torch(q, k, v, causal=causal,
                                         window=window)
    assert float((want.float() - uncapped.float()).abs().max()) > \
        10 * tol["atol"]
    assert torch.equal(got, ops.flash_attention(q, k, v, causal=causal,
                                                window=window,
                                                softcap=SOFTCAP))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,w,h,kv,hd,fills,window,roll", [
    (4, 4096, 32, 8, 128, (2303, 1100, 600, 503), None, None),  # qwen3-4b
    (4, 64, 25, 5, 64, (0, 50, 10, 1), 40, (100, None, None, None)),
    (2, 64, 8, 8, 64, (0, 0), None, None),                      # empty
])
def test_decode_attention_with_softcap_matches_plain_version(
        cuda_device, b, w, h, kv, hd, fills, window, roll, dtype):
    """B5 with a cap and its lse against the capped plain versions, at the
    bars of the uncapped tests; an empty lane's lse -1e30 exactly."""
    kc, vc, slot_pos, pos = _cache(b, w, kv, hd, fills, dtype, cuda_device,
                                   rolling_from=roll, seed=w + 1)
    q = (4 * torch.randn(b, h, hd, generator=torch.Generator().manual_seed(
        6))).to(cuda_device, dtype)
    build.reset_launch_counts()
    got, lse = ops.decode_attention(q, kc, vc, slot_pos, pos, window=window,
                                    with_lse=True, softcap=SOFTCAP)
    torch.cuda.synchronize()
    assert build.LAUNCHES["decode_attention"] == 1
    want = ref.decode_attention_torch(q, kc, vc, slot_pos, pos,
                                      window=window, softcap=SOFTCAP)
    torch.testing.assert_close(got.float(), want.float(), **_attn_tol(dtype))
    wlse = ref.decode_attention_lse_torch(q, kc, slot_pos, pos,
                                          window=window, softcap=SOFTCAP)
    empty = wlse <= -1e29
    assert torch.equal(lse[empty], wlse[empty])
    if not bool(empty.all()):
        torch.testing.assert_close(
            lse[~empty], wlse[~empty], rtol=0,
            atol=1e-5 * float(wlse[~empty].abs().max()))
        uncapped = ref.decode_attention_torch(q, kc, vc, slot_pos, pos,
                                              window=window)
        assert float((want.float() - uncapped.float()).abs().max()) > \
            10 * _attn_tol(dtype)["atol"]


#: the bf16 state's bar on the card, of the largest |entry| (of each
#: gradient's, for B6b): the kernels round where the plain versions round
#: (``ref._bf16_chunks``), so only an f32 ulp between their exponentials or
#: sums moves a value to the neighbouring bf16 one; B6b's 8-step segments
#: round its recomputed states at other points than B6's 16-step ones
SCAN_BF16_BAR = 1e-2


def _bf16_err(got, want):
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1e-30)


@pytest.mark.parametrize("b,s,d,n", SCAN_SHAPES)
def test_mamba_scan_bf16_state_matches_plain_version(cuda_device, b, s, d, n):
    """B6's bare and gated entries with the bf16 state against their plain
    versions with it: y, out and h_last within SCAN_BF16_BAR, h_last and
    the chunk states bf16 values, two calls the same bits, and the f32
    state's results differ."""
    args = _scan_inputs(b, s, d, n, cuda_device, seed=s)
    y, h = ops.mamba_scan(*args, bf16_state=True)
    y2, h2 = ops.mamba_scan(*args, bf16_state=True)
    torch.cuda.synchronize()
    wy, wh = ref.mamba_scan_torch(*args, bf16_state=True)
    assert _bf16_err(y, wy) <= SCAN_BF16_BAR
    assert _bf16_err(h, wh) <= SCAN_BF16_BAR
    assert torch.equal(y, y2) and torch.equal(h, h2)
    assert torch.equal(h.bfloat16().float(), h)
    if s > 4:
        assert not torch.equal(y, ops.mamba_scan(*args)[0])
    gargs, z = _gated_inputs(b, s, d, n, cuda_device, torch.bfloat16, seed=s)
    out, gh, states = mamba_scan_gated_cuda(*gargs, z, True,
                                            with_states=True)
    assert torch.equal(out, ops.mamba_scan_gated(*gargs, z,
                                                 bf16_state=True)[0])
    wout, wgh, wstates = ref.mamba_scan_gated_torch(*gargs, z.float(),
                                                    chunk=128,
                                                    bf16_state=True)
    assert _bf16_err(out, wout) <= SCAN_BF16_BAR
    assert _bf16_err(gh, wgh) <= SCAN_BF16_BAR
    assert torch.equal(states.bfloat16().float(), states)
    assert _bf16_err(states, wstates) <= SCAN_BF16_BAR


@pytest.mark.parametrize("zdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,d,n", SCAN_BWD_SHAPES)
def test_mamba_scan_gated_backward_bf16_state_matches_plain_version(
        cuda_device, b, s, d, n, zdtype):
    """B6b with the bf16 state, from B6's bf16 chunk states, against its
    plain version with the flag: every gradient within SCAN_BF16_BAR of its
    largest |entry|; two calls the same bits."""
    args, z = _gated_inputs(b, s, d, n, cuda_device, zdtype, seed=s)
    gen = torch.Generator().manual_seed(s + 2)
    dout = torch.randn(b, s, d, generator=gen).to(cuda_device, zdtype)
    dh = torch.randn(b, d, n, generator=gen).to(cuda_device)
    _, _, states = mamba_scan_gated_cuda(*args, z, True, with_states=True)
    got = mamba_scan_gated_bwd_cuda(*args, z, states, dout, dh, True)
    again = mamba_scan_gated_bwd_cuda(*args, z, states, dout, dh, True)
    torch.cuda.synchronize()
    want = ref.mamba_scan_gated_bwd_torch(*args, z, dout, dh,
                                          bf16_state=True)
    names = ("du", "ddt_raw", "ddt_bias", "dB", "dC", "dA", "dD", "dz")
    for name, g, a, w in zip(names, got, again, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert _bf16_err(g, w) <= SCAN_BF16_BAR, (name, _bf16_err(g, w))
        assert torch.equal(g, a), name


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "hymba-1.5b"])
def test_ssm_lm_training_on_the_card_matches_the_cpu(cuda_device, arch,
                                                     remat):
    """Reduced f32 SSM and hybrid models, the same weights and batch: the
    loss and every gradient through B6, B6b (and hymba's B4) on the card
    against the plain versions on the CPU (1e-5; gradients 1e-5 + 1e-4
    relative); B6 once per layer, twice under remat (the recompute), B6b
    once per layer."""
    cfg = dataclasses.replace(get_reduced_config(arch), remat=remat)
    cpu = lm.init_params(cfg, generator=torch.Generator().manual_seed(0))
    gpu = _to(cpu, cuda_device)
    tokens = torch.randint(0, cfg.vocab_size, (2, 140),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    out = {}
    build.reset_launch_counts()
    for name, params in (("cuda", gpu), ("cpu", cpu)):
        leaves = named_leaves(params)
        for x in leaves.values():
            x.requires_grad_(True)
        dev = next(iter(leaves.values())).device
        batch = {"tokens": tokens.to(dev), "labels": tokens.to(dev)}
        total, _ = lm.train_loss(params, batch, cfg)
        out[name] = (total, torch.autograd.grad(
            total, list(leaves.values()), allow_unused=True))
    torch.cuda.synchronize()
    per_layer = 1 if remat == "none" else 2
    assert build.LAUNCHES["mamba_scan"] == per_layer * cfg.num_layers
    assert build.LAUNCHES["mamba_scan_bwd"] == cfg.num_layers
    torch.testing.assert_close(out["cuda"][0].cpu(), out["cpu"][0],
                               atol=1e-5, rtol=1e-5)
    for g, w in zip(out["cuda"][1], out["cpu"][1]):
        assert (g is None) == (w is None)
        if g is not None:
            torch.testing.assert_close(g.cpu(), w, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "hymba-1.5b"])
def test_ssm_lm_on_the_card_matches_the_cpu(cuda_device, arch):
    """Reduced f32 SSM and hybrid models, same weights: a 40-token prefill
    (B6 in every layer; hymba's rolling window) and three decode steps on
    the card against the CPU (plain versions), logits to 1e-4."""
    cfg = get_reduced_config(arch)
    cpu = lm.init_params(cfg, generator=torch.Generator().manual_seed(0))
    gpu = _to(cpu, cuda_device)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    build.reset_launch_counts()
    cache_g, lg = lm.prefill(gpu, {"tokens": tokens.to(cuda_device)}, cfg,
                             max_seq=64)
    cache_c, lc = lm.prefill(cpu, {"tokens": tokens}, cfg, max_seq=64)
    torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=0)
    for step in range(3):
        tok = torch.tensor([step + 3, 7 * step], dtype=torch.int32)
        cache_g, lg = lm.decode_step(gpu, cache_g, {"token": tok.to(
            cuda_device)}, cfg)
        cache_c, lc = lm.decode_step(cpu, cache_c, {"token": tok}, cfg)
        torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=0)
    torch.cuda.synchronize()
    attn = cfg.num_layers if cfg.hybrid else 0
    assert build.LAUNCHES["mamba_scan"] == cfg.num_layers
    assert build.LAUNCHES["flash_attention"] == attn
    assert build.LAUNCHES["decode_attention"] == 3 * attn
    for key in ("h", "conv"):
        torch.testing.assert_close(cache_g["layers"][key].cpu(),
                                   cache_c["layers"][key], atol=1e-5,
                                   rtol=1e-5)


# -- the rollout engine ------------------------------------------------------


def _engine_case(name, b=6, rounds=8, resilience=None):
    arr = materialize_round_batch(scenario(name), 5, rounds, 0.25, b,
                                  base_seed=0)
    spec = scenario_fault_spec(name)
    if spec is not None:
        arr = faults.attach_fault_batch(arr, spec, 5, seeds=range(b))
    cfg = engine.EngineConfig(num_edges=5, num_rounds=rounds,
                              max_per_round=arr["mask"].shape[-1],
                              resilience=resilience)
    return cfg, arr


@pytest.mark.parametrize("name,backend", [("uniform_iid", "greedy"),
                                          ("chaos-rolling-failure", "local")])
def test_engine_rollout_on_the_card_equals_the_cpu(cuda_device, name,
                                                   backend):
    """The same arrivals through the engine on the card and on the CPU:
    counts and per-edge completions equal, floats within 1e-4."""
    res = (ResilienceConfig(admission="slo_threshold", breaker=True,
                            retry_backoff_rounds=1.0)
           if name.startswith("chaos") else None)
    cfg, arr = _engine_case(name, resilience=res)
    run = engine.make_rollout(cfg, engine.ASSIGN_FNS[backend], batch=True)
    out = {}
    for dev in ("cpu", cuda_device):
        final, infos = run(engine.init_batch(cfg, range(6), device=dev), arr)
        out[str(dev)] = ({k: v.cpu() for k, v in final.items()},
                         {k: v.cpu() for k, v in infos.items()})
    (gf, gi), (cf, ci) = out[str(cuda_device)], out["cpu"]
    for got, want in ((gf, cf), (gi, ci)):
        for k, w in want.items():
            if w.is_floating_point():
                torch.testing.assert_close(got[k], w, atol=1e-4, rtol=0)
            else:
                assert torch.equal(got[k], w), k
    gs, cs = engine.summarize(gf), engine.summarize(cf)
    for k, w in cs.items():
        assert gs[k] == (pytest.approx(w, abs=1e-4) if isinstance(w, float)
                         else w), k


@pytest.mark.parametrize("backend,kernel", [
    ("policy-fused", "policy_score_decode"), ("policy", "policy_score")])
def test_policy_rollout_launches_its_kernel_once_per_round(cuda_device,
                                                           backend, kernel):
    """A policy rollout on the card: the head's kernel (B3 fused, B1
    materialized) launches once per round for the whole batch, and each
    round's decisions equal the plain backend's where the top-2 gap
    exceeds 1e-4."""
    cfg, arr = _engine_case("hotspot_skew")
    policy = CoRaiSPolicy(PolicyConfig(**SMALL), device=cuda_device)
    fn = engine.resolve_assign_fn(backend, policy=policy)
    checked = []

    def assign(generator, inst):
        got = fn(generator, inst)
        with torch.inference_mode():
            c, h = corais_encode(policy, inst, per_instance=True)
            ti, tv = corais_score_decode(policy, c, h, inst["edge_mask"],
                                         k=2, normalize=False,
                                         backend="torch")
        gapped = ((tv[..., 0] - tv[..., 1]) > 1e-4) & inst["req_mask"]
        assert torch.equal(got[gapped], ti[..., 0][gapped])
        checked.append(int(gapped.sum()))
        return got

    run = engine.make_rollout(cfg, assign, batch=True)
    state = engine.init_batch(cfg, range(6), device=cuda_device)
    policy_score.reset_launch_counts()
    final, _ = run(state, arr)
    torch.cuda.synchronize()
    assert policy_score.LAUNCHES[kernel] == cfg.num_rounds
    assert sum(policy_score.LAUNCHES.values()) == cfg.num_rounds
    assert sum(checked) > 0
    m = engine.summarize(final)
    assert m["completed"] == m["submitted"] == int(arr["mask"].sum())


# -- temporal training (B1 forward and B2 backward once per round) ----------


@pytest.mark.parametrize("b,q,z", [(16, 5, 16), (8, 5, 64), (16, 100, 130)])
def test_head_kernels_at_the_temporal_shapes(cuda_device, b, q, z):
    """B1 and B2 at the temporal trainer's shapes (its defaults, the chaos
    path's 64-wide rounds, 16 instances of a 100-edge cluster), d = 256,
    against their plain versions; the same bits on two calls."""
    c, h, wx, wy, mask = _inputs(cuda_device, b, q, max(1, q - 2), z, 256,
                                 seed=b + z)
    maskf = mask.to(torch.float32)
    out = policy_score.policy_score_cuda(c, h, wx, wy, maskf)
    assert torch.equal(out, policy_score.policy_score_cuda(c, h, wx, wy,
                                                           maskf))
    torch.testing.assert_close(out, ref.policy_score_torch(c, h, wx, wy,
                                                           mask),
                               atol=ATOL, rtol=0)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(4)
                    ).to(cuda_device)
    got = policy_score.policy_score_bwd_cuda(g, out, c, h, wx, wy, maskf)
    again = policy_score.policy_score_bwd_cuda(g, out, c, h, wx, wy, maskf)
    want = ref.policy_score_bwd_torch(g, out, c, h, wx, wy, maskf)
    for name, x, y, w, tol in zip(("dc", "dh", "dw_px", "dw_py"), got, again,
                                  want, (2e-5, 2e-5, 1e-4, 1e-4)):
        assert torch.equal(x, y), f"{name} differs between two calls"
        assert _rel_err(x, w) <= tol, (name, _rel_err(x, w))


def test_temporal_update_through_cuda_matches_torch_head(cuda_device):
    """One temporal loss and its gradients through the kernels ("cuda")
    and through plain autograd ("torch"), two copies of one policy, the
    same clusters, arrivals and injected actions: B1 and B2 launch once
    per round, and loss and gradients agree."""
    cfg = ttrain.TemporalRLConfig(
        policy=PolicyConfig(**SMALL),
        engine=engine.EngineConfig(num_edges=5, num_rounds=6),
        batch_size=8)
    arrivals = ttrain._host_episode(cfg, None, scenario(cfg.scenario), 0)
    seeds = ttrain._cluster_seeds(cfg, 0)
    actions = torch.randint(0, 5, (6, 8, 16), generator=torch.Generator(
        ).manual_seed(1)).to(cuda_device)
    results = {}
    for backend in ("cuda", "torch"):
        pcfg = PolicyConfig(**SMALL, score_backend=backend)
        policy = CoRaiSPolicy(pcfg, generator=torch.Generator().manual_seed(0),
                              device=cuda_device)
        policy_score.reset_launch_counts()
        loss, aux, grads = ttrain.temporal_loss_and_grads(
            policy, engine.init_batch(cfg.engine, seeds, device=cuda_device),
            arrivals, dataclasses.replace(cfg, policy=pcfg), actions=actions)
        results[backend] = (loss, aux, grads, dict(policy_score.LAUNCHES))
    (loss_k, aux_k, grads_k, launches), (loss_p, aux_p, grads_p, _) = (
        results["cuda"], results["torch"])
    assert launches["policy_score"] == 6 and launches["policy_score_bwd"] == 6
    assert launches["policy_score_decode"] == 0
    assert abs(float(loss_k - loss_p)) <= 1e-5 * abs(float(loss_p))
    assert float(aux_k["completed"]) == float(aux_p["completed"]) > 0
    gmax = max(float(g.abs().max()) for g in grads_p.values())
    for key, gp in grads_p.items():
        torch.testing.assert_close(grads_k[key], gp, rtol=1e-4,
                                   atol=1e-5 * gmax, msg=key)


def test_device_samplers_on_a_cuda_generator(cuda_device):
    """The device episode and fault samplers on the card: tensors on the
    generator's device, the Poisson count moments, the exact clip contract
    and the scripted fault rows equal to the host's."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    d = materialize_round_batch_device(PoissonArrivals(rate=30.0), 4, 8,
                                       0.25, 512, generator=gen,
                                       max_per_round=64)
    assert all(v.device.type == "cuda" for v in d.values())
    counts = d["mask"].sum(-1).double().cpu().numpy()
    assert counts.mean() == pytest.approx(7.5, rel=0.05)
    assert counts.var() == pytest.approx(7.5, rel=0.15)
    c = materialize_round_batch_device(PoissonArrivals(rate=120.0), 4, 6,
                                       0.25, 64, generator=gen,
                                       max_per_round=8)
    kept = c["mask"].sum(-1)
    total = kept + c["dropped"]
    assert bool((c["dropped"] > 0).any())
    starts = torch.cumsum(total, -1) - total
    want = torch.where(c["mask"], starts[..., None] + torch.arange(
        8, device=cuda_device), 0)
    assert torch.equal(c["rid"], want.to(torch.int32))
    spec = faults.FaultSpec(rolling=(2, 2), jitter_sigma=0.3, min_alive=2)
    out = faults.attach_fault_batch_device(c, spec, 4, gen)
    host = faults.materialize_faults(spec, 4, 6, seed=0)
    for b in range(64):
        assert np.array_equal(out["alive"][b].cpu().numpy(), host["alive"])
    assert bool((out["jitter"][c["mask"]] >= rounds.MIN_JITTER).all())


# -- the serving host side (the central controller on the card) ------------


def _served(policy, fused):
    """``tests/test_serving.py``'s 4-edge, 40-request flow under the policy
    controller, recording each round's padded snapshot and decision."""
    cc = CentralController(scheduler="corais", policy=policy, z_pad=32,
                           fused_decode=fused)
    rounds = []
    decide = cc._policy_assign

    def recording(inst):
        out = decide(inst)
        rounds.append((inst, out))
        return out

    cc._policy_assign = recording
    sim = MultiEdgeSim(SimConfig(num_edges=4, seed=0), cc)
    rng = np.random.default_rng(0)
    for _ in range(40):
        sim.submit(int(rng.integers(0, 4)), float(rng.uniform(0.1, 1.0)),
                   t=float(rng.uniform(0, 2.0)))
    policy_score.reset_launch_counts()
    m = sim.run(until=240.0)
    return m, rounds, dict(policy_score.LAUNCHES)


@pytest.mark.parametrize("fused,kernel", [(False, "policy_score"),
                                          (True, "policy_score_decode")])
def test_controller_on_the_card_launches_its_kernel_once_per_round(
        cuda_device, fused, kernel):
    """The controller on CUDA: B1 (or B3 with ``fused_decode=True``) once
    per non-empty round and nothing else of the port; its decisions equal
    the CPU controller's where the top-2 gap exceeds 1e-4."""
    cfg = PolicyConfig(**SMALL)
    policy = CoRaiSPolicy(cfg, device=cuda_device)
    cpu = CoRaiSPolicy(cfg, device="cpu")
    m, rounds, launched = _served(policy, fused)
    assert m["completed"] == 40
    assert launched[kernel] == m["decision_rounds"] == len(rounds) > 0
    assert sum(launched.values()) == len(rounds)
    on_cpu = CentralController(scheduler="corais", policy=cpu, z_pad=32,
                               fused_decode=fused)
    checked = 0
    for inst, got in rounds:
        tinst = {k: torch.as_tensor(np.asarray(v)) for k, v in inst.items()}
        with torch.no_grad():
            c, h = corais_encode(cpu, tinst)
            _, tv = corais_score_decode(cpu, c, h, tinst["edge_mask"], k=2,
                                        normalize=False, backend="torch")
        gapped = (((tv[:, 0] - tv[:, 1]) > 1e-4) & tinst["req_mask"]).numpy()
        want = on_cpu._policy_assign(inst)
        np.testing.assert_array_equal(got[gapped], want[gapped])
        checked += int(gapped.sum())
    assert checked > 0


# -- LM training: B4's log-sum-exp and the flash backward -------------------

# (B, S, H, KV, hd, dtype, causal, window): olmo-1b's training heads, bf16
# and f32; qwen3-4b's GQA heads; a ragged S, causal and windowed
LSE_CASES = [
    (2, 256, 16, 16, 128, torch.bfloat16, True, None),
    (2, 256, 16, 16, 128, torch.float32, True, None),
    (1, 300, 32, 8, 128, torch.bfloat16, True, None),
    (2, 65, 4, 2, 64, torch.bfloat16, True, None),
    (2, 65, 4, 2, 64, torch.float32, True, 48),
    (2, 65, 4, 2, 64, torch.bfloat16, False, 48),
]


@pytest.mark.parametrize("b,s,h,kv,hd,dtype,causal,window", LSE_CASES)
def test_flash_attention_lse_matches_plain_version(cuda_device, b, s, h, kv,
                                                   hd, dtype, causal, window):
    """lse within 1e-5 of max |lse| (f32 sums in another order); ``out``
    the same bits with and without the lse store."""
    gen = torch.Generator().manual_seed(s + hd)
    q, k, v = (torch.randn(b, s, n, hd, generator=gen).to(cuda_device, dtype)
               for n in (h, kv, kv))
    build.reset_launch_counts()
    out, lse = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    with_lse=True)
    bare = flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention"] == 2
    want = ref.flash_attention_lse_torch(q, k, causal=causal, window=window)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    assert float((lse - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert torch.equal(out, bare)


@pytest.mark.parametrize("b,s,h,kv,hd,dtype,causal,window", LSE_CASES)
def test_flash_attention_backward_matches_autograd_through_plain(
        cuda_device, b, s, h, kv, hd, dtype, causal, window):
    """``FlashAttention`` (B4 forward, the pair-scan backward, chunk 64)
    against autograd through the plain version: f32 within 1e-4 of each
    gradient's largest |entry|, bf16 within 2^-6 (the forward's bf16
    output enters delta = rowsum(dO * O)); the same bits on two calls."""
    gen = torch.Generator().manual_seed(s)
    q, k, v, dout = (torch.randn(b, s, n, hd, generator=gen).to(cuda_device,
                                                                dtype)
                     for n in (h, kv, kv, h))

    def grads(fn):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        fn(*leaves).backward(dout)
        return [x.grad for x in leaves]

    got = grads(lambda *x: ops.flash_attention(*x, causal=causal,
                                               window=window, chunk=64))
    again = grads(lambda *x: ops.flash_attention(*x, causal=causal,
                                                 window=window, chunk=64))
    want = grads(lambda *x: ref.flash_attention_torch(*x, causal=causal,
                                                      window=window))
    tol = 1e-4 if dtype == torch.float32 else 2 ** -6
    for name, g, a, w in zip("qkv", got, again, want):
        assert g.dtype == dtype
        err = float((g.float() - w.float()).abs().max())
        assert err <= tol * float(w.float().abs().max()), (name, err)
        assert torch.equal(g, a), name


def test_b5_b6_refuse_gradients_on_the_card(cuda_device):
    """No silent detach: with inputs that need a gradient, B5 and B6's bare
    entry raise rather than return a kernel output cut off from autograd;
    B6's gated entry carries the graph (its backward is B6b)."""
    def t(*shape):
        return torch.randn(*shape, device=cuda_device, requires_grad=True)

    slot_pos = torch.arange(8, dtype=torch.int32,
                            device=cuda_device).repeat(2, 1)
    pos = torch.full((2,), 7, dtype=torch.int32, device=cuda_device)
    a = -torch.rand(16, 4, device=cuda_device)
    with pytest.raises(RuntimeError, match="B5 .* no backward"):
        ops.decode_attention(t(2, 4, 16), t(2, 8, 2, 16), t(2, 8, 2, 16),
                             slot_pos, pos)
    with pytest.raises(RuntimeError, match="no backward.*mamba_scan_gated"):
        ops.mamba_scan(t(1, 9, 16), torch.rand(1, 9, 16, device=cuda_device),
                       t(1, 9, 4), t(1, 9, 4), a)
    out, _ = ops.mamba_scan_gated(t(1, 9, 16), t(1, 9, 16), t(16),
                                  t(1, 9, 4), t(1, 9, 4), a, t(16),
                                  t(1, 9, 16))
    assert out.grad_fn is not None
    with torch.no_grad():
        ops.decode_attention(t(2, 4, 16), t(2, 8, 2, 16), t(2, 8, 2, 16),
                             slot_pos, pos)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_lm_training_on_the_card_matches_the_cpu(cuda_device, remat):
    """Reduced olmo-1b in f32, the same weights and batch: the loss and
    every gradient through B4 and the pair-scan backward on the card
    against the plain versions on the CPU (1e-5; gradients 1e-5 + 1e-4
    relative); B4 once per layer, twice under remat (the recompute)."""
    cfg = dataclasses.replace(get_reduced_config("olmo-1b"), remat=remat)
    cpu = lm.init_params(cfg, generator=torch.Generator().manual_seed(0))
    gpu = _to(cpu, cuda_device)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    out = {}
    build.reset_launch_counts()
    for name, params in (("cuda", gpu), ("cpu", cpu)):
        leaves = named_leaves(params)
        for x in leaves.values():
            x.requires_grad_(True)
        dev = next(iter(leaves.values())).device
        batch = {"tokens": tokens.to(dev), "labels": tokens.to(dev)}
        total, _ = lm.train_loss(params, batch, cfg)
        out[name] = (total, torch.autograd.grad(
            total, list(leaves.values()), allow_unused=True))
    torch.cuda.synchronize()
    per_layer = 1 if remat == "none" else 2
    assert build.LAUNCHES["flash_attention"] == per_layer * cfg.num_layers
    torch.testing.assert_close(out["cuda"][0].cpu(), out["cpu"][0],
                               atol=1e-5, rtol=1e-5)
    for g, w in zip(out["cuda"][1], out["cpu"][1]):
        assert (g is None) == (w is None)
        if g is not None:
            torch.testing.assert_close(g.cpu(), w, atol=1e-5, rtol=1e-4)


# -- whisper: B4 over a key sequence of its own length; MoE training ---------


CROSS_CASES = [
    (2, 4, 1500, 6, 6, 64, torch.bfloat16, False),   # whisper's cross prefill
    (2, 65, 63, 6, 6, 64, torch.bfloat16, False),
    (1, 448, 1500, 6, 6, 64, torch.float32, False),  # whisper's training
    (2, 1, 300, 8, 2, 64, torch.bfloat16, False),
    (2, 100, 37, 8, 2, 64, torch.float32, True),     # causal, rows past Sk
    (1, 40, 130, 4, 4, 128, torch.bfloat16, True),   # causal, top left
]


@pytest.mark.parametrize("b,sq,sk,h,kv,hd,dtype,causal", CROSS_CASES)
def test_flash_attention_at_other_key_lengths(cuda_device, b, sq, sk, h, kv,
                                              hd, dtype, causal):
    """B4 with Sq != Sk against its plain version (the reference's bars),
    its lse within 1e-5 of max |lse|, the output the same bits with and
    without the lse store and on two calls."""
    gen = torch.Generator().manual_seed(sq * 7 + sk)
    q = torch.randn(b, sq, h, hd, generator=gen).to(cuda_device, dtype)
    k, v = (torch.randn(b, sk, kv, hd, generator=gen).to(cuda_device, dtype)
            for _ in range(2))
    got = ops.flash_attention(q, k, v, causal=causal)
    out, lse = flash_attention_cuda(q, k, v, causal=causal, with_lse=True)
    want = ref.flash_attention_torch(q, k, v, causal=causal)
    want_lse = ref.flash_attention_lse_torch(q, k, causal=causal)
    torch.cuda.synchronize()
    assert got.shape == q.shape and torch.equal(got, out)
    torch.testing.assert_close(got.float(), want.float(), **_attn_tol(dtype))
    assert lse.shape == (b, h, sq)
    assert float((lse - want_lse).abs().max()) <= 1e-5 * float(
        want_lse.abs().max())
    assert torch.equal(got, ops.flash_attention(q, k, v, causal=causal))


@pytest.mark.parametrize("sq,sk,dtype", [(16, 448, torch.float32),
                                         (16, 1500, torch.bfloat16),
                                         (37, 20, torch.float32)])
def test_flash_attention_backward_at_other_key_lengths(cuda_device, sq, sk,
                                                       dtype):
    """``FlashAttention``'s gradients at Sq != Sk (non-causal, whisper's 6
    heads of 64, chunk 512 capped at Sq) against autograd through the
    plain version: f32 within 1e-4 of each gradient's largest |entry|,
    bf16 within 2^-6; the same bits on two calls."""
    gen = torch.Generator().manual_seed(sk)
    q, dout = (torch.randn(2, sq, 6, 64, generator=gen).to(cuda_device, dtype)
               for _ in range(2))
    k, v = (torch.randn(2, sk, 6, 64, generator=gen).to(cuda_device, dtype)
            for _ in range(2))

    def grads(fn):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        fn(*leaves).backward(dout)
        return [x.grad for x in leaves]

    got = grads(lambda *x: ops.flash_attention(*x, causal=False))
    again = grads(lambda *x: ops.flash_attention(*x, causal=False))
    want = grads(lambda *x: ref.flash_attention_torch(*x, causal=False))
    tol = 1e-4 if dtype == torch.float32 else 2 ** -6
    for name, g, a, w in zip("qkv", got, again, want):
        assert g.shape == w.shape and g.dtype == dtype
        err = float((g.float() - w.float()).abs().max())
        assert err <= tol * float(w.float().abs().max()), (name, err)
        assert torch.equal(g, a), name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cross_decode_attention_runs_b5_on_the_frames(cuda_device, dtype):
    """The one-token cross attention over 1,500 frames goes through B5
    (the frames' slot map, the query at Sk - 1), once, against the plain
    unmasked attention."""
    from repro_torch.models import attention
    gen = torch.Generator().manual_seed(5)
    q = torch.randn(8, 1, 6, 64, generator=gen).to(cuda_device, dtype)
    k, v = (torch.randn(8, 1500, 6, 64, generator=gen).to(cuda_device, dtype)
            for _ in range(2))
    build.reset_launch_counts()
    got = attention.cross_decode_attention(q, k, v)
    torch.cuda.synchronize()
    assert build.LAUNCHES["decode_attention"] == 1
    assert build.LAUNCHES["flash_attention"] == 0
    want = ref.flash_attention_torch(q, k, v, causal=False)
    assert got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **_attn_tol(dtype))


def test_whisper_on_the_card_matches_the_cpu(cuda_device):
    """Reduced f32 whisper: prefill over 40 frames (more than its 32
    ``encoder_len``) and a 5-token prompt, then three decode steps, on the
    card against the CPU (logits 1e-4); B4 once per encoder layer and
    twice per decoder layer in the prefill (self and cross), B5 twice per
    decoder layer in each step."""
    cfg = get_reduced_config("whisper-tiny")
    cpu = lm.init_params(cfg, generator=torch.Generator().manual_seed(0))
    gpu = _to(cpu, cuda_device)
    gen = torch.Generator().manual_seed(1)
    batch = {"embeds": torch.randn(2, 40, cfg.d_model, generator=gen),
             "tokens": torch.randint(0, cfg.vocab_size, (2, 5), generator=gen,
                                     dtype=torch.int32)}
    build.reset_launch_counts()
    cache_g, lg = lm.prefill(gpu, {k: v.to(cuda_device)
                                   for k, v in batch.items()}, cfg, max_seq=16)
    cache_c, lc = lm.prefill(cpu, batch, cfg, max_seq=16)
    torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=0)
    for step in range(3):
        dec = {"token": torch.tensor([step + 3, 7 * step], dtype=torch.int32)}
        cache_g, lg = lm.decode_step(gpu, cache_g, {
            k: v.to(cuda_device) for k, v in dec.items()}, cfg)
        cache_c, lc = lm.decode_step(cpu, cache_c, dec, cfg)
        torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=0)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention"] == (cfg.num_encoder_layers
                                                 + 2 * cfg.num_layers)
    assert build.LAUNCHES["decode_attention"] == 3 * 2 * cfg.num_layers
    for key in ("k", "v"):
        torch.testing.assert_close(cache_g["layers"][key].cpu(),
                                   cache_c["layers"][key], atol=1e-5,
                                   rtol=1e-5)
    torch.testing.assert_close(cache_g["enc_out"].cpu(), cache_c["enc_out"],
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ["whisper-tiny", "mixtral-8x7b"])
def test_whisper_and_moe_training_on_the_card_match_the_cpu(cuda_device,
                                                            arch):
    """Reduced f32 whisper (24 frames, 9 tokens) and mixtral under remat
    "full": the loss, ``aux_loss`` and every gradient through B4 and the
    pair-scan backward on the card against the plain versions on the CPU
    (1e-5; gradients 1e-5 + 1e-4 relative); B4 twice per attention (the
    recompute)."""
    cfg = dataclasses.replace(get_reduced_config(arch), remat="full")
    cpu = lm.init_params(cfg, generator=torch.Generator().manual_seed(0))
    gpu = _to(cpu, cuda_device)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 9), generator=gen,
                           dtype=torch.int32)
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.encoder_decoder:
        batch["embeds"] = torch.randn(2, 24, cfg.d_model, generator=gen)
    out = {}
    build.reset_launch_counts()
    for name, params in (("cuda", gpu), ("cpu", cpu)):
        leaves = named_leaves(params)
        for x in leaves.values():
            x.requires_grad_(True)
        dev = next(iter(leaves.values())).device
        total, metrics = lm.train_loss(
            params, {k: v.to(dev) for k, v in batch.items()}, cfg)
        out[name] = (total, metrics["aux_loss"], torch.autograd.grad(
            total, list(leaves.values()), allow_unused=True))
    torch.cuda.synchronize()
    attentions = (cfg.num_encoder_layers + 2 * cfg.num_layers
                  if cfg.encoder_decoder else cfg.num_layers)
    assert build.LAUNCHES["flash_attention"] == 2 * attentions
    for got, want in zip(out["cuda"][:2], out["cpu"][:2]):
        torch.testing.assert_close(got.detach().cpu(), want.detach(),
                                   atol=1e-5, rtol=1e-5)
    for g, w in zip(out["cuda"][2], out["cpu"][2]):
        assert (g is None) == (w is None)
        if g is not None:
            torch.testing.assert_close(g.cpu(), w, atol=1e-5, rtol=1e-4)
