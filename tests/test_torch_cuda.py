"""The port's CUDA kernels on a card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips without
one. The file imports neither jax nor the reference, so it runs on a GPU
machine that has only torch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance 2e-5: f32 sums in another order, scaled by C=10 through tanh.
The backward (B2) is held relative to each gradient's largest entry: 2e-5
for dc and dh, 1e-4 for the weight gradients, whose sums run over B*Z rows.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import instances as tinst
from repro_torch.core.policy import (CoRaiSPolicy, PolicyConfig,
                                     corais_encode, corais_score_decode)
from repro_torch.core.train import RLConfig, loss_and_grads, to_device
from repro_torch.kernels import ops, policy_score, ref
from repro_torch.serving.fastpath import DecisionFastPath

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
    assert policy_score.LAUNCHES == {"policy_score": 1, "policy_score_bwd": 0,
                                     "policy_score_decode": 1}


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


def _rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("b,q,q_valid,z,d", [
    (3, 6, 3, 37, 32),      # Z not a multiple of the 16-row tile
    (2, 128, 100, 20, 64),  # every lane holds four edges
    (64, 5, 4, 50, 128),    # B*Z = 3200 rows: split weight-gradient sums
    (1, 7, 7, 5, 512),      # the widest d
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
